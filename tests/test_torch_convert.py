"""State carry-over between the packages: models trained by the JAX
package enter the port through ``from_reference`` and leave through
``to_reference``; one learning round started from the same JAX-trained
global model and source pool gives the same model in both (atol 1e-4,
float32 roundoff, as in tests/test_torch_greedytl.py) and the same
ledger (exactly)."""
import numpy as np
import pytest
import torch

from repro.core import htl as j_htl
from repro.core import fleet as j_fleet
from repro.core.energy import Ledger as JLedger
from repro.data.synthetic_covtype import make_covtype_like
from repro_torch.core import convert, fleet as t_fleet
from repro_torch.core import htl as t_htl
from repro_torch.core.energy import Ledger as TLedger
from repro_torch.core.greedytl import greedytl

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

C = 7
DATA = make_covtype_like(n_total=2500, seed=2)


def _dcs(mod, lo, sizes):
    out, at = [], lo
    for i, n in enumerate(sizes):
        out.append(mod.DC(f"SM{i + 1}", DATA.x_train[at:at + n]
                          .astype(np.float32),
                          DATA.y_train[at:at + n].astype(np.int32)))
        at += n
    return out


def test_one_round_from_a_jax_trained_global_model():
    prev = j_htl.run_window_star(_dcs(j_htl, 0, [40, 25, 9]), None,
                                 JLedger(), "4g", cap=160, num_classes=C)
    prev = np.ascontiguousarray(prev, np.float32)
    carried = convert.to_reference(convert.from_reference(prev, "cpu"))
    assert carried.tobytes() == prev.tobytes()

    sizes = [30, 14, 50, 6]
    lj, lt = JLedger(), TLedger()
    want = j_fleet.run_window_a2a(_dcs(j_htl, 200, sizes), prev, lj, "wifi",
                                  cap=160, num_classes=C)
    got = t_fleet.run_window_a2a(_dcs(t_htl, 200, sizes), carried, lt,
                                 "wifi", cap=160, num_classes=C,
                                 device="cpu")
    assert lt.events == lj.events
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_source_pool_carries_over():
    bases = [np.ascontiguousarray(
        np.random.default_rng(s).normal(size=(55, C)), np.float32)
        for s in range(3)]
    src, sm = j_htl.build_source_pool(bases, bases[0])
    pool = convert.from_reference({"src": src, "src_mask": sm}, "cpu")
    assert pool["src"].shape == (16, 55, C) and pool["src_mask"].sum() == 4
    back = convert.to_reference(pool)
    assert back["src"].tobytes() == src.tobytes()
    assert back["src_mask"].tobytes() == sm.tobytes()
    rng = np.random.default_rng(0)
    idx = rng.choice(len(DATA.y_train), 40, replace=False)
    x = DATA.x_train[idx].astype(np.float32)
    y = DATA.y_train[idx].astype(np.int32)
    w, sel = greedytl(x, y, np.ones(40, np.float32), pool["src"],
                      pool["src_mask"], num_classes=C, device="cpu")
    assert torch.isfinite(w).all() and (sel[4:] == 0).all()


def test_from_reference_checks_layout_and_dtype():
    good = np.zeros((55, C), np.float32)
    with pytest.raises(TypeError):
        convert.from_reference(good.astype(np.float64), "cpu")
    with pytest.raises(ValueError):
        convert.from_reference(np.zeros(55, np.float32), "cpu")
    with pytest.raises(ValueError):
        convert.from_reference(np.zeros((C, 55), np.float32).T, "cpu")
    with pytest.raises(ValueError):                  # mask without a pool
        convert.from_reference({"src_mask": np.ones(3, np.float32)}, "cpu")
    with pytest.raises(ValueError):                  # mask of the wrong M
        convert.from_reference({"src": np.zeros((4, 55, C), np.float32),
                                "src_mask": np.ones(3, np.float32)}, "cpu")
    with pytest.raises(TypeError):
        convert.to_reference(torch.zeros((55, C), dtype=torch.float64))


def test_from_reference_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.from_reference(np.zeros((55, C), np.float32))
