"""The port's experiment surface against the JAX package's: every preset
expands to the same run list (labels and full configs) with the same
canonical hash, wire forms and result JSON round-trip, and a small sweep
gives the reference's ledgers exactly and its F1 within the port's bound
(5e-3; evidence in tests/test_torch_scenario.py)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import experiment as j_exp
from repro.data.synthetic_covtype import make_covtype_like
from repro_torch.core import experiment as t_exp

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F1_BOUND = 5e-3
PRESET_KW = {"paper_tables": dict(windows=30, n_seeds=1),
             "energy_tradeoff": {}, "transport_grid": {}, "city": {},
             "churn": {}, "drift": {}, "byzantine": {}, "pareto": {},
             "smoke": dict(windows=4, n_seeds=2)}


def _runs(spec):
    return [(lbl, dataclasses.asdict(cfg)) for lbl, cfg in spec.configs()]


@pytest.mark.parametrize("name", sorted(PRESET_KW) + ["mobility",
                                                      "realism"])
def test_presets_expand_like_the_reference(name, tmp_path):
    kw = dict(PRESET_KW.get(name, {}))
    if name in ("mobility", "realism"):
        kw["trace_dir"] = str(tmp_path)
    a, b = j_exp.get_preset(name, **kw), t_exp.get_preset(name, **kw)
    assert _runs(a) == _runs(b)
    assert a.canonical_hash() == b.canonical_hash()
    assert a.to_wire() == b.to_wire()


def test_wire_round_trip_and_errors():
    spec = t_exp.get_preset("paper_tables", windows=5, n_seeds=2)
    back = t_exp.SweepSpec.from_wire(json.loads(json.dumps(spec.to_wire())))
    assert _runs(back) == _runs(spec)
    assert back.canonical_hash() == spec.canonical_hash()
    with pytest.raises(ValueError):
        t_exp.SweepSpec(axes={"no_such_field": (1,)})
    with pytest.raises(ValueError):
        t_exp.SweepSpec(axes={"seed": (0, 0)}, label="dup").rows()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        spec.run(None, parallel="processes:n=2", device="cpu")


def test_small_sweep_matches_reference_and_round_trips():
    data = make_covtype_like(n_total=2500, seed=1)
    kw = dict(windows=2, n_seeds=2)
    want = j_exp.get_preset("smoke", **kw).run(data)
    got = t_exp.get_preset("smoke", **kw).run(data, device="cpu")
    assert got.labels() == want.labels()
    for a, b in zip(got.records, want.records):
        assert (a.label, dataclasses.asdict(a.cfg)) \
            == (b.label, dataclasses.asdict(b.cfg))
        assert a.events == b.events
        np.testing.assert_allclose(a.f1_curve, b.f1_curve, rtol=0,
                                   atol=F1_BOUND)
    for lbl in got.labels():
        s, r = got.summary(lbl), want.summary(lbl)
        for k in ("energy_mj", "collection_mj", "learning_mj"):
            assert s[k] == r[k]
    back = t_exp.SweepResult.from_json(got.to_json())
    assert back == got
    # the JSON the port writes loads in the reference, record for record
    ref_back = j_exp.SweepResult.from_json(got.to_json())
    assert [r.events for r in ref_back.records] == \
        [r.events for r in got.records]
    assert got.page(1, 4).records == got.records[4:]
