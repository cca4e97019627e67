"""Shared by the port's orchestration tests (tests/test_torch_parallel.py,
test_torch_launcher.py, test_torch_service.py): a tiny ``smoke`` sweep,
run sequentially by the port on the CPU and by the JAX package once per
process, and the check that holds a port result against the reference:
every ledger event exactly, every F1 value within the port's bound."""
import dataclasses
import functools

import numpy as np

from repro.core import experiment as j_exp
from repro_torch.core import experiment as t_exp
from repro_torch.data.synthetic_covtype import make_covtype_like
from test_torch_experiment import F1_BOUND

SMOKE_KW = dict(windows=2, n_seeds=2)
DATA = make_covtype_like(n_total=2500, seed=1)


def smoke_spec():
    return t_exp.get_preset("smoke", **SMOKE_KW)


@functools.lru_cache(maxsize=None)
def port_smoke_json() -> str:
    """The port's sequential (``parallel="none"``) CPU run, as JSON."""
    return smoke_spec().run(DATA, device="cpu").to_json()


@functools.lru_cache(maxsize=None)
def reference_smoke():
    return j_exp.get_preset("smoke", **SMOKE_KW).run(DATA)


def assert_matches_reference(got) -> None:
    want = reference_smoke()
    assert got.labels() == want.labels()
    for a, b in zip(got.records, want.records):
        assert (a.label, dataclasses.asdict(a.cfg)) \
            == (b.label, dataclasses.asdict(b.cfg))
        assert a.events == b.events
        np.testing.assert_allclose(a.f1_curve, b.f1_curve, rtol=0,
                                   atol=F1_BOUND)
