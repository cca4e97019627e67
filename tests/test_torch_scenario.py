"""Whole scenarios: the port against the JAX package on the same configs
and data, and the port's own engine contracts.

* Ledgers must be EXACTLY equal (every event, in order): collection
  draws, elections and charges are host-side numpy in both packages.
* F1 curves within F1_BOUND = 5e-3 of the reference. Evidence for the
  bound (CPU, this repo): on the full 30-window ``paper_tables`` grid the
  port's per-window F1 stays within 1.3e-3 of the JAX package's and its
  converged F1 within 5.2e-5; the differences come from float32 rounding
  that moves a hinge-subgradient kink or a test prediction.
* The port's fleet==loop contract (repro_torch.core.fleet): ledgers
  equal, F1 curves within the reference's own 1e-4 bar.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import scenario as j_scn
from repro.data.synthetic_covtype import make_covtype_like
from repro_torch.core import scenario as t_scn

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F1_BOUND = 5e-3
DATA = make_covtype_like(n_total=3000, seed=0)
BASE = j_scn.ScenarioConfig(windows=3, eval_every=1)

CASES = {
    "star_fleet": dict(algo="star", tech="4g"),
    "star_loop": dict(algo="star", tech="mesh:hops=2", engine="loop"),
    "a2a_fleet": dict(algo="a2a", tech="wifi", n_subsample=5),
    "a2a_loop": dict(algo="a2a", tech="wifi", engine="loop"),
    "edge_only": dict(algo="edge_only"),
    "a2a_churn": dict(algo="a2a", tech="4g", battery_mj=4.0, p_edge=0.15,
                      aggregate=True),
    "a2a_byzantine": dict(algo="a2a", tech="ble", byz_frac=0.3,
                          robust_agg="trim:frac=0.25"),
}


def _port_cfg(cfg):
    return t_scn.ScenarioConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CASES))
def test_scenario_matches_jax(name):
    cfg = dataclasses.replace(BASE, **CASES[name])
    want = j_scn.run_scenario(cfg, DATA)
    got = t_scn.run_scenario(_port_cfg(cfg), DATA, device="cpu")
    assert got.ledger.events == want.ledger.events
    assert got.energy_total == want.energy_total
    assert len(got.f1_curve) == len(want.f1_curve) == cfg.windows
    np.testing.assert_allclose(got.f1_curve, want.f1_curve, rtol=0,
                               atol=F1_BOUND)
    if name == "a2a_churn":
        assert any(e["purpose"] == "churn" for e in got.ledger.events)


@pytest.mark.parametrize("algo,tech", [("star", "4g"), ("a2a", "wifi")])
def test_port_fleet_matches_loop(algo, tech):
    cfg = t_scn.ScenarioConfig(windows=3, eval_every=1, algo=algo,
                               tech=tech, p_edge=0.15)
    loop = t_scn.run_scenario(dataclasses.replace(cfg, engine="loop"), DATA,
                              device="cpu")
    fleet = t_scn.run_scenario(cfg, DATA, device="cpu")
    assert fleet.ledger.events == loop.ledger.events
    np.testing.assert_allclose(fleet.f1_curve, loop.f1_curve, rtol=0,
                               atol=1e-4)


def test_stacked_sweep_matches_sequential():
    """Replica stacking (seeds and host-side variants in one fleet axis):
    ledgers exactly, F1 curves within the fleet==loop bar."""
    cfgs = [t_scn.ScenarioConfig(windows=2, eval_every=1, algo="a2a",
                                 seed=s) for s in (0, 1)]
    cfgs.append(dataclasses.replace(cfgs[0], tech="wifi", n_subsample=5,
                                    aggregate=True))
    seq = [t_scn.run_scenario(c, DATA, device="cpu") for c in cfgs]
    stk = t_scn.run_sweep(cfgs, DATA, stack_seeds=True, device="cpu")
    for a, b in zip(seq, stk):
        assert a.ledger.events == b.ledger.events
        np.testing.assert_allclose(b.f1_curve, a.f1_curve, atol=1e-4)


def test_eval_cache_is_keyed_per_device_and_refuses_pickling():
    import pickle

    cache = t_scn.EvalCache()
    a = cache.test_array(DATA, device="cpu")
    assert cache.test_array(DATA, device="cpu") is a
    assert (cache.hits, cache.misses) == (1, 1)
    assert a.device.type == "cpu" and a.shape == DATA.x_test.shape
    assert list(cache._entries)[0][2] == "cpu"
    with pytest.raises(TypeError):
        pickle.dumps(cache)


def test_validation_and_unported_engine():
    """Unknown engines raise; the scan engine runs and matches the fleet
    engine, ledgers exactly and F1 within the fleet==loop bar."""
    with pytest.raises(KeyError):
        t_scn.run_scenario(t_scn.ScenarioConfig(engine="warp"), DATA,
                           device="cpu")
    scan_cfg = t_scn.ScenarioConfig(engine="scan", windows=2, eval_every=1,
                                    algo="a2a", tech="wifi")
    scan = t_scn.run_scenario(scan_cfg, DATA, device="cpu")
    fleet = t_scn.run_scenario(dataclasses.replace(scan_cfg, engine="fleet"),
                               DATA, device="cpu")
    assert scan.ledger.events == fleet.ledger.events
    np.testing.assert_allclose(scan.f1_curve, fleet.f1_curve, rtol=0,
                               atol=1e-4)
    assert t_scn.host_side_fields() == j_scn.host_side_fields()
    cfg = t_scn.ScenarioConfig(seed=3, tech="wifi", p_edge=0.1)
    assert dataclasses.asdict(t_scn.stack_key(cfg)) == dataclasses.asdict(
        j_scn.stack_key(j_scn.ScenarioConfig(seed=3, tech="wifi",
                                             p_edge=0.1)))


def test_run_scenario_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_scn.ScenarioConfig(windows=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_scn.run_scenario(cfg, DATA)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_scn.run_sweep([cfg], DATA, stack_seeds=True)
