"""The port's host-only modules against the JAX package's: the copied
numpy/stdlib modules must give identical results — datasets byte-equal,
ledger events and totals exactly equal, identical spec parsing, traces and
drifted streams. Tolerance: none (exact equality throughout)."""
import dataclasses

import numpy as np
import pytest

from repro.core import energy as j_energy
from repro.core import metrics as j_metrics
from repro.core import registry as j_registry
from repro.core import topology as j_topology
from repro.data import mobility as j_mobility
from repro.data import synthetic_covtype as j_cov
from repro_torch.core import dispatch as t_dispatch
from repro_torch.core import energy as t_energy
from repro_torch.core import metrics as t_metrics
from repro_torch.core import registry as t_registry
from repro_torch.core import topology as t_topology
from repro_torch.data import mobility as t_mobility
from repro_torch.data import synthetic_covtype as t_cov


@pytest.mark.parametrize("n_total,seed,class_sep", [
    (19229, 0, 1.05), (3000, 7, 1.05), (1000, 3, 0.5)])
def test_make_covtype_like_byte_equal(n_total, seed, class_sep):
    a = j_cov.make_covtype_like(n_total=n_total, seed=seed,
                                class_sep=class_sep)
    b = t_cov.make_covtype_like(n_total=n_total, seed=seed,
                                class_sep=class_sep)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert u.tobytes() == v.tobytes()


@pytest.mark.parametrize("spec", ["none", "rotate", "rotate:rate=0.2",
                                  "prior:at=0.5", "prior:at=0.25,gamma=2",
                                  "rotate_prior"])
def test_drift_streams_equal(spec):
    d = j_cov.make_covtype_like(n_total=1400, seed=1)
    x, y = d.x_train[:600], d.y_train[:600]
    a = j_cov.get_drift(spec)(x, y, 6, 100, 3)
    b = t_cov.get_drift(spec)(x, y, 6, 100, 3)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()


def test_mobility_traces_equal(tmp_path):
    a = j_mobility.make_trace_loads(windows=9, mules=5, sensors=30, seed=4)
    b = t_mobility.make_trace_loads(windows=9, mules=5, sensors=30, seed=4)
    assert np.array_equal(a, b)
    pa = j_mobility.generate_trace(str(tmp_path / "j"), windows=5, seed=2)
    pb = t_mobility.generate_trace(str(tmp_path / "t"), windows=5, seed=2)
    assert pa.split("/")[-1] == pb.split("/")[-1]
    assert open(pa).read() == open(pb).read()
    assert np.array_equal(j_mobility.load_trace(pa),
                          t_mobility.load_trace(pb))


TECH_SPECS = ["4g", "nbiot", "802.15.4", "wifi", "ble", "lora",
              "lora:sf=12", "lora:sf=9", "mesh", "mesh:hops=2",
              "mesh:hops=3"]


def _ledger_script(energy, topology):
    """Every ledger path of tests/test_energy.py and test_transports.py:
    the calibration collections, flag unicasts, typed-topology collectives
    over every transport and role mix, churn events, attributed drain."""
    led = energy.Ledger()
    for _ in range(100):
        led.collect_to_edge(100)
        led.collect_to_mule(100, "SM1")
    led.collect_to_edge(10000)
    led.collect_to_mule(10000)
    for flags in ({}, {"src_is_ap": True}, {"dst_is_ap": True},
                  {"dst_is_es": True}, {"src_is_es": True}):
        for tech in ("4g", "wifi", "ble", "mesh:hops=3", "lora:sf=12"):
            led.unicast(tech, energy.MODEL_BYTES, **flags)
    nodes = [topology.Node("SM1", is_ap=True), topology.Node("SM2"),
             topology.Node("SM3"), topology.Node("ES", is_es=True)]
    for tech in TECH_SPECS:
        topo = topology.Topology(led, tech, nodes)
        topo.exchange_all(energy.MODEL_BYTES, what="m0 exchange")
        topo.broadcast(nodes[1], energy.INDEX_BYTES, what="center id")
        topo.gather(nodes[2], energy.MODEL_BYTES, what="m1 gather")
        topo.unicast(nodes[3], nodes[1], 123.0, purpose="collection")
        for nbytes in (1.0, 433.0, 1e5):
            led.add(tech, nbytes, purpose="learning", n_tx=2, n_rx=3)
    led.churn("SM2", 4)
    return led


def test_ledgers_equal_on_energy_and_transport_cases():
    a = _ledger_script(j_energy, j_topology)
    b = _ledger_script(t_energy, t_topology)
    assert a.events == b.events
    assert a.total() == b.total()
    assert a.by_purpose() == b.by_purpose() and a.by_tech() == b.by_tech()
    assert a.node_mj == b.node_mj
    assert a.total() > 0


def test_energy_constants_equal():
    assert {k: dataclasses.asdict(v) for k, v in j_energy.TECHS.items()} \
        == {k: dataclasses.asdict(v) for k, v in t_energy.TECHS.items()}
    assert (j_energy.OBS_BYTES, j_energy.MODEL_BYTES, j_energy.INDEX_BYTES) \
        == (t_energy.OBS_BYTES, t_energy.MODEL_BYTES, t_energy.INDEX_BYTES)
    for spec in TECH_SPECS:
        assert dataclasses.asdict(j_energy.resolve_tech(spec)) \
            == dataclasses.asdict(t_energy.resolve_tech(spec))


@pytest.mark.parametrize("tech", TECH_SPECS)
def test_transfer_counts_equal(tech):
    roles = [dict(), dict(is_ap=True), dict(is_es=True)]
    for rs in roles:
        for rd in roles:
            a = j_topology.transfer_counts(tech, j_topology.Node("a", **rs),
                                           j_topology.Node("b", **rd))
            b = t_topology.transfer_counts(tech, t_topology.Node("a", **rs),
                                           t_topology.Node("b", **rd))
            assert a == b


@pytest.mark.parametrize("spec", ["mesh", "mesh:hops=3,paywall=false",
                                  "lora:sf=12", "hosts:channel=ssh:x=1",
                                  "bursty:burst=8.5"])
def test_spec_grammar_equal(spec):
    assert j_registry.parse_spec(spec) == t_registry.parse_spec(spec)
    name, params = t_registry.parse_spec(spec)
    assert j_registry.format_spec(name, params) \
        == t_registry.format_spec(name, params)


@pytest.mark.parametrize("bad", ["", "mesh:", "mesh:hops", "mesh:=3"])
def test_malformed_specs_raise_alike(bad):
    with pytest.raises(ValueError):
        j_registry.parse_spec(bad)
    with pytest.raises(ValueError):
        t_registry.parse_spec(bad)


def test_metrics_equal():
    rng = np.random.default_rng(0)
    yt, yp = rng.integers(0, 7, 500), rng.integers(0, 7, 500)
    assert j_metrics.f_measure(yt, yp, 7) == t_metrics.f_measure(yt, yp, 7)
    cm = t_metrics.confusion_counts(yt, yp, 7)
    assert np.array_equal(cm, j_metrics.confusion_counts(yt, yp, 7))
    assert t_metrics.f_measure_from_confusion(cm) \
        == j_metrics.f_measure_from_confusion(cm)
    stack = rng.normal(size=(9, 5, 4)).astype(np.float32)
    for frac in (0.0, 0.2, 0.4):
        assert np.array_equal(j_metrics.trimmed_mean(stack, frac),
                              t_metrics.trimmed_mean(stack, frac))


def test_dispatch_counter_scopes():
    @t_dispatch.count_dispatch("probe")
    def probe():
        return 1

    with t_dispatch.dispatch_scope() as delta:
        probe()
        probe()
    assert delta == {"probe": 2}
