"""The scan and city engines (repro_torch.core.cityscan) against the JAX
package's (repro.core.cityscan) on the same seeds, and the port's own
contracts.

* The host planner is the reference's numpy code: packed plans byte-equal,
  ledgers EXACTLY equal (every event, in order).
* Device outputs: F1 within 1e-4, the reference's fleet-vs-loop bar
  (tests/test_fleet_engine.py:38). On this CPU every F1 value below came
  out exactly equal — scan against the JAX scan engine, scan against the
  port's fleet engine, the city against the reference's with the
  reference's draw indices injected (centers equal too) — and the
  ``smoke`` preset's ``SweepResult`` JSON of the scan engine, engine field
  normalised, is byte-equal to the fleet engine's
  (:func:`test_scan_sweep_json_is_byte_equal_to_the_fleet_engines`, the
  reference's ``scripts/scan_parity.py`` gate).
* The city's default draw is a different stream from the reference's
  threefry ``fold_in``/``randint``; the reference's indices are recovered
  exactly by calling its ``_draw_window`` with ``ytr = arange(n_train)``
  (its ``y`` output is then the index array) and injected through
  :func:`repro_torch.core.cityscan.table_draw`.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cityscan as j_city
from repro.core import scenario as j_scn
from repro.data.synthetic_covtype import make_covtype_like
from repro_torch.core import cityscan as t_city
from repro_torch.core import scenario as t_scn
from repro_torch.core.dispatch import dispatch_scope

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

F1_ATOL = 1e-4
DATA = make_covtype_like(seed=0)
W = 5

# tests/test_cityscan.py:38-46, plus a trimmed-mean A2A config
PARITY_CFGS = [
    dict(windows=W, eval_every=1, algo="a2a", tech="wifi", seed=1),
    dict(windows=W, eval_every=1, algo="star", tech="wifi", seed=1),
    dict(windows=W, eval_every=1, algo="star", tech="mesh:hops=2", seed=2,
         aggregate=True),
    dict(windows=W, eval_every=2, algo="a2a", tech="4g", seed=3,
         n_subsample=5),
    dict(windows=W, eval_every=1, algo="a2a", tech="wifi", seed=4,
         byz_frac=0.3, robust_agg="trim:frac=0.2"),
]
IDS = ["a2a_wifi_s1", "star_wifi_s1", "star_mesh_agg_s2", "a2a_4g_n5_s3",
       "a2a_trim_byz_s4"]

CITY = dict(windows=3, eval_every=1, algo="star", engine="scan",
            tech="wifi", fleet_size=40, obs_per_dc=4, train_iters=5)


def _cfgs(kw, engine="scan"):
    return (j_scn.ScenarioConfig(engine=engine, **kw),
            t_scn.ScenarioConfig(engine=engine, **kw))


@pytest.mark.parametrize("kw", [PARITY_CFGS[0], PARITY_CFGS[2]],
                         ids=["a2a", "star"])
def test_packed_plan_is_byte_equal_to_the_reference(kw):
    jcfg, tcfg = _cfgs(kw)
    want = j_city._pack_plan(jcfg, j_city._plan_scenario(jcfg, DATA)[0])
    got = t_city._pack_plan(tcfg, t_city._plan_scenario(tcfg, DATA)[0])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("kw", PARITY_CFGS, ids=IDS)
def test_scan_engine_matches_the_reference(kw):
    jcfg, tcfg = _cfgs(kw)
    want = j_scn.run_scenario(jcfg, DATA)
    with dispatch_scope() as counts:
        got = t_scn.run_scenario(tcfg, DATA, device="cpu")
    assert counts == {"scan_windows": 1}
    assert got.ledger.events == want.ledger.events
    assert len(got.f1_curve) == len(want.f1_curve)
    np.testing.assert_allclose(got.f1_curve, want.f1_curve, rtol=0,
                               atol=F1_ATOL)


@pytest.mark.parametrize("kw", PARITY_CFGS, ids=IDS)
def test_scan_engine_matches_the_ports_fleet_engine(kw):
    _, tcfg = _cfgs(kw)
    fleet = t_scn.run_scenario(dataclasses.replace(tcfg, engine="fleet"),
                               DATA, device="cpu")
    got = t_scn.run_scenario(tcfg, DATA, device="cpu")
    assert got.ledger.events == fleet.ledger.events
    np.testing.assert_allclose(got.f1_curve, fleet.f1_curve, rtol=0,
                               atol=F1_ATOL)


def test_scan_sweep_json_is_byte_equal_to_the_fleet_engines():
    """scripts/scan_parity.py's gate on the port: the smoke preset,
    sequential, engine field normalised."""
    from repro_torch.core.experiment import SweepResult, get_preset

    ref = get_preset("smoke", windows=4, engine="fleet").run(
        DATA, stack="off", device="cpu")
    scan = get_preset("smoke", windows=4, engine="scan").run(
        DATA, stack="off", device="cpu")
    normalised = SweepResult(name=scan.name, records=[
        dataclasses.replace(r, cfg=dataclasses.replace(r.cfg,
                                                       engine="fleet"))
        for r in scan.records])
    assert normalised.to_json() == ref.to_json()


# ---------------------------------------------------------------------------
# city engine
# ---------------------------------------------------------------------------

def _battery_for_churn(kw):
    """A battery that lets the 40-DC fleet die over the run's windows:
    1.5 windows of the analytic per-DC drain (t_die spread over 1..3)."""
    from repro_torch.core.energy import OBS_BYTES, Ledger, resolve_tech
    tmp = Ledger()
    t_city._charge_city_learning(tmp, kw["tech"], kw["fleet_size"],
                                 center_is_ap=False)
    e_w = (resolve_tech("802.15.4").rx_mj(kw["obs_per_dc"] * OBS_BYTES)
           + tmp.total() / kw["fleet_size"])
    return 1.5 * e_w


CITY_CASES = {"no_churn": CITY,
              "churn": dict(CITY, battery_mj=_battery_for_churn(CITY)),
              "fleet100_s3": dict(CITY, fleet_size=100, seed=3)}


def _reference_indices(cfg, L):
    """The reference's per-window draw indices (W, L, K), exactly: its
    ``_draw_window`` with ``ytr = arange(n_train)`` returns them as ``y``."""
    n = len(DATA.y_train)
    xtr = jnp.zeros((n, 1), jnp.float32)
    ytr = jnp.arange(n, dtype=jnp.int32)
    gid = jnp.arange(L, dtype=jnp.int32)
    key = jax.random.PRNGKey(cfg.seed)
    return np.stack([np.asarray(j_city._draw_window(
        xtr, ytr, key, jnp.int32(t), gid, jnp.ones(L), cfg.obs_per_dc)[1])
        for t in range(cfg.windows)]).astype(np.int64)


def _reference_city(cfg):
    """(F1 curve, centers, ledger events) of the reference's unsharded
    city program."""
    L = j_city.city_fleet_pad(cfg.fleet_size)
    xtr, ytr = j_city._train_arrays(DATA)
    x_test, y_oh = j_city._eval_arrays(DATA)
    t_die = j_city._city_death_schedule(cfg, cfg.fleet_size, L)
    prog = j_city._city_program(cfg.windows, L, cfg.obs_per_dc, 1, 7,
                                cfg.train_iters)
    cms, centers = prog(xtr, ytr, x_test, y_oh,
                        jnp.float32(cfg.global_update_rate),
                        jnp.int32(cfg.fleet_size),
                        jax.random.PRNGKey(cfg.seed), jnp.asarray(t_die))
    res = j_city.run_city(cfg, DATA, max_shards=1)
    return res, np.asarray(centers), np.asarray(cms)


@pytest.mark.parametrize("name", list(CITY_CASES))
def test_city_matches_the_reference_with_its_draws(name):
    jcfg, tcfg = (j_scn.ScenarioConfig(**CITY_CASES[name]),
                  t_scn.ScenarioConfig(**CITY_CASES[name]))
    L = t_city.city_fleet_pad(tcfg.fleet_size)
    draw = t_city.table_draw(torch.from_numpy(_reference_indices(jcfg, L)))
    want, want_centers, _ = _reference_city(jcfg)
    _, centers, t_die = t_city._city_outputs(tcfg, DATA, draw=draw,
                                             device="cpu")
    with dispatch_scope() as counts:
        got = t_city.run_city(tcfg, DATA, max_shards=1, draw=draw,
                              device="cpu")
    assert counts == {"city_scan": 1}
    np.testing.assert_array_equal(centers, want_centers)
    assert got.ledger.events == want.ledger.events
    np.testing.assert_allclose(got.f1_curve, want.f1_curve, rtol=0,
                               atol=F1_ATOL)
    if name == "churn":
        assert len(np.unique(t_die[:tcfg.fleet_size])) > 1


@pytest.mark.parametrize("battery", [None, 2.0, 5.0])
def test_city_death_schedule_is_the_reference(battery):
    kw = dict(CITY, fleet_size=70, battery_mj=battery, seed=7)
    L = t_city.city_fleet_pad(70)
    want = j_city._city_death_schedule(j_scn.ScenarioConfig(**kw), 70, L)
    got = t_city._city_death_schedule(t_scn.ScenarioConfig(**kw), 70, L)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["no_churn", "churn"])
def test_city_perwindow_matches_the_reference(name):
    jcfg, tcfg = (j_scn.ScenarioConfig(**CITY_CASES[name]),
                  t_scn.ScenarioConfig(**CITY_CASES[name]))
    want = j_city.run_city_perwindow(jcfg, DATA)
    got = t_city.run_city_perwindow(tcfg, DATA, device="cpu")
    assert got.ledger.events == want.ledger.events
    np.testing.assert_allclose(got.f1_curve, want.f1_curve, rtol=0,
                               atol=F1_ATOL)


def test_city_default_draw_runs_deterministically():
    """The preset path with the default (hash) draw: one dispatch, a
    learning F1 curve, 4 ledger events per window, repeatable."""
    cfg = t_scn.ScenarioConfig(**CITY)
    with dispatch_scope() as counts:
        a = t_scn.run_scenario(cfg, DATA, device="cpu")
    b = t_scn.run_scenario(cfg, DATA, device="cpu")
    assert counts == {"city_scan": 1}
    assert a.f1_curve == b.f1_curve and a.ledger.events == b.ledger.events
    assert len(a.f1_curve) == cfg.windows
    assert all(0.0 < v <= 1.0 for v in a.f1_curve)
    assert a.f1_curve[-1] > 0.25
    assert len(a.ledger.events) == 4 * cfg.windows


def test_hash_draw_is_deterministic_in_range_and_per_dc():
    n_train, K, L = 1000, 4, 64
    draw = t_city.hash_draw(torch.tensor(3), n_train, K)
    gid = torch.arange(L)
    t = torch.tensor([2])
    a = draw(t, gid)
    assert a.shape == (L, K) and a.dtype == torch.int64
    assert torch.equal(a, draw(t, gid))
    assert int(a.min()) >= 0 and int(a.max()) < n_train
    # a DC's draw depends on its id only, not on the DC axis around it
    assert torch.equal(draw(t, gid[10:20]), a[10:20])
    # other windows and seeds draw other indices
    assert not torch.equal(draw(torch.tensor([3]), gid), a)
    assert not torch.equal(t_city.hash_draw(4, n_train, K)(t, gid), a)
    # and they spread over the stream
    many = t_city.hash_draw(0, n_train, K)(t, torch.arange(4096))
    assert len(torch.unique(many)) > 0.9 * n_train


def _same_shape_runs(kind):
    """Two scenarios that share one cached program (same block shapes)
    but give other results: the scan engine at two update rates, the city
    at two seeds (its default draw reads the seed from the program)."""
    if kind == "scan":
        return ([t_scn.ScenarioConfig(engine="scan", **dict(
            PARITY_CFGS[0], global_update_rate=r)) for r in (0.3, 0.9)],
            lambda c: t_scn.run_scenario(c, DATA, device="cpu"))
    return ([t_scn.ScenarioConfig(**dict(CITY, seed=s)) for s in (0, 1)],
            lambda c: t_city.run_city(c, DATA, device="cpu"))


@pytest.mark.parametrize("kind", ["scan", "city"])
def test_programs_of_one_shape_take_turns_across_threads(kind):
    """A program owns mutable static tensors: two same-shape scenarios run
    from two threads at once each give what they give alone."""
    cfgs, run = _same_shape_runs(kind)
    n0 = len(t_city._PROGRAMS)
    alone = [run(c) for c in cfgs]
    assert len(t_city._PROGRAMS) <= n0 + 1          # one shared program
    assert alone[0].f1_curve != alone[1].f1_curve
    with ThreadPoolExecutor(max_workers=2) as ex:
        got = list(ex.map(run, cfgs * 3))
    for g, a in zip(got, alone * 3):
        assert g.f1_curve == a.f1_curve
        assert g.ledger.events == a.ledger.events


@pytest.mark.parametrize("center_is_ap", [True, False])
def test_city_learning_charge_is_the_pairwise_topology_sum(center_is_ap):
    """The city's analytic learning charge against the fleet engine's
    per-pair Topology patterns (entropy index to every ordered pair,
    center id broadcast, m0 gathered at the center) over small fleets."""
    from repro_torch.core.energy import INDEX_BYTES, Ledger, MODEL_BYTES
    from repro_torch.core.topology import Node, Topology

    for tech in ("wifi", "4g", "mesh:hops=2"):
        for n in range(3, 8):
            nodes = [Node(f"DC{i}", is_ap=(i == 0)) for i in range(n)]
            want = Ledger()
            topo = Topology(want, tech, nodes)
            center = nodes[0 if center_is_ap else 1]
            topo.exchange_all(INDEX_BYTES, what="entropy index")
            topo.broadcast(center, INDEX_BYTES, what="center id")
            topo.gather(center, MODEL_BYTES, what="m0 to center")
            got = Ledger()
            t_city._charge_city_learning(got, tech, n, center_is_ap)
            assert [e["what"] for e in got.events] == [
                "entropy index", "center id", "m0 to center"]
            for e in got.events:
                pairs = [p for p in want.events if p["what"] == e["what"]]
                assert e["n_tx"] == sum(p["n_tx"] for p in pairs)
                assert e["n_rx"] == sum(p["n_rx"] for p in pairs)
                assert {p["bytes"] for p in pairs} == {e["bytes"]}
            assert got.total() == pytest.approx(want.total(), rel=1e-12)


def test_max_shards_beyond_one_raises():
    cfg = t_scn.ScenarioConfig(**CITY)
    with pytest.raises(NotImplementedError, match="item 11"):
        t_city.run_city(cfg, DATA, max_shards=2, device="cpu")


def test_city_mode_config_validation():
    cfg = t_scn.ScenarioConfig(**CITY)
    with pytest.raises(ValueError, match="engine='scan'"):
        t_scn.run_scenario(dataclasses.replace(cfg, engine="fleet",
                                               train_iters=200), DATA,
                           device="cpu")
    with pytest.raises(ValueError, match="host-side collection"):
        t_scn.run_scenario(dataclasses.replace(cfg, p_edge=0.5), DATA,
                           device="cpu")
    with pytest.raises(ValueError, match=">= 2 DCs"):
        t_scn.run_scenario(dataclasses.replace(cfg, fleet_size=1), DATA,
                           device="cpu")


# ---------------------------------------------------------------------------
# EvalCache keying (tests/test_cityscan.py:149-190): (dataset, kind,
# device) entries isolate, so the scan engine's extra kinds never evict or
# shadow the fleet engine's test matrix
# ---------------------------------------------------------------------------

def test_evalcache_kind_keying_isolates_entries():
    cache = t_scn.EvalCache(maxsize=8)
    d1 = make_covtype_like(n_total=700, seed=11)
    d2 = make_covtype_like(n_total=700, seed=12)
    built = {}
    for i, data in enumerate((d1, d2)):
        for j, kind in enumerate(("test", "test_onehot", "train_x",
                                  "train_y")):
            built[(i, kind)] = cache.array(
                data, kind, lambda d, v=(i * 10 + j): torch.full((3,), v),
                device="cpu")
    assert cache.misses == 8 and cache.hits == 0
    for i, data in enumerate((d1, d2)):
        for kind in ("test", "test_onehot", "train_x", "train_y"):
            again = cache.array(data, kind,
                                lambda d: pytest.fail("rebuilt on hit"),
                                device="cpu")
            assert again is built[(i, kind)]
    assert cache.misses == 8 and cache.hits == 8


def test_evalcache_lru_bound_still_applies():
    cache = t_scn.EvalCache(maxsize=2)
    d = make_covtype_like(n_total=700, seed=13)
    for kind in ("a", "b", "c"):
        cache.array(d, kind, lambda _: torch.zeros(1), device="cpu")
    assert len(cache) == 2                 # oldest kind evicted
    cache.array(d, "a", lambda _: torch.zeros(1), device="cpu")
    assert cache.misses == 4               # 'a' was the evicted one


def test_scan_engine_reuses_fleet_test_matrix():
    """After a fleet run uploaded the test matrix, a scan run on the same
    dataset misses only on its new kind (the one-hot labels)."""
    data = make_covtype_like(n_total=3000, seed=14)
    cfg = t_scn.ScenarioConfig(windows=2, eval_every=1, algo="star",
                               tech="wifi")
    t_scn.run_scenario(cfg, data, device="cpu")           # uploads 'test'
    cache = t_scn._eval_cache
    h0, m0 = cache.hits, cache.misses
    t_scn.run_scenario(dataclasses.replace(cfg, engine="scan"), data,
                       device="cpu")
    assert cache.misses - m0 == 1                          # 'test_onehot'
    assert cache.hits - h0 >= 1                            # 'test' reused
