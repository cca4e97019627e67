"""The sharded city (``repro_torch.core.cityscan.run_city`` with its DC axis
split over the ranks of a process group; ``sharding.partitioning.
fleet_mesh`` and ``dc_shards``) against the one-shard city and against the
JAX package's city.

One world of 8 ``gloo`` processes on the CPU (each a ``python -c`` with
rank, world size and a file store in a temporary directory, one torch
thread each) runs every case at ``max_shards`` 1, 2, 4, 8 and 3 (3 divides
no padded fleet here, so it gives 2 shards and leaves ranks 2-7 outside
the mesh), and writes its results to a file:

* shard-count invariance, as ``tests/test_cityscan.py:102-139`` holds the
  reference on 8 fake devices: the reference's fleet sizes and seeds (40,
  0), (100, 1), (200, 2) at 3 windows, 5 iterations, 4 observations, wifi,
  and the churn case of ``tests/test_torch_cityscan.py:CITY_CASES``, with
  the default hash draw. Every rank's F1 curve, centers and ledger events
  are BITWISE those of ``max_shards=1`` (DESIGN.md §10: the one-hot sums
  add exact zeros and the election is a semilattice);
* against JAX: the parent computes the reference's draw indices and city;
  the ranks replay the indices through ``cityscan.table_draw`` at 2, 4 and
  8 shards: centers and ledger exactly the reference's, F1 within 1e-4
  (the reference's fleet-vs-loop bar, tests/test_fleet_engine.py:38).
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro.core import cityscan as j_city
from repro.core import scenario as j_scn
from repro.sharding import partitioning as j_part
from repro_torch.core import cityscan as t_city
from repro_torch.core import scenario as t_scn
from repro_torch.sharding import partitioning as t_part
from test_torch_cityscan import (CITY, CITY_CASES, DATA, _reference_city,
                                 _reference_indices)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
F1_ATOL = 1e-4
WORLD = 8
MAX_SHARDS = (2, 4, 8, 3)
JAX_SHARDS = (2, 4, 8)
# the reference's shard sweep (tests/test_cityscan.py:117-130), and churn
CASES = {f"fleet{n}_s{seed}": dict(CITY, fleet_size=n, seed=seed)
         for n, seed in ((40, 0), (100, 1), (200, 2))}
CASES["churn"] = CITY_CASES["churn"]
DC_SHARDS_GRID = [(n, m) for n in (1, 2, 7, 16, 32, 64, 96, 100, 224,
                                   100_000)
                  for m in (None, 0, 1, 2, 3, 4, 5, 8, 16)]

RANK = r"""
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=240))
from repro_torch.core import cityscan
from repro_torch.core.dispatch import dispatch_scope
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.data.synthetic_covtype import make_covtype_like
from repro_torch.sharding.partitioning import dc_shards, fleet_mesh

data = make_covtype_like(seed=0)
with open(f"{work}/cases.json") as fh:
    cases = json.load(fh)
grid = json.loads(sys.argv[5])

# the center ids of each run, from the function run_city reads them from
last = {}
outputs = cityscan._city_outputs
def recording(*a, **kw):
    last["out"] = outputs(*a, **kw)
    return last["out"]
cityscan._city_outputs = recording

def run(cfg, max_shards, draw=None):
    cityscan.reset_graph_stats()
    with dispatch_scope() as counts:
        res = cityscan.run_city(cfg, data, max_shards=max_shards, draw=draw,
                                device="cpu")
    return {"f1": res.f1_curve, "events": res.ledger.events,
            "centers": last["out"][1].tolist(),
            "dispatches": counts.get("city_scan", 0),
            "collectives": cityscan.graph_stats()["collectives"],
            "replays": cityscan.graph_stats()["replays"]}

out = {"default": {}, "injected": {}}
for name, kw in cases.items():
    cfg = ScenarioConfig(**kw)
    out["default"][name] = {str(m): run(cfg, m) for m in (1, 2, 4, 8, 3)}
    idx = torch.from_numpy(np.load(f"{work}/idx_{name}.npy"))
    out["injected"][name] = {str(m): run(cfg, m, cityscan.table_draw(idx))
                             for m in (2, 4, 8)}
out["dc_shards"] = [dc_shards(n, m) for n, m in grid]
try:
    fleet_mesh(world + 1, "cpu")
    out["beyond_world"] = None
except ValueError as e:
    out["beyond_world"] = str(e)
mesh = fleet_mesh(3, "cpu")
out["mesh_cached"] = fleet_mesh(3, "cpu") is mesh
out["coordinate"] = mesh.get_coordinate()
out["mesh_size"] = mesh.size()
with open(f"{work}/rank{rank}.json", "w") as fh:
    json.dump(out, fh)
dist.destroy_process_group()
print("OK", rank)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results, and the reference's city per case."""
    work = tmp_path_factory.mktemp("city_shards")
    with open(work / "cases.json", "w") as fh:
        json.dump(CASES, fh)
    for name, kw in CASES.items():
        L = j_city.city_fleet_pad(kw["fleet_size"])
        np.save(work / f"idx_{name}.npy",
                _reference_indices(j_scn.ScenarioConfig(**kw), L))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    grid = json.dumps(DC_SHARDS_GRID)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(WORLD),
         str(work / "store"), str(work), grid], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    try:
        # the reference's city per case, while the ranks run
        refs = {name: _reference_city(j_scn.ScenarioConfig(**kw))
                for name, kw in CASES.items()}
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        assert f"OK {r}" in out, out
    ranks = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    return ranks, refs


@pytest.mark.parametrize("max_shards", MAX_SHARDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_city_is_bitwise_the_one_shard_city(world, name, max_shards):
    ranks, _ = world
    want = ranks[0]["default"][name]["1"]
    L = t_city.city_fleet_pad(CASES[name]["fleet_size"])
    shards = _reference_dc_shards(L, max_shards, WORLD)
    assert shards == (2 if max_shards == 3 else max_shards)
    W = CASES[name]["windows"]
    for r, res in enumerate(ranks):
        got = res["default"][name][str(max_shards)]
        assert got["f1"] == want["f1"], (r, got["f1"], want["f1"])
        assert got["centers"] == want["centers"], r
        assert got["events"] == want["events"], r
        # ranks beyond the mesh compute nothing and receive rank 0's
        # outputs by one broadcast; a mesh rank sums twice per window,
        # eagerly (no graph replays)
        inside = r < shards
        assert got["dispatches"] == int(inside), r
        assert got["collectives"] == (2 * W if inside else 0) + 1, r
        assert got["replays"] == 0, r


@pytest.mark.parametrize("name", list(CASES))
def test_one_shard_in_a_world_runs_on_rank_0(world, name):
    """``max_shards=1`` in a world: rank 0 runs the one-shard program, the
    other ranks compute nothing and get its outputs by one broadcast."""
    ranks, _ = world
    want = ranks[0]["default"][name]["1"]
    assert want["dispatches"] == 1 and want["collectives"] == 1
    for r, res in enumerate(ranks[1:], start=1):
        assert res["default"][name]["1"] == dict(want, dispatches=0), r


@pytest.mark.parametrize("max_shards", JAX_SHARDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_city_matches_the_reference(world, name, max_shards):
    ranks, refs = world
    want, want_centers, _ = refs[name]
    for r, res in enumerate(ranks):
        got = res["injected"][name][str(max_shards)]
        assert got["centers"] == want_centers.tolist(), r
        assert got["events"] == want.ledger.events, r
        assert len(got["f1"]) == len(want.f1_curve)
        np.testing.assert_allclose(got["f1"], want.f1_curve, rtol=0,
                                   atol=F1_ATOL)


def test_dc_shards_and_fleet_mesh_in_the_world(world):
    """Every rank: ``dc_shards`` is the reference's rule at 8 devices,
    ``fleet_mesh`` refuses more shards than ranks, is cached, and gives
    ranks 3-7 no coordinate on a 3-rank mesh."""
    ranks, _ = world
    want = [_reference_dc_shards(n, m, WORLD) for n, m in DC_SHARDS_GRID]
    for r, res in enumerate(ranks):
        assert res["dc_shards"] == want, r
        assert res["beyond_world"] == \
            f"fleet_mesh wants 1..{WORLD} shards, got {WORLD + 1}"
        assert res["mesh_cached"] and res["mesh_size"] == 3
        assert res["coordinate"] == ([r] if r < 3 else None), r


def _reference_dc_shards(n_padded, max_shards, n_devices):
    """The reference's ``dc_shards`` on ``n_devices`` devices."""
    real = j_part.jax
    j_part.jax = types.SimpleNamespace(devices=lambda: [None] * n_devices)
    try:
        return j_part.dc_shards(n_padded, max_shards)
    finally:
        j_part.jax = real


@pytest.mark.parametrize("n_world", [1, 3, 8])
def test_dc_shards_is_the_references_rule(monkeypatch, n_world):
    monkeypatch.setattr(t_part, "fleet_world", lambda: (n_world, 0))
    for n, m in DC_SHARDS_GRID:
        assert t_part.dc_shards(n, m) == _reference_dc_shards(n, m, n_world)


def test_fleet_mesh_refuses_more_shards_than_ranks():
    """Without a process group (or in a one-rank one) the world is one
    rank: any other shard count is refused, as the reference refuses more
    shards than devices."""
    for n in (0, 2, 8):
        with pytest.raises(ValueError, match=f"wants 1..1 shards, got {n}"):
            t_part.fleet_mesh(n, "cpu")


def test_a_fake_world_runs_the_city_on_one_shard():
    """The ranks of a fake world are not devices: ``fleet_mesh`` refuses
    more than one shard there, ``dc_shards`` gives 1, and ``run_city`` at
    any ``max_shards`` is the one-shard city."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_world

    cfg = t_scn.ScenarioConfig(**CITY)
    want = t_city.run_city(cfg, DATA, max_shards=1, device="cpu")
    fake_world(4)
    try:
        assert t_part.fleet_world() == (1, 0)
        with pytest.raises(ValueError, match="fake world"):
            t_part.fleet_mesh(2, "cpu")
        assert t_part.dc_shards(64, 4) == 1
        got = t_city.run_city(cfg, DATA, max_shards=4, device="cpu")
    finally:
        dist.destroy_process_group()
    assert got.f1_curve == want.f1_curve
    assert got.ledger.events == want.ledger.events


def test_table_draw_reads_each_dcs_own_row():
    """A shard's DCs read their own rows of the whole fleet's table, in
    the order of their ids, whatever ids it holds."""
    idx = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    draw = t_city.table_draw(idx)
    gid = torch.tensor([5, 1, 6])
    assert torch.equal(draw(torch.tensor([1]), gid), idx[1][[5, 1, 6]])
    assert torch.equal(draw(torch.tensor([0]), torch.arange(4, 8)),
                       idx[0, 4:])
    assert torch.equal(draw(torch.tensor([1]), torch.arange(8)), idx[1])
