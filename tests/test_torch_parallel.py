"""The port's sweep executors (``repro_torch.core.parallel``) against the
JAX package's: the partitioner gives the reference's shards on the paper,
Pareto and transport grids and on permutations of their rows; the
host-only guard refuses torch tensors; and ``none``, ``devices:n=3`` and
``processes:n=2`` on the CPU give JSON byte-equal to the port's
sequential run, whose ledgers equal the reference's exactly and whose F1
is within the port's bound. Card-only cases are in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from _torch_sweep_ref import (DATA, assert_matches_reference,
                              port_smoke_json, smoke_spec)
from repro.core import experiment as j_exp
from repro.core import parallel as j_par
from repro_torch.core import experiment as t_exp
from repro_torch.core import parallel as t_par
from repro_torch.core.dispatch import dispatch_counts, reset_dispatch_counts

# One intra-op thread per pytest worker, and (through the environment) per
# spawned worker process: six workers must not oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


GRIDS = {"paper_tables": dict(windows=30, n_seeds=1), "pareto": {},
         "transport_grid": {}}


@pytest.mark.parametrize("perm_seed", [None, 0, 1])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_partition_matches_the_reference(grid, n_shards, perm_seed):
    t_cfgs = [c for _, c in t_exp.get_preset(grid, **GRIDS[grid]).configs()]
    j_cfgs = [c for _, c in j_exp.get_preset(grid, **GRIDS[grid]).configs()]
    if perm_seed is not None:
        order = np.random.default_rng(perm_seed).permutation(len(t_cfgs))
        t_cfgs = [t_cfgs[i] for i in order]
        j_cfgs = [j_cfgs[i] for i in order]
    got = t_par.partition_runs(t_cfgs, n_shards)
    assert got == j_par.partition_runs(j_cfgs, n_shards)
    assert sorted(i for s in got for i in s) == list(range(len(t_cfgs)))
    assert [t_par.run_cost(c) for c in t_cfgs] \
        == [j_par.run_cost(c) for c in j_cfgs]


def test_host_only_guard_refuses_tensors_and_passes_numpy():
    cfg = t_exp.ScenarioConfig()
    t_par.assert_host_only({"a": [np.zeros(3), (cfg, "x")], 1: {2.0}})
    for bad in (torch.zeros(2), {"k": [torch.ones(1)]},
                ([], {"x": (torch.zeros(1, 2),)})):
        with pytest.raises(TypeError, match="torch tensor"):
            t_par.assert_host_only(bad, where="shard task")


def test_executor_registry_and_shard_device():
    with pytest.raises(KeyError):
        t_par.get_executor("no_such_backend:n=2")
    with pytest.raises(ValueError):
        t_par.get_executor("processes:n=0")
    assert t_par.get_executor("devices:n=3") \
        is t_par.get_executor("devices:n=3")
    assert set(t_par.EXECUTORS) == set(j_par.EXECUTORS)
    assert t_par.shard_device("cpu", 5) == "cpu"


@pytest.mark.parametrize("parallel", ["none", "devices:n=3",
                                      "processes:n=2"])
def test_backend_is_byte_equal_to_the_sequential_run(parallel):
    ref = port_smoke_json()
    reset_dispatch_counts()
    seq = smoke_spec().run(DATA, device="cpu")
    seq_counts = dispatch_counts()
    reset_dispatch_counts()
    got = smoke_spec().run(DATA, parallel=parallel, device="cpu")
    assert got.to_json() == seq.to_json() == ref
    # worker dispatch counts merge back: same groups, same calls
    assert dispatch_counts() == seq_counts
    assert_matches_reference(got)


def test_a_failing_worker_fails_the_run():
    """No fallback: a worker that raises fails the whole run (the
    workers are asked for CUDA, which the CPU build of torch lacks)."""
    ex = t_par.get_executor("processes:n=2")
    spec = smoke_spec()
    runs = spec.configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.execute([lbl for lbl, _ in runs], [c for _, c in runs], DATA,
                   stack=True, device="cuda")
