"""Whole runs of a cell on the CPU at a tiny size (the harness's look for
a card skipped): the sound program comes out correct, and the timed path
broken underneath comes out not correct, once for each fault a served
cell can have. The control's test at the cells' own size runs on the
card."""
import time

import pytest
import torch

from perfbench import registry
from perfbench.cell import run_cell
from perfbench.faults import FAULTS
from perfbench.tests.conftest import bench

CELLS = [w["name"] for w in bench()["workloads"]]


def run(root, cell, hook=None, seed=2 ** 31 + 7, control=False, trace=False):
    return run_cell(bench(), cell, seed, 1.0, trace,
                    t_launch=time.perf_counter(), device="cpu", root=root,
                    hook=hook, control=control)


CASES = [(cell, f) for cell in CELLS for f in FAULTS]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0 and r["window"]["judged_tokens"] >= 40
    limits = registry.limits(cell, tiny_root)
    assert {k: v["limit"] for k, v in r["checks"].items()} == limits
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {m["name"] for m in registry.cell_metrics(
        bench(), cell, False)}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f}" for c, f in CASES])
def test_broken_path_is_not_correct(tiny_root, cell, fault):
    r = run(tiny_root, cell, hook=FAULTS[fault])
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(tiny_root, cell):
    """The control, put in the program's place, is judged by the same
    code against the same limits, and comes out not correct; on every
    number the cell compares it reads above the program."""
    r = run(tiny_root, cell, control=True)
    assert r["correct"] is True and r["control_correct"] is False
    for k in registry.limits(cell):
        assert r["control"][k] > r["numbers"][k]


def test_same_seed_same_judged_work(tiny_root):
    cell = "mamba2-1.3b.chat"
    a, b = run(tiny_root, cell, seed=11), run(tiny_root, cell, seed=11)
    assert a["window"]["weight_bytes"] == b["window"]["weight_bytes"]
    assert a["window"]["judged_requests"] >= 16


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    """On the card, at the cell's own size and limits: the program comes
    out correct and the control (the reference in float8, in the
    program's place) not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = run_cell(bench(), cell, 2 ** 31 + 19, 10.0, False,
                 t_launch=time.perf_counter(), control=True)
    assert r["correct"] is True and r["control_correct"] is False
