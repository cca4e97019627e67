"""The port's Pareto search (``repro_torch.core.pareto``) against the JAX
package's, on the CPU: dominance and the frontier agree point for point;
on a small ``pareto`` grid (4 windows, 1 seed) the halving and exhaustive
searches give the reference's frontier labels, rung schedule, audit
statuses and cost, every candidate's energy exactly and its F1 within
1e-4 (``edge_only``, the one label trained by the edge server's plain
SVM, within the port's bound of 5e-3: there the float32 trainer's
rounding moves its F1 by 9.8e-4); the frontier is byte-equal to a plain
run of ``frontier_spec``, and ``ParetoResult`` round-trips through
JSON."""
import functools
import threading

import numpy as np
import pytest
import torch

from repro.core import experiment as j_exp
from repro.core import pareto as j_par
from repro_torch.core import experiment as t_exp
from repro_torch.core import pareto as t_par
from repro_torch.data.synthetic_covtype import make_covtype_like
from test_torch_experiment import F1_BOUND

torch.set_num_threads(1)

DATA = make_covtype_like(n_total=2500, seed=1)
GRID = dict(windows=4, n_seeds=1)
SEARCHES = ("halving:rungs=3,keep=0.5", "exhaustive")
F1_ATOL = 1e-4
EDGE_ONLY = "edge_only"


@functools.lru_cache(maxsize=None)
def _searches(search):
    want = j_par.get_search(search).run(j_exp.get_preset("pareto", **GRID),
                                        DATA)
    got = t_par.get_search(search).run(t_exp.get_preset("pareto", **GRID),
                                       DATA, device="cpu")
    return got, want


@pytest.mark.parametrize("seed", range(4))
def test_dominance_and_frontier_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, size=(12, 2)) / 4.0
    tp = [t_par.ParetoPoint(f"p{i}", float(f), float(e))
          for i, (f, e) in enumerate(vals)]
    jp = [j_par.ParetoPoint(f"p{i}", float(f), float(e))
          for i, (f, e) in enumerate(vals)]
    for slacks in ({}, {"f1_slack": 0.25, "energy_slack": 0.3}):
        assert [[t_par.dominates(a, b, **slacks) for b in tp] for a in tp] \
            == [[j_par.dominates(a, b, **slacks) for b in jp] for a in jp]
        assert [p.label for p in t_par.pareto_frontier(tp, **slacks)] \
            == [p.label for p in j_par.pareto_frontier(jp, **slacks)]


def test_search_grammar_matches_the_reference():
    for spec in ("halving", "halving:keep=0.5,rungs=3", "exhaustive",
                 "halving:rungs=2,eta=3,min_windows=1"):
        assert t_par.get_search(spec).spec == j_par.get_search(spec).spec
    with pytest.raises(KeyError):
        t_par.get_search("annealing")
    with pytest.raises(ValueError):
        t_par.get_search("halving:keep=0")
    h = t_par.get_search("halving:rungs=3,keep=0.5")
    assert [h.rung_windows(24, r) for r in range(3)] == [6, 12, 24]
    assert [h.rung_seeds((0, 1), r) for r in range(3)] \
        == [(0,), (0,), (0, 1)]


@pytest.mark.parametrize("search", SEARCHES)
def test_search_recovers_the_reference_frontier(search):
    got, want = _searches(search)
    assert got.frontier_labels() == want.frontier_labels()
    assert got.schedule == want.schedule
    assert got.cost == want.cost
    assert got.search == want.search
    assert [(e["label"], e["status"], e["pruned_at_rung"], e["dominated_by"])
            for e in got.ledger] \
        == [(e["label"], e["status"], e["pruned_at_rung"], e["dominated_by"])
            for e in want.ledger]
    for g, w in zip(got.ledger, want.ledger):
        atol = F1_BOUND if g["label"] == EDGE_ONLY else F1_ATOL
        for rg, rw in zip(g["rungs"], w["rungs"]):
            assert (rg["rung"], rg["windows"], rg["seeds"]) \
                == (rw["rung"], rw["windows"], rw["seeds"])
            assert rg["energy_mj"] == rw["energy_mj"]
            assert abs(rg["f1"] - rw["f1"]) <= atol, (g["label"], rg, rw)
    for p, q in zip(got.frontier, want.frontier):
        atol = F1_BOUND if p.label == EDGE_ONLY else F1_ATOL
        assert p.energy_mj == q.energy_mj
        assert abs(p.f1 - q.f1) <= atol


@pytest.mark.parametrize("search", SEARCHES)
def test_frontier_is_byte_equal_to_a_plain_run_and_round_trips(search):
    got, _ = _searches(search)
    plain = t_par.frontier_spec(t_exp.get_preset("pareto", **GRID),
                                got.frontier_labels()).run(DATA,
                                                           device="cpu")
    assert got.frontier_result.to_json() == plain.to_json()
    back = t_par.ParetoResult.from_json(got.to_json())
    assert back == got and back.to_json() == got.to_json()
    if search != "exhaustive":
        assert got.dominated_counts().get("pruned", 0) > 0


def test_search_runs_on_the_card_unless_asked_and_cancels(monkeypatch):
    spec = t_exp.get_preset("pareto", **GRID)
    stop = threading.Event()
    stop.set()
    with pytest.raises(t_par.SearchCancelled):
        t_par.get_search("halving").run(spec, DATA, stop=stop,
                                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_par.get_search("exhaustive").run(spec, DATA)
