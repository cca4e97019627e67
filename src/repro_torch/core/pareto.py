"""Cost-accuracy Pareto-front search with successive-halving pruning.

Port of ``repro.core.pareto``; every rung runs through the port's executors
on the caller's ``device``.

The paper's headline — up to 94% energy saved for <=2% accuracy lost —
was found by hand-enumerating transport/placement configurations
(Tables 2-6); Valerio et al. (PAPERS.md) formalize it as a cost-accuracy
trade-off to be *searched*. This module is that search: candidates come
from any :class:`~repro_torch.core.experiment.SweepSpec` grid,
evaluate through the ordinary executor machinery (so stack-compatible
configs run replica-stacked in lockstep, and any ``parallel`` backend —
devices/processes/hosts — applies), and are pruned rung by rung:

* **dominance** — ``a`` dominates ``b`` on (F1 up, energy_mJ down) iff
  ``a`` is no worse on both axes and strictly better on at least one.
  With *slack* the strictly-better clause needs a margin (``f1_slack``
  absolute F1, ``energy_slack`` relative energy), so slack > 0 prunes
  *less*: a candidate survives unless someone beats it clearly. Slack
  dominance is irreflexive, asymmetric and transitive for any slacks
  (property-tested in the reference's tests); slack 0 is exact Pareto
  dominance.
* **successive halving** — rung ``r`` of ``R`` evaluates the survivors
  at ``windows / eta**(R-1-r)`` windows (floored at ``min_windows``)
  and a matching fraction of the seed axis, discards at most
  ``(1-keep)`` of them (the most-dominated first; ``keep=1.0`` prunes
  nothing, making the search exhaustive), and promotes the rest. The
  final rung always runs the full budget.
* **bitwise frontier** — after the final rung picks the exact
  (slack-free) frontier, the frontier configs are rerun as a literal
  frontier-only :class:`SweepSpec` (:func:`frontier_spec`) through the
  same executor/stack mode. That rerun IS "a plain ``SweepSpec.run`` of
  the frontier configs", so the reported frontier numbers are
  bitwise-identical to one by construction — the property chip_smoke.py
  checks on the card.

Searches are addressed by the shared spec-string grammar
(:func:`get_search`): ``"halving:rungs=3,keep=0.5"``,
``"exhaustive"`` — which is how the sweep service serves searches
(``POST /v1/jobs`` with a ``"search"`` key; rung progress streams as
NDJSON ``rung`` events).
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from repro_torch import resolve_device
from repro_torch.core.experiment import (LABEL_AXIS, SweepResult, SweepSpec,
                                         records_from)
from repro_torch.core.registry import (format_spec, register_factory,
                                       resolve_spec)
from repro_torch.core.scenario import ScenarioConfig, validate_config


class SearchCancelled(RuntimeError):
    """The search's stop event was set between rungs (job cancellation —
    the sweep service maps this to the ``cancelled`` job state)."""


# ---------------------------------------------------------------------------
# dominance
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParetoPoint:
    """One candidate's aggregated metrics (the two search objectives are
    ``f1`` and ``energy_mj``; the rest ride along for the table)."""
    label: str
    f1: float
    energy_mj: float
    f1_std: float = 0.0
    collection_mj: float = 0.0
    learning_mj: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def dominates(a: ParetoPoint, b: ParetoPoint, *, f1_slack: float = 0.0,
              energy_slack: float = 0.0) -> bool:
    """``a`` dominates ``b``: no worse on both axes, better by the slack
    margin on at least one. ``f1_slack`` is an absolute F1 margin;
    ``energy_slack`` a relative energy margin (``a`` must undercut
    ``b``'s energy by that fraction). Both margin clauses stay *strict*
    at their floor, so ties never dominate each other and the relation
    is a strict partial order for any slack values."""
    if f1_slack < 0 or energy_slack < 0:
        raise ValueError(f"slacks must be >= 0, got f1_slack={f1_slack} "
                         f"energy_slack={energy_slack}")
    if not (a.f1 >= b.f1 and a.energy_mj <= b.energy_mj):
        return False
    better_f1 = (a.f1 >= b.f1 + f1_slack) if f1_slack > 0 else a.f1 > b.f1
    better_energy = (a.energy_mj < b.energy_mj
                     and (energy_slack == 0
                          or a.energy_mj <= b.energy_mj
                          * (1.0 - energy_slack)))
    return better_f1 or better_energy


def pareto_frontier(points: Sequence[ParetoPoint], *,
                    f1_slack: float = 0.0,
                    energy_slack: float = 0.0) -> List[ParetoPoint]:
    """The non-dominated subset, input order preserved. With slacks the
    frontier is a *superset* of the exact one (harder to dominate)."""
    return [p for p in points
            if not any(dominates(q, p, f1_slack=f1_slack,
                                 energy_slack=energy_slack)
                       for q in points if q.label != p.label)]


def point_from_summary(label: str, summary: Mapping[str, Any]
                       ) -> ParetoPoint:
    """A :class:`ParetoPoint` from ``SweepResult.summary(label)``."""
    return ParetoPoint(label=label, f1=summary["f1"],
                       energy_mj=summary["energy_mj"],
                       f1_std=summary["f1_std"],
                       collection_mj=summary["collection_mj"],
                       learning_mj=summary["learning_mj"])


# ---------------------------------------------------------------------------
# spec surgery: rung budgets and the frontier-only spec
# ---------------------------------------------------------------------------

def _row_spec(label: str, cfg: ScenarioConfig) -> SweepSpec:
    """A single-row spec with an *explicit* label (the ``_label`` zip
    axis, so labels containing ``{}`` never hit str.format)."""
    return SweepSpec(name=label, base=cfg, mode="zip",
                     axes={LABEL_AXIS: (label,)})


def subset_spec(name: str, rows: Sequence[Tuple[str, ScenarioConfig]],
                seeds: Sequence[int] = ()) -> SweepSpec:
    """A literal :class:`SweepSpec` expanding to exactly ``rows`` (in
    order) replicated over ``seeds`` — the shape both the rung specs and
    the frontier rerun use, so "what the search ran" is always equal to
    "a plain spec of those rows" by construction."""
    if not rows:
        raise ValueError(f"subset spec {name!r} needs at least one row")
    return SweepSpec.union(name, *[_row_spec(lbl, cfg)
                                   for lbl, cfg in rows],
                           seeds=tuple(seeds))


def frontier_spec(spec: SweepSpec,
                  labels: Sequence[str]) -> SweepSpec:
    """The frontier-only spec: ``spec``'s rows restricted to ``labels``
    (row order preserved), same seeds, full budget. Running this through
    ``SweepSpec.run`` reproduces ``ParetoResult.frontier_result``
    bitwise — the pareto-smoke gate's surface."""
    want = set(labels)
    rows = [(lbl, cfg) for lbl, cfg in spec.rows() if lbl in want]
    missing = want - {lbl for lbl, _ in rows}
    if missing:
        raise KeyError(f"labels {sorted(missing)} are not rows of "
                       f"spec {spec.name!r}")
    return subset_spec(f"{spec.name}_frontier", rows, seeds=spec.seeds)


# ---------------------------------------------------------------------------
# ParetoResult
# ---------------------------------------------------------------------------

@dataclass
class ParetoResult:
    """A search's structured output (JSON round-trips like
    :class:`SweepResult`):

    * ``frontier`` — the exact Pareto front at full budget, row order;
      metrics come from ``frontier_result`` (the bitwise surface).
    * ``frontier_result`` — the frontier rerun's :class:`SweepResult`;
      its ``to_json()`` is byte-identical to
      ``frontier_spec(spec, labels).run(data, ...)``.
    * ``ledger`` — per-candidate audit: final status
      (``frontier`` | ``dominated`` | ``pruned``), which rung pruned it,
      who dominated it, per-rung metrics.
    * ``schedule`` — per-rung budgets and survivor/pruned counts.
    * ``cost`` — window-evaluations spent vs the exhaustive grid.

    ``meta`` is the out-of-band side channel (excluded from equality and
    JSON), matching ``SweepResult.meta``."""
    name: str
    search: str
    frontier: List[ParetoPoint]
    frontier_result: SweepResult
    ledger: List[Dict[str, Any]]
    schedule: List[Dict[str, Any]]
    cost: Dict[str, Any]
    meta: Dict[str, Any] = field(default_factory=dict, compare=False,
                                 repr=False)
    SCHEMA = 1

    def frontier_labels(self) -> List[str]:
        return [p.label for p in self.frontier]

    def dominated_counts(self) -> Dict[str, int]:
        """How many candidates each ledger status absorbed — the
        one-line audit of where the grid went."""
        out: Dict[str, int] = {}
        for entry in self.ledger:
            out[entry["status"]] = out.get(entry["status"], 0) + 1
        return out

    def to_json(self, path: Optional[str] = None, *,
                indent: int = 1) -> str:
        payload = {
            "schema": self.SCHEMA,
            "name": self.name,
            "search": self.search,
            "frontier": [p.as_dict() for p in self.frontier],
            "frontier_result": json.loads(self.frontier_result.to_json()),
            "ledger": self.ledger,
            "schedule": self.schedule,
            "cost": self.cost,
        }
        text = json.dumps(payload, indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, text: str) -> "ParetoResult":
        payload = json.loads(text)
        if payload.get("schema") != cls.SCHEMA:
            raise ValueError(f"unsupported ParetoResult schema "
                             f"{payload.get('schema')!r} (this build "
                             f"reads {cls.SCHEMA})")
        return cls(
            name=payload["name"],
            search=payload["search"],
            frontier=[ParetoPoint(**p) for p in payload["frontier"]],
            frontier_result=SweepResult.from_json(
                json.dumps(payload["frontier_result"])),
            ledger=list(payload["ledger"]),
            schedule=list(payload["schedule"]),
            cost=dict(payload["cost"]))

    @classmethod
    def load(cls, path: str) -> "ParetoResult":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# successive halving
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HalvingSearch:
    """Successive halving over a sweep grid (module docstring; spec form
    ``halving:rungs=R,keep=F,eta=E,f1_slack=A,energy_slack=B,
    min_windows=W``). ``rungs=1`` (or the ``exhaustive`` alias) is one
    full-budget rung over every candidate — plain exhaustive search."""
    rungs: int = 3
    keep: float = 0.5
    eta: float = 2.0
    f1_slack: float = 0.02
    energy_slack: float = 0.05
    min_windows: int = 2

    def __post_init__(self):
        object.__setattr__(self, "keep", float(self.keep))
        object.__setattr__(self, "eta", float(self.eta))
        object.__setattr__(self, "f1_slack", float(self.f1_slack))
        object.__setattr__(self, "energy_slack", float(self.energy_slack))
        if self.rungs < 1:
            raise ValueError(f"rungs must be >= 1, got {self.rungs}")
        if not 0.0 < self.keep <= 1.0:
            raise ValueError(f"keep must be in (0, 1], got {self.keep}")
        if self.eta <= 1.0:
            raise ValueError(f"eta must be > 1, got {self.eta}")
        if self.min_windows < 1:
            raise ValueError(f"min_windows must be >= 1, got "
                             f"{self.min_windows}")
        if self.f1_slack < 0 or self.energy_slack < 0:
            raise ValueError(f"slacks must be >= 0, got "
                             f"f1_slack={self.f1_slack} "
                             f"energy_slack={self.energy_slack}")

    @property
    def spec(self) -> str:
        """Canonical spec string — the cache-key component, so any
        spelling that parses to the same parameters keys identically."""
        return format_spec("halving", {
            "rungs": self.rungs, "keep": self.keep, "eta": self.eta,
            "f1_slack": self.f1_slack, "energy_slack": self.energy_slack,
            "min_windows": self.min_windows})

    # -- rung budgets --------------------------------------------------------
    def rung_windows(self, full_windows: int, rung: int) -> int:
        """Window budget at ``rung``: full budget shrunk by
        ``eta**(rungs-1-rung)``, floored at ``min_windows`` and capped
        at the full budget (the final rung is always the full budget)."""
        shrink = self.eta ** (self.rungs - 1 - rung)
        return min(full_windows,
                   max(self.min_windows,
                       math.ceil(full_windows / shrink)))

    def rung_seeds(self, seeds: Tuple[int, ...],
                   rung: int) -> Tuple[int, ...]:
        """Seed budget at ``rung``: the first ``ceil(n/shrink)`` seeds
        (prefixes, so later rungs strictly extend earlier ones). A
        seedless spec stays seedless at every rung."""
        if not seeds:
            return ()
        shrink = self.eta ** (self.rungs - 1 - rung)
        return seeds[:max(1, math.ceil(len(seeds) / shrink))]

    def _rung_rows(self, rows: Sequence[Tuple[str, ScenarioConfig]],
                   rung: int) -> List[Tuple[str, ScenarioConfig]]:
        out = []
        for lbl, cfg in rows:
            w = self.rung_windows(cfg.windows, rung)
            out.append((lbl, dataclasses.replace(
                cfg, windows=w, eval_every=min(cfg.eval_every, w))))
        return out

    # -- execution -----------------------------------------------------------
    def run(self, spec: SweepSpec, data: Any, *, stack: str = "auto",
            parallel: Any = "none",
            on_rung: Optional[Callable[[Dict[str, Any]], None]] = None,
            stop: Any = None, device="cuda") -> ParetoResult:
        """Search ``spec``'s grid. ``parallel`` is an executor spec
        string or an already-built executor (the sweep service passes
        its fresh per-job :class:`HostsExecutor`, so fault-injection
        parameters never leak through the shared executor cache).
        ``on_rung`` fires after each rung with the rung record the
        schedule keeps (the service streams these as NDJSON events);
        ``stop`` is an optional :class:`threading.Event` checked between
        rungs (and passed through to executors that accept it) —
        cancellation raises :class:`SearchCancelled`. Every rung and the
        frontier rerun run on ``device``."""
        if stack not in ("auto", "off"):
            raise ValueError(f"stack must be 'auto' or 'off', got "
                             f"{stack!r}")
        resolve_device(device)
        if hasattr(parallel, "execute_with_meta"):
            executor = parallel
        else:
            from repro_torch.core.parallel import get_executor
            executor = get_executor(parallel)

        rows = spec.rows()
        seeds = spec.seeds
        survivors = list(rows)
        audit: Dict[str, Dict[str, Any]] = {
            lbl: {"label": lbl, "status": "pruned", "pruned_at_rung": None,
                  "dominated_by": [], "rungs": []} for lbl, _ in rows}
        schedule: List[Dict[str, Any]] = []
        evals_windows = 0

        for rung in range(self.rungs):
            self._check_stop(stop)
            rung_rows = self._rung_rows(survivors, rung)
            rung_seeds = self.rung_seeds(seeds, rung)
            rung_spec = subset_spec(f"{spec.name}@rung{rung}", rung_rows,
                                    seeds=rung_seeds)
            result = self._run_spec(rung_spec, data, stack, executor,
                                    stop, device)
            n_seed = max(1, len(rung_seeds))
            evals_windows += sum(cfg.windows for _, cfg in rung_rows) \
                * n_seed
            points = {lbl: point_from_summary(lbl, result.summary(lbl))
                      for lbl, _ in rung_rows}
            rung_cfgs = dict(rung_rows)
            for lbl, p in points.items():
                audit[lbl]["rungs"].append({
                    "rung": rung, "windows": rung_cfgs[lbl].windows,
                    "seeds": n_seed, "f1": p.f1,
                    "energy_mj": p.energy_mj})

            final = rung == self.rungs - 1
            pruned_labels: List[str] = []
            if not final:
                pruned_labels = self._prune(list(points.values()), audit,
                                            rung)
                survivors = [(lbl, cfg) for lbl, cfg in survivors
                             if lbl not in set(pruned_labels)]
            record = {
                "rung": rung,
                "windows": max(cfg.windows for _, cfg in rung_rows),
                "seeds": n_seed,
                "candidates": len(rung_rows),
                "pruned": len(pruned_labels),
                "pruned_labels": pruned_labels,
                "survivors": [lbl for lbl, _ in survivors],
            }
            schedule.append(record)
            if on_rung is not None:
                on_rung(dict(record))

        # exact frontier at full budget, decided on the final rung's
        # metrics; then the bitwise rerun of just the frontier rows
        final_points = [points[lbl] for lbl, _ in survivors]
        front = pareto_frontier(final_points)
        front_labels = [p.label for p in front]
        for p in final_points:
            entry = audit[p.label]
            if p.label in front_labels:
                entry["status"] = "frontier"
            else:
                entry["status"] = "dominated"
                entry["dominated_by"] = [q.label for q in final_points
                                         if dominates(q, p)]

        self._check_stop(stop)
        front_rows = [(lbl, cfg) for lbl, cfg in survivors
                      if lbl in set(front_labels)]
        fspec = subset_spec(f"{spec.name}_frontier", front_rows,
                            seeds=seeds)
        if front_labels == [lbl for lbl, _ in survivors]:
            # the final rung already WAS the frontier-only full-budget
            # spec (identical construction), so its result is the rerun
            frontier_result = SweepResult(name=fspec.name,
                                          records=result.records)
        else:
            frontier_result = self._run_spec(fspec, data, stack,
                                             executor, stop, device)
            evals_windows += sum(cfg.windows for _, cfg in front_rows) \
                * max(1, len(seeds))

        frontier = [point_from_summary(lbl, frontier_result.summary(lbl))
                    for lbl in front_labels]
        exhaustive = sum(cfg.windows for _, cfg in rows) \
            * max(1, len(seeds))
        cost = {
            "evals_windows": evals_windows,
            "exhaustive_windows": exhaustive,
            "savings_pct": round(100.0 * (1.0 - evals_windows
                                          / exhaustive), 1),
        }
        return ParetoResult(name=spec.name, search=self.spec,
                            frontier=frontier,
                            frontier_result=frontier_result,
                            ledger=[audit[lbl] for lbl, _ in rows],
                            schedule=schedule, cost=cost)

    # -- internals -----------------------------------------------------------
    def _prune(self, points: List[ParetoPoint],
               audit: Dict[str, Dict[str, Any]], rung: int) -> List[str]:
        """Discard slack-dominated candidates, most-dominated first,
        never more than ``(1-keep)`` of the pool. Returns the pruned
        labels (deterministic order)."""
        doms = {p.label: [q.label for q in points
                          if q.label != p.label
                          and dominates(q, p, f1_slack=self.f1_slack,
                                        energy_slack=self.energy_slack)]
                for p in points}
        prunable = sorted((p for p in points if doms[p.label]),
                          key=lambda p: (-len(doms[p.label]), p.f1,
                                         -p.energy_mj, p.label))
        max_prune = len(points) - max(1, math.ceil(self.keep
                                                   * len(points)))
        pruned = prunable[:max_prune]
        for p in pruned:
            audit[p.label]["status"] = "pruned"
            audit[p.label]["pruned_at_rung"] = rung
            audit[p.label]["dominated_by"] = doms[p.label]
        return [p.label for p in pruned]

    @staticmethod
    def _check_stop(stop: Any) -> None:
        if stop is not None and stop.is_set():
            raise SearchCancelled("pareto search cancelled between rungs")

    @staticmethod
    def _run_spec(sub: SweepSpec, data: Any, stack: str, executor: Any,
                  stop: Any, device) -> SweepResult:
        """Exactly the body of ``SweepSpec.run`` (validate → execute →
        records), with the caller's executor — so every rung result, and
        in particular the frontier rerun, is bitwise what ``sub.run``
        would produce on the same backend and device."""
        import inspect

        runs = sub.configs()
        for _, cfg in runs:
            validate_config(cfg)
        labels = [lbl for lbl, _ in runs]
        cfgs = [cfg for _, cfg in runs]
        extra: Dict[str, Any] = {}
        if stop is not None and "stop" in inspect.signature(
                executor.execute_with_meta).parameters:
            extra["stop"] = stop
        results, exec_meta = executor.execute_with_meta(
            labels, cfgs, data, stack=(stack == "auto"), device=device,
            **extra)
        out = SweepResult(name=sub.name,
                          records=records_from(labels, results))
        if exec_meta:
            out.meta.update(exec_meta)
        return out


# ---------------------------------------------------------------------------
# search registry (spec-string grammar)
# ---------------------------------------------------------------------------

SEARCHES: Dict[str, Callable[..., HalvingSearch]] = {}
_SEARCH_CACHE: Dict[str, HalvingSearch] = {}


def register_search(name: str, factory: Callable[..., HalvingSearch]
                    ) -> None:
    register_factory(SEARCHES, name, factory, "search")


def get_search(spec: str) -> HalvingSearch:
    """Resolve a search spec string: ``"halving:rungs=3,keep=0.5"``,
    ``"exhaustive"``. Unknown names/parameters raise ``KeyError``;
    invalid values the constructor's ``ValueError`` — same contract as
    the transport/collection registries."""
    return resolve_spec(spec, SEARCHES, _SEARCH_CACHE, "search")


def _exhaustive(**params: Any) -> HalvingSearch:
    """One full-budget rung over every candidate; extra parameters (the
    slacks are irrelevant here, but accepted) pass through."""
    params.setdefault("rungs", 1)
    params.setdefault("keep", 1.0)
    return HalvingSearch(**params)


register_search("halving", HalvingSearch)
register_search("exhaustive", _exhaustive)
