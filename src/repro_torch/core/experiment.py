"""Experiment API v1: declarative sweeps over scenario grids.

The paper's results are a grid — algorithm x technology x offload fraction
x allocation policy (Tables 2-6) — and every driver in this repo
(benchmarks, ablations, examples, CI smoke) is some slice of such a grid.
This module gives that surface a declarative form:

* :class:`SweepSpec` — named axes over a base :class:`ScenarioConfig`,
  expanded cartesian (nested-loop order) or zipped, with per-row label
  templates, row ``variants`` (an innermost axis of label/override pairs),
  seed replication and union composition, so a whole paper table is one
  literal instead of a hand-rolled loop nest.
* :class:`SweepResult` — the typed result: one :class:`RunRecord` per
  (label, seed) run carrying the full F1 curve and energy-event ledger,
  with JSON round-trip serialization and per-label summary statistics
  (the aggregation previously re-implemented ad hoc by every benchmark).
* named presets (:func:`get_preset`) — the paper's Tables 2-6 grid
  (``"paper_tables"``), the energy/accuracy trade-off example grid, a CI
  smoke grid, and a mesh/BLE/LoRa technology grid over the parameterized
  transport registry.

``SweepSpec.run(data, stack="auto", parallel="none")`` evaluates the grid
through an executor of :mod:`repro_torch.core.parallel` with
metadata-driven replica stacking (configs differing only in ``host_side``
fields share one dispatch set per window), on ``device`` (default
``"cuda"``).

Port of ``repro.core.experiment``: the spec, its wire form and canonical
hash, the result type and every preset are the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.energy import Ledger
from repro_torch.core.scenario import (ScenarioConfig, ScenarioResult,
                                       validate_config)
from repro_torch.data.synthetic_covtype import Dataset

LABEL_AXIS = "_label"     # reserved zip-axis name: explicit per-row labels


# ---------------------------------------------------------------------------
# SweepSpec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepSpec:
    """A declarative scenario grid.

    ``axes`` maps config-field names to value tuples; ``mode="cartesian"``
    expands their product in declaration order (first axis outermost,
    exactly a nested ``for`` loop), ``mode="zip"`` walks them in lockstep.
    The reserved axis ``"_label"`` (zip mode) gives explicit row labels;
    otherwise ``label`` is a ``str.format`` template over the axis values,
    falling back to ``name_axis=value_...``. ``variants`` is an innermost
    axis of ``(label_template, {field: value})`` pairs — the idiom for
    paired table rows like "same cell with and without aggregation".
    ``seeds`` replicates every expanded row (seeds innermost, matching the
    legacy benchmark layout); empty means "keep each row's own seed".
    Specs compose by union (:meth:`union`), which simply concatenates
    expansions.
    """

    name: str = "sweep"
    base: ScenarioConfig = field(default_factory=ScenarioConfig)
    axes: Any = ()                  # Mapping | tuple of (name, values)
    mode: str = "cartesian"         # 'cartesian' | 'zip'
    label: str = ""
    variants: Tuple[Tuple[str, Any], ...] = ()
    seeds: Tuple[int, ...] = ()
    subspecs: Tuple["SweepSpec", ...] = ()

    def __post_init__(self):
        axes = self.axes
        if isinstance(axes, Mapping):
            axes = tuple((k, tuple(v)) for k, v in axes.items())
        else:
            axes = tuple((k, tuple(v)) for k, v in axes)
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "seeds", tuple(self.seeds))
        object.__setattr__(
            self, "variants",
            tuple((tmpl, dict(ov)) for tmpl, ov in self.variants))
        if self.mode not in ("cartesian", "zip"):
            raise ValueError(f"unknown sweep mode {self.mode!r} "
                             f"(want 'cartesian' or 'zip')")
        if self.subspecs and self.axes:
            raise ValueError("a union SweepSpec cannot carry its own axes")
        names = [n for n, _ in self.axes]
        cfg_fields = {f.name for f in dataclasses.fields(ScenarioConfig)}
        for n in names:
            if n != LABEL_AXIS and n not in cfg_fields:
                raise ValueError(f"unknown sweep axis {n!r}; ScenarioConfig "
                                 f"fields: {sorted(cfg_fields)}")
        if names.count(LABEL_AXIS) and self.mode != "zip":
            raise ValueError("the _label axis requires mode='zip'")
        if self.mode == "zip" and self.axes:
            lens = {len(v) for _, v in self.axes}
            if len(lens) > 1:
                raise ValueError(f"zip-mode axes must have equal lengths, "
                                 f"got {dict((n, len(v)) for n, v in self.axes)}")

    # -- composition --------------------------------------------------------
    @classmethod
    def union(cls, name: str, *specs: "SweepSpec",
              seeds: Sequence[int] = ()) -> "SweepSpec":
        """Concatenate several specs into one grid (expansion order is the
        argument order); ``seeds`` replicates every row of the union.
        Subspecs must not carry their own seeds — expansion works on
        logical rows, so nested seed replication would be silently
        dropped; declare seeds once, on the union."""
        seeded = [s.name for s in specs if s.seeds]
        if seeded:
            raise ValueError(f"subspec(s) {seeded} carry their own seeds; "
                             f"set seeds on the union instead")
        return cls(name=name, subspecs=tuple(specs), seeds=tuple(seeds))

    def with_seeds(self, n_or_seeds) -> "SweepSpec":
        """``3`` -> seeds (0, 1, 2); a sequence is taken verbatim."""
        seeds = (tuple(range(n_or_seeds)) if isinstance(n_or_seeds, int)
                 else tuple(n_or_seeds))
        return dataclasses.replace(self, seeds=seeds)

    # -- expansion ----------------------------------------------------------
    def rows(self) -> List[Tuple[str, ScenarioConfig]]:
        """The logical grid: ``(label, config)`` per row, seeds NOT yet
        replicated. Labels must be unique across the whole grid."""
        out = self._expand()
        seen: Dict[str, int] = {}
        for lbl, _ in out:
            seen[lbl] = seen.get(lbl, 0) + 1
        dups = sorted(lbl for lbl, k in seen.items() if k > 1)
        if dups:
            raise ValueError(f"duplicate sweep labels {dups}; make the "
                             f"label template mention every varying axis")
        return out

    def _expand(self) -> List[Tuple[str, ScenarioConfig]]:
        if self.subspecs:
            return [row for s in self.subspecs for row in s._expand()]
        names = [n for n, _ in self.axes]
        values = [v for _, v in self.axes]
        if not names:
            combos = [()]
        elif self.mode == "zip":
            combos = list(zip(*values))
        else:
            combos = list(itertools.product(*values))
        variants = self.variants or ((self.label, {}),)
        out: List[Tuple[str, ScenarioConfig]] = []
        for vals in combos:
            point = dict(zip(names, vals))
            explicit = point.pop(LABEL_AXIS, None)
            for tmpl, overrides in variants:
                cfg = dataclasses.replace(self.base, **point, **overrides)
                if explicit is not None:
                    lbl = str(explicit)
                elif tmpl:
                    lbl = tmpl.format(**point)
                else:
                    lbl = "_".join([self.name] + [f"{k}={v}"
                                                  for k, v in point.items()])
                out.append((lbl, cfg))
        return out

    def configs(self) -> List[Tuple[str, ScenarioConfig]]:
        """The physical run list: rows replicated over ``seeds`` (seeds
        innermost — ``row0/seed0, row0/seed1, row1/seed0, ...``)."""
        rows = self.rows()
        if not self.seeds:
            return rows
        return [(lbl, dataclasses.replace(cfg, seed=s))
                for lbl, cfg in rows for s in self.seeds]

    # -- wire form + canonical hashing (sweep service, DESIGN.md §12) -------
    WIRE_SCHEMA = 1

    def to_wire(self) -> Dict[str, Any]:
        """JSON-safe dict form of the whole spec tree — the sweep service's
        submit payload (:mod:`repro.service`). Pure data: axes values,
        variant overrides and the base config must already be JSON-safe
        (they are for every ScenarioConfig field), so
        ``from_wire(json.loads(json.dumps(to_wire())))`` reconstructs a
        spec with an identical expansion."""
        return {
            "schema": self.WIRE_SCHEMA,
            "name": self.name,
            "base": dataclasses.asdict(self.base),
            "axes": [[n, list(v)] for n, v in self.axes],
            "mode": self.mode,
            "label": self.label,
            "variants": [[tmpl, dict(ov)] for tmpl, ov in self.variants],
            "seeds": list(self.seeds),
            "subspecs": [s.to_wire() for s in self.subspecs],
        }

    @classmethod
    def from_wire(cls, payload: Mapping[str, Any]) -> "SweepSpec":
        if payload.get("schema") != cls.WIRE_SCHEMA:
            raise ValueError(f"unsupported SweepSpec wire schema "
                             f"{payload.get('schema')!r} (this build reads "
                             f"{cls.WIRE_SCHEMA})")
        return cls(
            name=payload["name"],
            base=ScenarioConfig(**payload["base"]),
            axes=tuple((n, tuple(v)) for n, v in payload["axes"]),
            mode=payload["mode"],
            label=payload["label"],
            variants=tuple((tmpl, dict(ov))
                           for tmpl, ov in payload["variants"]),
            seeds=tuple(payload["seeds"]),
            subspecs=tuple(cls.from_wire(s)
                           for s in payload["subspecs"]))

    def canonical_hash(self) -> str:
        """Content hash of the *physical run list* — the exact-result-cache
        key component (repro.service.cache, DESIGN.md §12).

        Hashes the expanded ``configs()`` (labels + full config dicts) as
        canonical JSON (sorted keys, compact separators), NOT the spec
        tree, so the hash is invariant to dict key order, to process
        restarts (no ids/addresses enter the digest) and to any spec
        refactoring that expands to the same runs — while any axis-value,
        variant, seed or base-field change lands in some config dict and
        changes the digest. Held equal to the reference's hash in
        tests/test_torch_experiment.py.
        """
        runs = [[lbl, dataclasses.asdict(cfg)] for lbl, cfg in
                self.configs()]
        blob = json.dumps({"schema": self.WIRE_SCHEMA, "runs": runs},
                          sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()

    # -- execution ----------------------------------------------------------
    def run(self, data: Dataset, *, stack: str = "auto",
            parallel: str = "none", device="cuda") -> "SweepResult":
        """Evaluate the grid on ``device``. ``stack="auto"`` runs
        metadata-derived stack-compatible groups replica-stacked (one
        dispatch set per window per group); ``stack="off"`` runs every
        config sequentially. Both go through the same engines, so they
        agree to the engine-parity tolerance.

        ``parallel`` picks the execution backend by spec string
        (:func:`repro_torch.core.parallel.get_executor`): ``"none"``
        (sequential over stacking groups), ``"devices:n=K"`` (K shards
        over the cards, shard k on ``cuda:{k % count}``),
        ``"processes:n=K"`` (a spawned worker pool) or
        ``"hosts:channel=...,n=K,retries=R"`` (the launcher of
        :mod:`repro_torch.core.launcher`). The device is the caller's:
        with ``device="cpu"`` every backend runs its shards on the CPU.
        Stack-key groups are never split across shards, so every backend
        runs the same stacked computations in the same within-group order
        and the result JSON is byte-equal across backends. Backends may
        report execution metadata (the launcher's per-shard attempt log)
        through the out-of-band ``SweepResult.meta`` field."""
        from repro_torch.core.parallel import get_executor

        if stack not in ("auto", "off"):
            raise ValueError(f"stack must be 'auto' or 'off', got {stack!r}")
        executor = get_executor(parallel)
        resolve_device(device)
        runs = self.configs()
        for _, cfg in runs:
            validate_config(cfg)
        labels = [lbl for lbl, _ in runs]
        results, exec_meta = executor.execute_with_meta(
            labels, [cfg for _, cfg in runs], data,
            stack=(stack == "auto"), device=device)
        out = SweepResult(name=self.name,
                          records=records_from(labels, results))
        if exec_meta:
            out.meta.update(exec_meta)
        return out


# ---------------------------------------------------------------------------
# SweepResult
# ---------------------------------------------------------------------------

@dataclass
class RunRecord:
    """One (label, seed) run: config, F1 curve, full energy-event ledger."""
    label: str
    cfg: ScenarioConfig
    f1_curve: List[float]
    events: List[dict]

    def to_scenario_result(self) -> ScenarioResult:
        return ScenarioResult(list(self.f1_curve), Ledger(list(self.events)),
                              self.cfg)


def records_from(labels: Sequence[str], results: Sequence[ScenarioResult]
                 ) -> List[RunRecord]:
    """Label a batch of scenario results — the single record-building path
    of :meth:`SweepSpec.run`."""
    return [RunRecord(label=lbl, cfg=r.cfg, f1_curve=list(r.f1_curve),
                      events=list(r.ledger.events))
            for lbl, r in zip(labels, results)]


@dataclass
class SweepResult:
    """Structured sweep output: per-run records + per-label aggregation.

    JSON round-trips losslessly (``from_json(r.to_json()) == r``), so
    benchmark outputs become reloadable artifacts instead of write-only
    dicts.

    ``meta`` is an out-of-band side channel for execution metadata — the
    multi-host launcher's per-shard attempt log lands here
    (``meta["launcher"]``, DESIGN.md §8). It is excluded from equality
    and from ``to_json`` by default, so two runs of the same grid compare
    and serialize identically however (and however faultily) they were
    executed — the bitwise-parity contract never sees it. Pass
    ``include_meta=True`` to serialize it for operator forensics."""
    name: str
    records: List[RunRecord]
    _summaries: Dict[str, Dict[str, Any]] = field(
        default_factory=dict, compare=False, repr=False)
    meta: Dict[str, Any] = field(
        default_factory=dict, compare=False, repr=False)
    SCHEMA = 1

    def labels(self) -> List[str]:
        """Unique labels, first-appearance order."""
        out, seen = [], set()
        for r in self.records:
            if r.label not in seen:
                seen.add(r.label)
                out.append(r.label)
        return out

    def select(self, label: str) -> List[ScenarioResult]:
        rs = [r.to_scenario_result() for r in self.records
              if r.label == label]
        if not rs:
            raise KeyError(f"no runs labelled {label!r}; have "
                           f"{self.labels()}")
        return rs

    def summary(self, label: str) -> Dict[str, Any]:
        """Aggregate a label's seed replicas: converged F1 (mean/std over
        seeds), mean energies by purpose, mean F1 curve — the row format
        of the paper-table benchmarks. Memoized per label (records are
        immutable in practice); callers get a fresh shallow copy, so
        annotating the returned dict never pollutes the cache."""
        cached = self._summaries.get(label)
        if cached is None:
            rs = self.select(label)
            curves = np.array([r.f1_curve for r in rs])
            cached = self._summaries[label] = {
                "f1": float(np.mean([r.converged_f1() for r in rs])),
                "f1_std": float(np.std([r.converged_f1() for r in rs])),
                "energy_mj": float(np.mean([r.energy_total for r in rs])),
                "collection_mj": float(np.mean([r.energy_collection
                                                for r in rs])),
                "learning_mj": float(np.mean([r.energy_learning
                                              for r in rs])),
                "f1_curve": [float(v) for v in curves.mean(axis=0)],
            }
        return dict(cached)

    def summaries(self) -> Dict[str, Dict[str, Any]]:
        return {lbl: self.summary(lbl) for lbl in self.labels()}

    # -- paging (sweep-service result endpoint, DESIGN.md §12) --------------
    def page(self, page: int, per_page: int) -> "SweepResult":
        """A record slice as its own :class:`SweepResult` (records
        ``[page*per_page, (page+1)*per_page)``, original order). Paging
        bookkeeping rides the out-of-band ``meta`` side channel
        (``meta["paging"]``), so a page serializes exactly like any other
        result and the full-result bytes stay the concatenation-free
        parity surface. An out-of-range page is an empty page, not an
        error — clients walk pages until one comes back empty."""
        if page < 0 or per_page < 1:
            raise ValueError(f"need page >= 0 and per_page >= 1, got "
                             f"page={page} per_page={per_page}")
        lo = page * per_page
        out = SweepResult(name=self.name,
                          records=list(self.records[lo:lo + per_page]))
        out.meta["paging"] = {
            "page": page, "per_page": per_page,
            "total_records": len(self.records),
            "total_pages": -(-len(self.records) // per_page),
        }
        return out

    # -- serialization ------------------------------------------------------
    def to_json(self, path: Optional[str] = None, *, indent: int = 1,
                include_meta: bool = False) -> str:
        payload = {
            "schema": self.SCHEMA,
            "name": self.name,
            "records": [{
                "label": r.label,
                "cfg": dataclasses.asdict(r.cfg),
                "f1_curve": [float(v) for v in r.f1_curve],
                "events": r.events,
            } for r in self.records],
        }
        if include_meta and self.meta:
            payload["meta"] = self.meta
        text = json.dumps(payload, indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_json(cls, text: str) -> "SweepResult":
        payload = json.loads(text)
        if payload.get("schema") != cls.SCHEMA:
            raise ValueError(f"unsupported SweepResult schema "
                             f"{payload.get('schema')!r} "
                             f"(this build reads {cls.SCHEMA})")
        records = [RunRecord(label=r["label"],
                             cfg=ScenarioConfig(**r["cfg"]),
                             f1_curve=list(r["f1_curve"]),
                             events=list(r["events"]))
                   for r in payload["records"]]
        return cls(name=payload["name"], records=records,
                   meta=dict(payload.get("meta") or {}))

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# named presets
# ---------------------------------------------------------------------------

PRESETS: Dict[str, Callable[..., SweepSpec]] = {}


def register_preset(name: str):
    def deco(fn):
        if name in PRESETS and PRESETS[name] is not fn:
            raise ValueError(f"preset {name!r} already registered")
        PRESETS[name] = fn
        return fn
    return deco


def get_preset(name: str, **overrides) -> SweepSpec:
    """Build a named preset grid; ``overrides`` are the preset's knobs
    (typically ``windows=``, ``n_seeds=``, ``engine=``)."""
    if name not in PRESETS:
        raise KeyError(f"no preset named {name!r}; known: "
                       f"{sorted(PRESETS)}")
    return PRESETS[name](**overrides)


@register_preset("paper_tables")
def _paper_tables(windows: int = 100, n_seeds: int = 3,
                  engine: str = "fleet") -> SweepSpec:
    """The paper's full result grid (Fig. 2 + Tables 2-6, 8-9), one row
    per table cell, labels exactly as results/benchmarks/paper_tables.json
    keys. Expansion order matches the legacy hand-rolled grid row for row,
    so the run list — and therefore the replica-stacking group layout —
    is unchanged."""
    base = ScenarioConfig(windows=windows, eval_every=max(1, windows // 20),
                          engine=engine)
    b = lambda **kw: dataclasses.replace(base, **kw)       # noqa: E731
    return SweepSpec.union(
        "paper_tables",
        SweepSpec("fig2", base=b(algo="edge_only"), label="fig2_edge_only"),
        # Table 2: partial data on the edge (StarHTL, 4G between DCs)
        SweepSpec("table2", base=b(algo="star", tech="4g"), mode="zip",
                  axes={"p_edge": (0.5, 0.15, 0.03),
                        LABEL_AXIS: ("table2_edge50pct", "table2_edge15pct",
                                     "table2_edge3pct")}),
        # Table 3: no data on edge, Zipf, A2A/Star x 4G/WiFi
        SweepSpec("table3", base=base,
                  axes={"algo": ("a2a", "star"), "tech": ("4g", "wifi")},
                  label="table3_{algo}_{tech}"),
        # Table 4: + data-aggregation heuristic (Zipf)
        SweepSpec("table4", base=b(aggregate=True),
                  axes={"algo": ("a2a", "star"), "tech": ("4g", "wifi")},
                  label="table4_{algo}_{tech}_agg"),
        # Tables 5/6: uniform initial distribution, +/- aggregation
        SweepSpec("table56", base=b(uniform=True),
                  axes={"algo": ("a2a", "star"), "tech": ("4g", "wifi")},
                  variants=(("table5_{algo}_{tech}_uniform", {}),
                            ("table6_{algo}_{tech}_uniform_agg",
                             {"aggregate": True}))),
        # Tables 8/9: GreedyTL sub-sampling (computational complexity)
        SweepSpec("table89", base=b(tech="wifi"),
                  axes={"n_subsample": (2, 5, 10), "algo": ("a2a", "star")},
                  variants=(("table8_{algo}_n{n_subsample}", {}),
                            ("table9_{algo}_n{n_subsample}_uniform",
                             {"uniform": True}))),
        seeds=range(n_seeds),
    )


@register_preset("energy_tradeoff")
def _energy_tradeoff(windows: int = 30, engine: str = "fleet") -> SweepSpec:
    """The examples/energy_tradeoff.py grid: edge-only reference, partial
    offload, and the HTL variants with/without aggregation."""
    base = ScenarioConfig(windows=windows, engine=engine,
                          eval_every=max(1, windows // 5))
    b = lambda **kw: dataclasses.replace(base, **kw)       # noqa: E731
    return SweepSpec.union(
        "energy_tradeoff",
        SweepSpec("edge", base=b(algo="edge_only"),
                  label="edge-only (NB-IoT)"),
        SweepSpec("partial", base=b(algo="star"), mode="zip",
                  axes={"p_edge": (0.5, 0.15, 0.03),
                        LABEL_AXIS: ("star 4g, 50% on edge",
                                     "star 4g, 15% on edge",
                                     "star 4g, 3% on edge")}),
        SweepSpec("htl", base=base,
                  axes={"algo": ("a2a", "star"), "tech": ("4g", "wifi")},
                  variants=(("{algo} {tech}, 0% on edge", {}),
                            ("{algo} {tech} + aggregation",
                             {"aggregate": True}))),
    )


@register_preset("transport_grid")
def _transport_grid(windows: int = 30, n_seeds: int = 1,
                    engine: str = "fleet") -> SweepSpec:
    """Beyond-paper technology grid over the parameterized transport
    registry (ROADMAP: mesh/BLE/LoRa): multi-hop 802.15.4 mesh depths vs
    BLE vs LoRa spreading factors, for both HTL variants."""
    base = ScenarioConfig(windows=windows, eval_every=max(1, windows // 5),
                          engine=engine)
    return SweepSpec(
        "transport_grid", base=base,
        axes={"algo": ("a2a", "star"),
              "tech": ("mesh:hops=1", "mesh:hops=2", "mesh:hops=3",
                       "ble", "lora:sf=7", "lora:sf=12")},
        label="{algo}_{tech}").with_seeds(n_seeds)


@register_preset("city")
def _city(fleet_size: int = 100_000, windows: int = 3, obs_per_dc: int = 4,
          train_iters: int = 6, n_seeds: int = 1,
          tech: str = "wifi") -> SweepSpec:
    """The million-DC scaling scenario (ROADMAP north-star): a smart-city
    StarHTL fleet of ``fleet_size`` Data Collectors on the scan engine —
    device-resident fleet state, one program for the whole run, the DC
    axis batched on one device (each window one CUDA-graph replay on the
    card) or, when every rank of a process group runs the spec, split over
    the ranks (repro_torch.core.cityscan.run_city). Defaults are sized for the
    reference's CI ``city-smoke`` gate: 10^5 DCs, 3 windows, trimmed
    base-SVM iterations."""
    base = ScenarioConfig(windows=windows, eval_every=1, algo="star",
                          engine="scan", tech=tech, fleet_size=fleet_size,
                          obs_per_dc=obs_per_dc, train_iters=train_iters)
    return SweepSpec(
        "city", base=base,
        label=f"city_{fleet_size}dc_{tech}").with_seeds(n_seeds)


@register_preset("churn")
def _churn(windows: int = 8, n_seeds: int = 1,
           engine: str = "fleet") -> SweepSpec:
    """DC churn (DESIGN.md §13): per-DC battery budgets fed back from the
    energy ledger — mules that spend their budget leave the fleet
    mid-scenario. One depleting battery axis x both HTL variants, plus a
    no-battery control row per algorithm so the preset itself exhibits
    the graceful-degradation curve."""
    base = ScenarioConfig(windows=windows, eval_every=1, tech="4g",
                          engine=engine)
    return SweepSpec(
        "churn", base=base,
        axes={"algo": ("star", "a2a"),
              "battery_mj": (None, 40.0, 15.0)},
        label="churn_{algo}_batt{battery_mj}").with_seeds(n_seeds)


@register_preset("drift")
def _drift(windows: int = 10, n_seeds: int = 1,
           engine: str = "fleet") -> SweepSpec:
    """Concept drift (DESIGN.md §13): gradual covariate rotation, abrupt
    label-prior shift, and their composition, against a drift-free
    control — all on the same stream draw, so the F1 gap IS the drift
    effect."""
    base = ScenarioConfig(windows=windows, eval_every=1, algo="star",
                          tech="4g", engine=engine)
    return SweepSpec(
        "drift", base=base,
        axes={"drift": ("none", "rotate", "prior:at=0.5",
                        "rotate_prior")},
        label="drift_{drift}").with_seeds(n_seeds)


@register_preset("byzantine")
def _byzantine(windows: int = 8, n_seeds: int = 1,
               engine: str = "fleet") -> SweepSpec:
    """Faulty collectors vs robust aggregation (DESIGN.md §13): a fraction
    of mule observations arrive mislabelled; the A2A combine either
    averages (paper baseline) or trims the outer models (trimmed mean)."""
    base = ScenarioConfig(windows=windows, eval_every=1, algo="a2a",
                          tech="wifi", engine=engine)
    return SweepSpec(
        "byzantine", base=base,
        axes={"byz_frac": (0.0, 0.25),
              "robust_agg": ("mean", "trim:frac=0.25")},
        label="byz{byz_frac}_{robust_agg}").with_seeds(n_seeds)


@register_preset("mobility")
def _mobility(windows: int = 8, n_seeds: int = 1, engine: str = "fleet",
              trace_dir: str = "results/traces") -> SweepSpec:
    """Mobility-trace collection (DESIGN.md §13): a random-waypoint trace
    (generated on demand into ``trace_dir``, digest-named so regeneration
    is idempotent) drives per-window per-mule loads through the
    ``trace_file:`` collection policy, next to the paper's Zipf and the
    synthetic ``trace:`` policy on the same scenario."""
    from repro_torch.data.mobility import generate_trace

    path = generate_trace(trace_dir, windows=windows, mules=6,
                          sensors=36, seed=0)
    base = ScenarioConfig(windows=windows, eval_every=1, algo="star",
                          tech="4g", engine=engine)
    return SweepSpec(
        "mobility", base=base,
        axes={"collection": ("poisson_zipf", "trace:loads=60-25-15",
                             f"trace_file:path={path}")},
        label="mobility_{collection}").with_seeds(n_seeds)


@register_preset("realism")
def _realism(windows: int = 8, n_seeds: int = 2, engine: str = "fleet",
             trace_dir: str = "results/traces") -> SweepSpec:
    """The full realism matrix (DESIGN.md §13): churn x drift x byzantine
    x mobility rows unioned into one seeded grid — the axis the paper's
    static-fleet evaluation leaves out, runnable through every engine and
    the sweep service like any other preset."""
    return SweepSpec.union(
        "realism",
        _churn(windows=windows, n_seeds=0, engine=engine),
        _drift(windows=windows + 2, n_seeds=0, engine=engine),
        _byzantine(windows=windows, n_seeds=0, engine=engine),
        _mobility(windows=windows, n_seeds=0, engine=engine,
                  trace_dir=trace_dir),
        seeds=range(n_seeds),
    )


@register_preset("pareto")
def _pareto(windows: int = 24, n_seeds: int = 2,
            engine: str = "fleet") -> SweepSpec:
    """The auto-tuner's candidate grid (DESIGN.md §14): the deployment
    space the paper enumerated by hand — transport technologies x HTL
    variant x aggregation heuristic, partial edge offload fractions, and
    collection policies — as one seeded union. Feed it to a search from
    :mod:`repro.core.pareto` (``HalvingSearch``/``get_search``) to get
    the energy/F1 frontier; running it directly is the exhaustive grid
    the searches are benchmarked against."""
    base = ScenarioConfig(windows=windows, eval_every=max(1, windows // 6),
                          engine=engine)
    b = lambda **kw: dataclasses.replace(base, **kw)       # noqa: E731
    return SweepSpec.union(
        "pareto",
        SweepSpec("edge", base=b(algo="edge_only"), label="edge_only"),
        SweepSpec("offload", base=b(algo="star"), mode="zip",
                  axes={"p_edge": (0.5, 0.15, 0.03),
                        LABEL_AXIS: ("star_4g_edge50", "star_4g_edge15",
                                     "star_4g_edge3")}),
        SweepSpec("transports", base=base,
                  axes={"algo": ("star", "a2a"),
                        "tech": ("4g", "wifi", "ble", "lora:sf=7")},
                  variants=(("{algo}_{tech}", {}),
                            ("{algo}_{tech}_agg", {"aggregate": True}))),
        SweepSpec("collection", base=b(algo="star", tech="wifi"),
                  axes={"collection": ("uniform", "bursty:burst=8")},
                  label="star_wifi_{collection}"),
        seeds=range(n_seeds),
    )


@register_preset("smoke")
def _smoke(windows: int = 6, n_seeds: int = 2,
           engine: str = "fleet") -> SweepSpec:
    """Tiny CI grid (scripts/verify.sh): one stackable HTL pair per
    algorithm plus a mesh row, small enough for the verify budget but
    wide enough to cross a stacking-group boundary."""
    base = ScenarioConfig(windows=windows, eval_every=max(1, windows // 3),
                          engine=engine)
    return SweepSpec.union(
        "smoke",
        SweepSpec("smoke_star", base=base,
                  axes={"tech": ("4g", "mesh:hops=2")},
                  label="star_{tech}"),
        SweepSpec("smoke_a2a",
                  base=dataclasses.replace(base, algo="a2a", tech="wifi"),
                  label="a2a_wifi"),
        seeds=range(n_seeds),
    )
