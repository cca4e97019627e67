"""Scenario simulation (paper Sections 3, 5, 6).

A slotted data-collection process: ``windows`` collection windows of
``obs_per_window`` observations each. Observations are either collected by
SmartMules (802.15.4) or shipped to the Edge Server (NB-IoT). The number of
mules per window is Poisson(lambda); the per-mule allocation follows a Zipf
ranking (or uniform, Scenario 3). After each window a learning round runs
(centralised on the ES, or A2AHTL/StarHTL among the Data Collectors) and the
global model is evaluated on the held-out test set.

The per-window pipeline is decomposed into composable phases —

    collection policy -> learning round -> global EMA update -> eval

— each a module-level function, so alternative policies (engines,
topologies, collection schemes) compose without touching the driver.
Collection policies are a spec-string registry
(:data:`COLLECTION_POLICIES`, mirroring the transport registry in
:mod:`repro_torch.core.topology`): builtin ``poisson_zipf`` (the paper's
process), ``uniform`` (Scenario 3), ``trace`` (deterministic replay of a
recorded per-mule allocation) and ``bursty`` (contiguous arrival runs).
The learning round runs on one of two engines: ``"fleet"`` (default,
O(1) trainer/refiner calls per window, :mod:`repro_torch.core.fleet`) or
``"loop"`` (per DC, :mod:`repro_torch.core.htl`); they agree within the
fleet==loop contract stated in :mod:`repro_torch.core.fleet`.

:func:`run_sweep` evaluates many configurations; with
``stack_seeds=True`` it runs all stack-compatible replicas of a
configuration in lockstep, stacking them into the fleet DC axis so one
call per sample bucket and window serves every seed (per-seed energy
ledgers and rng streams stay separate — :func:`run_scenarios_stacked`).
Stack compatibility is *derived from field metadata*: every
:class:`ScenarioConfig` field tagged ``host_side`` steers only host-side
work, so :func:`stack_key` normalizes exactly those fields.

A third engine, ``"scan"``, runs the whole scenario as one program
(:mod:`repro_torch.core.cityscan`: one captured CUDA graph replayed per
window on the card), and with ``fleet_size`` set it runs the city
scenario instead of the paper's collection stream.

Port of ``repro.core.scenario``. Everything host-side — the observation
stream, collection draws, churn, byzantine coins, every ledger charge, the
EMA update — is the reference's code, so ledgers match it exactly. Models
are trained and evaluated on ``device`` (default ``"cuda"``;
:func:`repro_torch.resolve_device` raises when CUDA is missing and the
caller did not pass ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fleet as fleet_engine
from repro_torch.core import htl as loop_engine
from repro_torch.core.energy import Ledger
from repro_torch.core.htl import DC, apply_aggregation_heuristic
from repro_torch.core.metrics import f_measure
from repro_torch.core.registry import register_factory, resolve_spec
from repro_torch.core.svm import svm_predict, train_svm
from repro_torch.data.synthetic_covtype import Dataset, NUM_CLASSES

ENGINES = {
    "fleet": {"a2a": fleet_engine.run_window_a2a,
              "star": fleet_engine.run_window_star},
    "loop": {"a2a": loop_engine.run_window_a2a,
             "star": loop_engine.run_window_star},
}

# Whole-scenario engines dispatch above the per-window ENGINES table
# (repro_torch.core.cityscan).
SCENARIO_ENGINES = ("scan",)


def _host(doc: str = "") -> dict:
    """Field metadata marking a config field as *host-side*: it steers
    collection rng, energy charging or other host work but never the
    shapes/semantics of the device calls, so replicas differing only in
    host-side fields may run replica-stacked (see :func:`_stack_key`)."""
    return {"host_side": True, "doc": doc}


@dataclass(frozen=True)
class ScenarioConfig:
    windows: int = 100
    obs_per_window: int = 100
    lam_poisson: float = field(default=7.0, metadata=_host())
    zipf_alpha: float = field(default=1.5, metadata=_host())
    # fraction of each window shipped to the ES
    p_edge: float = field(default=0.0, metadata=_host())
    algo: str = "star"            # 'star' | 'a2a' | 'edge_only'
    # DC<->DC technology: any transport spec string registered in
    # repro_torch.core.topology ('4g', 'wifi', 'ble', 'mesh:hops=3',
    # 'lora:sf=12')
    tech: str = field(default="4g", metadata=_host())
    # Scenario 3: uniform allocation over mules (legacy switch; equivalent
    # to collection="uniform", kept so existing grids keep working)
    uniform: bool = field(default=False, metadata=_host())
    # data-aggregation heuristic (Section 6.3)
    aggregate: bool = field(default=False, metadata=_host())
    # GreedyTL points per class (Sec. 7)
    n_subsample: Optional[int] = field(default=None, metadata=_host())
    include_es_in_learning: bool = field(default=True, metadata=_host())
    cap: int = 160                # padded local-dataset capacity
    eval_every: int = 1
    seed: int = field(default=0, metadata=_host())
    engine: str = "fleet"         # 'fleet' (batched) | 'loop' (reference)
    # collection-policy spec string (COLLECTION_POLICIES): 'poisson_zipf',
    # 'uniform', 'trace:loads=60-25-15', 'bursty:burst=8'
    collection: str = field(default="poisson_zipf", metadata=_host())
    # "This model is used to update the model elaborated until the previous
    # time slot" (paper Section 3): the window model updates the global model
    # incrementally. We use an exponential moving average with this rate.
    global_update_rate: float = field(default=0.3, metadata=_host())
    # City mode (engine="scan" only): a fixed fleet of ``fleet_size`` DCs,
    # each drawing ``obs_per_dc`` observations per window ON DEVICE — the
    # 10^5-DC scaling axis (repro_torch.core.cityscan.run_city). None =
    # the paper's host-side collection stream.
    fleet_size: Optional[int] = None
    obs_per_dc: int = 4
    # Base-SVM GD iterations, honored by the scan engine only (the
    # loop/fleet engines pin the paper's 200 — parity oracle); the city
    # preset trims it so 10^5-DC rounds fit the CI budget.
    train_iters: int = 200
    # --- realism axis (DESIGN.md §13) ---
    # Per-mule battery budget (mJ). When set, each mule's attributed drain
    # (Ledger.node_mj) is swept at the top of every window and a depleted
    # mule leaves the fleet for good (DC churn); None = infinite batteries.
    # Host-side: churn only changes which DCs the host hands the engines.
    battery_mj: Optional[float] = field(default=None, metadata=_host())
    # Concept-drift schedule applied to the observation stream: a spec
    # string over repro_torch.data.synthetic_covtype.DRIFT_FACTORIES ("none",
    # "rotate:rate=0.05", "prior:at=0.5,gamma=0.5", "rotate_prior").
    drift: str = field(default="none", metadata=_host())
    # Per-live-mule-per-window probability of a faulty (byzantine) upload:
    # the mule's window labels arrive cyclically shifted by one class.
    byz_frac: float = field(default=0.0, metadata=_host())
    # Combine rule of the A2A refine step: "mean" (the paper's average)
    # or "trim:frac=F" (coordinate-wise F-trimmed mean, byzantine-robust).
    robust_agg: str = field(default="mean", metadata=_host())


@dataclass
class ScenarioResult:
    f1_curve: List[float]
    ledger: Ledger
    cfg: ScenarioConfig

    @property
    def final_f1(self) -> float:
        return self.f1_curve[-1]

    def converged_f1(self, start_frac: float = 0.5) -> float:
        """Paper: mean F1 over the converged interval (50th-100th window)."""
        k = int(len(self.f1_curve) * start_frac)
        return float(np.mean(self.f1_curve[k:]))

    @property
    def energy_total(self) -> float:
        return self.ledger.total()

    @property
    def energy_collection(self) -> float:
        return self.ledger.total("collection")

    @property
    def energy_learning(self) -> float:
        return self.ledger.total("learning")


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


# ---------------------------------------------------------------------------
# collection-policy registry (mirrors the transport registry)
# ---------------------------------------------------------------------------

# A policy maps (cfg, rng, n_mule_obs[, window]) -> (L mules,
# per-observation mule assignment in [0, L)); factories take the
# spec-string parameters. ``window`` is the 0-based window index — the
# builtin stochastic policies ignore it (their dynamics live in the rng
# stream), the trace-file policy uses it as its cursor.
CollectionPolicy = Callable[["ScenarioConfig", np.random.Generator, int, int],
                            Tuple[int, np.ndarray]]


def _poisson_zipf_policy() -> CollectionPolicy:
    """The paper's process: Poisson(lambda) mules, Zipf(alpha) allocation."""
    def policy(cfg, rng, n, window=0):
        L = max(1, rng.poisson(cfg.lam_poisson))
        return L, rng.choice(L, size=n, p=_zipf_probs(L, cfg.zipf_alpha))
    return policy


def _uniform_policy() -> CollectionPolicy:
    """Scenario 3: Poisson(lambda) mules, uniform allocation."""
    def policy(cfg, rng, n, window=0):
        L = max(1, rng.poisson(cfg.lam_poisson))
        return L, rng.integers(0, L, size=n)
    return policy


def _apportion(shares: np.ndarray, n: int) -> Tuple[int, np.ndarray]:
    """Largest-remainder apportionment of ``n`` observations over per-mule
    ``shares`` — the deterministic allocation core shared by the ``trace``
    and ``trace_file`` policies."""
    L = len(shares)
    quota = shares / shares.sum() * n
    counts = np.floor(quota).astype(np.int64)
    order = np.argsort(-(quota - counts))
    counts[order[:n - counts.sum()]] += 1
    return L, np.repeat(np.arange(L), counts)


def _trace_policy(loads: str = "60-25-15") -> CollectionPolicy:
    """Deterministic replay of a recorded allocation: ``loads`` is a
    dash-separated per-mule load trace (relative shares), apportioned to
    each window's observations by largest remainder — same mule fleet,
    same split, every window, every seed."""
    shares = np.array([int(s) for s in str(loads).split("-")], np.float64)
    if len(shares) == 0 or (shares < 0).any() or shares.sum() <= 0:
        raise ValueError(f"trace loads must be non-negative with a positive "
                         f"sum, got {loads!r}")

    def policy(cfg, rng, n, window=0):
        return _apportion(shares, n)
    return policy


def _trace_file_policy(path: str = "") -> CollectionPolicy:
    """Windowed cursor over a mobility-trace *file*
    (:mod:`repro_torch.data.mobility`): window ``t`` apportions the mule
    share of the window's observations over row ``t % windows`` of the trace's
    ``(windows, mules)`` load matrix — the fleet moves window to window,
    and a scenario longer than the trace wraps around. Mules with zero
    load in a window simply collect nothing. Entirely rng-independent, so
    every seed replica sees the same fleet trajectory."""
    if not path:
        raise ValueError(
            "trace_file needs path=<trace json>; generate one with "
            "repro_torch.data.mobility.generate_trace")
    from repro_torch.data.mobility import load_trace
    loads = load_trace(str(path))

    def policy(cfg, rng, n, window=0):
        return _apportion(loads[window % loads.shape[0]], n)
    return policy


def _bursty_policy(burst: float = 8.0) -> CollectionPolicy:
    """Bursty arrivals: observations reach mules in contiguous runs of
    geometric mean length ``burst`` (a mule meets a sensor and drains it),
    run owners drawn from the Zipf(alpha) ranking — heavier short-term
    skew than i.i.d. Zipf at the same marginal allocation."""
    if burst < 1.0:
        raise ValueError(f"burst length must be >= 1, got {burst}")

    def policy(cfg, rng, n, window=0):
        L = max(1, rng.poisson(cfg.lam_poisson))
        p = _zipf_probs(L, cfg.zipf_alpha)
        assign = np.empty(n, np.int64)
        i = 0
        while i < n:
            run = int(rng.geometric(1.0 / burst))
            assign[i:i + run] = rng.choice(L, p=p)
            i += run
        return L, assign
    return policy


COLLECTION_POLICIES: Dict[str, Callable[..., CollectionPolicy]] = {
    "poisson_zipf": _poisson_zipf_policy,
    "uniform": _uniform_policy,
    "trace": _trace_policy,
    "trace_file": _trace_file_policy,
    "bursty": _bursty_policy,
}

_POLICY_CACHE: Dict[str, CollectionPolicy] = {}


def register_collection_policy(name: str,
                               factory: Callable[..., CollectionPolicy]
                               ) -> None:
    """Register a collection-policy factory under a spec name."""
    register_factory(COLLECTION_POLICIES, name, factory,
                     "collection policy")


def get_collection_policy(spec: str) -> CollectionPolicy:
    """Resolve a policy spec string (``"bursty:burst=8"``) to a cached
    policy callable; :class:`KeyError` on unknown names/malformed specs."""
    return resolve_spec(spec, COLLECTION_POLICIES, _POLICY_CACHE,
                        "collection policy")


def _effective_collection(cfg: ScenarioConfig) -> str:
    """The legacy ``uniform`` switch is sugar for ``collection="uniform"``
    (only when the policy was left at its default, so explicit policies
    always win)."""
    if cfg.uniform and cfg.collection == "poisson_zipf":
        return "uniform"
    return cfg.collection


# ---------------------------------------------------------------------------
# realism axis: battery-driven churn, robust aggregation, drifted streams
# (DESIGN.md §13)
# ---------------------------------------------------------------------------

class ChurnBook:
    """Per-replica churn state: one battery budget, and which mules have
    already depleted it (name -> window of death). Depletion is swept at
    the top of every window against the ledger's attributed per-node drain
    (:attr:`~repro_torch.core.energy.Ledger.node_mj`) in sorted-name order, so
    every driver that replays the same windows (fleet engine, scan
    planner, stacked replicas) kills the same mules at the same windows —
    churn parity is by construction, not by coincidence. The ES is mains
    powered and never churns."""

    def __init__(self, battery_mj: float):
        self.battery_mj = float(battery_mj)
        self.dead: Dict[str, int] = {}

    def sweep(self, ledger: Ledger, window: int) -> None:
        """Retire every node whose attributed drain crossed the budget."""
        for name in sorted(ledger.node_mj):
            if name == "ES" or name in self.dead:
                continue
            if ledger.node_mj[name] >= self.battery_mj:
                self.dead[name] = window
                ledger.churn(name, window)


def resolve_robust(spec: str) -> float:
    """Trim fraction of a robust-aggregation spec: ``"mean"`` -> 0.0 (the
    paper's plain average), ``"trim[:frac=F]"`` -> F (coordinate-wise
    trimmed mean, default 0.2). Same fail-fast contract as the spec
    registries: unknown names/parameters raise :class:`KeyError`, invalid
    fractions :class:`ValueError`."""
    from repro_torch.core.registry import parse_spec
    try:
        name, params = parse_spec(spec)
    except ValueError as e:
        raise KeyError(str(e)) from e
    if name == "mean":
        if params:
            raise KeyError(f"robust_agg 'mean' takes no parameters, "
                           f"got {spec!r}")
        return 0.0
    if name == "trim":
        frac = params.pop("frac", 0.2)
        if params:
            raise KeyError(f"unknown robust_agg parameters "
                           f"{sorted(params)} in {spec!r}")
        if isinstance(frac, bool) or not isinstance(frac, (int, float)) \
                or not 0.0 <= float(frac) < 0.5:
            raise ValueError(f"trim fraction must be in [0, 0.5), "
                             f"got {frac!r}")
        return float(frac)
    raise KeyError(f"no robust aggregation registered for {spec!r}; "
                   f"known: ['mean', 'trim']")


def build_stream(cfg: ScenarioConfig, data: Dataset,
                 rng: np.random.Generator
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The scenario's observation stream: a seeded draw from the train
    pool, then the configured concept-drift transform. Shared by every
    driver (sequential, stacked, scan planner), so drifted streams are
    identical across engines by construction. Consumes exactly one
    ``rng.permutation`` — drift randomness lives in its own seeded
    streams, so ``drift="none"`` configs replay bitwise as before."""
    n_total = cfg.windows * cfg.obs_per_window
    order = rng.permutation(len(data.y_train))[:n_total]
    sx, sy = data.x_train[order], data.y_train[order]
    if cfg.drift != "none":
        from repro_torch.data.synthetic_covtype import get_drift
        sx, sy = get_drift(cfg.drift)(sx, sy, cfg.windows,
                                      cfg.obs_per_window, cfg.seed)
    return sx.astype(np.float32), sy.astype(np.int32)


# ---------------------------------------------------------------------------
# per-window phases
# ---------------------------------------------------------------------------

def collect_window(cfg: ScenarioConfig, rng: np.random.Generator,
                   wx: np.ndarray, wy: np.ndarray, ledger: Ledger, *,
                   window: int = 0, churn: Optional[ChurnBook] = None
                   ) -> List[DC]:
    """Collection phase: split the window's observations between the Edge
    Server (NB-IoT, fraction ``p_edge``) and a SmartMule fleet (802.15.4)
    whose size/allocation comes from the configured collection policy,
    charging every transfer. This is a pure dispatch point: the arrival
    process itself lives in :data:`COLLECTION_POLICIES`.

    The realism hooks are applied here, identically for every driver:
    ``churn`` retires depleted mules *before* they collect (their
    observations are lost — the radio is dark, nothing is charged), and a
    ``byz_frac`` coin per live mule corrupts that mule's window labels
    (cyclic class shift). Both consume host rng/state only when enabled,
    so baseline configs replay bitwise."""
    if churn is not None:
        churn.sweep(ledger, window)
    n_edge = int(round(cfg.p_edge * cfg.obs_per_window))
    idx = rng.permutation(cfg.obs_per_window)
    edge_idx, mule_idx = idx[:n_edge], idx[n_edge:]

    policy = get_collection_policy(_effective_collection(cfg))
    L, assign = policy(cfg, rng, len(mule_idx), window)

    dcs: List[DC] = []
    for m in range(L):
        sel = mule_idx[assign == m]
        if len(sel) == 0:
            continue
        name = f"SM{m + 1}"
        if churn is not None and name in churn.dead:
            continue
        wy_m = wy[sel]
        if cfg.byz_frac > 0.0 and rng.random() < cfg.byz_frac:
            wy_m = (wy_m + 1) % NUM_CLASSES
        ledger.collect_to_mule(len(sel), name)
        dcs.append(DC(name, wx[sel], wy_m))
    if n_edge > 0:
        ledger.collect_to_edge(n_edge)
        if cfg.include_es_in_learning:
            dcs.append(DC("ES", wx[edge_idx], wy[edge_idx], is_es=True))
    return dcs


def learning_round(cfg: ScenarioConfig, dcs: List[DC],
                   prev_global: Optional[np.ndarray], ledger: Ledger,
                   rng: np.random.Generator, device="cuda"
                   ) -> Optional[np.ndarray]:
    """One HTL round on the configured engine (after the optional
    data-aggregation heuristic, paper Section 6.3). A window whose fleet
    churned away entirely runs no round (``None``: the global model is
    kept as-is — matching the scan engine's ``learn`` mask bitwise)."""
    if cfg.aggregate:
        dcs = apply_aggregation_heuristic(dcs, ledger, cfg.tech)
    if not dcs:
        return None
    run = ENGINES[cfg.engine][cfg.algo]
    return run(dcs, prev_global, ledger, cfg.tech, cap=cfg.cap,
               num_classes=NUM_CLASSES, n_subsample=cfg.n_subsample, rng=rng,
               robust=resolve_robust(cfg.robust_agg), device=device)


def update_global(cfg: ScenarioConfig, prev: Optional[np.ndarray],
                  new: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Paper Section 3: the window model updates the global model via EMA."""
    if prev is None or new is None:
        return new if new is not None else prev
    eta = cfg.global_update_rate
    return (1.0 - eta) * prev + eta * new


class EvalCache:
    """Keyed device-side dataset-derivative cache.

    Entries are keyed by ``(dataset identity, kind, device)`` — the dataset
    ref is pinned inside the entry so ids stay valid — and LRU-bounded, so
    interleaved sweeps over several datasets all hit without re-uploading
    per window, and a sweep on the CPU never evicts (or reads) the test
    tensor of a sweep on the card: one test tensor per device.

    Mutation is locked, and the cache holds device tensors, so it must
    never be pickled into another process (``__reduce__`` refuses)."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def array(self, data: Dataset, kind: str,
              build: Callable[[Dataset], torch.Tensor],
              device="cuda") -> torch.Tensor:
        """The device tensor ``build(data)`` on ``device``, cached under
        ``(id(data), kind, device)``."""
        dev = resolve_device(device)
        key = (id(data), kind, str(dev))
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] is data:
                self.hits += 1
                self._entries.move_to_end(key)
                return hit[1]
        # build outside the lock (device transfer can be slow); a racing
        # miss on the same key costs one redundant upload, nothing else
        arr = build(data).to(dev)
        with self._lock:
            self.misses += 1
            self._entries[key] = (data, arr)
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return arr

    def test_array(self, data: Dataset, device="cuda") -> torch.Tensor:
        return self.array(
            data, "test",
            lambda d: torch.from_numpy(d.x_test.astype(np.float32)), device)

    def __len__(self) -> int:
        return len(self._entries)

    def __reduce__(self):
        raise TypeError(
            "EvalCache holds device tensors and is process-local; "
            "another process must build its own (never pickle it across "
            "a process boundary)")


_eval_cache = EvalCache()


def _eval(w: np.ndarray, data: Dataset, device="cuda") -> float:
    x_test = _eval_cache.test_array(data, device)
    pred = svm_predict(torch.as_tensor(w, device=x_test.device), x_test)
    return f_measure(data.y_test, pred.cpu().numpy(), NUM_CLASSES)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _acc_cap(n_seen: int, n_total: int) -> int:
    """Bucketed capacity for the ES's growing accumulated dataset (doubling
    from 128): masked tail rows are dead compute for the trainer, so early
    windows need not pay for the full-stream allocation."""
    b = 128
    while b < n_seen:
        b *= 2
    return min(b, n_total)


def _run_edge_only(cfg: ScenarioConfig, data: Dataset, ledger: Ledger,
                   stream_x: np.ndarray, stream_y: np.ndarray,
                   device="cuda") -> ScenarioResult:
    """Edge-only benchmark: the ES accumulates everything and retrains."""
    n_total = cfg.windows * cfg.obs_per_window
    f1_curve: List[float] = []
    xacc = np.zeros((n_total, stream_x.shape[1]), np.float32)
    yacc = np.zeros((n_total,), np.int32)
    macc = np.zeros((n_total,), np.float32)
    w = None
    for t in range(cfg.windows):
        s = slice(t * cfg.obs_per_window, (t + 1) * cfg.obs_per_window)
        ledger.collect_to_edge(cfg.obs_per_window)
        xacc[s] = stream_x[s]
        yacc[s] = stream_y[s]
        macc[s] = 1.0
        b = _acc_cap((t + 1) * cfg.obs_per_window, n_total)
        w = train_svm(xacc[:b], yacc[:b], macc[:b], num_classes=NUM_CLASSES,
                      iters=300, w0=w, device=device).cpu().numpy()
        if (t + 1) % cfg.eval_every == 0:
            f1_curve.append(_eval(w, data, device))
    return ScenarioResult(f1_curve, ledger, cfg)


def validate_config(cfg: ScenarioConfig) -> None:
    """Fail fast on configs that cannot run: unknown engine / transport /
    collection specs (KeyError, before any window runs) and the
    empty-fleet trap — ``p_edge`` rounding to the whole window with the ES
    excluded from learning leaves every round with ``dcs == []``, so the
    global model would stay ``None`` forever and the first eval would
    crash deep in the engines."""
    if cfg.engine not in ENGINES and cfg.engine not in SCENARIO_ENGINES:
        raise KeyError(f"unknown engine {cfg.engine!r}; pick one of "
                       f"{sorted(ENGINES) + sorted(SCENARIO_ENGINES)}")
    if cfg.engine != "scan" and cfg.train_iters != 200:
        raise ValueError(
            f"train_iters={cfg.train_iters} is honored by the scan engine "
            f"only; the loop/fleet engines pin the paper's 200 iterations "
            f"(they are the parity oracle)")
    if cfg.train_iters < 1:
        raise ValueError(f"train_iters must be >= 1, got {cfg.train_iters}")
    if cfg.fleet_size is not None:
        if cfg.engine != "scan" or cfg.algo != "star":
            raise ValueError(
                "city mode (fleet_size set) needs engine='scan' and "
                "algo='star' — the device-resident fleet round is StarHTL")
        if cfg.fleet_size < 2:
            raise ValueError(f"city fleets need >= 2 DCs, got "
                             f"{cfg.fleet_size}")
        if cfg.obs_per_dc < 1:
            raise ValueError(f"obs_per_dc must be >= 1, got "
                             f"{cfg.obs_per_dc}")
        if (cfg.p_edge != 0.0 or cfg.aggregate or cfg.uniform
                or cfg.n_subsample is not None
                or cfg.collection != "poisson_zipf"):
            raise ValueError(
                "city mode draws observations on device per DC; the "
                "host-side collection knobs (p_edge, aggregate, uniform, "
                "n_subsample, collection policy) must stay at defaults")
    if cfg.engine == "scan" and cfg.algo == "edge_only":
        raise ValueError("the scan engine covers the HTL algorithms "
                         "('a2a'/'star'); use engine='fleet' for "
                         "algo='edge_only'")
    if cfg.algo != "edge_only":
        from repro_torch.core.energy import resolve_tech
        from repro_torch.core.topology import get_transport
        get_transport(cfg.tech)      # relay structure ...
        resolve_tech(cfg.tech)       # ... and per-event energy, both layers
        get_collection_policy(_effective_collection(cfg))
    # realism axis (DESIGN.md §13)
    if cfg.battery_mj is not None and cfg.battery_mj <= 0:
        raise ValueError(f"battery_mj must be positive (or None for "
                         f"infinite batteries), got {cfg.battery_mj}")
    if not 0.0 <= cfg.byz_frac <= 1.0:
        raise ValueError(f"byz_frac must be in [0, 1], got {cfg.byz_frac}")
    if cfg.algo == "edge_only" and (cfg.battery_mj is not None
                                    or cfg.byz_frac > 0.0):
        raise ValueError("churn/byzantine knobs model the mule fleet; "
                         "algo='edge_only' has no mules")
    if cfg.drift != "none":
        from repro_torch.data.synthetic_covtype import get_drift
        get_drift(cfg.drift)         # KeyError/ValueError before any window
    resolve_robust(cfg.robust_agg)
    if cfg.fleet_size is not None and (cfg.drift != "none"
                                       or cfg.byz_frac > 0.0
                                       or cfg.robust_agg != "mean"):
        raise ValueError(
            "city mode draws observations on device and runs StarHTL "
            "(no A2A combine): of the realism axis only battery churn "
            "applies; drift/byz_frac/robust_agg must stay at defaults")
    n_edge = int(round(cfg.p_edge * cfg.obs_per_window))
    if (cfg.algo != "edge_only" and not cfg.include_es_in_learning
            and n_edge >= cfg.obs_per_window):
        raise ValueError(
            f"empty fleet: p_edge={cfg.p_edge} sends all "
            f"{cfg.obs_per_window} observations of every window to the ES "
            f"while include_es_in_learning=False, so no Data Collector "
            f"ever joins a learning round; lower p_edge, set "
            f"include_es_in_learning=True, or use algo='edge_only'")


def run_scenario(cfg: ScenarioConfig, data: Dataset,
                 device="cuda") -> ScenarioResult:
    resolve_device(device)
    validate_config(cfg)
    if cfg.engine == "scan":
        from repro_torch.core import cityscan
        if cfg.fleet_size is not None:
            return cityscan.run_city(cfg, data, device=device)
        return cityscan.run_scenario_scan(cfg, data, device=device)
    rng = np.random.default_rng(cfg.seed)
    ledger = Ledger()
    stream_x, stream_y = build_stream(cfg, data, rng)

    if cfg.algo == "edge_only":
        return _run_edge_only(cfg, data, ledger, stream_x, stream_y,
                              device)

    churn = None if cfg.battery_mj is None else ChurnBook(cfg.battery_mj)
    f1_curve: List[float] = []
    prev_global: Optional[np.ndarray] = None
    for t in range(cfg.windows):
        s = slice(t * cfg.obs_per_window, (t + 1) * cfg.obs_per_window)
        dcs = collect_window(cfg, rng, stream_x[s], stream_y[s], ledger,
                             window=t, churn=churn)
        new_global = learning_round(cfg, dcs, prev_global, ledger, rng,
                                    device)
        prev_global = update_global(cfg, prev_global, new_global)
        if (t + 1) % cfg.eval_every == 0:
            f1_curve.append(_eval(prev_global, data, device))

    return ScenarioResult(f1_curve, ledger, cfg)


# {field: default} for every ScenarioConfig field tagged host_side — the
# stack key normalizes exactly these, so adding a field with
# ``metadata=_host()`` automatically opts it into replica stacking (and
# omitting the tag automatically keeps it a group splitter).
_HOST_SIDE_DEFAULTS: Dict[str, object] = {
    f.name: f.default for f in dataclasses.fields(ScenarioConfig)
    if f.metadata.get("host_side")
}


def host_side_fields() -> Tuple[str, ...]:
    """Names of the config fields that may vary within a stacked group."""
    return tuple(_HOST_SIDE_DEFAULTS)


def stack_key(cfg: ScenarioConfig) -> ScenarioConfig:
    """Configs with equal keys may run replica-stacked: the normalized
    fields only steer host-side work (collection rng, energy charging,
    GreedyTL subsampling inputs, EMA rate), never the shapes or semantics
    of the device calls, so stacking them changes nothing per replica.
    Which fields those are is declared as ``host_side`` field metadata on
    :class:`ScenarioConfig` — this function is purely derived.

    In the reference the key is also the sharding atom of the parallel
    sweep executor (``repro.core.parallel``, not ported yet).
    """
    return dataclasses.replace(cfg, **_HOST_SIDE_DEFAULTS)


# compatibility alias (pre-parallel-executor internal name)
_stack_key = stack_key


def stack_groups(configs: Sequence[ScenarioConfig],
                 key_fn: Callable[[ScenarioConfig], object] = stack_key
                 ) -> List[List[int]]:
    """Indices of ``configs`` grouped by ``key_fn`` (default
    :func:`stack_key`), groups in first-appearance order, indices
    ascending — the grouping entry of the stacked sweep driver below (and,
    in the reference, of the shard partitioner in ``repro.core.parallel``,
    so grouping semantics cannot diverge between the two)."""
    groups: "OrderedDict[object, List[int]]" = OrderedDict()
    for i, cfg in enumerate(configs):
        groups.setdefault(key_fn(cfg), []).append(i)
    return list(groups.values())


def run_scenarios_stacked(cfgs: Sequence[ScenarioConfig], data: Dataset,
                          device="cuda") -> List[ScenarioResult]:
    """Run several scenario replicas in lockstep — one dispatch set per
    window for the whole group.

    The replicas may differ in seed and in any host-side field (tech,
    p_edge, uniform, aggregate, n_subsample, Zipf/Poisson parameters, EMA
    rate — see :func:`_stack_key`). Each window, every replica collects its
    own data (own rng stream, own energy ledger) and the learning rounds
    stack into the flat fleet DC axis
    (:func:`repro_torch.core.fleet.run_window_a2a_stacked` /
    ``_star_stacked``),
    so the group costs O(sample buckets) dispatches per window instead of
    O(replicas). Results match sequential :func:`run_scenario` runs
    replica-for-replica (ledgers exactly, F1 curves to the engine-parity
    tolerance; tests/test_torch_scenario.py).
    """
    resolve_device(device)
    cfg0 = cfgs[0]
    for c in cfgs:
        validate_config(c)
    if any(_stack_key(c) != _stack_key(cfg0) for c in cfgs):
        raise ValueError("run_scenarios_stacked needs configs that agree "
                         "on every non-host-side field (see _stack_key)")
    if cfg0.engine != "fleet" or cfg0.algo not in ("a2a", "star"):
        return [run_scenario(c, data, device) for c in cfgs]
    run_stacked = {"a2a": fleet_engine.run_window_a2a_stacked,
                   "star": fleet_engine.run_window_star_stacked}[cfg0.algo]

    S = len(cfgs)
    rngs = [np.random.default_rng(c.seed) for c in cfgs]
    ledgers = [Ledger() for _ in cfgs]
    techs = [c.tech for c in cfgs]
    n_subsamples = [c.n_subsample for c in cfgs]
    robusts = [resolve_robust(c.robust_agg) for c in cfgs]
    churns = [None if c.battery_mj is None else ChurnBook(c.battery_mj)
              for c in cfgs]
    streams = [build_stream(c, data, rng) for c, rng in zip(cfgs, rngs)]

    curves: List[List[float]] = [[] for _ in cfgs]
    prevs: List[Optional[np.ndarray]] = [None] * S
    for t in range(cfg0.windows):
        sl = slice(t * cfg0.obs_per_window, (t + 1) * cfg0.obs_per_window)
        fleets = []
        for s in range(S):
            dcs = collect_window(cfgs[s], rngs[s], streams[s][0][sl],
                                 streams[s][1][sl], ledgers[s],
                                 window=t, churn=churns[s])
            if cfgs[s].aggregate:
                dcs = apply_aggregation_heuristic(dcs, ledgers[s], techs[s])
            fleets.append(dcs)
        news = run_stacked(fleets, prevs, ledgers, techs, cap=cfg0.cap,
                           num_classes=NUM_CLASSES,
                           n_subsamples=n_subsamples, rngs=rngs,
                           robusts=robusts, device=device)
        # a replica whose fleet churned away keeps its model as-is (the
        # sequential driver skips the round; EMA-ing prev with itself is
        # NOT a bitwise no-op, so the skip must match exactly)
        prevs = [prevs[s] if not fleets[s]
                 else update_global(cfgs[s], prevs[s], news[s])
                 for s in range(S)]
        if (t + 1) % cfg0.eval_every == 0:
            for s in range(S):
                curves[s].append(_eval(prevs[s], data, device))
    return [ScenarioResult(curves[s], ledgers[s], cfgs[s]) for s in range(S)]


def run_sweep(configs: Sequence[ScenarioConfig], data: Dataset, *,
              stack_seeds: bool = False,
              device="cuda") -> List[ScenarioResult]:
    """Evaluate many scenario configurations over the same dataset.

    New code should build a declarative
    :class:`repro_torch.core.experiment.SweepSpec` and call
    ``spec.run(data, stack="auto")``, which routes through this function.

    ``stack_seeds=True`` groups stack-compatible configs (equal
    :func:`_stack_key`: same algo/engine/windows/cap, any mix of seeds and
    host-side fields) and runs each group through
    :func:`run_scenarios_stacked` — O(sample buckets) dispatches per window
    for the whole group; other configs — and the default — run
    sequentially. Result order always matches ``configs``.
    """
    resolve_device(device)
    if not stack_seeds:
        return [run_scenario(cfg, data, device) for cfg in configs]
    results: List[Optional[ScenarioResult]] = [None] * len(configs)
    for idxs in stack_groups(configs):
        grp = [configs[i] for i in idxs]
        key = stack_key(grp[0])
        if (len(grp) == 1 or key.engine != "fleet"
                or key.algo not in ("a2a", "star")):
            rs = [run_scenario(c, data, device) for c in grp]
        else:
            rs = run_scenarios_stacked(grp, data, device)
        for i, r in zip(idxs, rs):
            results[i] = r
    return results
