"""Whole-scenario engines: the scan engine and the city engine.

Port of ``repro.core.cityscan``. Both engines collapse a scenario into a
program that runs one window per step over tensors that stay on the device
(the fleet engine of :mod:`repro_torch.core.fleet` drives each window from
Python and round-trips fleet state host<->device per window):

**Scan engine** (``engine="scan"``, :func:`run_scenario_scan`). A host-side
*planner* replays the scenario's host work exactly as the fleet engine
would — same rng consumption order (collection, then GreedyTL
subsampling), same ledger events in the same order, same AP/center
election and single-DC early exits — and packs every window's padded fleet
blocks into ``(W, ...)`` arrays (the planner is the reference's numpy code,
so the packed plan is byte-equal to the reference's). The plan goes to the
device once; the window body — base training -> GreedyTL refine -> A2A
combine or single-DC rule -> EMA -> streamed eval — then updates a carried
fleet state ``(w_global, has_global)`` and writes one integer confusion
matrix per window (exact in float32: counts < 2^24), from which the host
recovers the paper's F1 (:func:`repro_torch.core.metrics.
f_measure_from_confusion`). Ledgers are host-replayed and therefore
exactly equal to the fleet engine's; models agree to float32 roundoff
(the scan engine pads every window to one ``(L, cap, rcap)`` layout, so
its products sum over other shapes than the fleet engine's buckets).

**City engine** (``engine="scan"`` + ``fleet_size``, :func:`run_city`).
The smart-city scenario: a StarHTL fleet of ``fleet_size`` DCs, each
drawing ``obs_per_dc`` observations per window on the device, with the DC
axis batched on one device. Cross-DC combination is exact: one-hot
reductions for the source pool and the center dataset, first-max argmax
for the entropy election. Energy is charged analytically — O(1) ledger
events per window. Sharding the DC axis over several GPUs (the reference's
``shard_map``) is not ported: ``max_shards`` > 1 raises.

**How a window runs.** The reference compiles the scenario into one jitted
``lax.scan``. Here the window body is a function of static tensors — the
packed plan (or the city's train stream and death schedule), the carry, a
device window index the body advances itself, and the per-window outputs —
and the tensors' device decides how it runs, as it does for the kernels:

* on the card the body is captured once into a ``torch.cuda.CUDAGraph``
  (after one warm-up run on a side stream, which sets up the cuBLAS and
  cuSOLVER handles and workspaces, as PyTorch's graph documentation asks)
  and each window is one replay of that graph; the graph launches the
  ``loo_trials_step`` kernel at every greedy step. The host syncs once, at
  the end of the scenario. Graphs are cached per block shape, as the
  reference's ``lru_cache``d programs are (LRU-bounded here: a graph holds
  its plan buffers and its memory pool);
* on the CPU the same body runs eagerly, window by window.

**Programs are not reentrant.** A reference program is a pure jitted
function; a program here owns mutable static tensors (plan, carry, window
index, outputs) and, on the card, one graph over them, shared by every
caller whose shapes and device match. Each run therefore holds the
program's lock from the upload to the read-back, so scenarios of one
shape run from several threads (the devices executor of the scenario
module's sweeps) take turns on it, and scenarios of different shapes run
side by side. Graphs are captured in ``thread_local`` error mode, so
another thread's allocations do not break a capture.

Nothing in the body syncs the host: no ``.item()``, no Python branch on a
tensor value, no boolean-mask indexing; windows are selected by
``index_select`` on the device index. The kernel wrappers' Python launch
counters see a graph's launches once, at capture: :func:`graph_stats`
counts replays and the launches they make (captured per window × replays).

**The city draw.** The reference draws each DC's observations with
``jax.random.fold_in``/``randint`` (threefry), which torch cannot cheaply
reproduce. The draw here is injectable — a callable ``(t, gid) -> (L, K)``
train-stream indices on the device — and the default,
:func:`hash_draw`, is a counter-based integer hash of (seed, window, DC
id, sample): a different stream from the reference's, with the same
property that a DC's draw does not depend on how the DC axis is laid out.
:func:`table_draw` replays fixed indices (the tests inject the
reference's).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import htl
from repro_torch.core.dispatch import count_dispatch
from repro_torch.core.energy import (INDEX_BYTES, Ledger, MODEL_BYTES,
                                     OBS_BYTES)
from repro_torch.core.fleet import fleet_cap
from repro_torch.core.greedytl import _greedytl
from repro_torch.core.htl import DC, M_CAP, apply_aggregation_heuristic
from repro_torch.core.metrics import f_measure_from_confusion
from repro_torch.core.svm import _train_svm, pad_local, sample_cap
from repro_torch.core.topology import (Node, Topology, fleet_nodes,
                                       get_transport)
from repro_torch.data.synthetic_covtype import Dataset, NUM_CLASSES
from repro_torch.kernels import loo_trials as kernel

CITY_SHARDS_NOT_PORTED = (
    "run_city(max_shards={}): sharding the city's DC axis over several GPUs "
    "(the reference's all_gather/psum election and pool, dc_shards/"
    "fleet_mesh) is not ported yet: ROADMAP.md Queue 1 item 11 (multi-GPU "
    "city sharding)")

# Captured programs kept at once (each holds its graph, its memory pool and
# its static buffers; the paper grid at 30 windows needs about ten).
MAX_PROGRAMS = 16


# ---------------------------------------------------------------------------
# shared eval plumbing: device test arrays come from the scenario module's
# EvalCache (lazy import; scenario.py imports this module lazily too)
# ---------------------------------------------------------------------------

def _eval_arrays(data: Dataset, device):
    from repro_torch.core.scenario import _eval_cache
    x_test = _eval_cache.test_array(data, device)
    y_oh = _eval_cache.array(
        data, "test_onehot",
        lambda d: torch.from_numpy(np.eye(NUM_CLASSES, dtype=np.float32)
                                   [np.asarray(d.y_test, np.int64)]),
        device)
    return x_test, y_oh


def _train_arrays(data: Dataset, device):
    from repro_torch.core.scenario import _eval_cache
    xtr = _eval_cache.array(
        data, "train_x",
        lambda d: torch.from_numpy(d.x_train.astype(np.float32)), device)
    ytr = _eval_cache.array(
        data, "train_y",
        lambda d: torch.from_numpy(d.y_train.astype(np.int32)), device)
    return xtr, ytr


def _f1_curve(cms: np.ndarray, eval_every: int) -> List[float]:
    """Streamed F1: per-window integer confusion counts -> paper F1."""
    out = []
    for t in range(cms.shape[0]):
        if (t + 1) % eval_every == 0:
            out.append(f_measure_from_confusion(cms[t].astype(np.int64)))
    return out


def _window_cm(w, x_test, y_oh, num_classes: int):
    """One window's streamed eval: confusion counts, exact in float32."""
    scores = x_test @ w[:-1] + w[-1]
    pred = torch.nn.functional.one_hot(torch.argmax(scores, dim=-1),
                                       num_classes).to(torch.float32)
    return y_oh.T @ pred


# ---------------------------------------------------------------------------
# programs: a window body over static tensors, captured on the card
# ---------------------------------------------------------------------------

_STATS = {"captures": 0, "capture_s": 0.0, "replays": 0,
          "loo_trials_launches": 0, "loo_trials_step_launches": 0}
_STATS_LOCK = threading.Lock()


def graph_stats() -> dict:
    """Graphs captured (and seconds spent capturing them, warm-up runs
    included), replays, and the ``loo_trials`` kernel launches the replays
    made (``loo_trials_launches`` counts both entry points,
    ``loo_trials_step_launches`` the fused one), since the last reset.
    The launches a replay makes are read from the kernel wrappers'
    counters around the capture, so an eager launch of the kernel from
    another thread during a capture would be counted in."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_graph_stats() -> None:
    with _STATS_LOCK:
        _STATS.update(captures=0, capture_s=0.0, replays=0,
                      loo_trials_launches=0, loo_trials_step_launches=0)


def _add_stats(**inc) -> None:
    with _STATS_LOCK:
        for k, v in inc.items():
            _STATS[k] += v


class _Program:
    """A window body over the static tensors ``state``, on their device.
    :meth:`run` steps it: on the card as replays of a graph captured at
    the first run, on the CPU by calling the body. Not reentrant: a caller
    holds :attr:`lock` from writing ``state`` to reading it back."""

    def __init__(self, state: Dict[str, torch.Tensor],
                 body: Callable[[Dict[str, torch.Tensor]], None],
                 device: torch.device):
        self.state, self.body, self.device = state, body, device
        self.lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        # kernel launches one replay makes, recorded at capture
        self.trial_launches = self.step_launches = 0

    def run(self, windows: int,
            reset: Callable[[Dict[str, torch.Tensor]], None]) -> None:
        """``reset`` the state, then step the body ``windows`` times."""
        reset(self.state)
        if self.device.type != "cuda":
            for _ in range(windows):
                self.body(self.state)
            return
        if self.graph is None:
            self._capture()
            reset(self.state)
        for _ in range(windows):
            self.graph.replay()
        _add_stats(replays=windows,
                   loo_trials_launches=windows * self.trial_launches,
                   loo_trials_step_launches=windows * self.step_launches)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.body(self.state)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        trials, steps = kernel.launches, kernel.step_launches
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.body(self.state)
        self.trial_launches = kernel.launches - trials
        self.step_launches = kernel.step_launches - steps
        self.graph = graph
        _add_stats(captures=1, capture_s=time.perf_counter() - t0)


_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()
_PROGRAMS_LOCK = threading.Lock()


def _cached_program(key: tuple, make: Callable[[], _Program]) -> _Program:
    """The program cached under ``key`` (LRU, :data:`MAX_PROGRAMS`)."""
    with _PROGRAMS_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is None:
            prog = _PROGRAMS[key] = make()
            while len(_PROGRAMS) > MAX_PROGRAMS:
                _PROGRAMS.popitem(last=False)
        _PROGRAMS.move_to_end(key)
        return prog


def _window(s, name):
    """Window ``s["t"]`` of the (W, ...) static tensor ``s[name]``."""
    return s[name].index_select(0, s["t"])[0]


def _reset_carry(s) -> None:
    s["w"].zero_()
    s["has_g"].zero_()
    s["t"].zero_()


# ---------------------------------------------------------------------------
# scan engine: host-replay planner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _WindowPlan:
    live: List[DC]                 # non-empty DCs, fleet-engine order
    refine: List[DC]               # a2a: per-DC subsampled; star: [center]
    n_pool: int = 0                # base models entering the source pool
    prev_slot: int = -1            # pool slot of the previous global model
    single: bool = False


def _plan_scenario(cfg, data: Dataset) -> Tuple[List[_WindowPlan], Ledger]:
    """Replay every window's host-side work exactly as run_scenario with the
    fleet engine would: identical rng consumption order (collection policy,
    then per-DC subsampling), identical ledger events in identical order
    (collection; then per-pair m0 exchange / entropy index / center id /
    gather events through the same Topology patterns), identical AP/center
    election and single-DC early exits. Only the device numerics are left
    for the scan program."""
    from repro_torch.core.scenario import (ChurnBook, build_stream,
                                           collect_window)

    rng = np.random.default_rng(cfg.seed)
    ledger = Ledger()
    # realism axis rides along for free: the (possibly drifted) stream
    # comes from the shared build_stream, churn/byzantine faults happen
    # inside the shared collect_window — a churned-away window becomes an
    # empty plan, masked by the scan program's ``learn`` flag (alive-state
    # masking: shapes never change, dead fleets are zero rows)
    sx, sy = build_stream(cfg, data, rng)
    churn = None if cfg.battery_mj is None else ChurnBook(cfg.battery_mj)

    plans: List[_WindowPlan] = []
    prev_exists = False
    for t in range(cfg.windows):
        s = slice(t * cfg.obs_per_window, (t + 1) * cfg.obs_per_window)
        dcs = collect_window(cfg, rng, sx[s], sy[s], ledger,
                             window=t, churn=churn)
        if cfg.aggregate:
            dcs = apply_aggregation_heuristic(dcs, ledger, cfg.tech)
        live = [d for d in dcs if d.n > 0]
        if not live:
            plans.append(_WindowPlan([], []))
            continue
        if len(live) == 1:
            plans.append(_WindowPlan(live, [], single=True))
            prev_exists = True
            continue
        ap = htl._ap_name(live)
        topo = Topology(ledger, cfg.tech, fleet_nodes(live, ap))
        if cfg.algo == "a2a":
            topo.exchange_all(MODEL_BYTES, what="m0 exchange")
            refine = [htl._subsample(d, cfg.n_subsample, NUM_CLASSES, rng)
                      for d in live]
            center = next((d for d in live if d.name == ap), live[0])
            topo.gather(topo.node(center.name), MODEL_BYTES, what="m1 gather")
        else:
            topo.exchange_all(INDEX_BYTES, what="entropy index")
            c_idx = int(np.argmax([htl.label_entropy(d.y, NUM_CLASSES)
                                   for d in live]))
            center = live[c_idx]
            topo.broadcast(topo.node(center.name), INDEX_BYTES,
                           what="center id")
            topo.gather(topo.node(center.name), MODEL_BYTES,
                        what="m0 to center")
            refine = [htl._subsample(center, cfg.n_subsample, NUM_CLASSES,
                                     rng)]
        n_pool = min(len(live), M_CAP)
        prev_slot = len(live) if (prev_exists and len(live) < M_CAP) else -1
        plans.append(_WindowPlan(live, refine, n_pool, prev_slot))
        prev_exists = True
    return plans, ledger


def _pack_plan(cfg, plans: List[_WindowPlan]) -> dict:
    """Second pass: pad every window onto one stable (W, ...) block layout
    — DC axis at the bucketed fleet capacity, samples at the max bucketed
    sample capacity over all windows — so one scan program serves every
    Poisson draw of the scenario."""
    W = cfg.windows
    F = NUM_CLASSES  # placeholder; fixed below from data
    max_live = max([len(p.live) for p in plans] + [1])
    L = fleet_cap(max_live)
    cap = max([sample_cap(d.n, cfg.cap) for p in plans for d in p.live]
              + [sample_cap(1, cfg.cap)])
    rcap = max([sample_cap(d.n, cfg.cap) for p in plans for d in p.refine]
               + [sample_cap(1, cfg.cap)])
    feats = [d.x.shape[1] for p in plans for d in p.live]
    F = feats[0] if feats else 1

    xb = np.zeros((W, L, cap, F), np.float32)
    yb = np.zeros((W, L, cap), np.int32)
    mb = np.zeros((W, L, cap), np.float32)
    dcm = np.zeros((W, L), np.float32)
    src_base = np.zeros((W, M_CAP), np.float32)
    src_prev = np.zeros((W, M_CAP), np.float32)
    n_live = np.zeros((W,), np.float32)
    learn = np.zeros((W,), bool)
    single = np.zeros((W,), bool)
    if cfg.algo == "a2a":
        xr = np.zeros((W, L, rcap, F), np.float32)
        yr = np.zeros((W, L, rcap), np.int32)
        mr = np.zeros((W, L, rcap), np.float32)
    else:
        xr = np.zeros((W, rcap, F), np.float32)
        yr = np.zeros((W, rcap), np.int32)
        mr = np.zeros((W, rcap), np.float32)

    for t, p in enumerate(plans):
        for i, d in enumerate(p.live):
            xb[t, i], yb[t, i], mb[t, i] = pad_local(d.x, d.y, cap)
            dcm[t, i] = 1.0
        n_live[t] = len(p.live)
        learn[t] = bool(p.live)
        single[t] = p.single
        if p.single or not p.live:
            continue
        src_base[t, :p.n_pool] = 1.0
        if p.prev_slot >= 0:
            src_prev[t, p.prev_slot] = 1.0
        if cfg.algo == "a2a":
            for i, d in enumerate(p.refine):
                xr[t, i], yr[t, i], mr[t, i] = pad_local(d.x, d.y, rcap)
        else:
            xr[t], yr[t], mr[t] = pad_local(p.refine[0].x, p.refine[0].y,
                                            rcap)
    return {"xb": xb, "yb": yb, "mb": mb, "dcm": dcm, "xr": xr, "yr": yr,
            "mr": mr, "src_base": src_base, "src_prev": src_prev,
            "n_live": n_live, "learn": learn, "single": single}


# ---------------------------------------------------------------------------
# scan engine: the window body
# ---------------------------------------------------------------------------

_PLAN_KEYS = ("xb", "yb", "mb", "dcm", "xr", "yr", "mr", "src_base",
              "src_prev", "n_live", "learn", "single")


def _scan_body(s, *, algo: str, num_classes: int, iters: int,
               trim: float) -> None:
    """One window of the scan program over the static tensors ``s``: the
    packed plan (W, ...), the carry ``w``/``has_g``, ``eta``, the test
    arrays, the window index ``t`` (advanced here) and the confusion
    buffer ``cms`` (W, C, C). ``trim`` > 0 swaps the A2A combine for the
    coordinate-wise trimmed mean (robust_agg="trim:frac=...")."""
    inp = {k: _window(s, k) for k in _PLAN_KEYS}
    w, has_g, eta = s["w"], s["has_g"], s["eta"]
    base = _train_svm(inp["xb"], inp["yb"], inp["mb"],
                      num_classes=num_classes, iters=iters)   # (L, F+1, C)
    L = base.shape[0]
    basep = (base[:M_CAP] if L >= M_CAP else torch.cat(
        [base, base.new_zeros((M_CAP - L,) + base.shape[1:])]))
    # masked pool build is exact: x + 0 == x bitwise
    src = (basep * inp["src_base"][:, None, None]
           + w[None] * inp["src_prev"][:, None, None])
    src_mask = inp["src_base"] + inp["src_prev"]
    if algo == "a2a":
        # the reference lax.maps _greedytl over DCs; one batched call over
        # the fleet axis, every DC against the same pool
        refined = _greedytl(inp["xr"], inp["yr"], inp["mr"],
                            src.expand(L, *src.shape),
                            src_mask.expand(L, M_CAP),
                            num_classes=num_classes)[0]       # (L, F+1, C)
        nl = torch.clamp(inp["n_live"], min=1.0)
        if trim > 0.0:
            # trimmed-mean combine over the LIVE rows only: dead and
            # padding rows are pushed past every finite value so the sort
            # stacks them at the top, then the kept band [k, n_live - k)
            # is averaged — the device analogue of metrics.trimmed_mean
            vals = torch.where(inp["dcm"][:, None, None] > 0, refined,
                               3.4e38)
            srt = torch.sort(vals, dim=0).values
            k = torch.floor(trim * nl)
            pos = torch.arange(L, dtype=torch.float32, device=w.device)
            keep = ((pos >= k) & (pos < nl - k)).to(torch.float32)
            multi_new = (torch.einsum("l,lfc->fc", keep, srt)
                         / torch.clamp(nl - 2.0 * k, min=1.0))
        else:
            multi_new = torch.einsum("l,lfc->fc", inp["dcm"], refined) / nl
    else:
        multi_new = _greedytl(inp["xr"][None], inp["yr"][None],
                              inp["mr"][None], src[None], src_mask[None],
                              num_classes=num_classes)[0][0]
    single_new = torch.where(has_g, 0.5 * (base[0] + w), base[0])
    new = torch.where(inp["single"], single_new, multi_new)
    upd = torch.where(has_g, (1.0 - eta) * w + eta * new, new)
    w2 = torch.where(inp["learn"], upd, w)
    cm = _window_cm(w2, s["x_test"], s["y_oh"], num_classes)
    has_g.logical_or_(inp["learn"])
    w.copy_(w2)
    s["cms"].index_copy_(0, s["t"], cm[None])
    s["t"].add_(1)


def _scan_program(algo: str, num_classes: int, iters: int, trim: float,
                  plan: Dict[str, np.ndarray], n_test: int,
                  device: torch.device) -> _Program:
    """The scan program for ``plan``'s block shapes (W, L, cap, rcap, F),
    cached per (algo, iters, trim, shapes, test size, device): a Poisson
    sweep lands on a handful of bucketed shapes."""
    key = ("scan", algo, num_classes, iters, trim, n_test, str(device),
           tuple((k, plan[k].shape, plan[k].dtype.str) for k in _PLAN_KEYS))

    def make():
        F = plan["xb"].shape[-1]
        W = plan["xb"].shape[0]
        s = {k: torch.empty(plan[k].shape,
                            dtype=torch.from_numpy(plan[k][:0]).dtype,
                            device=device) for k in _PLAN_KEYS}
        s.update(
            w=torch.zeros((F + 1, num_classes), dtype=torch.float32,
                          device=device),
            has_g=torch.zeros((), dtype=torch.bool, device=device),
            eta=torch.zeros((), dtype=torch.float32, device=device),
            t=torch.zeros((1,), dtype=torch.int64, device=device),
            cms=torch.zeros((W, num_classes, num_classes),
                            dtype=torch.float32, device=device),
            x_test=torch.empty((n_test, F), dtype=torch.float32,
                               device=device),
            y_oh=torch.empty((n_test, num_classes), dtype=torch.float32,
                             device=device))

        def body(state):
            _scan_body(state, algo=algo, num_classes=num_classes,
                       iters=iters, trim=trim)
        return _Program(s, body, device)

    return _cached_program(key, make)


@count_dispatch("scan_windows")
def _dispatch_scan(program: _Program, plan: Dict[str, np.ndarray], eta,
                   x_test, y_oh) -> np.ndarray:
    """The whole scenario: the plan and the test arrays to the device once,
    one step per window, one host sync for the confusion counts."""
    s = program.state
    with program.lock:
        for k in _PLAN_KEYS:
            s[k].copy_(torch.from_numpy(plan[k]))
        s["x_test"].copy_(x_test)
        s["y_oh"].copy_(y_oh)
        s["eta"].fill_(eta)
        program.run(plan["xb"].shape[0], _reset_carry)
        return s["cms"].cpu().numpy()


def run_scenario_scan(cfg, data: Dataset, device="cuda"):
    """The whole scenario as one program on ``device`` (parity path of the
    scan engine — ledgers exactly equal to the fleet engine's, F1 through
    the streamed confusion counts)."""
    from repro_torch.core.scenario import ScenarioResult, resolve_robust

    dev = resolve_device(device)
    plans, ledger = _plan_scenario(cfg, data)
    plan = _pack_plan(cfg, plans)
    x_test, y_oh = _eval_arrays(data, dev)
    program = _scan_program(cfg.algo, NUM_CLASSES, cfg.train_iters,
                            resolve_robust(cfg.robust_agg), plan,
                            x_test.shape[0], dev)
    cms = _dispatch_scan(program, plan, cfg.global_update_rate, x_test,
                         y_oh)
    return ScenarioResult(_f1_curve(cms, cfg.eval_every), ledger, cfg)


# ---------------------------------------------------------------------------
# city engine: StarHTL over a device-resident fleet, DC axis on one device
# ---------------------------------------------------------------------------

def city_fleet_pad(fleet_size: int) -> int:
    """Padded city DC capacity: the fleet engine's bucket policy
    (multiples of 32 beyond 16 DCs)."""
    return fleet_cap(fleet_size)


def _city_round(w, has_g, x, y, m, alive, gid, l0, eta, x_test, y_oh, *,
                num_classes: int, iters: int):
    """One city StarHTL round. ``x``/``y``/``m`` are this window's per-DC
    datasets (L, K, ·), ``gid`` the DC ids, ``alive`` the churn-aware
    membership mask (valid AND battery not yet depleted). All cross-DC
    combination is an exact one-hot reduction (source pool, center
    dataset) or a first-max argmax (entropy election, lowest DC id on a
    tie). Returns ``(w2, cm, cg, do)`` where ``cg`` (1,) is the center's
    id and ``do`` flags whether a learning round ran (>= 2 DCs alive; a
    churned-to-nothing fleet keeps ``w`` untouched)."""
    f32 = torch.float32
    K = x.shape[1]
    base = _train_svm(x, y, m, num_classes=num_classes, iters=iters)

    # entropy-based center election (paper Sec. 4); the class terms are
    # added in class order, so DCs whose histograms are permutations of
    # each other tie exactly and the first of them wins
    cnt = torch.sum(torch.nn.functional.one_hot(y.long(), num_classes)
                    .to(f32) * m[:, :, None], dim=1)             # (L, C)
    tot = torch.clamp(torch.sum(cnt, dim=1), min=1.0)
    p = cnt / tot[:, None]
    terms = torch.where(p > 0, p * torch.log(p), 0.0)
    ent = terms[:, 0]
    for c in range(1, num_classes):
        ent = ent + terms[:, c]
    ent = -ent / float(np.log(np.float32(num_classes)))   # float32 log
    ent = torch.where(alive, ent, -1.0)
    cg = gid.index_select(0, torch.argmax(ent).reshape(1))       # (1,)
    n_alive = torch.sum(alive.to(f32))

    # source pool: base models of the first min(L0, M_CAP) *alive* DCs'
    # slots, gathered by exact one-hot reduction (x + 0 == x bitwise); the
    # mask is the same one-hot reduced, so dead DCs' slots leave the pool
    slot = torch.arange(M_CAP, dtype=gid.dtype, device=gid.device)
    oh = ((gid[:, None] == slot[None, :]) & (slot[None, :] < l0)
          & alive[:, None]).to(f32)
    src = torch.einsum("lm,lfc->mfc", oh, base)
    src_mask = torch.sum(oh, dim=0)

    # center's local dataset, same exact one-hot reduction
    coh = (gid == cg).to(f32)
    cx = torch.einsum("l,lkf->kf", coh, x)
    cy = torch.einsum("l,lk->k", coh, y.to(f32))

    refined = _greedytl(cx[None], cy.to(torch.int32)[None],
                        torch.ones((1, K), dtype=f32, device=x.device),
                        src[None], src_mask[None],
                        num_classes=num_classes)[0][0]
    do = n_alive >= 2.0
    upd = torch.where(has_g, (1.0 - eta) * w + eta * refined, refined)
    w2 = torch.where(do, upd, w)
    cm = _window_cm(w2, x_test, y_oh, num_classes)
    return w2, cm, cg, do


_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B


def _mix32(x):
    """A bijective 32-bit integer mix on int64 tensors in [0, 2^32): every
    product stays below 2^59, so nothing overflows."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def hash_draw(seed, n_train: int, obs_per_dc: int):
    """The city's default draw: a callable ``(t, gid) -> (L, K)`` indices
    into the train stream, a counter-based hash of (seed, window ``t``, DC
    id, sample k) reduced to [0, n_train). ``seed`` and ``t`` may be device
    tensors; no generator state, so it runs inside a captured graph, and a
    DC's draw depends on its id only. A different stream from the
    reference's threefry ``fold_in``/``randint``."""
    def draw(t, gid):
        k = torch.arange(obs_per_dc, dtype=torch.int64, device=gid.device)
        h = _mix32(_mix32(torch.as_tensor(seed, device=gid.device) & _M32)
                   ^ t)
        h = _mix32(h ^ gid)
        return _mix32(h[:, None] ^ k[None, :]) % n_train
    return draw


def table_draw(indices):
    """A draw that replays fixed train-stream indices ``(W, L, K)`` (a
    tensor on the run's device): window ``t`` reads row ``t``."""
    def draw(t, gid):
        return indices.index_select(0, t)[0]
    return draw


def _draw_window(xtr, ytr, draw, t, gid, validf, obs_per_dc: int):
    """Device-side collection: ``obs_per_dc`` draws from the train stream
    per DC, indices from ``draw(t, gid)``."""
    idx = draw(t, gid)
    L = gid.shape[0]
    if tuple(idx.shape) != (L, obs_per_dc):
        raise ValueError(f"a city draw gives (L, K) = {(L, obs_per_dc)} "
                         f"indices, got {tuple(idx.shape)}")
    flat = idx.reshape(-1)
    x = xtr.index_select(0, flat).view(L, obs_per_dc, xtr.shape[1])
    y = ytr.index_select(0, flat).view(L, obs_per_dc)
    m = torch.ones((L, obs_per_dc), dtype=torch.float32,
                   device=gid.device) * validf[:, None]
    return x, y, m


def _city_body(s, *, draw, num_classes: int, iters: int,
               obs_per_dc: int) -> None:
    """One city window over the static tensors ``s``: collection,
    training, election, refine, EMA and streamed eval on the device; the
    window's center id goes to ``s["centers"]``."""
    t, gid = s["t"], s["gid"]
    alive = (gid < s["l0"]) & (t < s["t_die"])
    x, y, m = _draw_window(s["xtr"], s["ytr"], draw, t, gid,
                           alive.to(torch.float32), obs_per_dc)
    w2, cm, cg, do = _city_round(
        s["w"], s["has_g"], x, y, m, alive, gid, s["l0"], s["eta"],
        s["x_test"], s["y_oh"], num_classes=num_classes, iters=iters)
    s["has_g"].logical_or_(do)
    s["w"].copy_(w2)
    s["cms"].index_copy_(0, t, cm[None])
    s["centers"].index_copy_(0, t, cg)
    t.add_(1)


def _city_program(W: int, L: int, K: int, num_classes: int, iters: int,
                  train_shape, n_test: int, device: torch.device,
                  draw=None) -> _Program:
    """The city program: one window per step, per-window buffers in the
    graph's pool, so peak memory does not grow with W. Cached per shape
    with the default draw (:func:`hash_draw` on the static ``seed``); an
    injected draw gets a program of its own."""
    def make():
        n_train, F = train_shape
        i64, f32 = torch.int64, torch.float32
        s = dict(
            xtr=torch.empty((n_train, F), dtype=f32, device=device),
            ytr=torch.empty((n_train,), dtype=torch.int32, device=device),
            x_test=torch.empty((n_test, F), dtype=f32, device=device),
            y_oh=torch.empty((n_test, num_classes), dtype=f32,
                             device=device),
            gid=torch.arange(L, dtype=i64, device=device),
            t_die=torch.empty((L,), dtype=i64, device=device),
            l0=torch.zeros((), dtype=i64, device=device),
            seed=torch.zeros((), dtype=i64, device=device),
            eta=torch.zeros((), dtype=f32, device=device),
            w=torch.zeros((F + 1, num_classes), dtype=f32, device=device),
            has_g=torch.zeros((), dtype=torch.bool, device=device),
            t=torch.zeros((1,), dtype=i64, device=device),
            cms=torch.zeros((W, num_classes, num_classes), dtype=f32,
                            device=device),
            centers=torch.zeros((W,), dtype=i64, device=device))
        d = draw if draw is not None else hash_draw(s["seed"], n_train, K)

        def body(state):
            _city_body(state, draw=d, num_classes=num_classes, iters=iters,
                       obs_per_dc=K)
        return _Program(s, body, device)

    if draw is not None:
        return make()
    key = ("city", W, L, K, num_classes, iters, tuple(train_shape), n_test,
           str(device))
    return _cached_program(key, make)


@count_dispatch("city_scan")
def _dispatch_city(program: _Program, inputs: Dict[str, object],
                   windows: int):
    """The whole city run: ``inputs`` (static tensor name -> tensor,
    array or number) into the program's state, one step per window, one
    host sync for the confusion counts and the center ids."""
    s = program.state
    with program.lock:
        for k, v in inputs.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                s[k].copy_(torch.as_tensor(v))
            else:
                s[k].fill_(v)
        program.run(windows, _reset_carry)
        return s["cms"].cpu().numpy(), s["centers"].cpu().numpy()


def _charge_city_collection(ledger: Ledger, fleet_size: int,
                            obs_per_dc: int) -> None:
    """One aggregate collection event per window: every DC collects
    ``obs_per_dc`` observations over 802.15.4 (1 tx + 1 rx each), charged
    as event counts so the total equals ``fleet_size`` separate
    ``collect_to_mule`` events."""
    ledger.add("802.15.4", obs_per_dc * OBS_BYTES, purpose="collection",
               n_tx=fleet_size, n_rx=fleet_size, what="sensor->SM (city)")


def _charge_city_learning(ledger: Ledger, tech: str, fleet_size: int,
                          center_is_ap: bool) -> None:
    """Analytic StarHTL learning charge for one window: the loop/fleet
    engines iterate Topology patterns over L(L-1) ordered pairs; at city
    scale we evaluate the transport's per-role-pair (tx, rx) counts on
    three representative nodes and multiply by the pair multiplicities —
    O(1) ledger events per window, totals equal to the pairwise sum."""
    L = fleet_size
    counts = get_transport(tech).counts
    ap, m1, m2 = Node("AP", is_ap=True), Node("SM1"), Node("SM2")

    def add(nbytes, what, pairs):
        tx = rx = 0
        for mult, src, dst in pairs:
            a, b = counts(src, dst)
            tx += mult * a
            rx += mult * b
        ledger.add(tech, nbytes, purpose="learning", n_tx=tx, n_rx=rx,
                   what=what)

    # entropy index exchange: every ordered pair
    add(INDEX_BYTES, "entropy index",
        [(L - 1, ap, m1), (L - 1, m1, ap), ((L - 1) * (L - 2), m1, m2)])
    if center_is_ap:
        add(INDEX_BYTES, "center id", [(L - 1, ap, m1)])
        add(MODEL_BYTES, "m0 to center", [(L - 1, m1, ap)])
    else:
        add(INDEX_BYTES, "center id", [(1, m1, ap), (L - 2, m1, m2)])
        add(MODEL_BYTES, "m0 to center", [(1, ap, m1), (L - 2, m2, m1)])


def _city_death_schedule(cfg, L0: int, L: int) -> np.ndarray:
    """Per-DC death windows of the city churn model (DC ``i`` is alive for
    windows ``t < t_die[i]``; ``windows`` everywhere = nobody ever dies).

    Batteries are heterogeneous — ``battery_mj * (0.5 + U[0, 1))`` per DC
    from a dedicated seeded stream, so depletion staggers instead of the
    whole fleet dying at once — and drain per window is the analytic
    per-DC share of the city charging model (collection rx + learning
    total / L0), evaluated once up front. The schedule is therefore a
    deterministic function of (seed, battery_mj, tech, fleet shape) — the
    device side only ever sees the precomputed ``t_die`` array."""
    W = cfg.windows
    t_die = np.full((L,), W, np.int32)
    if cfg.battery_mj is None:
        return t_die
    from repro_torch.core.energy import resolve_tech
    drng = np.random.default_rng([int(cfg.seed), 0xC17B])
    batt = cfg.battery_mj * (0.5 + drng.random(L0))
    tmp = Ledger()
    _charge_city_learning(tmp, cfg.tech, L0, center_is_ap=False)
    e_w = (resolve_tech("802.15.4").rx_mj(cfg.obs_per_dc * OBS_BYTES)
           + tmp.total() / L0)
    t_die[:L0] = np.minimum(W, np.ceil(batt / e_w)).astype(np.int32)
    return t_die


def _city_outputs(cfg, data: Dataset, *, draw=None, device="cuda"):
    """The city scenario's device outputs: per-window confusion counts
    (W, C, C), center ids (W,), and the death schedule they ran under."""
    dev = resolve_device(device)
    L0, K, W = cfg.fleet_size, cfg.obs_per_dc, cfg.windows
    L = city_fleet_pad(L0)
    xtr, ytr = _train_arrays(data, dev)
    x_test, y_oh = _eval_arrays(data, dev)
    t_die = _city_death_schedule(cfg, L0, L)
    program = _city_program(W, L, K, NUM_CLASSES, cfg.train_iters,
                            tuple(xtr.shape), x_test.shape[0], dev, draw)
    cms, centers = _dispatch_city(program, dict(
        xtr=xtr, ytr=ytr, x_test=x_test, y_oh=y_oh, t_die=t_die, l0=L0,
        seed=int(cfg.seed), eta=cfg.global_update_rate), W)
    return cms, centers, t_die


def run_city(cfg, data: Dataset, *, max_shards: Optional[int] = None,
             draw=None, device="cuda"):
    """The city scenario: ``cfg.fleet_size`` DCs, ``cfg.obs_per_dc``
    observations each per window, StarHTL, one program for the whole run
    on ``device``. ``max_shards`` None or 1 keeps the DC axis on one
    device (larger raises :class:`NotImplementedError`); ``draw`` replaces
    the default :func:`hash_draw` (see the module doc)."""
    from repro_torch.core.scenario import ScenarioResult

    if max_shards is not None and max_shards > 1:
        raise NotImplementedError(CITY_SHARDS_NOT_PORTED.format(max_shards))
    cms, centers, t_die = _city_outputs(cfg, data, draw=draw, device=device)
    L0, K = cfg.fleet_size, cfg.obs_per_dc
    ledger = Ledger()
    for t in range(cfg.windows):
        alive = t < t_die[:L0]
        n_alive = int(alive.sum())
        if n_alive > 0:
            _charge_city_collection(ledger, n_alive, K)
        if n_alive >= 2:
            # the analytic AP role falls to the lowest-gid alive DC
            ap_gid = int(np.argmax(alive))
            _charge_city_learning(ledger, cfg.tech, n_alive,
                                  center_is_ap=(int(centers[t]) == ap_gid))
    return ScenarioResult(_f1_curve(cms, cfg.eval_every), ledger, cfg)


# ---------------------------------------------------------------------------
# per-window city reference: host-driven loop, one program step + one host
# sync per window, host-side collection shipped to the device every window
# — the pre-scan execution pattern, kept as the benchmark comparator
# ---------------------------------------------------------------------------

def _city_round_program(num_classes: int, iters: int, L: int, K: int,
                        F: int, n_test: int, device) -> _Program:
    """One city round as a program: inputs copied into its static tensors
    by the caller, outputs ``w2``, ``cm``, ``cg``, ``do`` read back."""
    def make():
        f32 = torch.float32
        s = dict(
            w=torch.zeros((F + 1, num_classes), dtype=f32, device=device),
            has_g=torch.zeros((), dtype=torch.bool, device=device),
            x=torch.zeros((L, K, F), dtype=f32, device=device),
            y=torch.zeros((L, K), dtype=torch.int32, device=device),
            m=torch.zeros((L, K), dtype=f32, device=device),
            alive=torch.zeros((L,), dtype=torch.bool, device=device),
            gid=torch.arange(L, dtype=torch.int64, device=device),
            l0=torch.zeros((), dtype=torch.int64, device=device),
            eta=torch.zeros((), dtype=f32, device=device),
            x_test=torch.empty((n_test, F), dtype=f32, device=device),
            y_oh=torch.empty((n_test, num_classes), dtype=f32,
                             device=device),
            w2=torch.zeros((F + 1, num_classes), dtype=f32, device=device),
            cm=torch.zeros((num_classes, num_classes), dtype=f32,
                           device=device),
            cg=torch.zeros((1,), dtype=torch.int64, device=device),
            do=torch.zeros((), dtype=torch.bool, device=device))

        def body(st):
            outs = _city_round(st["w"], st["has_g"], st["x"], st["y"],
                               st["m"], st["alive"], st["gid"], st["l0"],
                               st["eta"], st["x_test"], st["y_oh"],
                               num_classes=num_classes, iters=iters)
            for name, v in zip(("w2", "cm", "cg", "do"), outs):
                st[name].copy_(v)
        return _Program(s, body, device)

    return _cached_program(("round", num_classes, iters, L, K, F, n_test,
                            str(device)), make)


def run_city_perwindow(cfg, data: Dataset, device="cuda"):
    """City scenario on the per-window pattern: every window the host draws
    the fleet's observations, packs and uploads them, runs one round and
    syncs the global model back — wall-clock scales with ``windows x
    fleet data volume`` where :func:`run_city` syncs once. Draws with
    numpy, as the reference does, so its indices are the reference's."""
    from repro_torch.core.scenario import ScenarioResult

    dev = resolve_device(device)
    L0, K, W = cfg.fleet_size, cfg.obs_per_dc, cfg.windows
    L = city_fleet_pad(L0)
    rng = np.random.default_rng(cfg.seed)
    xtr_host = data.x_train.astype(np.float32)
    ytr_host = data.y_train.astype(np.int32)
    x_test, y_oh = _eval_arrays(data, dev)
    valid_host = np.arange(L) < L0
    t_die = _city_death_schedule(cfg, L0, L)
    program = _city_round_program(NUM_CLASSES, cfg.train_iters, L, K,
                                  xtr_host.shape[1], x_test.shape[0], dev)
    with program.lock:
        s = program.state
        s["x_test"].copy_(x_test)
        s["y_oh"].copy_(y_oh)
        s["l0"].fill_(L0)
        s["eta"].fill_(cfg.global_update_rate)

        ledger = Ledger()
        w = np.zeros((xtr_host.shape[1] + 1, NUM_CLASSES), np.float32)
        has_g = False
        cms = np.zeros((W, NUM_CLASSES, NUM_CLASSES), np.float32)
        for t in range(W):
            alive_host = valid_host & (t < t_die)
            m_host = np.broadcast_to(alive_host[:, None], (L, K)
                                     ).astype(np.float32).copy()
            idx = rng.integers(0, len(ytr_host), size=(L, K))
            # host gather, uploaded fresh
            for name, a in (("w", w), ("has_g", np.asarray(has_g)),
                            ("x", xtr_host[idx]), ("y", ytr_host[idx]),
                            ("m", m_host), ("alive", alive_host)):
                s[name].copy_(torch.from_numpy(a))
            program.run(1, lambda st: None)
            w = s["w2"].cpu().numpy()                  # per-window host sync
            has_g = bool(has_g or bool(s["do"].cpu()))
            cms[t] = s["cm"].cpu().numpy()
            n_alive = int(alive_host.sum())
            if n_alive > 0:
                _charge_city_collection(ledger, n_alive, K)
            if n_alive >= 2:
                ap_gid = int(np.argmax(alive_host))
                _charge_city_learning(ledger, cfg.tech, n_alive,
                                      center_is_ap=(int(s["cg"].cpu()[0])
                                                    == ap_gid))
    return ScenarioResult(_f1_curve(cms, cfg.eval_every), ledger, cfg)
