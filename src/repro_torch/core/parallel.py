"""Device-/process-sharded sweep execution with bitwise-parity guarantees.

Port of ``repro.core.parallel``. A parallel run must be *JSON-identical*
to the sequential run, so parallelism can never change a published table:

* :func:`partition_runs` — the reference's deterministic partitioner over
  ``SweepSpec.configs()`` rows (copied verbatim): rows are grouped by
  :func:`repro_torch.core.scenario.stack_key` (groups are **never split**
  across shards, so every shard keeps its replica-stacking wins), each
  group is costed at ``windows x replicas`` and placed greedy-LPT onto
  the least-loaded shard, in (cost, canonical key) order, so the
  partition is invariant to row permutations.
* executors behind the spec-string grammar of
  :mod:`repro_torch.core.registry` (``get_executor("devices:n=2")``):

  - ``none`` — the sequential ``run_sweep``;
  - ``devices`` — one thread per shard (at most one per card), shard
    ``k`` on ``cuda:{k % torch.cuda.device_count()}``; with
    ``device="cpu"`` every shard runs on the CPU, in one thread;
  - ``processes`` — a spawn-based pool runs whole shards and ships each
    shard's ``SweepResult`` back as JSON text; worker ``k`` of the pool
    runs on ``cuda:{k % count}`` (or on the CPU). Tasks are host-only
    (:func:`assert_host_only`): numpy, never a ``torch.Tensor``;
  - ``hosts`` — the multi-host launcher (:mod:`repro_torch.core.launcher`).

The device is an argument of ``execute``/``execute_with_meta``, never part
of the spec string, so the cached executors serve every device. Every
backend runs each group through the same stacked engines in the same
within-group order as ``parallel="none"``, so results are bitwise
identical, not merely close. No backend falls back: a failed worker fails
the run.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.dispatch import dispatch_counts, merge_dispatch_counts
from repro_torch.core.registry import register_factory, resolve_spec
from repro_torch.core.scenario import (ScenarioConfig, ScenarioResult,
                                       run_sweep, stack_groups, stack_key)
from repro_torch.data.synthetic_covtype import Dataset


# ---------------------------------------------------------------------------
# cost model + partitioner (copied from repro.core.parallel)
# ---------------------------------------------------------------------------

def run_cost(cfg: ScenarioConfig) -> float:
    """Estimated cost of one run: its window count. A stacking group of R
    replicas therefore costs ``windows x R`` — the group runs one stacked
    dispatch set per window, and per-window host work grows with R."""
    return float(cfg.windows)


def partition_runs(cfgs: Sequence[ScenarioConfig], n_shards: int, *,
                   key_fn: Callable[[ScenarioConfig], Any] = stack_key,
                   cost_fn: Callable[[ScenarioConfig], float] = run_cost
                   ) -> List[List[int]]:
    """Split run indices into ``n_shards`` shards, stack-key groups atomic.

    Contract (property-tested):

    * every index appears in exactly one shard;
    * rows with equal ``key_fn`` stay on one shard (so replica stacking
      inside :func:`~repro_torch.core.scenario.run_sweep` sees the same
      groups a sequential run would);
    * greedy LPT balance: the max shard cost is at most twice the ideal
      ``max(total / n_shards, max_group_cost)``;
    * the grouping of configs onto shards is invariant to the input order
      of the rows (groups are placed in (cost desc, canonical key) order,
      never first-appearance order).

    Shards may be empty when there are fewer groups than shards. Within a
    shard, indices stay ascending, so per-shard execution preserves the
    original relative run order.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    placed = sorted(
        ((sum(cost_fn(cfgs[i]) for i in idxs),
          repr(key_fn(cfgs[idxs[0]])), idxs)
         for idxs in stack_groups(cfgs, key_fn)),
        key=lambda rec: (-rec[0], rec[1]))
    loads = [0.0] * n_shards
    shards: List[List[int]] = [[] for _ in range(n_shards)]
    for cost, _, idxs in placed:
        k = min(range(n_shards), key=lambda j: loads[j])
        loads[k] += cost
        shards[k].extend(idxs)
    for s in shards:
        s.sort()
    return shards


# ---------------------------------------------------------------------------
# host-only payload guard (the process boundary)
# ---------------------------------------------------------------------------

def assert_host_only(obj: Any, where: str = "payload") -> None:
    """Refuse torch tensors, on any device, in inter-process payloads.

    Pickling a ``torch.Tensor`` drags its storage (and for a card tensor a
    device sync and a CUDA context in the receiver) through the worker
    queue; every array crossing the boundary must be host-side numpy.
    Walks nested containers; numpy arrays, dataclass-like plain values and
    strings pass."""
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            raise TypeError(
                f"torch tensor in inter-process {where}: "
                f"{type(o).__name__} on {o.device} with shape "
                f"{tuple(o.shape)}; convert to numpy before crossing the "
                f"process boundary")
        if isinstance(o, np.ndarray):
            continue
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif dataclasses_fields := getattr(o, "__dataclass_fields__", None):
            stack.extend(getattr(o, f) for f in dataclasses_fields)


def shard_device(device, k: int) -> str:
    """The device of shard (or worker) ``k``: ``cuda:{k % count}`` over
    every card when ``device`` is a CUDA device, else ``device`` itself.
    Raises, as every entry point does, for CUDA where there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return str(dev)
    return f"cuda:{k % torch.cuda.device_count()}"


# ---------------------------------------------------------------------------
# execution backends
# ---------------------------------------------------------------------------

class SweepExecutor:
    """Backend protocol: evaluate labelled runs on ``device``, results in
    input order."""

    def execute(self, labels: Sequence[str],
                cfgs: Sequence[ScenarioConfig], data: Dataset, *,
                stack: bool, device="cuda") -> List[ScenarioResult]:
        raise NotImplementedError

    def execute_with_meta(self, labels: Sequence[str],
                          cfgs: Sequence[ScenarioConfig], data: Dataset, *,
                          stack: bool, device="cuda"
                          ) -> Tuple[List[ScenarioResult], Dict[str, Any]]:
        """Evaluate and additionally return execution metadata (attempt
        logs, channel info, ...) for ``SweepResult.meta``. Metadata is a
        side channel: it never enters the serialized result, so backends
        that populate it keep the bitwise-parity contract intact. The
        default backend has nothing to report."""
        return self.execute(labels, cfgs, data, stack=stack,
                            device=device), {}


class _SequentialExecutor(SweepExecutor):
    """``parallel="none"``: the single-host path, verbatim."""

    def execute(self, labels, cfgs, data, *, stack, device="cuda"):
        return run_sweep(list(cfgs), data, stack_seeds=stack, device=device)


class _DeviceShardExecutor(SweepExecutor):
    """``parallel="devices:n=K"``: K shards, shard ``k`` on
    :func:`shard_device` ``(device, k)``, one thread per shard but no more
    threads than devices (on one card, or on the CPU, the shards run one
    after another in one thread). Every shard runs the standard stacked
    ``run_sweep``, so the computation per group is the sequential one
    placed on another device — values are bitwise identical, only
    placement and overlap change."""

    def __init__(self, n: Optional[int] = None):
        if n is not None and n < 1:
            raise ValueError(f"devices executor needs n >= 1, got {n}")
        self.n = n

    def execute(self, labels, cfgs, data, *, stack, device="cuda"):
        n_devices = (torch.cuda.device_count()
                     if resolve_device(device).type == "cuda" else 1)
        n = self.n if self.n is not None else n_devices
        shards = [s for s in partition_runs(cfgs, n) if s]
        results: List[Optional[ScenarioResult]] = [None] * len(cfgs)

        def run_shard(k: int) -> List[ScenarioResult]:
            return run_sweep([cfgs[i] for i in shards[k]], data,
                             stack_seeds=stack,
                             device=shard_device(device, k))

        workers = max(1, min(len(shards), n_devices))
        if workers <= 1:
            outs = [run_shard(k) for k in range(len(shards))]
        else:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                outs = list(pool.map(run_shard, range(len(shards))))
        for idxs, rs in zip(shards, outs):
            for i, r in zip(idxs, rs):
                results[i] = r
        return results


def run_shard_payload(labels: Sequence[str], cfgs: Sequence[ScenarioConfig],
                      data: Dataset, stack: bool, device="cuda"
                      ) -> Tuple[str, dict]:
    """Run one whole shard on ``device`` and return its transport-agnostic
    wire form: the shard's :class:`~repro_torch.core.experiment.
    SweepResult` serialized as JSON plus the dispatch counts the shard
    incurred. The single shard-runner shared by every out-of-process
    backend — the spawn-pool worker below and the launcher workers
    (:mod:`repro_torch.core.launcher`) — so the payload schema cannot
    drift between transports."""
    from repro_torch.core.dispatch import reset_dispatch_counts
    from repro_torch.core.experiment import SweepResult, records_from

    # per-shard counts: one worker may execute several shards, and the
    # parent merges every returned snapshot, so counts must not
    # accumulate across tasks
    reset_dispatch_counts()
    results = run_sweep(list(cfgs), data, stack_seeds=stack, device=device)
    records = records_from(labels, results)
    payload = SweepResult(name="shard", records=records).to_json(indent=0)
    return payload, dispatch_counts()


class ShardMerger:
    """Incremental, order-stable merge of per-shard wire payloads.

    Shards write to disjoint run-index slots, so they may arrive in *any*
    order — as NDJSON events stream in from the sweep service
    (:mod:`repro_torch.service`), as launcher retries land late, or twice
    after a client reconnect replays part of a stream — and the merged run
    list is identical to the sequential run's regardless. All mutation is
    lock-guarded, and each shard's dispatch counts fold into the process
    counter exactly once even if its payload is replayed."""

    def __init__(self, n_runs: int, shards: Sequence[Sequence[int]]):
        self.shards = [list(s) for s in shards]
        self._results: List[Optional[ScenarioResult]] = [None] * n_runs
        self._done: set = set()
        self._lock = threading.Lock()

    def add(self, shard: int, payload: str, counts: dict) -> bool:
        """Fold one shard's payload in; returns False (and does nothing)
        when that shard was already merged — replays after a reconnect are
        idempotent by construction."""
        from repro_torch.core.experiment import SweepResult

        idxs = self.shards[shard]
        shard_result = SweepResult.from_json(payload)
        if len(shard_result.records) != len(idxs):
            raise ValueError(
                f"shard payload carries {len(shard_result.records)} records "
                f"for a {len(idxs)}-run shard")
        with self._lock:
            if shard in self._done:
                return False
            self._done.add(shard)
            merge_dispatch_counts(counts)
            for i, rec in zip(idxs, shard_result.records):
                self._results[i] = rec.to_scenario_result()
        return True

    def pending(self) -> List[int]:
        with self._lock:
            return [k for k in range(len(self.shards))
                    if k not in self._done]

    def results(self) -> List[ScenarioResult]:
        """The full merged run list; raises if any shard is still missing
        (an incremental merge is only a result once every shard landed)."""
        missing = self.pending()
        if missing:
            raise ValueError(f"shard(s) {missing} not merged yet")
        with self._lock:
            return list(self._results)


def merge_shard_payloads(n_runs: int, shards: Sequence[Sequence[int]],
                         outs: Sequence[Tuple[str, dict]]
                         ) -> List[ScenarioResult]:
    """Order-stable merge of per-shard wire payloads back into the full
    run list (shard k's i-th record lands at the i-th index of shard k's
    partition slot; every shard's dispatch counts fold into the parent
    counter). Shared by the processes backend and the hosts launcher; the
    sweep service merges the same payloads incrementally via
    :class:`ShardMerger`, which this wraps."""
    merger = ShardMerger(n_runs, shards)
    for k, (payload, counts) in enumerate(outs):
        merger.add(k, payload, counts)
    return merger.results()


_WORKER_DEVICE_INDEX: Optional[int] = None


def _init_worker(counter) -> None:
    """Pool initializer: give this worker its index in the pool (worker
    ``k`` runs its shards on ``cuda:{k % count}``)."""
    global _WORKER_DEVICE_INDEX
    with counter.get_lock():
        _WORKER_DEVICE_INDEX = counter.value
        counter.value += 1


def _worker_run_shard(task: Tuple[List[str], List[ScenarioConfig],
                                  Dataset, bool, str]) -> Tuple[str, dict]:
    """Process-pool worker: run one whole shard via the shared shard
    runner, on this worker's device. Runs in a spawned interpreter, so the
    CUDA context, EvalCache and dispatch counters are process-local."""
    labels, cfgs, data, stack, device = task
    return run_shard_payload(labels, cfgs, data, stack,
                             shard_device(device, _WORKER_DEVICE_INDEX))


class _ProcessShardExecutor(SweepExecutor):
    """``parallel="processes:n=K"``: a spawn-based pool runs whole shards;
    per-shard ``SweepResult`` JSON payloads merge back order-stably.

    ``spawn``, never ``fork``: a parent that holds a CUDA context cannot
    fork. Inbound tasks are host-only (:func:`assert_host_only`; the
    ``EvalCache`` refuses pickling), and the shard result travels back as
    JSON text plus a plain count dict, so no tensor crosses the queue.
    Worker dispatch counts merge into the parent counter. A worker that
    raises or dies fails the whole run: nothing is re-run in process."""

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError(f"processes executor needs n >= 1, got {n}")
        self.n = n

    def execute(self, labels, cfgs, data, *, stack, device="cuda"):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        shards = [s for s in partition_runs(cfgs, self.n) if s]
        tasks = []
        for idxs in shards:
            task = ([labels[i] for i in idxs], [cfgs[i] for i in idxs],
                    data, stack, str(device))
            assert_host_only(task, where="shard task")
            tasks.append(task)
        if not shards:
            return []
        # always a real pool — even for one shard — so the isolation
        # contract does not silently depend on the shard count; a worker
        # that dies fails the run (BrokenProcessPool) instead of hanging
        ctx = mp.get_context("spawn")
        counter = ctx.Value("i", 0)
        with ProcessPoolExecutor(max_workers=min(self.n, len(shards)),
                                 mp_context=ctx, initializer=_init_worker,
                                 initargs=(counter,)) as pool:
            outs = list(pool.map(_worker_run_shard, tasks))
        return merge_shard_payloads(len(cfgs), shards, outs)


# ---------------------------------------------------------------------------
# executor registry (shared spec grammar: "devices:n=2", "processes:n=4",
# "hosts:channel=local,n=2,retries=1")
# ---------------------------------------------------------------------------

def _hosts_factory(**params) -> SweepExecutor:
    """``"hosts:channel=...,n=K,retries=R"``: the multi-host launcher
    (:mod:`repro_torch.core.launcher`). Imported lazily: the launcher
    builds on this module."""
    from repro_torch.core.launcher import HostsExecutor
    return HostsExecutor(**params)


EXECUTORS: Dict[str, Callable[..., SweepExecutor]] = {
    "none": _SequentialExecutor,
    "devices": _DeviceShardExecutor,
    "processes": _ProcessShardExecutor,
    "hosts": _hosts_factory,
}

_EXECUTOR_CACHE: Dict[str, SweepExecutor] = {}


def register_executor(name: str,
                      factory: Callable[..., SweepExecutor]) -> None:
    """Register a sweep-executor factory under a spec name."""
    register_factory(EXECUTORS, name, factory, "sweep executor")


def get_executor(spec: str) -> SweepExecutor:
    """Resolve an executor spec string (``"none"``, ``"devices:n=2"``,
    ``"processes:n=4"``, ``"hosts:..."``) to a cached executor;
    :class:`KeyError` on unknown names / malformed specs,
    :class:`ValueError` on bad ``n``."""
    return resolve_spec(spec, EXECUTORS, _EXECUTOR_CACHE, "sweep executor")
