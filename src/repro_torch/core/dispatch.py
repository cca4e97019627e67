# Copied from src/repro/core/dispatch.py; only the import paths differ.
"""Jitted-dispatch accounting for the HTL engines.

The fleet engine's contract is O(1) jitted dispatches per collection window
(vs one per DC — or per seed replica — in the loop engine), and the sweep
layer's contract is that seed stacking does not multiply dispatches by the
seed count. Those are easy properties to silently regress (one refactor that
re-introduces a Python loop over DCs around a jitted call), so every jitted
entry point of the algorithm layer is wrapped with :func:`count_dispatch`
and a CI gate (tests/test_dispatch_gate.py, run by scripts/verify.sh)
asserts the counts.

A "dispatch" here is one Python-level call into a jitted entry point — the
unit of host-sync / executable-launch overhead the fleet engine exists to
amortise. Counting wraps the function object itself, so the gate also
catches loops hidden inside helper modules, not just the engine drivers.
"""
from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from functools import wraps
from typing import Mapping

_COUNTS: Counter = Counter()
# The parallel sweep executor (repro.core.parallel) dispatches shards from
# several threads (devices backend) and merges counts shipped back from
# worker processes (processes backend), so all counter mutation is locked.
_LOCK = threading.Lock()


def count_dispatch(name: str):
    """Decorator: count Python-level calls into a jitted entry point."""
    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            with _LOCK:
                _COUNTS[name] += 1
            return fn(*args, **kwargs)
        wrapper.__wrapped__ = fn
        return wrapper
    return deco


def reset_dispatch_counts() -> None:
    with _LOCK:
        _COUNTS.clear()


def dispatch_counts() -> dict:
    """Snapshot of {entry-point name: call count} since the last reset."""
    with _LOCK:
        return dict(_COUNTS)


@contextmanager
def dispatch_scope():
    """Yield a dict that, on exit, holds the dispatch-count DELTA of the
    enclosed block (names with zero delta are omitted). Reads snapshots
    instead of resetting the global counter, so scopes nest and compose
    with the CI gate's own reset/inspect cycle. The gate uses this to pin
    exact per-call dispatch profiles — e.g. that a deep greedy refine is
    ONE jitted dispatch no matter how many candidates it accepts."""
    before = dispatch_counts()
    delta: dict = {}
    try:
        yield delta
    finally:
        for name, count in dispatch_counts().items():
            d = count - before.get(name, 0)
            if d:
                delta[name] = d


def merge_dispatch_counts(counts: Mapping[str, int]) -> None:
    """Fold a worker process's dispatch counts into this process's counter,
    so sharded sweeps stay observable by the dispatch CI gate: the merged
    total bounds per-shard work (each shard's own counts are a subset)."""
    with _LOCK:
        for name, k in counts.items():
            _COUNTS[name] += int(k)
