# Copied from src/repro/service/statsd.py; stdlib only, as there.
"""Dependency-free statsd-style fleet-health metrics (DESIGN.md §12).

The sweep service and the multi-host launcher need the usual operational
trio — counters, timers, gauges — without dragging a metrics dependency
into a repo whose hard constraint is "stdlib + the baked-in jax stack".
This module is both halves of statsd in one place:

* **in-process aggregation** — every metric accumulates into a process-
  wide snapshot (:meth:`Statsd.snapshot`), which is what the service's
  ``GET /v1/metrics`` endpoint serves, what the cache hit-rate gate reads
  (scripts/service_parity.py), and what the tests assert against. Timers
  keep count/sum/min/max/last so rates and latency distributions are
  recoverable without storing samples.
* **optional wire emission** — when ``REPRO_STATSD_ADDR=host:port`` is
  set (or an address is passed explicitly), every metric is *also* sent
  as a standard statsd datagram (``name:value|c``, ``|ms``, ``|g``, with
  ``|#k:v`` DogStatsD-style tags) over UDP, fire-and-forget: a real
  statsd/telegraf agent can aggregate a fleet of services with zero code
  change here. Send failures are swallowed — metrics must never take
  down the control plane.

Metric names are dotted paths namespaced by subsystem — the service uses
``service.*`` (jobs, stream, cache hit/miss, queue depth) and the
launcher retry path uses ``launcher.shard.*`` (attempts, ok, failures by
kind, retries, attempt latency); the full catalogue is in DESIGN.md §12.
Tags are rendered into the aggregation key as ``name|k=v,...`` (sorted),
so tagged series stay distinguishable in snapshots too.

All mutation is lock-guarded: the launcher dispatches shards from worker
threads and the HTTP server handles requests from its own thread pool.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Mapping, Optional

ADDR_ENV = "REPRO_STATSD_ADDR"


def _series(name: str, tags: Optional[Mapping[str, Any]]) -> str:
    if not tags:
        return name
    body = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}|{body}"


class Statsd:
    """One metrics sink: in-process aggregation + optional UDP emission."""

    def __init__(self, namespace: str = "repro",
                 addr: Optional[str] = None):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, Dict[str, float]] = {}
        self._sock: Optional[socket.socket] = None
        self._target = None
        addr = addr if addr is not None else os.environ.get(ADDR_ENV, "")
        if addr:
            host, _, port = addr.rpartition(":")
            try:
                self._target = (host or "127.0.0.1", int(port))
                self._sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
            except (ValueError, OSError):
                self._target = self._sock = None

    # -- the three statsd verbs ---------------------------------------------
    def increment(self, name: str, value: float = 1,
                  tags: Optional[Mapping[str, Any]] = None) -> None:
        key = _series(name, tags)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value
        self._emit(name, value, "c", tags)

    def gauge(self, name: str, value: float,
              tags: Optional[Mapping[str, Any]] = None) -> None:
        key = _series(name, tags)
        with self._lock:
            self._gauges[key] = float(value)
        self._emit(name, value, "g", tags)

    def timing(self, name: str, ms: float,
               tags: Optional[Mapping[str, Any]] = None) -> None:
        key = _series(name, tags)
        with self._lock:
            t = self._timers.get(key)
            if t is None:
                t = self._timers[key] = {"count": 0, "sum_ms": 0.0,
                                         "min_ms": float("inf"),
                                         "max_ms": 0.0, "last_ms": 0.0}
            t["count"] += 1
            t["sum_ms"] += ms
            t["min_ms"] = min(t["min_ms"], ms)
            t["max_ms"] = max(t["max_ms"], ms)
            t["last_ms"] = ms
        self._emit(name, ms, "ms", tags)

    @contextmanager
    def timed(self, name: str,
              tags: Optional[Mapping[str, Any]] = None) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.timing(name, (time.monotonic() - t0) * 1e3, tags)

    # -- observation --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """A JSON-safe copy of every series: what ``GET /v1/metrics``
        serves. Timer aggregates gain a derived ``avg_ms``."""
        with self._lock:
            timers = {}
            for key, t in self._timers.items():
                timers[key] = dict(t, avg_ms=t["sum_ms"] / t["count"])
            return {"namespace": self.namespace,
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "timers": timers}

    def counter(self, name: str,
                tags: Optional[Mapping[str, Any]] = None) -> float:
        with self._lock:
            return self._counters.get(_series(name, tags), 0)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()

    # -- wire emission (optional) -------------------------------------------
    def _emit(self, name: str, value: float, kind: str,
              tags: Optional[Mapping[str, Any]]) -> None:
        if self._sock is None:
            return
        line = f"{self.namespace}.{name}:{value}|{kind}"
        if tags:
            line += "|#" + ",".join(f"{k}:{tags[k]}" for k in sorted(tags))
        try:
            self._sock.sendto(line.encode("ascii", "replace"),
                              self._target)
        except OSError:
            pass                 # fire-and-forget: never fail the caller


# The process-wide default sink, shared by the service, the launcher retry
# path and the benchmarks; tests needing isolation construct their own
# Statsd or call reset().
statsd = Statsd()
