"""How the port captures a CUDA graph: the one mechanism behind the decode
graph (:mod:`repro_torch.models.decode_graph`), the prefill graphs
(:mod:`repro_torch.models.prefill_graph`) and the scan and city engines'
window programs (:mod:`repro_torch.core.cityscan`), each of which keeps its
own rule for which graphs exist and when they go.

* :data:`CAPTURE_LOCK`: ``torch.cuda.graph`` synchronises the device on
  entry, which CUDA refuses while another thread captures. Captures run in
  ``thread_local`` error mode, so other threads' allocations and replays
  do not break them;
* :func:`side_stream`: one stream a device for every warm-up and capture,
  since cuBLAS keeps a workspace (32 MiB on the H100) for every stream it
  has run on, for the life of the process. Whatever queues work on it
  holds the lock: work queued there during another thread's capture would
  join that graph;
* :func:`warm_up` runs a body eagerly before its capture, which builds its
  kernels and sets up the stream's cuBLAS and cuSOLVER handles, as
  PyTorch's graph documentation asks; :func:`capture` also returns the
  kernel launches a replay makes, since the kernel wrappers' counters
  (:func:`kernel_launches`) see a graph's launches once, at its capture.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import decode_attention, flash_attention, \
    loo_trials, rglru_scan, ssd_scan
from repro_torch.sharding.partitioning import current_mesh
from repro_torch.spans import span

CAPTURE_LOCK = threading.Lock()
_STREAMS: dict = {}


def side_stream(device) -> torch.cuda.Stream:
    """The device's one stream for warm-ups and captures."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def warm_up(fn, device):
    """``fn()`` run eagerly on the device's side stream, the current
    stream made to wait for it; every tensor it returns is recorded on
    the current stream. Returns what ``fn`` returns."""
    stream = side_stream(device)
    current = torch.cuda.current_stream(stream.device)
    with CAPTURE_LOCK:
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
    for t in tree_leaves(out):
        if torch.is_tensor(t):
            t.record_stream(current)
    return out


def capture(fn, device, *, pool=None, span_name: Optional[str] = None):
    """``fn()`` captured on the device's side stream, in ``pool`` where
    one is given; nothing runs. Returns the graph, ``fn``'s outputs (the
    graph's static outputs) and {kernel: launches one replay makes}."""
    stream = side_stream(device)
    with span(span_name) if span_name else nullcontext():
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK:
            stream.wait_stream(torch.cuda.current_stream(stream.device))
            before = kernel_launches()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
            launches = {k: n - before[k] for k, n in
                        kernel_launches().items() if n > before[k]}
    return graph, out, launches


def kernel_launches() -> dict:
    """{kernel: its wrapper's launch counter}; ``loo_trials`` counts both
    of its entry points, ``loo_trials_step`` the fused one."""
    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "ssd_scan": ssd_scan.launches,
            "rglru_scan": rglru_scan.launches,
            "loo_trials": loo_trials.launches,
            "loo_trials_step": loo_trials.step_launches}


class Counts:
    """Counts behind one lock: numbers, and {key: number} tallies, from
    the zeros given."""

    def __init__(self, **zero):
        self._zero = zero
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._counts = _copy(self._zero)

    def add(self, **inc) -> None:
        """Add each number to its count, each {key: number} to its
        tally."""
        with self._lock:
            for k, v in inc.items():
                if isinstance(v, dict):
                    tally = self._counts[k]
                    for kk, vv in v.items():
                        tally[kk] = tally.get(kk, 0) + vv
                else:
                    self._counts[k] += v

    def read(self) -> dict:
        with self._lock:
            return _copy(self._counts)


def _copy(counts: dict) -> dict:
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in counts.items()}


def refusal(held, inputs=()) -> Optional[str]:
    """Why a graph may not take a call (``"dtensor"``, ``"fake"``,
    ``"meta"``, ``"mesh"``, ``"device"``, ``"capturing"``), or None:
    ``held`` are the tensors the graph reads in place (a cache, the
    parameters), which must be on the card; ``inputs`` what a call copies
    into its static inputs (tensors or numbers), from any device."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    held = list(held)
    for t in held + [x for x in inputs if torch.is_tensor(x)]:
        if isinstance(t, DTensor):
            return "dtensor"
        if isinstance(t, FakeTensor):
            return "fake"
        if t.is_meta:
            return "meta"
    if current_mesh() is not None:
        return "mesh"
    if not held or any(t.device.type != "cuda" for t in held):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None
