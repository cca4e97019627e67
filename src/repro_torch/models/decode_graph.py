"""The serve decode step as one CUDA graph, inside
:meth:`repro_torch.models.model.Model.decode_step`.

A decode step is a fixed chain of a few thousand small eager ops over
fixed buffers: the model's parameters and the cache leaves, which the
step writes in place. On the card the host's launches, not the device,
set its pace, so ``decode_step`` captures the chain (``Model._decode_body``)
once as a ``torch.cuda.CUDAGraph`` and replays it on later calls:

* a graph is keyed on what the call shows (:func:`graph_key`): the
  address, shape, stride and dtype of every cache leaf, the shapes and
  dtypes of ``tokens`` and ``pos`` (a Python int counts as a 0-d long
  tensor), the device and the model's config;
* it engages only where :func:`refusal` finds nothing: on CUDA, with no
  DTensor, fake or meta tensor among the inputs, no ambient mesh and the
  current stream not capturing (grad mode is off: ``decode_step`` runs
  under ``no_grad``). Every other call (the CPU, the dry-run's DTensor and
  meta traces, a step captured into an outer graph) runs the eager body
  as it is;
* the first call with a new key runs the body eagerly on the device's
  side stream, shared by every decode graph (the warm-up, which also sets
  up cuBLAS's handle and workspace for that stream), the second captures
  it there and replays once, every later
  call replays. A capture runs nothing, so a recurrent state (SSD state,
  conv window, rolled window cache, RG-LRU state) advances exactly once
  per call;
* ``tokens`` and ``pos`` are copied into the graph's static inputs before
  a replay, and the logits come back as a fresh copy: a caller that keeps
  an earlier step's logits never sees them overwritten. The cache returned
  is the caller's dict.

The replay launches the eager body's kernels at the same shapes, dtypes
and order, so its tokens and logits are bitwise the eager step's. A model
holds one graph at a time: a new key drops the old graph and its memory
pool, and so do ``Model.load_params``, ``init`` and anything that moves
or casts the module. The graph holds the cache leaves it was captured on
weakly: the first of them to die drops the graph (so its addresses are
never replayed after reuse), and the cache and the graph's pool are
freed together, as when a batcher is deleted or ``generate`` returns.
The parameters are read at the addresses the graph was captured on: a
route that swaps them without the calls above (``torch.func.
functional_call``) must not call ``decode_step`` on the card. Captures
take the process's one capture lock
(:data:`repro_torch.core.cityscan._CAPTURE_LOCK`).

Spans (:mod:`repro_torch.spans`, inside ``repro_torch.decode_step``):
``repro_torch.decode_graph.capture`` and ``repro_torch.decode_graph.replay``.
A replay runs no Python of the body, so the decode step's inner spans
(``decode_attention``, ``moe.*``, ``ssd.decode``, ``head``) fire only on
eager steps; their kernels still run, under their own names.
:func:`decode_graph_stats` counts captures, replays and eager calls.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Optional

import torch

from repro_torch.sharding.partitioning import current_mesh
from repro_torch.spans import span

# One side stream per device for every decode graph (and every prefill
# graph, ``prefill_graph``): cuBLAS keeps a workspace (32 MiB on the H100)
# for each stream it has run on, for the life of the process, so a new
# stream per graph (one per ``generate``) would pile them up.
_STREAMS: dict = {}


def _side_stream(device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


class Counts:
    """Counts behind one lock (this module's and ``prefill_graph``'s):
    numbers, and {key: number} tallies, from the zeros given."""

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


_COUNTS = Counts(captures=0, capture_s=0.0, replays=0, eager=0)
count = _COUNTS.add


def decode_graph_stats() -> dict:
    """Decode graphs captured (and seconds spent capturing them), replays
    (the capturing call's own included) and decode steps run eagerly (the
    warm-up call of each key, and every call :func:`refusal` turned
    away), since the last reset."""
    return _COUNTS.read()


def reset_decode_graph_stats() -> None:
    _COUNTS.reset()


def refusal(cache, tokens, pos) -> Optional[str]:
    """Why a decode call takes the eager body (``"dtensor"``, ``"fake"``,
    ``"meta"``, ``"mesh"``, ``"device"``, ``"capturing"``), or None where
    it may run as a graph."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    leaves = list(cache.values())
    for t in leaves + [x for x in (tokens, pos) if torch.is_tensor(x)]:
        if isinstance(t, DTensor):
            return "dtensor"
        if isinstance(t, FakeTensor):
            return "fake"
        if t.is_meta:
            return "meta"
    if current_mesh() is not None:
        return "mesh"
    if not leaves or any(t.device.type != "cuda" for t in leaves):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _signature(x):
    """(shape, dtype) of ``tokens`` or ``pos``; an int is a 0-d long."""
    if torch.is_tensor(x):
        return tuple(x.shape), x.dtype
    return (), torch.long


def graph_key(cache, tokens, pos, cfg) -> tuple:
    """What a graph is keyed on (module doc)."""
    leaves = tuple((name, t.device, t.data_ptr(), tuple(t.shape), t.stride(),
                    t.dtype) for name, t in cache.items())
    return leaves, _signature(tokens), _signature(pos), cfg


class DecodeGraph:
    """One key's graph: warmed up, then captured, then replayed (module
    doc). ``body(cache, tokens, pos)`` is the eager decode step; it is
    passed to each call, not kept. ``owner`` (held weakly) is the model
    whose ``_decode_graph`` this is, dropped there when a leaf dies."""

    def __init__(self, key: tuple, cache, owner):
        self.key = key
        owner, me = weakref.ref(owner), weakref.ref(self)

        def drop(_):
            model = owner()
            if model is not None and model._decode_graph is me():
                model._decode_graph = None
        # weak, so the cache dies with its holder; the refs die with the
        # graph, so a dropped graph's callbacks never fire
        self.leaves = tuple(weakref.ref(t, drop) for t in cache.values())
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tokens = self.pos = self.logits = None

    def warm_up(self, body, cache, tokens, pos):
        """The key's first call: the body run eagerly on the side stream
        that will capture it."""
        self.stream = _side_stream(next(iter(cache.values())).device)
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            logits, cache = body(cache, tokens, pos)
        current.wait_stream(self.stream)
        logits.record_stream(current)
        count(eager=1)
        return logits, cache

    def capture(self, body, cache, tokens, pos) -> None:
        """Capture the body over static ``tokens`` and ``pos`` on the side
        stream; nothing runs."""
        from repro_torch.core.cityscan import _CAPTURE_LOCK

        t0 = time.perf_counter()
        with span("repro_torch.decode_graph.capture"):
            dev = self.stream.device
            shape, dtype = _signature(pos)
            self.tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                      device=dev)
            self.pos = torch.empty(shape, dtype=dtype, device=dev)
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, torch.cuda.graph(
                    graph, stream=self.stream,
                    capture_error_mode="thread_local"):
                self.logits, _ = body(cache, self.tokens, self.pos)
            self.graph = graph
        count(captures=1, capture_s=time.perf_counter() - t0)

    def replay(self, tokens, pos):
        """One step: the inputs copied in, the graph replayed on the
        current stream, a copy of its logits returned."""
        with span("repro_torch.decode_graph.replay"):
            self.tokens.copy_(tokens)
            if torch.is_tensor(pos):
                self.pos.copy_(pos)
            else:
                self.pos.fill_(int(pos))
            self.graph.replay()
            logits = self.logits.clone()
        count(replays=1)
        return logits
