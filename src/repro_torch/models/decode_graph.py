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
* the first call with a new key runs the body eagerly (the warm-up), the
  second captures it and replays once, every later call replays, both on
  the device's side stream (:mod:`repro_torch.graphs`). A capture runs
  nothing, so a recurrent state (SSD state, conv window, rolled window
  cache, RG-LRU state) advances exactly once per call;
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
functional_call``) must not call ``decode_step`` on the card.

Spans (:mod:`repro_torch.spans`, inside ``repro_torch.decode_step``):
``repro_torch.decode_graph.capture`` and ``repro_torch.decode_graph.replay``.
A replay runs no Python of the body, so the decode step's inner spans
(``decode_attention``, ``moe.*``, ``ssd.decode``, ``head``) fire only on
eager steps; their kernels still run, under their own names.
:func:`decode_graph_stats` counts captures, replays, eager calls and the
kernel launches the replays made.
"""
from __future__ import annotations

import time
import weakref
from typing import Optional

import torch

from repro_torch import graphs
from repro_torch.spans import span

_COUNTS = graphs.Counts(captures=0, capture_s=0.0, replays=0, eager=0,
                        launches={})
count = _COUNTS.add


def decode_graph_stats() -> dict:
    """Decode graphs captured (and seconds spent capturing them), replays
    (the capturing call's own included), decode steps run eagerly (the
    warm-up call of each key, and every call :func:`refusal` turned
    away) and ``launches``, {kernel: launches the replays made} (the
    kernel wrappers' own counters see a graph's launches once, at its
    capture, which runs nothing), since the last reset."""
    return _COUNTS.read()


def reset_decode_graph_stats() -> None:
    _COUNTS.reset()


def refusal(cache, tokens, pos) -> Optional[str]:
    """Why a decode call takes the eager body (:func:`repro_torch.graphs.
    refusal` over the cache leaves, ``tokens`` and ``pos``), or None
    where it may run as a graph."""
    return graphs.refusal(cache.values(), (tokens, pos))


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
    """One key's graph: captured after the key's warm-up, then replayed
    (module doc). ``body(cache, tokens, pos)`` is the eager decode step;
    it is passed to each call, not kept. ``owner`` (held weakly) is the model
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
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.tokens = self.pos = self.logits = None
        self.launches: dict = {}

    def capture(self, body, cache, tokens, pos) -> None:
        """Capture the body over static ``tokens`` and ``pos`` on the side
        stream, noting the kernel launches it holds; nothing runs."""
        t0 = time.perf_counter()
        dev = next(iter(cache.values())).device
        shape, dtype = _signature(pos)
        self.tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                  device=dev)
        self.pos = torch.empty(shape, dtype=dtype, device=dev)
        self.graph, (self.logits, _), self.launches = graphs.capture(
            lambda: body(cache, self.tokens, self.pos), dev,
            span_name="repro_torch.decode_graph.capture")
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
        count(replays=1, launches=self.launches)
        return logits
