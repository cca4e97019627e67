"""The serve prefill as one CUDA graph per prompt-length bucket, inside
:meth:`repro_torch.models.model.Model.prefill`.

A refill's prefill is a batch-1 chain of a few thousand small eager ops
(2,100 to 6,710 in the benchmark's models); on the card the host's
launches, not the device, set its pace. Its shapes follow the prompt's
length, so a graph per length would hardly ever replay. ``prefill``
instead pads the prompt to its bucket (:func:`bucket`) and replays a
graph of the padded body (``Model._prefill_body`` given the prompt's
length), captured once per bucket:

* the padded body is the eager prefill over the tokens padded with
  ``PAD_ID`` to the bucket's length ``Lb``, given the prompt's length as
  a 0-d device tensor. Causal attention (the flash kernel, MLA's
  ``chunked_attention``) keeps every real row from the pads; an MoE
  whose capacity cannot drop a token routes and sums each real token as
  without them; the SSD mixer zeroes dt from the length on and reads its
  conv tail there (:func:`repro_torch.models.ssd.ssd_forward`); the last
  logits are read at ``length - 1``. So the real positions' logits and
  caches are the true-length prefill's up to rounding (the products run
  over Lb rows);
* it engages only where :func:`refusal` finds nothing. It refuses what
  padding would change: the vlm, audio and hybrid families, a sliding
  window (the cache keeps the last ``w`` positions), attention that is
  not causal, an MoE whose capacity can drop a token
  (``capacity_factor * top_k < num_experts``: the padded token count
  would change which real tokens are kept); ``plain``; and what
  :func:`repro_torch.graphs.refusal` refuses for the model's embedding
  and the tokens (the CPU, DTensor, fake or meta inputs, an ambient mesh,
  a running capture). A refused call runs the eager body
  (``Model._prefill_body``) as it is, its reason counted;
* a model's first accepted call runs the padded body eagerly (the
  warm-up), which builds the kernels. From then on the first call in a
  bucket captures its graph and replays it, and every later call
  replays; warm-up and captures run on the device's side stream
  (:mod:`repro_torch.graphs`). The key is (batch, ``Lb``, device,
  config);
* before a replay the tokens (padded with ``PAD_ID``) and the length are
  copied into the graph's static inputs; after it the logits and the
  cache leaves, those with a ``cache_len`` axis cut to the prompt's
  length, are copied out. So a later replay never overwrites what a
  caller holds, and ``prefill``'s contract (a cache of the prompt's
  length) stands;
* the graphs' memory pool only grows: it keeps every graph's static
  outputs (the logits and the cache at ``Lb``) and the largest blocks
  any capture took for its intermediates (a longer bucket's cannot reuse
  a shorter one's). So the pool is bounded: once it holds more than
  :data:`MEMORY_SHARE` of the device's memory, the next capture first
  drops every graph of the model and the pool with them, and starts a
  new pool. A dropped bucket is captured again at its next call.
  Dropping one graph at a time would free its outputs inside the pool
  and return nothing to the device;

The replay launches the padded body's kernels at the same shapes and in
the same order, so it gives bitwise what :func:`eager` gives. A model's
prefill graphs share one memory pool, apart from the decode graph's:
each replay's outputs are copied out before any other graph runs, and a
graph's static outputs stay allocated until it is dropped.
``Model.load_params``, ``init`` and anything that moves or casts the
module drop them all, as they drop the decode graph: the graphs read the
parameters at the addresses they were captured on.

Spans (:mod:`repro_torch.spans`, inside ``repro_torch.prefill``):
``repro_torch.prefill_graph.capture`` and
``repro_torch.prefill_graph.replay``. A replay runs no Python of the
body, so the prefill's inner spans (``mla.*``, ``moe.*``, ``ssd.*``,
``attention``, ``ssd_scan``, ``head``) open only in eager prefills and
captures; a replay's kernels still run, under their own names.
:func:`prefill_graph_stats` counts captures, replays, eager calls,
dropped graphs, refusals by reason, the kernel launches the replays made
(the kernel wrappers' own counters see a graph's launches once, at its
capture), and the real and the pad tokens of every call that took the
padded body.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import graphs
from repro_torch.spans import span

PAD_ID = 0
# Buckets: multiples of max(MIN_STEP, 2**floor(log2(S - 1)) / PER_OCTAVE).
MIN_STEP = 16
PER_OCTAVE = 8
# The share of a device's memory past which a model's prefill graphs are
# dropped, at its next capture (module doc).
MEMORY_SHARE = 1 / 4

_COUNTS = graphs.Counts(captures=0, capture_s=0.0, replays=0, eager=0,
                        dropped=0, refused={}, launches={}, tokens=0,
                        pad_tokens=0)
count = _COUNTS.add


def bucket(length: int) -> int:
    """The bucket of a prompt of ``length`` tokens: ``length`` rounded up
    to a multiple of max(16, 2**floor(log2(length - 1)) / 8), so eight
    buckets an octave from 128 tokens up, each padding a prompt by less
    than an eighth of its octave's start, and steps of 16 below."""
    octave = 1 << max(0, (length - 1).bit_length() - 1)
    step = max(MIN_STEP, octave // PER_OCTAVE)
    return -(-length // step) * step


def prefill_graph_stats() -> dict:
    """Since the last reset: graphs captured (and seconds spent capturing
    them); replays (a capturing call's own included); prefills run
    eagerly (a model's warm-up and every refused call); graphs
    ``dropped`` with their pool past :data:`MEMORY_SHARE`; ``refused``,
    {reason: calls}; ``launches``, {kernel: launches the replays made};
    ``tokens`` and ``pad_tokens``, the prompt tokens and the pad positions
    of every call that took the padded body (the warm-up and the
    replays). The replay share is replays / (replays + eager), the
    padding share pad_tokens / tokens."""
    return _COUNTS.read()


def reset_prefill_graph_stats() -> None:
    _COUNTS.reset()


def refusal(model, batch, plain) -> Optional[str]:
    """Why a prefill takes the eager body (``"plain"``, ``"family"``,
    ``"window"``, ``"noncausal"``, ``"moe_capacity"``, or one of
    :func:`repro_torch.graphs.refusal`'s reasons for the model's
    embedding and the tokens), or None where it may run as a graph."""
    cfg = model.cfg
    if plain:
        return "plain"
    if cfg.family not in ("dense", "moe", "ssm"):
        return "family"
    if cfg.sliding_window:
        return "window"
    if not cfg.causal:
        return "noncausal"
    m = cfg.moe
    if m is not None and m.capacity_factor * m.top_k < m.num_experts:
        return "moe_capacity"
    return graphs.refusal([model.top["embed"]], (batch["tokens"],))


class PrefillGraphs:
    """A model's prefill graphs by key, their memory pool and the bytes
    it held after the last capture, and whether the model's warm-up has
    run (module doc)."""

    def __init__(self):
        self.warm = False
        self.pool = None
        self.pool_bytes = 0
        self.graphs: dict = {}

    def drop(self, device) -> None:
        """Drop every graph and the pool, and hand the pool's memory back
        to the device."""
        count(dropped=len(self.graphs))
        self.graphs.clear()
        self.pool, self.pool_bytes = None, 0
        with torch.cuda.device(device):
            torch.cuda.empty_cache()


def pool_bytes(pool) -> int:
    """The bytes the caching allocator holds in ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def _padded(tokens, Lb: int, device):
    out = torch.full((tokens.shape[0], Lb), PAD_ID, dtype=torch.long,
                     device=device)
    out[:, :tokens.shape[1]] = tokens
    return out


def _outputs(logits, cache, axes, length: int):
    """Fresh copies of the padded body's logits and cache, every
    ``cache_len`` axis cut to ``length``."""
    out = {}
    for name, leaf in cache.items():
        if axes[name] is not None:
            leaf = leaf.narrow(axes[name], 0, length)
        out[name] = leaf.clone(memory_format=torch.contiguous_format)
    return logits.clone(), out


def eager(model, tokens):
    """The padded body run eagerly over ``tokens`` padded to its bucket,
    its outputs as :func:`prefill` returns them (on any device)."""
    B, L = tokens.shape
    Lb = bucket(L)
    dev = model.device
    length = torch.full((), L, dtype=torch.long, device=dev)
    logits, cache = model._prefill_body({"tokens": _padded(tokens, Lb, dev)},
                                        length=length)
    return _outputs(logits, cache, model.cache_len_axes(B, Lb), L)


def prefill(model, tokens):
    """``Model.prefill`` of a call :func:`refusal` accepted: the model's
    warm-up, or a bucket's capture and replay, or a replay (module
    doc). Returns (logits, cache)."""
    B, L = tokens.shape
    Lb = bucket(L)
    state = model._prefill_graphs
    if state is None:
        model._prefill_graphs = state = PrefillGraphs()
    count(tokens=B * L, pad_tokens=B * (Lb - L))
    if not state.warm:
        out = graphs.warm_up(lambda: eager(model, tokens), model.device)
        state.warm = True
        count(eager=1)
        return out
    key = (B, Lb, model.device, model.cfg)
    g = state.graphs.get(key)
    if g is None:
        total = torch.cuda.get_device_properties(model.device).total_memory
        if state.pool_bytes > total * MEMORY_SHARE:
            state.drop(model.device)
        if state.pool is None:
            state.pool = torch.cuda.graph_pool_handle()
        g = PrefillGraph(model, B, Lb)
        g.capture(model, state.pool)
        state.graphs[key] = g
        state.pool_bytes = pool_bytes(state.pool)
    return g.replay(tokens)


class PrefillGraph:
    """One bucket's graph over its static inputs (module doc)."""

    def __init__(self, model, batch: int, Lb: int):
        dev = model.device
        self.tokens = torch.full((batch, Lb), PAD_ID, dtype=torch.long,
                                 device=dev)
        self.length = torch.ones((), dtype=torch.long, device=dev)
        self.axes = model.cache_len_axes(batch, Lb)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits = self.cache = None
        self.launches: dict = {}

    def capture(self, model, pool) -> None:
        """Capture the padded body over the static inputs, in the model's
        pool, noting the kernel launches it holds; nothing runs."""
        t0 = time.perf_counter()
        self.graph, (self.logits, self.cache), self.launches = \
            graphs.capture(lambda: model._prefill_body(
                {"tokens": self.tokens}, length=self.length), model.device,
                pool=pool, span_name="repro_torch.prefill_graph.capture")
        count(captures=1, capture_s=time.perf_counter() - t0)

    def replay(self, tokens):
        """The prompt copied in, the graph replayed on the current stream,
        copies of its outputs returned."""
        with span("repro_torch.prefill_graph.replay"):
            L = tokens.shape[1]
            self.tokens[:, :L].copy_(tokens)
            self.tokens[:, L:].fill_(PAD_ID)
            self.length.fill_(L)
            self.graph.replay()
            out = _outputs(self.logits, self.cache, self.axes, L)
        count(replays=1, launches=self.launches)
        return out

