"""Named spans at the serve path's layer boundaries, for ``torch.profiler``.

``with span("repro_torch.decode_step"):`` marks a block. While a
``torch.profiler.profile`` runs (its start sets
``torch.autograd.profiler._is_profiler_enabled``) a span is a
``record_function`` range: it lies on the profiler's clock beside the
device's kernels, and the profiler links each kernel, copy or memset to
the host op that launched it, so a trace can say which span launched
what. Otherwise a span is one shared no-op context manager: no
``record_function`` (which enters the dispatcher even with no profiler
running), no allocation. There is no setting: profiling the serve path
turns the spans on. A span carries no request id: the profiler records
no string among a range's inputs (``record_function``'s ``args`` reach
neither its events nor its chrome trace).

Every name starts with ``repro_torch.``; the set is fixed:

* serving loop (``serving/scheduler.py``): ``serve.step``,
  ``serve.refill``, ``serve.prefill``, ``serve.pad_cache``,
  ``serve.splice``, ``serve.sample`` (the decode argmax and its copy to
  the host);
* model (``models/model.py``): ``prefill``, ``decode_step``, ``head``
  (final norm and head), ``decode_attention`` (a buffered GQA or MLA
  decode layer's attention, projections to output); inside
  ``decode_step`` on the card, ``decode_graph.capture`` and
  ``decode_graph.replay`` (``models/decode_graph.py``: a replay runs none
  of the step's inner spans); inside ``prefill`` on the card,
  ``prefill_graph.capture`` and ``prefill_graph.replay``
  (``models/prefill_graph.py``: a replay runs none of the prefill's inner
  spans);
* MoE FFN (``models/blocks.py``): ``moe.router``, ``moe.dispatch``,
  ``moe.experts`` (dispatch buffer and the expert products),
  ``moe.combine``;
* MLA (``models/blocks.py``, ``models/model.py``): ``mla.q`` (q
  down-projection, norm, up-projection, RoPE), ``mla.kv`` (prefill: the
  latent, its norm, the rope key, the k/v up-projection and the cache
  entry; decode: the new entry and its write), ``mla.out`` (prefill's out
  product), ``mla.absorbed`` (decode: the absorbed attention and the out
  product);
* SSD mixer (``models/ssd.py``): ``ssd.in_proj``, ``ssd.conv`` (conv,
  silu, split, softplus, A), ``ssd.out`` (D skip, gated norm, out
  product), ``ssd.decode`` (a decode step's mixer);
* kernels: ``attention``, ``ssd_scan``, ``rglru_scan``, the roofline
  regions (:func:`repro_torch.roofline.trace.region`).
"""
from __future__ import annotations

from contextlib import nullcontext

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

PREFIX = "repro_torch."

_OFF = nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler runs, else a
    shared no-op (module doc)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
