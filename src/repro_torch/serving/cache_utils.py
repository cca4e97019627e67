"""KV cache utilities (port of ``repro.serving.cache_utils``).

``decode_step`` writes into fixed-size buffers at a position index. After a
prefill of length S, the cache buffers have length S; to keep decoding they
are padded to the target budget once (one concatenation) and then written
in place. Window caches (sliding-window attention, the hybrid family's
local attention) roll instead and never grow; recurrent states and conv
windows (ssm, hybrid) have no ``cache_len`` axis and are left alone, and
so is the audio family's cross-attention cache (``xk``/``xv``: the
encoder's keys and values, fixed for the whole decode).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.model import Model
from repro_torch.sharding.partitioning import flatten, torch_dtype


def pad_cache(model: Model, cache, n_extra: int, batch: int, seq_len: int):
    """Grow every cache_len axis by ``n_extra`` zero slots (append budget).

    Window caches (length == window) are returned untouched — they roll;
    so are the cross-attention caches ``xk``/``xv``, which decode only
    reads (zero slots there would be keys that cross-attention attends
    to). As in the reference, any cache of length ``min(window,
    seq_len)`` counts as a window cache, so one shorter than the window is
    never padded and rolls from the first decode step (ROADMAP Queue 3).
    """
    cfg = model.cfg
    axes = model.cache_len_axes(batch, seq_len)
    window = cfg.sliding_window or (cfg.rglru.window if cfg.rglru else 0)
    out = {}
    for key, leaf in cache.items():
        ax = axes.get(key)
        if ax is None or key in ("xk", "xv") or (
                window and leaf.shape[ax] == min(window, seq_len)):
            out[key] = leaf
            continue
        shape = list(leaf.shape)
        shape[ax] = n_extra
        out[key] = torch.cat([leaf, leaf.new_zeros(shape)], dim=ax)
    return out


def cache_bytes(model: Model, batch: int, seq_len: int) -> int:
    dt = model.cfg.dtype
    return sum(math.prod(s.shape) * torch_dtype(s.dtype or dt).itemsize
               for _, s in flatten(model.cache_template(batch, seq_len)))
