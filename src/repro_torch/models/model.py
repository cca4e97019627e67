"""Model assembly of the ``dense``, ``ssm`` and ``hybrid`` families (port
of ``repro.models.model``).

One :class:`Model` (an ``nn.Module``) wraps a :class:`ModelConfig` and
holds its parameters, in the reference's layouts:

* ``template()``        — ParamSpec tree, the reference's (layers stacked)
* ``init(seed)``        — draw the parameters (port's own stream)
* ``load_params(flat)`` — copy {``/``-joined path: array} into the module
* ``prefill``           — full-context forward returning (last_logits, cache)
* ``decode_step``       — one-token serve step against a fixed-size cache
* ``cache_template``    — ParamSpec tree for the serve cache

Layers are ``ModuleList``s walked in a Python loop (the reference's
``lax.scan`` over stacked layers): ``layers`` (dense, ssm), or ``periods``
of ``{rec1, rec2, att}`` and a ``tail`` of RG-LRU sublayers (hybrid);
``load_params`` splits a stacked ``layers/...``, ``periods/...`` or
``tail/...`` leaf of shape (L, ...) across them. Parameters live
on the model's device in the config's dtype (bfloat16 at full size) and
take no gradients: the port serves, training is a later slice
(``loss_fn`` waits for ROADMAP Queue 1 item 9d).

The decode cache is updated in place: ``decode_step`` writes the new K/V
entries into the buffers it is given (or rolls a window cache in place),
overwrites the SSM / RG-LRU states and conv windows, and returns them.
The reference returns new arrays; in place saves a copy of the whole
cache per step.

Ported: ``dense`` without MLA or MoE, ``ssm`` (Mamba-2) and ``hybrid``
(RecurrentGemma); any other config raises :class:`NotImplementedError`
naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import NOT_PORTED, ModelConfig
from repro_torch.models import blocks, rglru, ssd
from repro_torch.models.blocks import (
    chunked_attention, gqa_attention, gqa_template, mlp, mlp_template,
    out_proj, rmsnorm,
)
from repro_torch.sharding.partitioning import (
    ParamModule, ParamSpec, flatten, iter_init, torch_dtype,
)


def _stack(t, n: int):
    """Add a leading stacked-layers dim to every ParamSpec in a template."""
    if isinstance(t, ParamSpec):
        return ParamSpec((n,) + t.shape, ("layers",) + t.axes, t.init,
                         t.dtype)
    return {k: _stack(v, n) for k, v in t.items()}


def _norm_spec(d):
    return ParamSpec((d,), (None,), "ones")


def _attn_block_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {"ln1": _norm_spec(d), "ln2": _norm_spec(d),
            "attn": gqa_template(cfg), "mlp": mlp_template(d, cfg.d_ff)}


def _ssm_block_template(cfg: ModelConfig) -> dict:
    return {"ln1": _norm_spec(cfg.d_model), "mixer": ssd.ssd_template(cfg)}


def _hybrid_sublayer(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    mix = rglru.rglru_template(cfg) if kind == "rglru" else gqa_template(cfg)
    return {"ln1": _norm_spec(d), "mix": mix,
            "ln2": _norm_spec(d), "mlp": mlp_template(d, cfg.d_ff)}


def _hybrid_period(cfg: ModelConfig) -> dict:
    return {"rec1": _hybrid_sublayer(cfg, "rglru"),
            "rec2": _hybrid_sublayer(cfg, "rglru"),
            "att": _hybrid_sublayer(cfg, "attn")}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.mla is None and cfg.moe is None and cfg.family in (
            "dense", "ssm", "hybrid"):
        return
    item = NOT_PORTED.get(cfg.name, "Queue 1 item 9 (LM families)")
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r}"
        f"{' with MLA' if cfg.mla is not None else ''} is not ported yet: "
        f"ROADMAP {item}")


# ---------------------------------------------------------------------------
# Block forward functions
# ---------------------------------------------------------------------------

def _attn_block(p, h, cfg: ModelConfig):
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    a, cache = gqa_attention(p["attn"], x, cfg)
    h = h + a
    x2 = rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + mlp(p["mlp"], x2), cache


def _attn_block_decode(p, h, cfg: ModelConfig, cache_slice, pos, *,
                       window_cache=False):
    """One layer of one decode step; writes the layer's cache in place."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    decode = _gqa_decode_window if window_cache else _gqa_decode_buffered
    h = h + decode(p["attn"], x, cache_slice["k"], cache_slice["v"], cfg, pos)
    x2 = rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + mlp(p["mlp"], x2)


def _write_at(c, new, pos):
    """Write a one-token entry into a (B,S,...) buffer at ``pos``, in
    place — 0-d (shared position) or (B,) per-sequence (continuous
    batching). Index tensors stay on the device: no host sync."""
    if pos.dim() == 0:
        return c.index_copy_(1, pos.reshape(1), new)
    B = c.shape[0]
    c[torch.arange(B, device=c.device), pos] = new[:, 0]
    return c


def _positions(pos, batch):
    """(B, 1) RoPE positions from a 0-d or (B,) position tensor."""
    return pos.reshape(-1, 1).expand(batch, 1)


def _gqa_decode_buffered(p, x, ck, cv, cfg, pos):
    """Decode against a fixed-size buffer: write at ``pos`` (in place),
    mask > pos."""
    q, k_new, v_new = blocks.gqa_project_qkv(p, x, cfg)
    posb = _positions(pos, x.shape[0])
    q = blocks.apply_rope(q, posb, cfg.rope_theta)
    k_new = blocks.apply_rope(k_new, posb, cfg.rope_theta)
    k = _write_at(ck, k_new, pos)
    v = _write_at(cv, v_new, pos)
    out = chunked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                            q_offset=pos)
    return out_proj(out, p["wo"])


def _gqa_decode_window(p, x, ck, cv, cfg, pos):
    """Decode against a rolling window cache (all entries valid); the
    rolled window is copied back into ``ck``/``cv``."""
    q, k_new, v_new = blocks.gqa_project_qkv(p, x, cfg)
    posb = _positions(pos, x.shape[0])
    q = blocks.apply_rope(q, posb, cfg.rope_theta)
    k_new = blocks.apply_rope(k_new, posb, cfg.rope_theta)
    k = torch.cat([ck[:, 1:], k_new], dim=1)
    v = torch.cat([cv[:, 1:], v_new], dim=1)
    out = chunked_attention(q, k, v, causal=False, window=0)
    ck.copy_(k)
    cv.copy_(v)
    return out_proj(out, p["wo"])


def _hybrid_sub(p, h, cfg: ModelConfig, kind: str):
    """One hybrid sublayer (mixer + MLP) over the full sequence. Returns
    (h, state): (h_last, conv_tail) for RG-LRU, the last ``window`` keys
    and values for local attention."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "rglru":
        y, st = rglru.rglru_forward(p["mix"], x, cfg)
    else:
        win = cfg.rglru.window
        y, (k, v) = gqa_attention(p["mix"], x, cfg, window=win)
        w = min(win, k.shape[1])
        st = (k[:, -w:], v[:, -w:])
    h = h + y
    return h + mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps)), st


def _hybrid_sub_decode(p, h, cfg: ModelConfig, kind: str, st, pos):
    """One hybrid sublayer of one decode step; writes ``st`` (the
    sublayer's two cache buffers) in place."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "rglru":
        y, _ = rglru.rglru_decode(p["mix"], x, st[0], st[1], cfg)
    else:
        y = _gqa_decode_window(p["mix"], x, st[0], st[1], cfg, pos)
    h = h + y
    return h + mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))


# Hybrid cache leaves of one period, in sublayer order.
_PERIOD_CACHE = (("rec1", "rglru", ("rec1_h", "rec1_conv")),
                 ("rec2", "rglru", ("rec2_h", "rec2_conv")),
                 ("att", "attn", ("att_k", "att_v")))
_TAIL_CACHE = ("tail_h", "tail_conv")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """A decoder of a ported family on ``device`` (default ``"cuda"``:
    raises without CUDA unless the CPU, or ``"meta"`` for shapes only, is
    asked for). Parameters are allocated uninitialised; call :meth:`init`
    or :meth:`load_params`."""

    STACKED = ("layers", "periods", "tail")

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        self.dtype = torch_dtype(dtype or cfg.dtype)
        top = {k: v for k, v in self.template().items()
               if k not in self.STACKED}
        self.top = ParamModule(top, dev, self.dtype)

        def stack(template, n):
            return nn.ModuleList(ParamModule(template, dev, self.dtype)
                                 for _ in range(n))

        if cfg.family == "hybrid":
            n_per, n_tail = self._hybrid_counts()
            self.periods = stack(_hybrid_period(cfg), n_per)
            self.tail = stack(_hybrid_sublayer(cfg, "rglru"), n_tail)
        else:
            self.layers = stack(self._block_template(), cfg.num_layers)

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    # ------------------------------------------------------------- templates
    def _block_template(self) -> dict:
        if self.cfg.family == "ssm":
            return _ssm_block_template(self.cfg)
        return _attn_block_template(self.cfg)

    def _hybrid_counts(self):
        L = self.cfg.num_layers
        period = len(self.cfg.rglru.pattern)
        return L // period, L % period

    def template(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        t: Dict[str, Any] = {
            "embed": ParamSpec((v, d), ("vocab", "embed"), "embed"),
            "final_norm": _norm_spec(d),
        }
        if not cfg.tie_embeddings:
            t["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
        if cfg.family == "hybrid":
            n_per, n_tail = self._hybrid_counts()
            t["periods"] = _stack(_hybrid_period(cfg), n_per)
            if n_tail:
                t["tail"] = _stack(_hybrid_sublayer(cfg, "rglru"), n_tail)
        else:
            t["layers"] = _stack(self._block_template(), cfg.num_layers)
        return t

    # ------------------------------------------------------------ parameters
    def _targets(self, path: str):
        """The parameter(s) a reference leaf path maps onto: one tensor, or
        one per layer for a stacked ``layers/``, ``periods/`` or ``tail/``
        leaf."""
        head, _, sub = path.partition("/")
        if head in self.STACKED:
            return [layer.leaf(sub) for layer in getattr(self, head)]
        return self.top.leaf(path)

    @torch.no_grad()
    def load_params(self, flat: Mapping[str, torch.Tensor]) -> "Model":
        """Copy {``/``-joined reference path: tensor} into the parameters
        (cast to their dtype, moved to their device). Every template leaf
        must be present with its shape; nothing else may be."""
        want = dict(flatten(self.template()))
        if set(flat) != set(want):
            raise ValueError(f"parameter paths differ: missing "
                             f"{sorted(set(want) - set(flat))}, unexpected "
                             f"{sorted(set(flat) - set(want))}")
        for path, spec in want.items():
            self._load_leaf(path, flat[path], spec)
        return self

    def _load_leaf(self, path, src, spec):
        if tuple(src.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)}, want "
                             f"{spec.shape}")
        dst = self._targets(path)
        if isinstance(dst, list):
            for layer_dst, layer_src in zip(dst, src):
                layer_dst.copy_(layer_src)
        else:
            dst.copy_(src)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Draw every parameter on the model's device (the reference's
        initialisers, the port's own random stream: see
        :mod:`repro_torch.sharding.partitioning`), one leaf at a time."""
        want = dict(flatten(self.template()))
        for path, value in iter_init(self.template(), seed, self.dtype,
                                     self.device):
            self._load_leaf(path, value, want[path])
            del value
        return self

    def _norm(self, h):
        return rmsnorm(h, self.top["final_norm"], self.cfg.norm_eps)

    # ------------------------------------------------------------- embedding
    def _embed(self, tokens):
        h = self.top["embed"][tokens.long()].to(self.dtype)
        if self.cfg.family == "hybrid":           # gemma-style scaling
            # sqrt(d_model) rounded to the model dtype, as the reference
            h = h * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.dtype,
                                 device=h.device)
        return h

    def _head(self, h):
        if self.cfg.tie_embeddings:
            return h @ self.top["embed"].t()
        return h @ self.top["lm_head"]

    # ---------------------------------------------------------- trunk passes
    def _trunk(self, h, *, collect_cache=False):
        """Full-sequence pass over all layers. Returns (h, caches): per
        cache leaf name, the list of per-layer entries (empty unless
        ``collect_cache``)."""
        cfg = self.cfg
        caches: Dict[str, list] = {}

        def keep(names, values):
            if collect_cache:
                for name, value in zip(names, values):
                    caches.setdefault(name, []).append(value)

        if cfg.family == "dense":
            for p_l in self.layers:
                h, kv = _attn_block(p_l, h, cfg)
                keep(("k", "v"), kv)
        elif cfg.family == "ssm":
            for p_l in self.layers:
                x = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
                y, st = ssd.ssd_forward(p_l["mixer"], x, cfg)
                h = h + y
                keep(("state", "conv"), st)
        else:
            for p_l in self.periods:
                for sub, kind, names in _PERIOD_CACHE:
                    h, st = _hybrid_sub(p_l[sub], h, cfg, kind)
                    keep(names, st)
            for p_l in self.tail:
                h, st = _hybrid_sub(p_l, h, cfg, "rglru")
                keep(_TAIL_CACHE, st)
        return h, caches

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch):
        """batch: {"tokens": (B, S) integer tensor on the model's device}.
        Returns (last_token_logits (B, V), cache)."""
        tokens = batch["tokens"]
        h = self._embed(tokens)
        h, caches = self._trunk(h, collect_cache=True)
        logits = self._head(self._norm(h[:, -1:]))[:, 0]
        return logits, self._pack_cache(caches, *tokens.shape)

    def _pack_cache(self, caches, batch: int, seq_len: int):
        """Stack the per-layer entries into the reference's cache leaves
        ((layers, batch, ...)); a hybrid model without periods (or tail)
        gets the empty leaves of its cache template."""
        tmpl = self.cache_template(batch, seq_len)
        out = {}
        for name, spec in tmpl.items():
            vals = caches.get(name)
            out[name] = torch.stack(vals) if vals else torch.zeros(
                spec.shape, dtype=self.dtype, device=self.device)
        if self.cfg.family == "dense" and self.cfg.sliding_window:
            w = min(self.cfg.sliding_window, out["k"].shape[2])
            out = {k: v[:, :, -w:] for k, v in out.items()}
        return out

    def cache_template(self, batch: int, seq_len: int) -> dict:
        cfg = self.cfg
        L, B = cfg.num_layers, batch
        KV, hd = cfg.num_kv_heads, cfg.head_dim
        S = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
            else seq_len

        def kv(nl, s):
            ax = ("layers", "batch", "cache_len", "kv_heads", None)
            return (ParamSpec((nl, B, s, KV, hd), ax, "zeros", None),
                    ParamSpec((nl, B, s, KV, hd), ax, "zeros", None))

        if cfg.family == "ssm":
            d_in, nh, P, N = ssd.ssd_dims(cfg)
            ch = d_in + 2 * N
            return {
                "state": ParamSpec((L, B, nh, P, N),
                                   ("layers", "batch", "heads", None, None),
                                   "zeros", None),
                "conv": ParamSpec((L, B, cfg.ssm.conv_width - 1, ch),
                                  ("layers", "batch", None, "mlp"),
                                  "zeros", None)}
        if cfg.family == "hybrid":
            n_per, n_tail = self._hybrid_counts()
            W = rglru.rglru_width(cfg)
            cw = cfg.rglru.conv_width

            def rec(n):
                return (ParamSpec((n, B, W), ("layers", "batch", "lru"),
                                  "zeros", None),
                        ParamSpec((n, B, cw - 1, W),
                                  ("layers", "batch", None, "lru"),
                                  "zeros", None))
            out = {}
            for _, kind, names in _PERIOD_CACHE:
                specs = rec(n_per) if kind == "rglru" \
                    else kv(n_per, min(cfg.rglru.window, seq_len))
                out.update(zip(names, specs))
            if n_tail:
                out.update(zip(_TAIL_CACHE, rec(n_tail)))
            return out
        k, v = kv(L, S)
        return {"k": k, "v": v}

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One serve step: tokens (B,1) integers, pos an int, a 0-d tensor
        or a (B,) tensor of per-sequence positions (the ssm family ignores
        it, as the reference does).

        Returns (logits (B,V), cache): the caches are fixed-size buffers
        written in place (K/V at ``pos``, window caches rolled, recurrent
        states and conv windows overwritten) and returned.
        """
        cfg = self.cfg
        pos = pos.to(self.device, torch.long) if torch.is_tensor(pos) \
            else torch.full((), int(pos), dtype=torch.long, device=self.device)
        h = self._embed(tokens)
        if cfg.family == "dense":
            window_cache = bool(cfg.sliding_window)
            for l, p_l in enumerate(self.layers):
                c_l = {"k": cache["k"][l], "v": cache["v"][l]}
                h = _attn_block_decode(p_l, h, cfg, c_l, pos,
                                       window_cache=window_cache)
        elif cfg.family == "ssm":
            for l, p_l in enumerate(self.layers):
                x = rmsnorm(h, p_l["ln1"], cfg.norm_eps)
                y, _ = ssd.ssd_decode(p_l["mixer"], x, cache["state"][l],
                                      cache["conv"][l], cfg)
                h = h + y
        else:
            for l, p_l in enumerate(self.periods):
                for sub, kind, names in _PERIOD_CACHE:
                    st = tuple(cache[n][l] for n in names)
                    h = _hybrid_sub_decode(p_l[sub], h, cfg, kind, st, pos)
            for l, p_l in enumerate(self.tail):
                st = tuple(cache[n][l] for n in _TAIL_CACHE)
                h = _hybrid_sub_decode(p_l, h, cfg, "rglru", st, pos)
        logits = self._head(self._norm(h))[:, 0]
        return logits, cache


def build_model(cfg: ModelConfig, *, device="cuda", dtype=None) -> Model:
    return Model(cfg, device=device, dtype=dtype)
