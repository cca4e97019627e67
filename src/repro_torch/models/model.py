"""Model assembly of every family of the reference (port of
``repro.models.model``): ``dense`` (GQA or MLA attention), ``moe`` (MoE
FFN, dense-first layers, MLA), ``ssm`` (Mamba-2), ``hybrid``
(RecurrentGemma), ``vlm`` (a dense decoder after precomputed frontend
embeddings) and ``audio`` (a Whisper-style encoder and a decoder with
cross-attention).

One :class:`Model` (an ``nn.Module``) wraps a :class:`ModelConfig` and
holds its parameters, in the reference's layouts:

* ``template()``        — ParamSpec tree, the reference's (layers stacked)
* ``init(seed)``        — draw the parameters (port's own stream)
* ``load_params(flat)`` — copy {``/``-joined path: array} into the module
* ``param_tree()``      — {path: parameter, or its per-layer parameters}
* ``loss_fn(batch)``    — training loss (CE + MoE aux + MTP); ``forward``
* ``prefill``           — full-context forward returning (last_logits, cache)
* ``decode_step``       — one-token serve step against a fixed-size cache
* ``cache_template``    — ParamSpec tree for the serve cache

Layers are ``ModuleList``s walked in a Python loop (the reference's
``lax.scan`` over stacked layers): ``layers`` (and ``layers_dense`` before
them in the moe family, ``enc_layers`` for the audio encoder), or
``periods`` of ``{rec1, rec2, att}`` and a ``tail`` of RG-LRU sublayers
(hybrid); ``load_params`` splits a stacked leaf of shape (L, ...) across
them. Parameters live on the model's device in the config's dtype
(bfloat16 at full size) and take no gradients until a trainer asks for
them (:func:`repro_torch.launch.train.make_train_step`).

Training: ``loss_fn`` adds the MoE aux loss of every MoE layer and, for
the moe family's ``mtp`` group (DeepSeek's multi-token prediction, unused
by serving), ``MTP_LOSS_COEF`` times its cross-entropy. It runs the plain
route of every mixer (``plain=True``: ``chunked_attention``,
``ssd_chunked``, ``rglru_scan_ref``, the reference's XLA path), on the
card too: the kernels have no backward, as the Pallas kernels they
replace have none, so this is the one path where the device does not
pick the kernel (ROADMAP Queue 1 item 9d). ``cfg.remat`` other than
``"none"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``): ``"full"``, and ``"dots"`` too (the
reference's ``checkpoint_dots`` keeps matmul outputs; no config uses it,
and here it recomputes like ``"full"``). Remat changes no value. The loss also runs under ``torch.func.functional_call`` with a
{name: tensor} dict (:meth:`Model.named_from_tree`): the checkpointed
layers are handed their tensors, so a recompute never reads the module's
own parameters back.

The decode cache is updated in place: ``decode_step`` writes the new K/V
or MLA latent entries into the buffers it is given (or rolls a window
cache in place), overwrites the SSM / RG-LRU states and conv windows, and
returns them. The reference returns new arrays; in place saves a copy of
the whole cache per step. On the card the step is one CUDA graph,
captured at a cache's second step and replayed from its third
(:mod:`repro_torch.models.decode_graph`); ``_decode_body`` is the eager
step it captures. On the card ``prefill`` replays one CUDA graph per
prompt-length bucket of ``_prefill_body`` over the prompt padded to its
bucket (:mod:`repro_torch.models.prefill_graph`); every refused call
runs ``_prefill_body`` eagerly over the prompt as it is.

Serving spans (:mod:`repro_torch.spans`, on only under a profiler):
``repro_torch.prefill`` and ``repro_torch.decode_step`` (each method
whole), ``repro_torch.head`` (final norm and head) and
``repro_torch.decode_attention`` (a buffered GQA or MLA decode layer's
attention, projections to output; MLA's holds ``repro_torch.mla.q``,
``.mla.kv`` and ``.mla.absorbed``); ``repro_torch.decode_graph.capture``
and ``.decode_graph.replay`` inside ``decode_step``;
``repro_torch.prefill_graph.capture`` and ``.prefill_graph.replay``
inside ``prefill``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import graphs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import (
    blocks, decode_graph, prefill_graph, rglru, ssd,
)
from repro_torch.models.blocks import (
    _proj_heads, chunked_attention, cross_attention, gqa_attention,
    gqa_template, mla_attention, mla_template, mlp, mlp_template, moe_ffn,
    moe_template, out_proj, rmsnorm,
)
from repro_torch.sharding.partitioning import (
    ParamModule, ParamSpec, flatten, hint, iter_init, torch_dtype,
)
from repro_torch.spans import span


def _stack(t, n: int):
    """Add a leading stacked-layers dim to every ParamSpec in a template."""
    if isinstance(t, ParamSpec):
        return ParamSpec((n,) + t.shape, ("layers",) + t.axes, t.init,
                         t.dtype)
    return {k: _stack(v, n) for k, v in t.items()}


def _norm_spec(d):
    return ParamSpec((d,), (None,), "ones")


def _attn_block_template(cfg: ModelConfig, ffn: str = "mlp") -> dict:
    d = cfg.d_model
    t = {"ln1": _norm_spec(d), "ln2": _norm_spec(d)}
    t["attn"] = mla_template(cfg) if cfg.mla is not None else gqa_template(cfg)
    if ffn == "mlp":
        t["mlp"] = mlp_template(d, cfg.d_ff)
    elif ffn == "moe":
        t["moe"] = moe_template(cfg)
    elif ffn == "dense_first":
        t["mlp"] = mlp_template(d, cfg.moe.dense_d_ff or cfg.d_ff)
    return t


def _encdec_dec_block_template(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": _norm_spec(d), "attn": gqa_template(cfg),
        "lnx": _norm_spec(d), "xattn": gqa_template(cfg),
        "ln2": _norm_spec(d), "mlp": mlp_template(d, cfg.d_ff),
    }


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


# ---------------------------------------------------------------------------
# Block forward functions
# ---------------------------------------------------------------------------

MTP_LOSS_COEF = 0.1


def _ffn(p, x, cfg: ModelConfig):
    """The block's MLP or MoE FFN: (y, MoE aux loss, 0.0 for an MLP).
    ``expert_parallel="shard_map"`` selects the expert-parallel
    ``moe_ffn_shard_map``, which is :func:`moe_ffn` without a mesh."""
    if "moe" not in p:
        return mlp(p["mlp"], x), 0.0
    if cfg.expert_parallel == "shard_map":
        return blocks.moe_ffn_shard_map(p["moe"], x, cfg)
    return moe_ffn(p["moe"], x, cfg)


def _attn_block(p, h, cfg: ModelConfig, plain=False):
    """One attention block over the full sequence. Returns (h, MoE aux
    loss, cache entries): (ckv,) for MLA, (k, v) for GQA."""
    h = hint(h, ("batch", None, None))
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, ckv = mla_attention(p["attn"], x, cfg)
        cache = (ckv,)
    else:
        a, cache = gqa_attention(p["attn"], x, cfg, plain=plain)
    h = h + a
    x2 = rmsnorm(h, p["ln2"], cfg.norm_eps)
    f, aux = _ffn(p, x2, cfg)
    return h + f, aux, cache


def _attn_block_decode(p, h, cfg: ModelConfig, cache_slice, pos, *,
                       window_cache=False):
    """One layer of one decode step; writes the layer's cache in place."""
    h = hint(h, ("batch", None, None))
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        h = h + _mla_decode_buffered(p["attn"], x, cache_slice["ckv"], pos,
                                     cfg)
    else:
        decode = _gqa_decode_window if window_cache else _gqa_decode_buffered
        h = h + decode(p["attn"], x, cache_slice["k"], cache_slice["v"], cfg,
                       pos)
    x2 = rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + _ffn(p, x2, cfg)[0]


def _encdec_block(p, h, enc_out, cfg: ModelConfig, plain=False):
    """One decoder block of the audio family over the full sequence:
    causal self-attention, cross-attention to the encoder output, MLP.
    Returns (h, (k, v, xk, xv))."""
    h = hint(h, ("batch", None, None))
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    a, (k, v) = gqa_attention(p["attn"], x, cfg, plain=plain)
    h = h + a
    xq = rmsnorm(h, p["lnx"], cfg.norm_eps)
    ek = _proj_heads(enc_out, p["xattn"]["wk"])
    ev = _proj_heads(enc_out, p["xattn"]["wv"])
    if cfg.qkv_bias:
        ek = ek + p["xattn"]["bk"]
        ev = ev + p["xattn"]["bv"]
    h = h + cross_attention(p["xattn"], xq, (ek, ev), cfg)
    h = h + mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))
    return h, (k, v, ek, ev)


def _encdec_block_decode(p, h, cfg: ModelConfig, st, pos):
    """One decoder block of one audio decode step against its caches
    ``st`` = (k, v, xk, xv); writes k and v in place."""
    ck, cv, xk, xv = st
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    h = h + _gqa_decode_buffered(p["attn"], x, ck, cv, cfg, pos)
    xq = rmsnorm(h, p["lnx"], cfg.norm_eps)
    h = h + cross_attention(p["xattn"], xq, (xk, xv), cfg)
    return h + mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps))


def _write_at(c, new, pos):
    """Write a one-token entry into a (B,S,...) buffer at ``pos``, in
    place — 0-d (shared position) or (B,) per-sequence (continuous
    batching). Index tensors stay on the device: no host sync. A DTensor
    buffer (the dry-run's) is written by a masked select, which DTensor
    runs shard by shard: its index writes either have no sharding rule
    or, in place, change the placements but not the shard."""
    if pos.dim() == 0:
        if _is_dtensor(c):
            hit = torch.arange(c.shape[1], device=c.device) == pos
            hit = hit.reshape((1, -1) + (1,) * (c.dim() - 2))
            return c.copy_(torch.where(hit, new, c))
        return c.index_copy_(1, pos.reshape(1), new)
    B = c.shape[0]
    c[torch.arange(B, device=c.device), pos] = new[:, 0]
    return c


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _positions(pos, batch):
    """(B, 1) RoPE positions from a 0-d or (B,) position tensor."""
    return pos.reshape(-1, 1).expand(batch, 1)


def _gqa_decode_buffered(p, x, ck, cv, cfg, pos):
    """Decode against a fixed-size buffer: write at ``pos`` (in place),
    attend to the positions up to ``pos``
    (:func:`~repro_torch.kernels.decode_attention.decode_attention`: the
    kernel on the card, which reads the buffer only that far). DTensor
    buffers attend as a manual region (``blocks._localize``). The span
    ``repro_torch.decode_attention``."""
    with span("repro_torch.decode_attention"):
        q, k_new, v_new = blocks.gqa_project_qkv(p, x, cfg)
        posb = _positions(pos, x.shape[0])
        q = blocks.apply_rope(q, posb, cfg.rope_theta)
        k_new = blocks.apply_rope(k_new, posb, cfg.rope_theta)
        q, k, v, back = blocks._localize(q, _write_at(ck, k_new, pos),
                                         _write_at(cv, v_new, pos))
        out = back(decode_attention(q, k, v, pos,
                                    window=cfg.sliding_window))
        return out_proj(out, p["wo"])


def _mla_decode_buffered(p, x, cache, pos, cfg):
    """MLA absorbed decode against a fixed-size latent buffer: write the
    new entry at ``pos`` (in place), mask entries beyond each sequence's
    position. The span ``repro_torch.decode_attention``, holding
    ``repro_torch.mla.q``, ``repro_torch.mla.kv`` (the new entry and its
    write) and ``repro_torch.mla.absorbed`` (the absorbed attention and
    the out product)."""
    with span("repro_torch.decode_attention"):
        posb = _positions(pos, x.shape[0])
        q_nope, q_rope = blocks._mla_q(p, x, cfg.mla, cfg, posb)
        with span("repro_torch.mla.kv"):
            cache = _write_at(cache, blocks.mla_new_entry(p, x, cfg, posb),
                              pos)
        with span("repro_torch.mla.absorbed"):
            valid = torch.arange(cache.shape[1],
                                 device=x.device)[None, :] <= posb
            return blocks.mla_absorbed(p, q_nope, q_rope, cache, cfg, valid)


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


def _hybrid_sub(p, h, cfg: ModelConfig, kind: str, plain=False):
    """One hybrid sublayer (mixer + MLP) over the full sequence. Returns
    (h, state): (h_last, conv_tail) for RG-LRU, the last ``window`` keys
    and values for local attention."""
    h = hint(h, ("batch", None, None))
    x = rmsnorm(h, p["ln1"], cfg.norm_eps)
    if kind == "rglru":
        y, st = rglru.rglru_forward(p["mix"], x, cfg, plain=plain)
    else:
        win = cfg.rglru.window
        y, (k, v) = gqa_attention(p["mix"], x, cfg, window=win, plain=plain)
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
_ENCDEC_CACHE = ("k", "v", "xk", "xv")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """A model of any family on ``device`` (default ``"cuda"``: raises
    without CUDA unless the CPU, or ``"meta"`` for shapes only, is asked
    for). Parameters are allocated uninitialised; call :meth:`init` or
    :meth:`load_params`."""

    STACKED = ("layers_dense", "layers", "enc_layers", "periods", "tail")

    def __init__(self, cfg: ModelConfig, *, device="cuda", dtype=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.dtype = torch_dtype(dtype or cfg.dtype)
        top = {k: v for k, v in self.template().items()
               if k not in self.STACKED}
        self.top = ParamModule(top, dev, self.dtype)
        stacks = self._stacks()
        for name in self.STACKED:
            template, n = stacks.get(name, (None, 0))
            setattr(self, name, nn.ModuleList(
                ParamModule(template, dev, self.dtype) for _ in range(n)))
        self._decode_graph = None        # decode_graph.DecodeGraph
        self._prefill_graphs = None      # prefill_graph.PrefillGraphs

    def __getstate__(self):
        # a CUDA graph neither pickles nor copies: a copy starts without one
        return dict(super().__getstate__(), _decode_graph=None,
                    _prefill_graphs=None)

    def _drop_graphs(self):
        self._decode_graph = None
        self._prefill_graphs = None

    def _apply(self, fn, recurse=True):
        self._drop_graphs()              # tensors moved or cast: drop them
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    # ------------------------------------------------------------- templates
    def _hybrid_counts(self):
        L = self.cfg.num_layers
        period = len(self.cfg.rglru.pattern)
        return L // period, L % period

    def _stacks(self) -> dict:
        """{stacked group: (one layer's template, number of layers)}."""
        cfg = self.cfg
        fam, L = cfg.family, cfg.num_layers
        if fam in ("dense", "vlm"):
            return {"layers": (_attn_block_template(cfg), L)}
        if fam == "moe":
            fk = cfg.moe.first_k_dense
            out = {"layers": (_attn_block_template(cfg, "moe"), L - fk)}
            if fk:
                out["layers_dense"] = (
                    _attn_block_template(cfg, "dense_first"), fk)
            return out
        if fam == "ssm":
            return {"layers": (_ssm_block_template(cfg), L)}
        if fam == "hybrid":
            n_per, n_tail = self._hybrid_counts()
            out = {"periods": (_hybrid_period(cfg), n_per)}
            if n_tail:
                out["tail"] = (_hybrid_sublayer(cfg, "rglru"), n_tail)
            return out
        if fam == "audio":
            return {"enc_layers": (_attn_block_template(cfg),
                                   cfg.num_encoder_layers),
                    "layers": (_encdec_dec_block_template(cfg), L)}
        raise ValueError(fam)

    def template(self) -> dict:
        cfg = self.cfg
        d, v = cfg.d_model, cfg.vocab_size
        t: Dict[str, Any] = {
            "embed": ParamSpec((v, d), ("vocab", "embed"), "embed"),
            "final_norm": _norm_spec(d),
        }
        if not cfg.tie_embeddings:
            t["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))
        for name, (template, n) in self._stacks().items():
            t[name] = _stack(template, n)
        if cfg.family == "moe" and cfg.num_mtp_modules:
            t["mtp"] = {
                "proj": ParamSpec((2 * d, d), ("embed", None)),
                "norm_h": _norm_spec(d), "norm_e": _norm_spec(d),
                "block": _attn_block_template(cfg, "moe"),
                "final_norm": _norm_spec(d),
            }
        if cfg.family == "audio":
            t["enc_norm"] = _norm_spec(d)
        return t

    def _attn_layers(self):
        """The attention blocks of the dense, vlm and moe families in
        order: the dense-first layers, then the rest."""
        return list(self.layers_dense) + list(self.layers)

    # ------------------------------------------------------------ parameters
    def _targets(self, path: str):
        """The parameter(s) a reference leaf path maps onto: one tensor, or
        one per layer for a stacked leaf (``layers/``, ``periods/``, ...)."""
        head, _, sub = path.partition("/")
        if head in self.STACKED:
            return [layer.leaf(sub) for layer in getattr(self, head)]
        return self.top.leaf(path)

    @torch.no_grad()
    def load_params(self, flat: Mapping[str, torch.Tensor]) -> "Model":
        """Copy {``/``-joined reference path: tensor} into the parameters
        (cast to their dtype, moved to their device). Every template leaf
        must be present with its shape; nothing else may be."""
        self._drop_graphs()
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

    def param_tree(self) -> Dict[str, Any]:
        """{reference path: parameter}, a stacked leaf as the list of its
        per-layer parameters (the optimiser's tree,
        :mod:`repro_torch.optim.adamw`). A stacked group without layers
        (a reduced hybrid's ``periods``) gives an empty tensor of the
        reference's (0, ...) shape, which no gradient reaches."""
        out = {}
        for path, spec in flatten(self.template()):
            leaf = self._targets(path)
            if isinstance(leaf, list) and not leaf:
                leaf = torch.zeros(spec.shape, device=self.device,
                                   dtype=torch_dtype(spec.dtype or
                                                     self.dtype))
            out[path] = leaf
        return out

    def named_from_tree(self, tree: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """{module parameter name: tensor} for
        ``torch.func.functional_call`` from {reference path: tensor in the
        reference's shape}; a stacked leaf is split into its layers' rows
        (views, so gradients reach the stacked tensor)."""
        out = {}
        for path, t in tree.items():
            head, _, sub = path.partition("/")
            if head in self.STACKED:
                name = sub.replace("/", ".")
                for l, row in enumerate(t.unbind(0)):
                    out[f"{head}.{l}.{name}"] = row
            else:
                out["top." + path.replace("/", ".")] = t
        return out

    @torch.no_grad()
    def init(self, seed: int = 0) -> "Model":
        """Draw every parameter on the model's device (the reference's
        initialisers, the port's own random stream: see
        :mod:`repro_torch.sharding.partitioning`), one leaf at a time."""
        self._drop_graphs()
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
        if self.cfg.embedding_impl == "one_hot":
            # a matmul in place of the gather (the reference's option for
            # its stacked-hypothesis trainer under a mesh)
            oh = torch.nn.functional.one_hot(
                tokens.long(), self.cfg.vocab_size).to(self.dtype)
            h = oh @ self.top["embed"].to(self.dtype)
        else:
            h = self.top["embed"][tokens.long()].to(self.dtype)
        if self.cfg.family == "hybrid":           # gemma-style scaling
            # sqrt(d_model) rounded to the model dtype, as the reference
            # (a fill, not a copy from the host: the decode graph captures it)
            h = h * torch.full((), self.cfg.d_model ** 0.5, dtype=self.dtype,
                               device=h.device)
        # keep activations batch-sharded (not FSDP-sharded on d_model)
        return hint(h, ("batch", None, None))

    def _final(self, h):
        """The final norm and the head: the span ``repro_torch.head``."""
        with span("repro_torch.head"):
            return self._head(self._norm(h))

    def _head(self, h):
        if self.cfg.tie_embeddings:
            return h @ self.top["embed"].t()
        return h @ self.top["lm_head"]

    # ---------------------------------------------------------- trunk passes
    def _bodies(self, enc_out, plain, length=None):
        """(layers, body, cache leaf names) in the order the trunk runs
        them; ``body(p, h)`` returns (h, MoE aux loss, cache entries).
        ``length`` (a padded prefill's) reaches the SSD mixer."""
        cfg = self.cfg
        if cfg.family in ("dense", "vlm", "moe"):
            names = ("ckv",) if cfg.mla is not None else ("k", "v")
            return [(self._attn_layers(), lambda p, h: _attn_block(
                p, h, cfg, plain), names)]
        if cfg.family == "audio":
            def dec(p, h):
                h, entries = _encdec_block(p, h, enc_out, cfg, plain)
                return h, 0.0, entries
            return [(self.layers, dec, _ENCDEC_CACHE)]
        if cfg.family == "ssm":
            def ssm(p, h):
                h = hint(h, ("batch", None, None))
                x = rmsnorm(h, p["ln1"], cfg.norm_eps)
                y, st = ssd.ssd_forward(p["mixer"], x, cfg, plain=plain,
                                        length=length)
                return h + y, 0.0, st
            return [(self.layers, ssm, ("state", "conv"))]

        def period(p, h):
            sts = ()
            for sub, kind, _ in _PERIOD_CACHE:
                h, st = _hybrid_sub(p[sub], h, cfg, kind, plain)
                sts += st
            return h, 0.0, sts

        def tail(p, h):
            h, st = _hybrid_sub(p, h, cfg, "rglru", plain)
            return h, 0.0, st
        return [(self.periods, period,
                 sum((names for _, _, names in _PERIOD_CACHE), ())),
                (self.tail, tail, _TAIL_CACHE)]

    def _trunk(self, h, *, collect_cache=False, enc_out=None, plain=False,
               remat=False, length=None):
        """Full-sequence pass over all layers (the audio decoder attends
        to ``enc_out``); ``plain`` takes every mixer's plain route,
        ``remat`` recomputes each layer (a hybrid period) in the backward
        pass, ``length`` marks the positions from it on as padding (the
        SSD mixer's; :meth:`_prefill_body`). Returns (h, MoE aux loss
        summed over layers, caches): per cache leaf name, the list of
        per-layer entries (empty unless ``collect_cache``)."""
        caches: Dict[str, list] = {}
        aux = 0.0
        for layers, body, names in self._bodies(enc_out, plain, length):
            for p_l in layers:
                h, a, entries = _run(body, p_l, h, remat)
                aux = aux + a
                if collect_cache:
                    for name, value in zip(names, entries):
                        caches.setdefault(name, []).append(value)
        return h, aux, caches

    def _encode(self, enc_embeds, *, plain=False, remat=False):
        """The audio encoder over precomputed (stub-frontend) frame
        embeddings: sinusoidal positions, then non-causal self-attention
        without RoPE (through the flash kernel, or with ``plain`` through
        ``chunked_attention``) and an MLP per layer."""
        cfg = self.cfg
        h = enc_embeds.to(self.dtype)
        S, d = h.shape[1], h.shape[2]
        pos = torch.arange(S, device=h.device, dtype=torch.float32)[:, None]
        dim = torch.arange(0, d, 2, device=h.device,
                           dtype=torch.float32)[None, :]
        angle = pos / torch.pow(10000.0, dim / d)
        pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
        h = h + pe[None].to(self.dtype)

        def layer(p, h):
            h = hint(h, ("batch", None, None))
            x = rmsnorm(h, p["ln1"], cfg.norm_eps)
            a, _ = gqa_attention(p["attn"], x, cfg, causal=False,
                                 rope=False, plain=plain)
            h = h + a
            return h + mlp(p["mlp"], rmsnorm(h, p["ln2"], cfg.norm_eps)), \
                0.0, ()
        for p_l in self.enc_layers:
            h = _run(layer, p_l, h, remat)[0]
        return rmsnorm(h, self.top["enc_norm"], cfg.norm_eps)

    # -------------------------------------------------------------- training
    def loss_fn(self, batch):
        """batch: int ``tokens`` and ``targets`` (B, S) on the model's
        device, plus ``frontend_embeds`` (vlm: prepended, then sliced off
        before the head) or ``encoder_embeds`` (audio). Returns (total,
        metrics): total = CE + MoE aux (+ ``MTP_LOSS_COEF`` x MTP CE), a
        0-d float32 tensor to differentiate, and the detached metrics
        {"ce", "aux", "loss"[, "mtp"]}. Plain route, ``cfg.remat`` honoured
        (module doc)."""
        cfg = self.cfg
        remat = cfg.remat != "none"
        tokens, targets = batch["tokens"], batch["targets"]
        h = self._embed(tokens)
        enc_out = None
        n_front = 0
        if cfg.family == "audio":
            enc_out = self._encode(batch["encoder_embeds"], plain=True,
                                   remat=remat)
        elif cfg.family == "vlm":
            fe = batch["frontend_embeds"].to(self.dtype)
            n_front = fe.shape[1]
            h = torch.cat([fe, h], dim=1)
        h, aux, _ = self._trunk(h, enc_out=enc_out, plain=True, remat=remat)
        if n_front:
            h = h[:, n_front:]
        h = self._norm(h)
        loss = _ce(self._head(h), targets)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
        metrics = {"ce": loss.detach(), "aux": aux.detach()}
        if cfg.num_mtp_modules:
            mtp = self._mtp_loss(h, tokens, targets)
            metrics["mtp"] = mtp.detach()
            loss = loss + MTP_LOSS_COEF * mtp
        total = loss + aux
        metrics["loss"] = total.detach()
        return total, metrics

    def forward(self, batch):
        """:meth:`loss_fn`, so that ``torch.func.functional_call`` runs
        the loss under parameters given by name."""
        return self.loss_fn(batch)

    def _mtp_loss(self, h, tokens, targets):
        """DeepSeek-V3 multi-token prediction: predict t+2 from (final-
        normed h_t, the embedding of token t+1), through one MoE block
        (its aux loss is not added, as in the reference)."""
        cfg = self.cfg
        m = self.top["mtp"]
        h_in = rmsnorm(h[:, :-1], m["norm_h"], cfg.norm_eps)
        e_in = rmsnorm(self._embed(tokens[:, 1:]), m["norm_e"], cfg.norm_eps)
        x = torch.cat([h_in, e_in], dim=-1) @ m["proj"]
        x2, _, _ = _attn_block(m["block"], x, cfg, plain=True)
        x2 = rmsnorm(x2, m["final_norm"], cfg.norm_eps)
        return _ce(self._head(x2), targets[:, 1:])

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch, *, plain=False):
        """batch: {"tokens": (B, S) integer tensor on the model's device},
        plus ``frontend_embeds`` (B, F, D) for the vlm family (prepended
        to the token embeddings) or ``encoder_embeds`` (B, T, D) for the
        audio family. Returns (last_token_logits (B, V), cache), the cache
        of the S positions (the vlm's frontend positions before them).
        ``plain`` takes every mixer's plain route (the dry-run's trace,
        whose fake tensors no kernel can take).

        On the card, the dense, moe and ssm families replay a CUDA graph
        of :meth:`_prefill_body` over the prompt padded to its bucket,
        captured once per bucket of S
        (:mod:`repro_torch.models.prefill_graph`): the real positions'
        logits and cache as the true-length prefill's up to rounding,
        returned as fresh tensors. Every call that module refuses
        (:func:`~repro_torch.models.prefill_graph.refusal`: the CPU and
        ``plain`` among others) runs :meth:`_prefill_body` as it is. The
        graphs read the parameters at the addresses they were captured
        on: ``load_params``, ``init`` and moves or casts of the module drop
        them. The span ``repro_torch.prefill``."""
        with span("repro_torch.prefill"):
            why = prefill_graph.refusal(self, batch, plain)
            if why is not None:
                prefill_graph.count(eager=1, refused={why: 1})
                return self._prefill_body(batch, plain=plain)
            return prefill_graph.prefill(self, batch["tokens"])

    def _prefill_body(self, batch, *, plain=False, length=None):
        """The eager prefill (:meth:`prefill`'s arguments and return,
        called under its ``no_grad``). With ``length`` (a 0-d long tensor
        on the device; text families), the tokens from ``length`` on are
        padding, as the prefill graph captures the body: the SSD mixer's
        dt is 0 there and its conv tail is read at ``length``, the logits
        are those at ``length - 1`` (device indices, no host sync), and
        the cache holds every position,
        :mod:`repro_torch.models.prefill_graph` cuts it."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = self._embed(tokens)
        enc_out = None
        if cfg.family == "audio":
            enc_out = self._encode(batch["encoder_embeds"], plain=plain)
        elif cfg.family == "vlm":
            h = torch.cat([batch["frontend_embeds"].to(self.dtype), h],
                          dim=1)
        h, _, caches = self._trunk(h, collect_cache=True, enc_out=enc_out,
                                   plain=plain, length=length)
        last = h[:, -1:] if length is None else \
            h.index_select(1, (length - 1).reshape(1))
        logits = self._final(last)[:, 0]
        return logits, self._pack_cache(caches, tokens.shape[0], h.shape[1])

    def _pack_cache(self, caches, batch: int, seq_len: int):
        """Stack the per-layer entries into the reference's cache leaves
        ((layers, batch, ...)); the MLA ``ckv`` holds the dense-first
        layers, then the rest. A hybrid model without periods (or tail)
        gets the empty leaves of its cache template."""
        cfg = self.cfg
        tmpl = self.cache_template(batch, seq_len)
        out = {}
        for name, spec in tmpl.items():
            vals = caches.get(name)
            out[name] = torch.stack(vals) if vals else torch.zeros(
                spec.shape, dtype=self.dtype, device=self.device)
        if (cfg.family in ("dense", "vlm", "moe") and cfg.mla is None
                and cfg.sliding_window):
            w = min(cfg.sliding_window, out["k"].shape[2])
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

        if cfg.mla is not None:
            width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            return {"ckv": ParamSpec((L, B, S, width),
                                     ("layers", "batch", "cache_len", None),
                                     "zeros", None)}
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
        if cfg.family == "audio":
            xk, xv = kv(L, cfg.encoder_seq_len)
            return {"k": k, "v": v, "xk": xk, "xv": xv}
        return {"k": k, "v": v}

    def cache_len_axes(self, batch: int, seq_len: int) -> dict:
        """{cache leaf: its ``cache_len`` axis, or None}."""
        return {name: spec.axes.index("cache_len")
                if "cache_len" in spec.axes else None
                for name, spec in self.cache_template(batch, seq_len).items()}

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One serve step: tokens (B,1) integers, pos an int, a 0-d tensor
        or a (B,) tensor of per-sequence positions (the ssm family ignores
        it, as the reference does).

        Returns (logits (B,V), cache): the caches are fixed-size buffers
        written in place (K/V or MLA latents at ``pos``, window caches
        rolled, recurrent states and conv windows overwritten) and
        returned; the audio family's cross-attention caches are read only.
        On the card, a replay of a CUDA graph of :meth:`_decode_body`
        from a cache's third step on (:mod:`repro_torch.models.
        decode_graph`): the same kernels, bitwise the same logits, returned
        as a fresh tensor. The graph reads the parameters at the addresses
        it was captured on: ``load_params``, ``init`` and moves or casts of
        the module drop it, and nothing else may swap them (no
        ``torch.func.functional_call`` of this method on the card). The
        span ``repro_torch.decode_step``.
        """
        with span("repro_torch.decode_step"):
            if decode_graph.refusal(cache, tokens, pos) is not None:
                decode_graph.count(eager=1)
                return self._decode_body(cache, tokens, pos)
            key = decode_graph.graph_key(cache, tokens, pos, self.cfg)
            g = self._decode_graph
            if g is None or g.key != key:
                self._decode_graph = None    # the old graph's pool goes first
                self._decode_graph = decode_graph.DecodeGraph(key, cache,
                                                              self)
                decode_graph.count(eager=1)
                return graphs.warm_up(
                    lambda: self._decode_body(cache, tokens, pos),
                    self.device)
            if g.graph is None:
                g.capture(self._decode_body, cache, tokens, pos)
            return g.replay(tokens, pos), cache

    def _decode_body(self, cache, tokens, pos):
        """The eager decode step (:meth:`decode_step`'s arguments and
        return, called under its ``no_grad``), which the decode graph
        captures."""
        cfg = self.cfg
        pos = pos.to(self.device, torch.long) if torch.is_tensor(pos) \
            else torch.full((), int(pos), dtype=torch.long,
                            device=self.device)
        h = self._embed(tokens)
        if cfg.family in ("dense", "vlm", "moe"):
            window_cache = bool(cfg.sliding_window)
            names = ("ckv",) if cfg.mla is not None else ("k", "v")
            for l, p_l in enumerate(self._attn_layers()):
                c_l = {n: cache[n][l] for n in names}
                h = _attn_block_decode(p_l, h, cfg, c_l, pos,
                                       window_cache=window_cache)
        elif cfg.family == "audio":
            for l, p_l in enumerate(self.layers):
                st = tuple(cache[n][l] for n in _ENCDEC_CACHE)
                h = _encdec_block_decode(p_l, h, cfg, st, pos)
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
        logits = self._final(h)[:, 0]
        return logits, cache


def _run(body, p, h, remat: bool):
    """``body(p, h)``, or with ``remat`` under ``torch.utils.checkpoint``
    (non-reentrant), handed the layer's tensors (a nested dict) rather
    than its module, so that the recompute in the backward pass sees the
    tensors of the forward pass (those of a ``functional_call`` too)."""
    if not remat:
        return body(p, h)
    return checkpoint(body, p.tensors(), h, use_reentrant=False)


def _ce(logits, targets):
    """Mean token cross-entropy, in float32. Under a mesh the logits are
    gathered over the vocabulary first (DTensor's vocab-parallel gather
    fails to reduce its masked partial sums at rank 3)."""
    logits = hint(logits, ("batch", None, None)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).mean()


def build_model(cfg: ModelConfig, *, device="cuda", dtype=None) -> Model:
    return Model(cfg, device=device, dtype=dtype)
