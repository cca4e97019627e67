"""Transformer building blocks: RMSNorm, RoPE, q-chunked exact attention
(GQA), the GQA attention block, cross-attention, Multi-head Latent
Attention (MLA), the gated MLP and the top-k MoE FFN with capacity
dropping. Port of ``repro.models.blocks``.

Forwards are plain functions over parameter containers
(:class:`~repro_torch.sharding.partitioning.ParamModule`, indexed like the
reference's dicts: ``p["wq"]``) built from the same
:class:`~repro_torch.sharding.partitioning.ParamSpec` templates, in the
reference's layouts (``wq`` is (D, H, hd), ``wo`` is (H, hd, D)).

Prefill attention (:func:`gqa_attention`) goes through
:func:`~repro_torch.kernels.flash_attention.flash_attention_bshd`: on the
card that is the hand-written kernel, on the CPU its plain version. There
is no ``attention_impl`` switch. The one exception is the training loss:
its caller passes ``plain=True`` and attention runs
:func:`chunked_attention`, the reference's XLA path, on any device. The
kernel has no backward, as the Pallas kernel it replaces has none, so the
training path is the one place where the device does not pick the kernel
(ROADMAP Queue 1 item 9d); the route is the caller's argument, never a
fallback on an error, grad mode or a global. Decode attention is
:func:`chunked_attention` in torch ops, as in the reference, whose decode
never reaches the Pallas kernel (its ``q_offset`` is static, decode
positions are per sequence). Cross-attention and MLA attend through
:func:`chunked_attention` in prefill too, as the reference does (MLA's
q/k head dim differs from its v head dim, which the flash kernel does not
take). Prefill attention runs inside a roofline region
(:func:`repro_torch.roofline.trace.region`): a trace counts the work the
attention needs (:func:`repro_torch.roofline.costs.attention_cost`),
whichever route runs. The reference's ``hint`` calls stand where they
stand there (no-ops without a mesh, :func:`repro_torch.sharding.
partitioning.hint`), and :func:`moe_ffn_shard_map` runs the reference's
expert-parallel schedule under a mesh.

MoE dispatch keeps exactly the reference's assignments: top-k by a stable
descending sort (``lax.top_k`` keeps the lower expert on ties, which
``torch.topk`` does not promise), a stable argsort by expert and capacity
dropping through the drop slot ``E*C``. The combine gathers each token's
K expert rows and adds them in a fixed order (ascending expert, as the
reference's scatter-add visits them) in the activation dtype: no atomics,
so it is the same from run to run on the card. The MoE FFN's router,
dispatch, expert products and combine are spans (:mod:`repro_torch.spans`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.roofline.costs import attention_cost
from repro_torch.roofline.trace import region
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES, MULTIPOD_RULES, P, ParamSpec, current_mesh, hint,
    logical_to_pspec, mesh_axes, to_placements,
)
from repro_torch.spans import span

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-rotation / llama style)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: (..., S) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # (d/2,)
    angles = positions[..., None].float() * freqs                 # (...,S,d/2)
    cos = torch.cos(angles)[..., None, :]                         # (...,S,1,d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core: q-chunked exact attention, GQA aware
# ---------------------------------------------------------------------------

def _attend_chunk(q, k, v, q_pos, k_pos, causal, window):
    """q: (B,Cq,KV,G,hd)  k,v: (B,T,KV,hd)  -> (B,Cq,KV,G,hd).

    q_pos: (Cq,) shared positions, or (B,Cq) per-sequence positions
    (continuous batching decodes sequences at different depths).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,btkd->bqkgt", q.float(), k.float()) * scale
    qp = q_pos[..., :, None]                   # (Cq,1) or (B,Cq,1)
    kp = k_pos[None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window and window > 0:
        mask &= (qp - kp) < window
    if mask.dim() == 2:
        mask = mask[None, :, None, None, :]
    else:                                      # batched positions
        mask = mask[:, :, None, None, :]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqkgt,btkd->bqkgd", probs.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      chunk=512):
    """q: (B,S,H,hd), k/v: (B,T,KV,hd). Exact attention, looped over q
    chunks when S is a multiple of ``chunk`` larger than it.

    q_offset: absolute position of q[0] relative to k[0] (decode: T_cache);
    an int, a 0-d tensor, or a (B,) tensor of per-sequence positions (then
    S must fit one chunk, as in the reference). DTensor inputs run as a
    manual region (:func:`_localize`).
    """
    q, k, v, back = _localize(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]                      # v head dim may differ (MLA)
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    k_pos = torch.arange(T, device=q.device)
    offset = torch.as_tensor(q_offset, device=q.device)
    if S <= chunk or S % chunk != 0:
        q_pos = offset[..., None] + torch.arange(S, device=q.device)
        out = _attend_chunk(qg, k, v, q_pos, k_pos, causal, window)
        return back(out.reshape(B, S, H, vd))
    outs = []
    for start in range(0, S, chunk):
        q_pos = offset + start + torch.arange(chunk, device=q.device)
        outs.append(_attend_chunk(qg[:, start:start + chunk], k, v, q_pos,
                                  k_pos, causal, window))
    return back(torch.cat(outs, dim=1).reshape(B, S, H, vd))


def _localize(q, k, v):
    """Attention under a mesh as a manual region: each rank attends its own
    batch rows and heads, with no collective inside. DTensor q/k/v are laid
    out as ("batch", -, "heads", -), heads sharded only as the KV groups
    divide (so q's heads and k/v's KV heads stay aligned), and unwrapped;
    ``back`` wraps the local output in q's layout. Plain tensors come back
    as they are (``back`` is the identity). DTensor's own propagation of
    the attention's einsums merges a batch-sharded dim with a head-sharded
    one into strided shards, whose redistribution it plans by a graph
    search that a 3-D mesh makes slow."""
    from torch.distributed.tensor import DTensor
    mesh = current_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return q, k, v, lambda out: out
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rules = MULTIPOD_RULES if "pod" in mesh_axes(mesh) else DEFAULT_RULES
    qp = to_placements(logical_to_pspec(
        ("batch", None, "heads", None), (B, S, KV, hd), mesh, rules), mesh)
    kp = to_placements(logical_to_pspec(
        ("batch", None, "kv_heads", None), tuple(k.shape), mesh, rules), mesh)

    def local(t, pl):
        return _ContiguousGrad.apply(t.redistribute(mesh, pl).to_local())

    def back(out):
        return DTensor.from_local(out, mesh, qp, run_check=False)
    return local(q, qp), local(k, kp), local(v, kp), back


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a gradient leaving
    a manual region goes back into DTensor ops, whose views of the local
    shard need a contiguous one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_template(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = {
        "wq": ParamSpec((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, D), ("heads", "head_dim", "embed"),
                        "scaled_normal"),
    }
    if cfg.qkv_bias:
        t["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), "zeros")
        t["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), "zeros")
    return t


def _proj_heads(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product. Under a mesh
    the product's flattened heads dim is laid out as its heads divide
    (:func:`~repro_torch.sharding.partitioning.hint`'s ``units``): DTensor
    has no rule to view a dim sharded across head boundaries."""
    D, H, hd = w.shape
    y = x @ w.reshape(D, H * hd)
    y = hint(y, ("batch",) + (None,) * (y.dim() - 2) + ("heads",),
             units=tuple(y.shape[:-1]) + (H,))
    return y.unflatten(-1, (H, hd))


def out_proj(out, wo):
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product (under a
    mesh, whole heads on each side of the merge, the gradient's view back
    included)."""
    H, hd, D = wo.shape
    lead = ("batch",) + (None,) * (out.dim() - 3)
    out = hint(out, lead + ("heads", None))
    flat = hint(out.flatten(-2), lead + ("heads",),
                units=tuple(out.shape[:-2]) + (H,))
    return flat @ wo.reshape(H * hd, D)


def gqa_project_qkv(p, x, cfg: ModelConfig):
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def gqa_attention(p, x, cfg: ModelConfig, *, positions=None, causal=None,
                  window=None, rope=True, plain=False):
    """Full-sequence GQA self-attention through the flash kernel, or with
    ``plain`` (the training loss) through :func:`chunked_attention`
    (module doc). Returns (output, (k, v))."""
    B, S, D = x.shape
    q, k, v = gqa_project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal if causal is None else causal
    window = cfg.sliding_window if window is None else window
    if cfg.context_parallel_attention:
        # shard query positions over the model axis; K/V replicated there
        q = hint(q, ("batch", "qseq", None, None))
        k = hint(k, ("batch", None, None, None))
        v = hint(v, ("batch", None, None, None))
    attend = chunked_attention if plain else flash_attention_bshd
    ql, kl, vl, back = _localize(q, k, v)
    with region("attention", lambda: attention_cost(
            ql, kl, causal=causal, window=window)):
        out = back(attend(ql, kl, vl, causal=causal, window=window))
    if cfg.context_parallel_attention:
        out = hint(out, ("batch", "qseq", None, None))
    return out_proj(out, p["wo"]), (k, v)


def gqa_decode(p, x, cache_k, cache_v, cfg: ModelConfig, *, t_cache: int,
               window=None, rope=True):
    """One-token decode against a full KV cache of length t_cache."""
    q, k_new, v_new = gqa_project_qkv(p, x, cfg)       # (B,1,?,hd)
    pos = torch.full((x.shape[0], 1), t_cache, device=x.device)
    if rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    k = torch.cat([cache_k, k_new], dim=1)
    v = torch.cat([cache_v, v_new], dim=1)
    window = cfg.sliding_window if window is None else window
    out = chunked_attention(q, k, v, causal=True, window=window,
                            q_offset=t_cache)
    return out_proj(out, p["wo"]), (k_new, v_new)


def cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """Decoder cross-attention over precomputed encoder K/V."""
    k, v = enc_kv
    q = _proj_heads(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    out = chunked_attention(q, k, v, causal=False, window=0)
    return out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — MiniCPM3 / DeepSeek-V3
# ---------------------------------------------------------------------------

def mla_template(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    t = {}
    if m.q_lora_rank:
        t["wq_a"] = ParamSpec((D, m.q_lora_rank), ("embed", "latent"))
        t["q_norm"] = ParamSpec((m.q_lora_rank,), (None,), "ones")
        t["wq_b"] = ParamSpec((m.q_lora_rank, H, qk),
                              ("latent", "heads", None))
    else:
        t["wq"] = ParamSpec((D, H, qk), ("embed", "heads", None))
    t["wkv_a"] = ParamSpec((D, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", "latent"))
    t["kv_norm"] = ParamSpec((m.kv_lora_rank,), (None,), "ones")
    t["wkv_b"] = ParamSpec((m.kv_lora_rank, H,
                            m.qk_nope_head_dim + m.v_head_dim),
                           ("latent", "heads", None))
    t["wo"] = ParamSpec((H, m.v_head_dim, D), ("heads", None, "embed"),
                        "scaled_normal")
    return t


def _mla_q(p, x, m: MLAConfig, cfg, positions):
    if m.q_lora_rank:
        qa = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        q = _proj_heads(qa, p["wq_b"])
    else:
        q = _proj_heads(x, p["wq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def mla_attention(p, x, cfg: ModelConfig, *, positions=None):
    """Expanded (prefill) MLA. Returns the output and the latent cache
    entry (B, S, kv_lora + rope): the normalised latent and the shared
    rope key after RoPE, as the absorbed decode reads it and writes its
    own entries. The reference caches that key before RoPE here, so its
    decode after a prefill rotates the prompt's keys wrongly (ROADMAP
    Queue 3); the port caches what its decode reads."""
    B, S, D = x.shape
    m = cfg.mla
    H = cfg.num_heads
    r = m.kv_lora_rank
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, m, cfg, positions)

    kv_a = x @ p["wkv_a"]                                   # (B,S,r+rope)
    c_kv = rmsnorm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., None, r:], positions,
                        cfg.rope_theta)                     # (B,S,1,rope)
    kv = _proj_heads(c_kv, p["wkv_b"])
    k_nope = kv[..., :m.qk_nope_head_dim]
    v = kv[..., m.qk_nope_head_dim:]

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                  dim=-1)
    out = chunked_attention(q, k, v, causal=cfg.causal)
    cache = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    return out_proj(out, p["wo"]), cache


def mla_absorbed(p, q_nope, q_rope, cache, cfg: ModelConfig, valid=None):
    """Absorbed MLA attention of one query position against a latent
    cache (B, T, kv_lora + rope): the k up-projection folded into q, the
    v up-projection applied after the weighted sum of latents. ``valid``
    (B, T) masks cache entries beyond each sequence's position."""
    m = cfg.mla
    r = m.kv_lora_rank
    c = cache[..., :r]                                      # (B,T,r)
    k_rope = cache[..., r:]                                 # (B,T,rope)
    wk = p["wkv_b"][..., :m.qk_nope_head_dim]               # (r,H,nope)
    wv = p["wkv_b"][..., m.qk_nope_head_dim:]               # (r,H,v)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bshr,btr->bsht", q_lat.float(), c.float())
              + torch.einsum("bshk,btk->bsht", q_rope.float(),
                             k_rope.float())) * scale
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bsht,btr->bshr", probs.to(c.dtype), c)
    o = torch.einsum("bshr,rhk->bshk", o_lat, wv)           # (B,1,H,v)
    return out_proj(o, p["wo"])


def mla_new_entry(p, x, cfg: ModelConfig, positions):
    """The latent cache entry of the decoded token(s): the normalised
    latent and the roped shared key."""
    m = cfg.mla
    r = m.kv_lora_rank
    kv_a = x @ p["wkv_a"]
    c_new = rmsnorm(kv_a[..., :r], p["kv_norm"], cfg.norm_eps)
    kr_new = apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)
    return torch.cat([c_new, kr_new[:, :, 0, :]], dim=-1)


def mla_decode(p, x, cache, cfg: ModelConfig, *, t_cache: int):
    """Absorbed one-token MLA decode against a latent cache of length
    t_cache (B, T, kv_lora + rope_dim): the per-token cache is the
    low-rank latent plus the shared rope key, not per-head K/V. Returns
    (output, new entry)."""
    pos = torch.full((x.shape[0], 1), t_cache, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg.mla, cfg, pos)
    new_entry = mla_new_entry(p, x, cfg, pos)
    cache = torch.cat([cache, new_entry], dim=1)            # (B,T+1,...)
    return mla_absorbed(p, q_nope, q_rope, cache, cfg), new_entry


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------

def mlp_template(d_model: int, d_ff: int) -> dict:
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wg": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled_normal"),
    }


def mlp(p, x):
    """The gated MLP. Under a mesh its hidden activation is laid out as
    ("batch", ..., "mlp"), the tensor-parallel layout (DTensor's own
    choice of a sequence-sharded hidden has no rule for the next
    product's flatten)."""
    axes = ("batch",) + (None,) * (x.dim() - 2) + ("mlp",)
    h = F.silu(hint(x @ p["wg"], axes)) * hint(x @ p["wi"], axes)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity dropping, scatter-based dispatch
# ---------------------------------------------------------------------------

def moe_template(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    m = cfg.moe
    t = {
        "router": ParamSpec((D, m.num_experts), ("embed", None)),
        "wi": ParamSpec((m.num_experts, D, m.d_expert),
                        ("experts", "embed", None)),
        "wg": ParamSpec((m.num_experts, D, m.d_expert),
                        ("experts", "embed", None)),
        "wo": ParamSpec((m.num_experts, m.d_expert, D),
                        ("experts", None, "embed"), "scaled_normal"),
    }
    if m.num_shared_experts:
        t["shared"] = mlp_template(D, m.d_expert * m.num_shared_experts)
    return t


def _capacity(tokens: int, m: MoEConfig) -> int:
    c = math.ceil(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_counts(flat_e, E: int):
    """Assignments per expert: ``torch.bincount(flat_e, minlength=E)`` for
    ids below E, with a static shape (a fake or meta tensor holds no data
    to size bincount's output by)."""
    return torch.zeros(E, dtype=torch.long, device=flat_e.device
                       ).scatter_add(0, flat_e, torch.ones_like(flat_e))


def moe_dispatch(probs, K: int, C: int):
    """The reference's routing of T tokens to E experts, K each, at most C
    per expert. Returns (gate (T,K) normalised, flat_e (T*K,) expert of
    each assignment, order (T*K,) the stable sort of assignments by
    expert, keep (T*K,) in sorted order, dest (T*K,) each sorted
    assignment's row of the (E*C + 1)-row dispatch buffer, E*C for a
    dropped one, counts (E,) assignments per expert). The span
    ``repro_torch.moe.dispatch``."""
    with span("repro_torch.moe.dispatch"):
        T, E = probs.shape
        gate, idx = top_k(probs, K)
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
        flat_e = idx.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = expert_counts(flat_e, E)
        starts = torch.cumsum(counts, 0) - counts
        pos_in_e = torch.arange(T * K, device=probs.device) - \
            starts[sorted_e]
        keep = pos_in_e < C                                 # capacity drops
        dest = torch.where(keep, sorted_e * C + pos_in_e,
                           torch.full_like(pos_in_e, E * C))  # drop slot
        return gate, flat_e, order, keep, dest, counts


def _experts_combine(xt, w, gate, order, keep, dest, n_e: int, C: int,
                     K: int, e_ax=None):
    """The experts' products over an (n_e*C + 1)-row dispatch buffer (the
    last row is the drop slot) and the combine: each token's K slots
    gathered and added in ascending expert order, in the activation dtype,
    without atomics. ``w`` = (wi, wg, wo) of the n_e experts; ``e_ax``,
    when given, is the logical axis of the buffer's expert dim. The spans
    ``repro_torch.moe.experts`` (buffer and products) and
    ``repro_torch.moe.combine``."""
    T, D = xt.shape
    wi, wg, wo = w
    with span("repro_torch.moe.experts"):
        buf = xt.new_zeros((n_e * C + 1, D))
        buf[dest] = xt[order // K]
        h = buf[:-1].reshape(n_e, C, D)
        if e_ax:
            h = hint(h, (e_ax, None, None))
        hh = F.silu(torch.bmm(h, wg)) * torch.bmm(h, wi)
        y_e = torch.bmm(hh, wo)
        if e_ax:
            y_e = hint(y_e, (e_ax, None, None))
        y_e = y_e.reshape(n_e * C, D)

    with span("repro_torch.moe.combine"):
        gath = torch.where(keep[:, None], y_e[dest.clamp(max=n_e * C - 1)],
                           0.0)
        contrib = gath * gate.reshape(-1)[order][:, None].to(xt.dtype)
        # each token's K sorted slots, ascending: its experts in id order
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * K, device=xt.device)
        slots = inv.reshape(T, K).sort(dim=-1).values
        y = torch.zeros((T, D), dtype=xt.dtype, device=xt.device)
        for k in range(K):               # fixed order, activation dtype
            y = y + contrib[slots[:, k]]
        return y


def _aux_loss(counts, probs, m: MoEConfig, T: int):
    """Load-balance aux loss (Switch/GShard form): E * sum_e f_e * P_e."""
    f = counts.float() / (T * m.top_k)
    return m.router_aux_coef * m.num_experts * torch.sum(
        f * probs.mean(dim=0))


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B,S,D) -> (y, aux_loss). Scatter-based dispatch into an
    (E, C, D) buffer, batched expert products, and a gather-based combine
    without atomics (module doc)."""
    B, S, D = x.shape
    m = cfg.moe
    T = B * S
    E, K = m.num_experts, m.top_k
    C = _capacity(T, m)
    xt = x.reshape(T, D)

    with span("repro_torch.moe.router"):
        logits = (xt @ p["router"]).float()                 # (T,E)
        probs = torch.softmax(logits, dim=-1)
    gate, _, order, keep, dest, counts = moe_dispatch(probs, K, C)
    # expert-parallel layout: the dispatch buffer's sharding agrees with
    # the expert weights' (workload-dependent)
    e_ax = "experts_both" if cfg.expert_parallel == "both" else "experts"
    y = _experts_combine(xt, (p["wi"], p["wg"], p["wo"]), gate, order, keep,
                         dest, E, C, K, e_ax)
    aux = _aux_loss(counts, probs, m, T)

    y = y.reshape(B, S, D)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux


def _manual(t, mesh, spec):
    """The local tensor a manual region computes on: a DTensor
    redistributed to ``spec`` and unwrapped, or a plain tensor (the same
    full tensor on every rank) cut to this rank's part of ``spec``."""
    from torch.distributed.tensor import DTensor
    placements = to_placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements).to_local()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            size = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return t


def moe_ffn_shard_map(p, x, cfg: ModelConfig):
    """MoE FFN with the reference's hand-written expert-parallel schedule.

    A manual region over the 'model' axis of the ambient mesh: every rank
    owns E/n of the experts, the tokens are replicated, so dispatch is a
    purely local scatter (each rank keeps the assignments routed to its
    experts, with the full routing's capacity slots), and the only
    collective is one activation-sized all-reduce of the combined output
    over the model group. The aux loss comes from the full counts.
    Without a mesh, or when the expert count does not divide the axis, it
    is :func:`moe_ffn`, as in the reference. The region's tensors are
    local (DTensor inputs are unwrapped, plain ones cut to the rank's
    experts); the output is a replicated DTensor when ``x`` is a DTensor.
    """
    mesh = current_mesh()
    m = cfg.moe
    E = m.num_experts
    if mesh is None or E % mesh_axes(mesh).get("model", E + 1) != 0:
        return moe_ffn(p, x, cfg)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    n_sh = mesh_axes(mesh)["model"]
    E_loc = E // n_sh
    B, S, D = x.shape
    T = B * S
    K = m.top_k
    C = _capacity(T, m)
    sh = mesh.get_local_rank("model")

    w = tuple(_manual(p[k], mesh, P("model")) for k in ("wi", "wg", "wo"))
    xt = _manual(x, mesh, P()).reshape(T, D)
    router = _manual(p["router"], mesh, P())
    probs = torch.softmax((xt @ router).float(), dim=-1)
    gate, flat_e, order, keep, dest, counts = moe_dispatch(probs, K, C)
    mine = (flat_e[order] // E_loc) == sh
    keep = keep & mine
    dest = torch.where(keep, dest - sh * E_loc * C,
                       torch.full_like(dest, E_loc * C))
    y = _experts_combine(xt, w, gate, order, keep, dest, E_loc, C, K)
    y = funcol.wait_tensor(funcol.all_reduce(
        y, "sum", mesh.get_group("model")))     # the only collective
    aux = _aux_loss(counts, probs, m, T)

    y = y.reshape(B, S, D)
    if isinstance(x, DTensor):
        rep = [Replicate()] * mesh.ndim
        y = DTensor.from_local(y, mesh, rep, run_check=False)
        aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux
