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
take). There is no mesh, so the reference's ``hint`` and
``context_parallel_attention`` have nothing to do here, and
:func:`moe_ffn_shard_map` takes the reference's off-mesh branch.

MoE dispatch keeps exactly the reference's assignments: top-k by a stable
descending sort (``lax.top_k`` keeps the lower expert on ties, which
``torch.topk`` does not promise), a stable argsort by expert and capacity
dropping through the drop slot ``E*C``. The combine gathers each token's
K expert rows and adds them in a fixed order (ascending expert, as the
reference's scatter-add visits them) in the activation dtype: no atomics,
so it is the same from run to run on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.sharding.partitioning import ParamSpec

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
    S must fit one chunk, as in the reference).
    """
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
        return out.reshape(B, S, H, vd)
    outs = []
    for start in range(0, S, chunk):
        q_pos = offset + start + torch.arange(chunk, device=q.device)
        outs.append(_attend_chunk(qg[:, start:start + chunk], k, v, q_pos,
                                  k_pos, causal, window))
    return torch.cat(outs, dim=1).reshape(B, S, H, vd)


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
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def out_proj(out, wo):
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product."""
    H, hd, D = wo.shape
    return out.flatten(-2) @ wo.reshape(H * hd, D)


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
    attend = chunked_attention if plain else flash_attention_bshd
    out = attend(q, k, v, causal=causal, window=window)
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
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
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


def moe_dispatch(probs, K: int, C: int):
    """The reference's routing of T tokens to E experts, K each, at most C
    per expert. Returns (gate (T,K) normalised, flat_e (T*K,) expert of
    each assignment, order (T*K,) the stable sort of assignments by
    expert, keep (T*K,) in sorted order, dest (T*K,) each sorted
    assignment's row of the (E*C + 1)-row dispatch buffer, E*C for a
    dropped one)."""
    T, E = probs.shape
    gate, idx = top_k(probs, K)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=probs.device) - starts[sorted_e]
    keep = pos_in_e < C                                     # capacity drops
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))    # drop slot
    return gate, flat_e, order, keep, dest


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

    logits = (xt @ p["router"]).float()                     # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate, flat_e, order, keep, dest = moe_dispatch(probs, K, C)
    src_tok = order // K

    buf = xt.new_zeros((E * C + 1, D))
    buf[dest] = xt[src_tok]
    h = buf[:-1].reshape(E, C, D)
    hh = F.silu(torch.bmm(h, p["wg"])) * torch.bmm(h, p["wi"])
    y_e = torch.bmm(hh, p["wo"]).reshape(E * C, D)

    gath = torch.where(keep[:, None], y_e[dest.clamp(max=E * C - 1)], 0.0)
    w = gate.reshape(-1)[order][:, None].to(xt.dtype)
    contrib = gath * w                                      # sorted order
    # each token's K sorted slots, ascending: its experts in id order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=x.device)
    slots = inv.reshape(T, K).sort(dim=-1).values
    y = torch.zeros((T, D), dtype=xt.dtype, device=x.device)
    for k in range(K):                   # fixed order, activation dtype
        y = y + contrib[slots[:, k]]

    # load-balance aux loss (Switch/GShard form): E * sum_e f_e * P_e
    f = torch.bincount(flat_e, minlength=E).float() / (T * K)
    aux = m.router_aux_coef * E * torch.sum(f * probs.mean(dim=0))

    y = y.reshape(B, S, D)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], x)
    return y, aux


def moe_ffn_shard_map(p, x, cfg: ModelConfig):
    """The reference's expert-parallel MoE FFN takes its off-mesh branch
    here, :func:`moe_ffn`: the port has no mesh (its expert-parallel
    schedule waits for ROADMAP Queue 1 item 10)."""
    return moe_ffn(p, x, cfg)
