"""Transformer building blocks of the ``dense`` family: RMSNorm, RoPE,
q-chunked exact attention (GQA), the GQA attention block and the gated
MLP. Port of the dense parts of ``repro.models.blocks``; MLA, MoE and
cross-attention wait for ROADMAP Queue 1 item 9d.

Forwards are plain functions over parameter containers
(:class:`~repro_torch.sharding.partitioning.ParamModule`, indexed like the
reference's dicts: ``p["wq"]``) built from the same
:class:`~repro_torch.sharding.partitioning.ParamSpec` templates, in the
reference's layouts (``wq`` is (D, H, hd), ``wo`` is (H, hd, D)).

Prefill attention (:func:`gqa_attention`) always goes through
:func:`~repro_torch.kernels.flash_attention.flash_attention_bshd`: on the
card that is the hand-written kernel, on the CPU its plain version. There
is no ``attention_impl`` switch. Decode attention is
:func:`chunked_attention` in torch ops, as in the reference, whose decode
never reaches the Pallas kernel (its ``q_offset`` is static, decode
positions are per sequence). There is no mesh, so the reference's
``hint`` and ``context_parallel_attention`` have nothing to do here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
                  window=None, rope=True):
    """Full-sequence (prefill) GQA self-attention through the flash
    kernel (module doc). Returns (output, (k, v))."""
    B, S, D = x.shape
    q, k, v = gqa_project_qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal if causal is None else causal
    window = cfg.sliding_window if window is None else window
    out = flash_attention_bshd(q, k, v, causal=causal, window=window)
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
