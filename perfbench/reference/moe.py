"""Plain float32 reference of the ``moe`` family (olmoe-1b-7b): a decoder
of pre-norm blocks, each causal multi-head attention with RoPE, then a
mixture of experts with top-k routing, computed dropless.

It follows the port's equations, which depart from the published model in
the ways the configuration file lists under ``departures`` (no QK-norm;
the top-k gate weights renormalised). Per block, for the sequence x:

    a   = rms(h, ln1);  q, k, v = a Wq, a Wk, a Wv (heads of head_dim)
    q, k = rope(q), rope(k)      half rotation, theta rope_theta
    h  += softmax(q k^T / sqrt(head_dim), causal) v  Wo
    a   = rms(h, ln2);  p = softmax(a Wr)           over num_experts
    top-k experts e of p, gate g_e = p_e / (sum of the top-k p + 1e-9)
    h  += sum_e g_e (silu(a Wg_e) * (a Wi_e)) Wo_e

then logits = rms(h, final_norm) lm_head. Attention is computed one block
of queries at a time; the experts one expert at a time over the tokens
routed to it, so nothing is dropped. No cache: one forward over the whole
sequence gives every position's logits.
"""
from __future__ import annotations

import math

import torch
from torch.nn.functional import silu

from perfbench.reference.common import full_float32, mm, rms


def leaves(c) -> dict:
    """{parameter path: (shape, init)} in the port's layout; init is
    ("normal", fan_in), "ones" or "zeros"."""
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    E, de = c["num_experts"], c["moe_intermediate_size"]
    out = {
        "embed": ((V, D), ("normal", 1)),
        "final_norm": ((D,), "ones"),
        "layers/ln1": ((L, D), "ones"),
        "layers/ln2": ((L, D), "ones"),
        "layers/attn/wq": ((L, D, H, hd), ("normal", D)),
        "layers/attn/wk": ((L, D, KV, hd), ("normal", D)),
        "layers/attn/wv": ((L, D, KV, hd), ("normal", D)),
        "layers/attn/wo": ((L, H, hd, D), ("normal", H * hd)),
        "layers/moe/router": ((L, D, E), ("normal", D)),
        "layers/moe/wi": ((L, E, D, de), ("normal", D)),
        "layers/moe/wg": ((L, E, D, de), ("normal", D)),
        "layers/moe/wo": ((L, E, de, D), ("normal", de)),
    }
    if not c["tie_word_embeddings"]:
        out["lm_head"] = ((D, V), ("normal", D))
    return out


def rope(x, theta):
    """x (S, H, d), positions 0..S-1: the half-rotation (llama) RoPE."""
    S, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, block=1024):
    """Causal attention, q (S, H, d), k/v (S, KV, d); query head h reads
    key head h // (H / KV)."""
    S, H, d = q.shape
    G = H // k.shape[1]
    qh = q.transpose(0, 1)
    kh = k.transpose(0, 1).repeat_interleave(G, 0)
    vh = v.transpose(0, 1).repeat_interleave(G, 0)
    out = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = qh[:, s0:s1] @ kh[:, :s1].transpose(1, 2) / math.sqrt(d)
        later = torch.arange(s1, device=q.device)[None, :] > \
            torch.arange(s0, s1, device=q.device)[:, None]
        sc = sc.masked_fill(later, float("-inf"))
        out.append(torch.softmax(sc, dim=-1) @ vh[:, :s1])
    return torch.cat(out, dim=1).transpose(0, 1)


def experts(c, W, l, x, prec):
    """The MoE FFN of layer ``l`` over x (T, D), dropless."""
    E, K = c["num_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(mm(x, W["layers/moe/router"][l], prec), dim=-1)
    top, idx = probs.topk(K, dim=-1)
    gate = (top / (top.sum(-1, keepdim=True) + 1e-9)).reshape(-1)
    flat = idx.reshape(-1)
    order = torch.argsort(flat)
    counts = torch.bincount(flat, minlength=E).tolist()
    wi, wg, wo = (W[f"layers/moe/{n}"][l] for n in ("wi", "wg", "wo"))
    y = torch.zeros_like(x)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        sel = order[start:start + n]
        start += n
        tok = sel // K
        xe = x[tok]
        he = silu(mm(xe, wg[e], prec)) * mm(xe, wi[e], prec)
        y.index_add_(0, tok, mm(he, wo[e], prec) * gate[sel, None])
    return y


@torch.no_grad()
def forward(c, W, tokens, first: int, prec: str = "float32", kv_at=None):
    """float32 logits (S - first, vocab) at positions first..S-1 of the
    token sequence ``tokens`` (S,), from the weights ``W`` ({path:
    tensor} in the port's layout, any dtype). With ``kv_at`` (positions),
    also the cache entries there: (positions, layers, 2 KV head_dim),
    each layer's keys after RoPE, then its values."""
    full_float32()
    L, D = c["num_hidden_layers"], c["hidden_size"]
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    S = tokens.shape[0]
    h = W["embed"][tokens].float()
    kv = []
    for l in range(L):
        a = rms(h, W["layers/ln1"][l], eps)
        q = mm(a, W["layers/attn/wq"][l].reshape(D, H * hd), prec)
        k = mm(a, W["layers/attn/wk"][l].reshape(D, KV * hd), prec)
        v = mm(a, W["layers/attn/wv"][l].reshape(D, KV * hd), prec)
        q = rope(q.view(S, H, hd), theta)
        k = rope(k.view(S, KV, hd), theta)
        if kv_at is not None:
            kv.append(torch.cat([k[kv_at].reshape(-1, KV * hd),
                                 v[kv_at]], -1))
        o = attention(q, k, v.view(S, KV, hd)).reshape(S, H * hd)
        h = h + mm(o, W["layers/attn/wo"][l].reshape(H * hd, D), prec)
        h = h + experts(c, W, l, rms(h, W["layers/ln2"][l], eps), prec)
    x = rms(h[first:], W["final_norm"], eps)
    head = W["embed"].t() if c["tie_word_embeddings"] else W["lm_head"]
    logits = mm(x, head, prec)
    return logits if kv_at is None else (logits, torch.stack(kv, 1))
