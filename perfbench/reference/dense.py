"""Plain float32 reference of the ``dense`` family with Multi-head Latent
Attention (minicpm3-4b): a decoder of pre-norm blocks, each MLA in its
expanded form with RoPE on a shared key, then a gated (SwiGLU) MLP.

It follows the port's equations, which depart from the published model in
the ways the configuration file lists under ``departures`` (plain RoPE, no
muP scalings). Per block, for the sequence x at positions 0..S-1:

    a     = rms(h, ln1)
    q     = rms(a Wq_a, q_norm) Wq_b     (a Wq where q_lora_rank is 0)
            heads of qk_nope + qk_rope; q = [q_nope, rope(q_rope)]
    [c, r] = a Wkv_a;  c = rms(c, kv_norm)      latent of kv_lora_rank
    kr    = rope(r), one key of qk_rope shared by every head
    [kn, v] = c Wkv_b                   heads of qk_nope, heads of v
    h    += softmax([q_nope, q_rope] [kn, kr]^T / sqrt(qk_nope + qk_rope),
                    causal) v  Wo
    a     = rms(h, ln2);  h += (silu(a Wg) * (a Wi)) Wo

then logits = rms(h, final_norm) head, the head the embedding's transpose
where the embedding is tied. RoPE is the half rotation at theta
rope_theta, each key rotated at its own position. Attention is computed
one block of queries at a time. No cache: one forward over the whole
sequence gives every position's logits.
"""
from __future__ import annotations

import math

import torch
from torch.nn.functional import silu

from perfbench.reference.common import full_float32, mm, rms

MLA = ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
       "qk_rope_head_dim", "v_head_dim")


def _mla(c) -> tuple:
    """The configuration's MLA widths; a dense configuration without them
    has no reference here."""
    missing = [k for k in MLA if k not in c]
    if missing:
        raise KeyError(f"{c.get('name', 'the configuration')}: the dense "
                       f"reference is MLA's and needs {missing}")
    return tuple(c[k] for k in MLA)


def leaves(c) -> dict:
    """{parameter path: (shape, init)} in the port's layout; init is
    ("normal", fan_in), "ones" or "zeros". The embedding is drawn as the
    head's product is (fan-in hidden_size), since tied it is the head:
    the logits then spread about 1, as an untied head's do, and the
    residual stream's copy of the input token stays small beside the
    blocks' outputs. (At fan-in 1 a token's own logit outweighs every
    other, and each served token repeats the one before it, whatever the
    layers computed.)"""
    qr, r, nope, rope_d, vd = _mla(c)
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    H, F = c["num_attention_heads"], c["intermediate_size"]
    qk = nope + rope_d
    out = {
        "embed": ((V, D), ("normal", D)),
        "final_norm": ((D,), "ones"),
        "layers/ln1": ((L, D), "ones"),
        "layers/ln2": ((L, D), "ones"),
        "layers/attn/wkv_a": ((L, D, r + rope_d), ("normal", D)),
        "layers/attn/kv_norm": ((L, r), "ones"),
        "layers/attn/wkv_b": ((L, r, H, nope + vd), ("normal", r)),
        "layers/attn/wo": ((L, H, vd, D), ("normal", H * vd)),
        "layers/mlp/wi": ((L, D, F), ("normal", D)),
        "layers/mlp/wg": ((L, D, F), ("normal", D)),
        "layers/mlp/wo": ((L, F, D), ("normal", F)),
    }
    if qr:
        out["layers/attn/wq_a"] = ((L, D, qr), ("normal", D))
        out["layers/attn/q_norm"] = ((L, qr), "ones")
        out["layers/attn/wq_b"] = ((L, qr, H, qk), ("normal", qr))
    else:
        out["layers/attn/wq"] = ((L, D, H, qk), ("normal", D))
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


def attention(q, k, v, block=512):
    """Causal attention, q and k (S, H, d_qk), v (S, H, d_v), one block
    of queries at a time."""
    S, H, d = q.shape
    qh, kh, vh = (t.transpose(0, 1) for t in (q, k, v))
    out = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        sc = qh[:, s0:s1] @ kh[:, :s1].transpose(1, 2) / math.sqrt(d)
        later = torch.arange(s1, device=q.device)[None, :] > \
            torch.arange(s0, s1, device=q.device)[:, None]
        sc = sc.masked_fill(later, float("-inf"))
        out.append(torch.softmax(sc, dim=-1) @ vh[:, :s1])
    return torch.cat(out, dim=1).transpose(0, 1)


def mla(c, W, l, a, prec):
    """The expanded MLA of layer ``l`` over a (S, D)."""
    qr, r, nope, rope_d, vd = _mla(c)
    D, H = c["hidden_size"], c["num_attention_heads"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    S, qk = a.shape[0], nope + rope_d
    A = {n: W[f"layers/attn/{n}"][l] for n in
         ("wkv_a", "kv_norm", "wkv_b", "wo")}
    if qr:
        qa = rms(mm(a, W["layers/attn/wq_a"][l], prec),
                 W["layers/attn/q_norm"][l], eps)
        q = mm(qa, W["layers/attn/wq_b"][l].reshape(qr, H * qk), prec)
    else:
        q = mm(a, W["layers/attn/wq"][l].reshape(D, H * qk), prec)
    q = q.view(S, H, qk)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    kv_a = mm(a, A["wkv_a"], prec)
    lat = rms(kv_a[:, :r], A["kv_norm"], eps)
    kr = rope(kv_a[:, None, r:], theta)                     # (S, 1, rope)
    kv = mm(lat, A["wkv_b"].reshape(r, H * (nope + vd)), prec)
    kv = kv.view(S, H, nope + vd)
    k = torch.cat([kv[..., :nope], kr.expand(S, H, rope_d)], dim=-1)
    o = attention(q, k, kv[..., nope:]).reshape(S, H * vd)
    return mm(o, A["wo"].reshape(H * vd, D), prec)


@torch.no_grad()
def forward(c, W, tokens, first: int, prec: str = "float32"):
    """float32 logits (S - first, vocab) at positions first..S-1 of the
    token sequence ``tokens`` (S,), from the weights ``W`` ({path:
    tensor} in the port's layout, any dtype)."""
    _mla(c)
    full_float32()
    eps = c["rms_norm_eps"]
    h = W["embed"][tokens].float()
    for l in range(c["num_hidden_layers"]):
        h = h + mla(c, W, l, rms(h, W["layers/ln1"][l], eps), prec)
        a = rms(h, W["layers/ln2"][l], eps)
        g = silu(mm(a, W["layers/mlp/wg"][l], prec)) * \
            mm(a, W["layers/mlp/wi"][l], prec)
        h = h + mm(g, W["layers/mlp/wo"][l], prec)
    x = rms(h[first:], W["final_norm"], eps)
    head = W["embed"].t() if c["tie_word_embeddings"] else W["lm_head"]
    return mm(x, head, prec)
