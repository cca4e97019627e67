"""Plain float32 reference of the ``ssm`` family (mamba2-1.3b): pre-norm
Mamba-2 blocks (the SSD mixer) and a head tied to the embedding.

Per block, for the sequence h (S, D), with d_inner = expand * D, H =
d_inner / head_dim heads of P = head_dim, state N:

    a    = rms(h, ln1)
    z    = a W_z                                  (S, d_inner)
    u    = a W_xbc                                (S, d_inner + 2 N)
    xbc  = silu(causal depthwise conv(u, conv_w) + conv_b)
    x, B, C = xbc split (d_inner as H x P, N, N)
    dt   = softplus(a W_dt + dt_bias)             (S, H)
    A    = -exp(A_log)
    s_t  = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T   (H, P, N), s_0 = 0
    y_t  = s_t C_t + D_skip x_t
    h   += rms(y * silu(z), gate_norm) W_out

then logits = rms(h, final_norm) embed^T. The recurrence is computed in
its exact chunked form (chunks of 64 steps: within a chunk the masked
decays exp(cs_i - cs_j), across chunks the carried state), all in
float32. No cache: one forward over the whole sequence gives every
position's logits.
"""
from __future__ import annotations

import torch
from torch.nn.functional import silu, softplus

from perfbench.reference.common import full_float32, mm, rms


def dims(c):
    d_inner = c["expand"] * c["hidden_size"]
    return d_inner, d_inner // c["head_dim"], c["head_dim"], c["state_size"]


def leaves(c) -> dict:
    """{parameter path: (shape, init)} in the port's layout; init is
    ("normal", fan_in), "ones", "zeros", "dt_bias" or "a_log"."""
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    d_in, H, _, N = dims(c)
    ch = d_in + 2 * N
    m = "layers/mixer/"
    out = {
        "embed": ((V, D), ("normal", D)),
        "final_norm": ((D,), "ones"),
        "layers/ln1": ((L, D), "ones"),
        m + "w_z": ((L, D, d_in), ("normal", D)),
        m + "w_xbc": ((L, D, ch), ("normal", D)),
        m + "w_dt": ((L, D, H), ("normal", D)),
        m + "dt_bias": ((L, H), "dt_bias"),
        m + "A_log": ((L, H), "a_log"),
        m + "D_skip": ((L, H), "ones"),
        m + "conv_w": ((L, c["conv_kernel"], ch),
                       ("normal", c["conv_kernel"])),
        m + "conv_b": ((L, ch), "zeros"),
        m + "gate_norm": ((L, d_in), "ones"),
        m + "w_out": ((L, d_in, D), ("normal", d_in)),
    }
    if not c["tie_word_embeddings"]:
        out["lm_head"] = ((D, V), ("normal", D))
    return out


def causal_conv(u, w, b):
    """Depthwise causal conv: out_t = sum_k w_k u_{t - (cw-1) + k} + b."""
    cw = w.shape[0]
    up = torch.cat([u.new_zeros(cw - 1, u.shape[1]), u])
    S = u.shape[0]
    return sum(w[k].float() * up[k:k + S] for k in range(cw)) + b.float()


def ssd(x, dt, A, B, C, Q=64):
    """y (S, H, P) of the recurrence (module doc) without the skip."""
    S, H, P = x.shape
    N = B.shape[1]
    pad = (-S) % Q
    if pad:   # trailing zeros: dt 0 decays nothing and adds nothing
        x = torch.cat([x, x.new_zeros(pad, H, P)])
        dt = torch.cat([dt, dt.new_zeros(pad, H)])
        B = torch.cat([B, B.new_zeros(pad, N)])
        C = torch.cat([C, C.new_zeros(pad, N)])
    nc = x.shape[0] // Q
    cs = torch.cumsum((dt * A).view(nc, Q, H), dim=1)          # (c, Q, H)
    xdt = (x * dt[..., None]).view(nc, Q, H, P)
    Bc, Cc = B.view(nc, Q, N), C.view(nc, Q, N)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cs[:, :, None, :] - cs[:, None, :, :]                # (c, i, j, H)
    decay = torch.exp(seg.masked_fill(~keep[None, :, :, None],
                                      float("-inf")))
    M = decay * (Cc @ Bc.transpose(1, 2))[..., None]          # (c, i, j, H)
    y = M.permute(0, 3, 1, 2) @ xdt.permute(0, 2, 1, 3)       # (c, H, i, P)
    to_end = torch.exp(cs[:, -1:, :] - cs)                     # (c, Q, H)
    own = torch.einsum("cjhp,cjn->chpn", xdt * to_end[..., None], Bc)
    s = x.new_zeros(H, P, N)
    carried = []
    for c in range(nc):
        carried.append(s)
        s = s * torch.exp(cs[c, -1])[:, None, None] + own[c]
    carried = torch.stack(carried)                             # (c, H, P, N)
    y_in = torch.einsum("cin,chpn->chip", Cc, carried) \
        * torch.exp(cs).permute(0, 2, 1)[..., None]
    return (y + y_in).permute(0, 2, 1, 3).reshape(nc * Q, H, P)[:S]


@torch.no_grad()
def forward(c, W, tokens, first: int, prec: str = "float32"):
    """float32 logits (S - first, vocab) at positions first..S-1 of the
    token sequence ``tokens`` (S,), from the weights ``W`` ({path:
    tensor} in the port's layout, any dtype)."""
    full_float32()
    L, eps = c["num_hidden_layers"], c["rms_norm_eps"]
    d_in, H, P, N = dims(c)
    S = tokens.shape[0]
    m = "layers/mixer/"
    h = W["embed"][tokens].float()
    for l in range(L):
        a = rms(h, W["layers/ln1"][l], eps)
        z = mm(a, W[m + "w_z"][l], prec)
        xbc = silu(causal_conv(mm(a, W[m + "w_xbc"][l], prec),
                               W[m + "conv_w"][l], W[m + "conv_b"][l]))
        x = xbc[:, :d_in].reshape(S, H, P)
        B, C = xbc[:, d_in:d_in + N], xbc[:, d_in + N:]
        dt = softplus(mm(a, W[m + "w_dt"][l], prec)
                      + W[m + "dt_bias"][l].float())
        A = -torch.exp(W[m + "A_log"][l].float())
        y = ssd(x, dt, A, B, C) + x * W[m + "D_skip"][l].float()[:, None]
        y = rms(y.reshape(S, d_in) * silu(z), W[m + "gate_norm"][l], eps)
        h = h + mm(y, W[m + "w_out"][l], prec)
    x = rms(h[first:], W["final_norm"], eps)
    head = W["embed"].t() if c["tie_word_embeddings"] else W["lm_head"]
    return mm(x, head, prec)
