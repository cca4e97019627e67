"""The benchmark's frozen yardstick: the H100's published peaks, the work a
kernel's function needs (bytes and operations from its shapes), and the
model FLOPs per token worked out from a configuration's widths.

These are copies, frozen here, of the port's own arithmetic
(``repro_torch.roofline.costs``: ``bound``, ``flash_pairs``,
``flash_cost``, ``ssd_cost``, ``mla_attention_cost`` and the peaks;
``repro_torch.configs.base.ModelConfig.param_count`` /
``active_param_count`` and ``repro_torch.roofline.analysis
.model_flops_for``). The program may change its copies; the benchmark's
stay as they are, so that a later change to the program cannot move the
yardstick it is measured by. A CPU test holds each copy equal to the
port's at the cells' shapes.

Widths come from a configuration file's keys (``configs/*.json``), never
from the program's config object or its family: a layer is the SSD
mixer where ``state_size`` is given, else attention (MLA where the MLA
widths are given, else GQA of ``head_dim``) and a feed-forward (experts
where ``num_experts`` is given, else a gated MLP of
``intermediate_size``). A configuration whose widths name none of these
raises.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
PEAK_FLOPS_PER_S = {"bfloat16": 989e12,    # H100 SXM tensor cores, dense
                    "float32": F32_FLOPS_PER_S}


def bound(nbytes, flops, dtype):
    """(bound us, "bytes" or "operations"): the larger of the bytes at the
    memory rate and the operations at the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_pairs(shape) -> int:
    """(query, key) pairs the mask keeps, per (batch, head). ``shape`` is
    (B, H, KV, Sq, Skv, d, causal, window, q_offset, dtype name)."""
    _, _, _, Sq, Skv, _, causal, window, q_offset, _ = shape
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(shape):
    """(bytes, flops) attention needs: q, k, v read once and o written
    once; 2*2*d operations per kept (query, key) pair (q.k and p.v)."""
    B, H, KV, Sq, Skv, d, *_, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * d * B * (2 * H * Sq + 2 * KV * Skv)
    return nbytes, 4 * B * H * d * flash_pairs(shape)


def ssd_cost(shape):
    """(bytes, flops) the SSD scan needs: x, dt, A, B, C read once, y and
    the state written once; per (batch, chunk of q steps) and per kept
    (i >= j) pair, 2 N operations for C B^T (shared by the heads) and 2 P
    per head for the masked scores times x; per head 2 q N P for the
    carried state's output and 2 q N P for the state update. ``shape`` is
    (B, S, H, P, N, chunk, dtype name)."""
    B, S, H, P, N, Q, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * S * H * P + 2 * B * S * N + B * H * P * N) \
        + 4 * (B * S * H + H)
    qs = [min(Q, S - c) for c in range(0, S, Q)]
    flops = B * sum(q * (q + 1) * (N + H * P) + 4 * H * q * N * P
                    for q in qs)
    return nbytes, flops


def mla_attention_cost(shape):
    """(bytes, flops) of MLA's expanded attention: q, k and v read once
    and o written once, k and v expanded to every head; per kept (query,
    key) pair and head, 2 d_qk operations for q.k and 2 d_v for p.v.
    ``shape`` is (B, H, Sq, Skv, d_qk, d_v, causal, dtype name); the
    queries are the last Sq of the Skv positions."""
    B, H, Sq, Skv, d_qk, d_v, causal, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * B * H * (Sq + Skv) * (d_qk + d_v)
    pairs = flash_pairs((B, H, H, Sq, Skv, d_qk, causal, 0, Skv - Sq,
                         dtype))
    return nbytes, 2 * (d_qk + d_v) * B * H * pairs


# ---------------------------------------------------------------------------
# Parameters and model FLOPs from a configuration file's widths
# ---------------------------------------------------------------------------

MLA = ("q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
       "qk_rope_head_dim", "v_head_dim")


def _need(c, keys, what):
    missing = [k for k in keys if k not in c]
    if missing:
        raise ValueError(f"{c.get('name', 'the configuration')}: the "
                         f"yardstick counts {what} from {missing}")


def _ssd(c) -> int:
    """The SSD mixer: in-projection (z, x, B, C, dt), out-projection,
    the depthwise convolution, A, D and two norms."""
    _need(c, ("state_size", "expand", "head_dim", "conv_kernel"), "SSD")
    d, N = c["hidden_size"], c["state_size"]
    d_inner = c["expand"] * d
    nheads = d_inner // c["head_dim"]
    return (d * (2 * d_inner + 2 * N + nheads) + d_inner * d
            + c["conv_kernel"] * (d_inner + 2 * N) + 2 * nheads + 2 * d)


def _attention(c) -> int:
    """MLA's weight products where any MLA width is given: q down and up
    (or the full-rank q), the joint kv latent and rope key, the k/v
    up-projection, the out product (the port counts no norm scale of q
    or the latent). Else GQA: q, k, v and o of ``head_dim``."""
    if any(k in c for k in MLA):
        _need(c, ("num_attention_heads",) + MLA, "MLA")
    else:
        _need(c, ("num_attention_heads", "num_key_value_heads",
                  "head_dim"), "GQA attention")
    d, H = c["hidden_size"], c["num_attention_heads"]
    if "kv_lora_rank" not in c:
        hd = c["head_dim"]
        return 2 * d * H * hd + 2 * d * c["num_key_value_heads"] * hd
    qr, r = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope_d, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"])
    q = (d * qr + qr * H * (nope + rope_d)) if qr else \
        d * H * (nope + rope_d)
    return q + d * (r + rope_d) + r * H * (nope + vd) + H * vd * d


def _mlp(c) -> int:
    _need(c, ("intermediate_size",), "a gated MLP")
    return 3 * c["hidden_size"] * c["intermediate_size"]


def _expert(c) -> int:
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def _experts(c) -> int:
    """A layer's experts held here: the router at its published width
    (``router_experts``, default ``num_experts``), ``num_experts`` routed
    experts and ``n_shared_experts`` shared ones, each a gated MLP of
    ``moe_intermediate_size``."""
    _need(c, ("moe_intermediate_size", "num_experts_per_tok"), "experts")
    routers = c.get("router_experts", c["num_experts"])
    return c["hidden_size"] * routers + _expert(c) * (
        c["num_experts"] + c.get("n_shared_experts", 0))


def _layers(c) -> tuple:
    """(dense layers, expert layers, parameters of each): the first
    ``first_k_dense_replace`` layers of an expert model are dense."""
    L = c["num_hidden_layers"]
    if "state_size" in c:
        mixed = [k for k in ("num_attention_heads", "num_experts",
                             "intermediate_size") if k in c]
        if mixed:
            raise ValueError(f"{c.get('name')}: the yardstick counts an "
                             f"SSD layer alone, not beside {mixed}")
        return L, 0, _ssd(c), 0
    attn = _attention(c) + 2 * c["hidden_size"]
    if "num_experts" not in c:
        return L, 0, attn + _mlp(c), 0
    k = c.get("first_k_dense_replace", 0)
    return k, L - k, (attn + _mlp(c)) if k else 0, attn + _experts(c)


def param_count(c) -> int:
    """All parameters held here, the embedding and an untied head
    included."""
    d, v = c["hidden_size"], c["vocab_size"]
    dense, moe, dense_block, moe_block = _layers(c)
    head = 0 if c["tie_word_embeddings"] else v * d
    return v * d + head + dense * dense_block + moe * moe_block


def active_param_count(c):
    """Parameters a token touches here: of the routed experts held here,
    on average ``num_experts_per_tok * num_experts / router_experts``
    (its top-k where every expert is held here); the shared experts
    always. An int where that count is whole, else a float."""
    total = param_count(c)
    if "num_experts" not in c:
        return total
    E = c["num_experts"]
    used = Fraction(c["num_experts_per_tok"] * E,
                    c.get("router_experts", E))
    active = total - _expert(c) * (E - used) * _layers(c)[1]
    return int(active) if active.denominator == 1 else float(active)


def matmul_params_per_token(c):
    """The active parameters that a token multiplies: the embedding is a
    lookup, so an untied embedding does no FLOPs (a tied one is the head,
    counted once)."""
    lookup = 0 if c["tie_word_embeddings"] else \
        c["vocab_size"] * c["hidden_size"]
    return active_param_count(c) - lookup


def model_flops(c, tokens: int) -> float:
    """2 N FLOPs per token through the model's matrix products (N from
    :func:`matmul_params_per_token`); attention's scores are not
    counted."""
    return 2.0 * matmul_params_per_token(c) * tokens
