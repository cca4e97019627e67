"""The benchmark's frozen yardstick: the H100's published peaks, the work a
kernel's function needs (bytes and operations from its shapes), and the
model FLOPs per token worked out from a configuration's widths.

These are copies, frozen here, of the port's own arithmetic
(``repro_torch.roofline.costs``: ``bound``, ``flash_pairs``,
``flash_cost``, ``ssd_cost`` and the peaks; ``repro_torch.configs.base
.ModelConfig.param_count`` / ``active_param_count`` and
``repro_torch.roofline.analysis.model_flops_for``). The program may change
its copies; the benchmark's stay as they are, so that a later change to
the program cannot move the yardstick it is measured by. A CPU test holds
each copy equal to the port's at the cells' shapes.

Widths come from a configuration file's keys (``configs/*.json``), never
from the program's config object.
"""
from __future__ import annotations

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


# ---------------------------------------------------------------------------
# Parameters and model FLOPs from a configuration file's widths
# ---------------------------------------------------------------------------

def _moe_block(c) -> int:
    d, hd = c["hidden_size"], c["head_dim"]
    attn = d * c["num_attention_heads"] * hd \
        + 2 * d * c["num_key_value_heads"] * hd \
        + c["num_attention_heads"] * hd * d
    ffn = d * c["num_experts"] + 3 * d * c["moe_intermediate_size"] \
        * c["num_experts"]
    return attn + ffn + 2 * d


def _ssm_block(c) -> int:
    d, N = c["hidden_size"], c["state_size"]
    d_inner = c["expand"] * d
    nheads = d_inner // c["head_dim"]
    return (d * (2 * d_inner + 2 * N + nheads) + d_inner * d
            + c["conv_kernel"] * (d_inner + 2 * N) + 2 * nheads + 2 * d)


def param_count(c) -> int:
    """All parameters, the embedding and an untied head included."""
    d, v = c["hidden_size"], c["vocab_size"]
    block = _moe_block(c) if c["family"] == "moe" else _ssm_block(c)
    head = 0 if c["tie_word_embeddings"] else v * d
    return v * d + head + block * c["num_hidden_layers"]


def active_param_count(c) -> int:
    """Parameters a token touches: the routed experts count top-k of
    num_experts."""
    total = param_count(c)
    if c["family"] != "moe":
        return total
    idle = 3 * c["hidden_size"] * c["moe_intermediate_size"] * (
        c["num_experts"] - c["num_experts_per_tok"])
    return total - idle * c["num_hidden_layers"]


def matmul_params_per_token(c) -> int:
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
