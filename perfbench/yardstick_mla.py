"""The frozen yardstick of a dense model with Multi-head Latent Attention
(MLA): its parameters and model FLOPs per token worked out from a
configuration file's widths, and the work of MLA's expanded (prefill)
attention from its shapes.

Copies, frozen here, of the port's own arithmetic for such a model
(``repro_torch.configs.base.ModelConfig.param_count`` with an ``mla``
sub-config and no ``moe``, and ``repro_torch.roofline.costs
.mla_attention_cost``), beside :mod:`perfbench.yardstick`, whose peaks,
``bound`` and ``flash_pairs`` they use. The program may change its
copies; these stay as they are. A CPU test holds each equal to the
port's at the cell's shapes. Widths come from a configuration file's
keys (``configs/*.json``), never from the program's config object.
"""
from __future__ import annotations

from perfbench.yardstick import flash_pairs


def _attn(c) -> int:
    """MLA's weight products: q down and up (or the full-rank q), the
    joint kv latent and rope key, the k/v up-projection, the out
    product. The port counts no norm scale of q or the latent."""
    d, H = c["hidden_size"], c["num_attention_heads"]
    qr, r = c["q_lora_rank"], c["kv_lora_rank"]
    nope, rope_d, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"])
    q = (d * qr + qr * H * (nope + rope_d)) if qr else \
        d * H * (nope + rope_d)
    return (q + d * (r + rope_d) + r * H * (nope + vd) + H * vd * d)


def param_count(c) -> int:
    """All parameters: the embedding, an untied head, and per layer MLA,
    the gated MLP and two norms."""
    d, v = c["hidden_size"], c["vocab_size"]
    block = _attn(c) + 3 * d * c["intermediate_size"] + 2 * d
    head = 0 if c["tie_word_embeddings"] else v * d
    return v * d + head + block * c["num_hidden_layers"]


def matmul_params_per_token(c) -> int:
    """The parameters a token multiplies: every one but an untied
    embedding, which is a lookup (a tied one is the head, counted
    once)."""
    lookup = 0 if c["tie_word_embeddings"] else \
        c["vocab_size"] * c["hidden_size"]
    return param_count(c) - lookup


def model_flops(c, tokens: int) -> float:
    """2 N FLOPs per token through the model's matrix products (N from
    :func:`matmul_params_per_token`); attention's scores are not
    counted."""
    return 2.0 * matmul_params_per_token(c) * tokens


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
