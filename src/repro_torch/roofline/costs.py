"""The work each kernel's function needs, and the H100's peaks: the
yardstick of ``chip_smoke.py``'s kernel rows and of the trace's mixer
regions (:func:`repro_torch.roofline.trace.region`).

Each ``*_cost`` returns (bytes, operations) of the function itself, not
of one implementation: every input read once, every output written once,
and the operations the function needs (a masked attention pair is not
computed, a causal chunk's upper triangle is not). :func:`bound` turns
them into the least time the card could take.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
PEAK_FLOPS_PER_S = {"bfloat16": 989e12,    # H100 SXM tensor cores, dense
                    "float32": F32_FLOPS_PER_S}


def bound(nbytes, flops, dtype):
    """(bound µs, "bytes" or "operations"): the larger of the bytes at the
    memory rate and the operations at the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_cost(L, R, D, M):
    """(bytes, flops) the function needs: every input read once, the
    output written once; 2·R·D·M for the products plus 13 operations per
    (row, candidate) for the epilogue and the row sum."""
    floats = L * (R * D + D * M + R * M + 4 * R + 2 * M) + L * M
    return 4 * floats, L * (2 * R * D * M + 13 * R * M)


def step_cost(L, R, D, M):
    """(bytes, flops) of the fused step: the scorer's inputs less zj and
    dinv, plus diag_g, aty_m, sel, src_mask and z read once, objs, dinv and
    zj written once; the scorer's operations plus 4·D·M for cc's squares
    and ccᵀz and 7 per candidate for dinv and zj."""
    floats = L * (R * D + D * M + R * M + 4 * R + 4 * M + D) + 3 * L * M
    return 4 * floats, L * (2 * R * D * M + 13 * R * M + 4 * D * M + 7 * M)


def flash_pairs(shape) -> int:
    """(query, key) pairs the mask keeps, per (batch, head). ``shape`` is
    (B, H, KV, Sq, Skv, d, causal, window, q_offset, dtype name)."""
    _, _, _, Sq, Skv, _, causal, window, q_offset, _ = shape
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(shape):
    """(bytes, flops) the function needs: q, k, v read once and o written
    once; 2·2·d operations per kept (query, key) pair (q·k and p·v)."""
    B, H, KV, Sq, Skv, d, *_, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * d * B * (2 * H * Sq + 2 * KV * Skv)
    return nbytes, 4 * B * H * d * flash_pairs(shape)


def ssd_cost(shape):
    """(bytes, flops) the function needs: x, dt, A, B, C read once, y and
    the state written once. Per (batch, chunk of q steps) and per kept
    (i >= j) pair of the chunk's q (q + 1) / 2: 2 N operations for the
    scores C B^T, once for all heads (B and C are shared by the heads),
    and 2 P per head for the masked scores times x; per head, 2 q N P for
    the carried state's output C h^T and 2 q N P for the state update.
    ``shape`` is (B, S, H, P, N, chunk, dtype name)."""
    B, S, H, P, N, Q, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * B * S * H * P + 2 * B * S * N + B * H * P * N) \
        + 4 * (B * S * H + H)
    qs = [min(Q, S - c) for c in range(0, S, Q)]
    flops = B * sum(q * (q + 1) * (N + H * P) + 4 * H * q * N * P
                    for q in qs)
    return nbytes, flops


def mla_attention_cost(shape):
    """(bytes, flops) of MLA's expanded attention (prefill): q, k and v
    read once and o written once, k and v expanded to every head; per
    kept (query, key) pair and head, 2 d_qk operations for q.k and 2 d_v
    for p.v. ``shape`` is (B, H, Sq, Skv, d_qk, d_v, causal, dtype name);
    the queries are the last Sq of the Skv positions."""
    B, H, Sq, Skv, d_qk, d_v, causal, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * B * H * (Sq + Skv) * (d_qk + d_v)
    pairs = flash_pairs((B, H, H, Sq, Skv, d_qk, causal, 0, Skv - Sq,
                         dtype))
    return nbytes, 2 * (d_qk + d_v) * B * H * pairs


def decode_attention_cost(H, KV, d, dtype, keys):
    """(bytes, flops) of one decode step's attention: q read and o
    written once, and each slot's attended K/V rows read once (``keys``:
    the number of keys of each slot, up to its position), never the
    buffer beyond them; 2·2·d operations per (head, attended key)."""
    item = 2 if dtype == "bfloat16" else 4
    n = int(np.sum(keys))
    return item * d * (2 * KV * n + 2 * H * len(keys)), 4 * H * d * n


def rglru_cost(shape):
    """(bytes, flops): a and b read once, h written once, float32; one FMA
    per element. ``shape`` is (B, S, W)."""
    B, S, W = shape
    return 3 * 4 * B * S * W, 2 * B * S * W


# ---------------------------------------------------------------------------
# The same counts from a mixer's tensors (the trace's regions). A DTensor
# counts its local shard: the work of one device.
# ---------------------------------------------------------------------------

def _local_shape(t):
    local = getattr(t, "to_local", None)
    return tuple((local() if local else t).shape)


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def attention_cost(q, k, *, causal, window, q_offset=0):
    """:func:`flash_cost` of attention over q (B,Sq,H,d) and k/v
    (B,Skv,KV,d)."""
    B, Sq, H, d = _local_shape(q)
    _, Skv, KV, _ = _local_shape(k)
    return flash_cost((B, H, KV, Sq, Skv, d, bool(causal), int(window or 0),
                       int(q_offset), _dtype_name(q)))


def mla_cost(q_nope, q_rope, v, *, causal):
    """:func:`mla_attention_cost` of attention over q = [q_nope, q_rope]
    (B,S,H,d_qk), its expanded k and v (B,S,H,d_v)."""
    B, S, H, nope = _local_shape(q_nope)
    d_qk = nope + _local_shape(q_rope)[-1]
    return mla_attention_cost((B, H, S, S, d_qk, _local_shape(v)[-1],
                               bool(causal), _dtype_name(q_nope)))


def ssd_scan_cost(x, Bm, chunk):
    """:func:`ssd_cost` of the scan of x (B,S,H,P) with B/C (B,S,N)."""
    B, S, H, P = _local_shape(x)
    N = _local_shape(Bm)[-1]
    return ssd_cost((B, S, H, P, N, chunk, _dtype_name(x)))


def rglru_scan_cost(a):
    """:func:`rglru_cost` of the recurrence over a (B,S,W)."""
    return rglru_cost(_local_shape(a))
