"""Flash attention: the Hopper kernel, its plain PyTorch version, and the
two layouts the model code calls.

Port of ``repro.kernels.flash_attention`` (the Pallas kernel), of
``ref.mha_reference`` and of the ``flash_attention`` /
``flash_attention_bshd`` wrappers in ``repro.kernels.ops``:

    flash_attention       q (B,H,Sq,d), k/v (B,KV,Skv,d) -> (B,H,Sq,d)
    flash_attention_bshd  q (B,Sq,H,d), k/v (B,Skv,KV,d) -> (B,Sq,H,d)

with a causal mask, a sliding ``window`` (> 0) and a static ``q_offset``
(the absolute position of q[0]); GQA/MQA take KV head ``h // (H // KV)``.
The kernel chooses its own tiles, so the reference's ``block_q`` /
``block_kv`` arguments are gone. The output has q's dtype.

Implementation choice is by the tensors' device only: a CUDA tensor
launches the hand-written kernel (``csrc/flash_attention.cu``, float32 or
bfloat16, head_dim 32/64/128/256, read in place through strides in either
layout) or raises; a CPU tensor takes :func:`flash_attention_ref` (or
:func:`flash_attention_bshd_ref`). A failed
build or launch is never swapped for the plain version. The kernel has no
backward: a CUDA call with an input that requires grad raises under grad
mode (:func:`~repro_torch.kernels._grad.forbid_grad`); the plain version
is torch and differentiates. Inside the CUDA
source, bfloat16 with 16-byte aligned rows (every contiguous layout; see
:func:`tensor_core_route`) runs the Hopper kernel: TMA loads into a shared-memory ring fed by a producer
warpgroup, two consumer warpgroups running both products on ``wgmma``
(P·V float32-exact through a hi + lo bf16 split of P), helpers in
``csrc/hopper.cuh``; float32, and bfloat16 read through odd strides, run on
the CUDA cores in full float32. Both count as one launch.

One corner differs: a query row with no valid key at all (only possible
with a window or ``q_offset`` that leaves it none) is the mean of v under
:func:`flash_attention_ref` (a softmax over all -1e30), and 0 from the
kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._grad import forbid_grad

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """Plain PyTorch version (port of ``ref.mha_reference``): exact softmax
    in float32 over K/V repeated to H heads. (B,H,Sq,d) layout."""
    B, H, Sq, d = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_bshd_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """The plain version in the (B,S,H,d) layout."""
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, q_offset=q_offset
                               ).transpose(1, 2)


def _check(q, k, v, bshd):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants 4-D q, k, v")
    h_ax, s_ax = (2, 1) if bshd else (1, 2)
    B, H, Sq, d = q.shape[0], q.shape[h_ax], q.shape[s_ax], q.shape[3]
    KV, Skv = k.shape[h_ax], k.shape[s_ax]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {KV} KV heads do not divide "
                         f"{H} query heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one device")
    return B, H, KV, Sq, Skv, d, h_ax, s_ax


def tensor_core_route(q, k, v, out) -> bool:
    """Whether a call takes the bf16 ``wgmma`` kernel (TMA loads): bfloat16,
    every pointer 16-byte aligned and every (batch, seq, head) stride a
    multiple of 8 elements, in either layout. A stride of 0 on a dimension
    of extent > 1 (an ``expand``ed K/V, e.g. one KV head broadcast to
    several) goes to the CUDA-core kernel, which reads any stride, where
    the tensor-map encoder may refuse it. Everything else runs on the CUDA
    cores."""
    if q.dtype != torch.bfloat16:
        return False
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            return False
        for ax in range(3):
            s = t.stride(ax)
            if s % 8 or (s == 0 and t.shape[ax] > 1):
                return False
    return True


def _launcher():
    """The kernel's ``extern "C"`` launcher, built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal, window, q_offset, dims):
    global launches
    B, H, KV, Sq, Skv, d, h_ax, s_ax = dims
    if q.dtype not in DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes float32/bfloat16 and "
                         f"head_dim in {HEAD_DIMS}, got {q.dtype}, d={d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if q_offset < 0 or window < 0:
        raise ValueError("flash_attention: q_offset and window must be >= 0")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(s_ax), t.stride(h_ax)]
    tensor_cores = tensor_core_route(q, k, v, out)
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *strides, B, H, KV, Sq, Skv, d, DTYPES[q.dtype],
                 int(bool(causal)), int(window), int(q_offset),
                 int(tensor_cores), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def _dispatch(q, k, v, causal, window, q_offset, bshd):
    dims = _check(q, k, v, bshd)
    if q.device.type == "cuda":
        forbid_grad("flash_attention", q, k, v)
        return _launch(q, k, v, causal, window, q_offset, dims)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: no implementation for device "
                         f"{q.device}")
    ref = flash_attention_bshd_ref if bshd else flash_attention_ref
    return ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """(B,H,S,d) layout (module doc). CUDA tensors run the kernel, CPU
    tensors the plain version; anything else raises."""
    return _dispatch(q, k, v, causal, window, q_offset, bshd=False)


def flash_attention_bshd(q, k, v, *, causal=True, window=0, q_offset=0):
    """(B,S,H,d) layout, as ``models.blocks`` holds q/k/v; the kernel reads
    it in place (the reference's transposes are a TPU layout choice)."""
    return _dispatch(q, k, v, causal, window, q_offset, bshd=True)
