"""Decode attention over a fixed-size KV buffer: the Hopper kernel, its
plain PyTorch version, and the wrapper the model's buffered GQA decode
calls.

    decode_attention(q, ck, cv, pos, window=0) -> o
    q (B,1,H,hd) after RoPE, ck/cv (B,S,KV,hd) already written at pos,
    pos a 0-d or (B,) position tensor -> o (B,1,H,hd) in q's dtype

Each query attends to the keys at positions ``lo <= j <= pos`` of its
slot (``lo = pos - window + 1`` with ``window > 0``, else 0), as
``chunked_attention(q, ck, cv, causal=True, window=window, q_offset=pos)``
does; GQA takes KV head ``h // (H // KV)``. Scores, the softmax and the
p·v sums are float32; the output is rounded to q's dtype once (the
reference's einsum path also rounds the probabilities to v's dtype before
p·v, which neither version here does).

It replaces no Pallas kernel: the JAX package decodes through plain
einsums (``repro.models.model._gqa_decode_buffered``). What bounds it is
the bytes of the filled K/V positions, each read once in the buffer's
own type (``csrc/decode_attention.cu`` for the design).

Implementation choice is by the tensors' device only: a CUDA tensor
launches the kernel (float32 or bfloat16, head_dim 32/64/128, up to 8
query heads a KV head, no window, K/V rows 16-byte aligned and read in
place through their strides, positions read on the device, so it runs
inside a CUDA graph's capture) or raises; any other tensor (the CPU, the
dry-run's meta tensors) takes :func:`decode_attention_ref`. The plain
version also takes a window, as ``chunked_attention`` does; the model
never passes one (a windowed cache decodes through its rolling buffer,
``_gqa_decode_window``), so the kernel has none. A failed build or launch is
never swapped for the plain version. The kernel has no backward: a CUDA
call with an input that requires grad raises under grad mode
(:func:`~repro_torch.kernels._grad.forbid_grad`). Each call (the split
pass and its combine) counts as one launch.

One corner differs: a slot with no key at all (``pos < 0``) gets 0 from
the kernel and the mean of v from the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._grad import forbid_grad

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NEG_INF = -1e30

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def decode_attention_ref(q, ck, cv, pos, *, window=0):
    """Plain PyTorch version: float32 scores over the whole buffer, the
    positions past ``pos`` (and before its window) masked, float32 softmax
    and p·v."""
    B, _, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), ck.float()) / \
        math.sqrt(hd)
    p = pos.to(q.device).reshape(-1, 1, 1, 1)
    k_pos = torch.arange(S, device=q.device)
    keep = k_pos <= p
    if window > 0:
        keep &= (p - k_pos) < window
    s = s.masked_fill(~keep, NEG_INF)
    o = torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, dim=-1), cv.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def kernel_dims(q, ck, cv, window=0):
    """(B, H, KV, S, hd) of a call the kernel takes; raises
    :class:`ValueError` (or :class:`TypeError` for the dtypes) on one it
    does not take."""
    if window:
        raise ValueError(f"decode_attention kernel takes no window, got "
                         f"{window}")
    if q.dim() != 4 or q.shape[1] != 1 or ck.dim() != 4:
        raise ValueError(f"decode_attention wants q (B,1,H,hd) and ck/cv "
                         f"(B,S,KV,hd), got {tuple(q.shape)} and "
                         f"{tuple(ck.shape)}")
    B, _, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    if ck.shape != cv.shape or ck.shape[0] != B or ck.shape[3] != hd:
        raise ValueError(f"decode_attention: ck {tuple(ck.shape)} and cv "
                         f"{tuple(cv.shape)} do not fit q {tuple(q.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes up to {MAX_GROUP} "
                         f"query heads per KV head, got H={H}, KV={KV}")
    if q.dtype not in DTYPES or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes one dtype of "
                        f"{tuple(DTYPES)} for q, ck and cv, got {q.dtype}, "
                        f"{ck.dtype}, {cv.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, ck, cv)):
        raise ValueError("decode_attention: head_dim must be contiguous")
    size = q.element_size()
    for t in (ck, cv):
        if t.data_ptr() % 16 or any(t.stride(ax) * size % 16
                                    for ax in range(3)):
            raise ValueError("decode_attention: every K/V row must be "
                             "16-byte aligned")
    if ck.device != q.device or cv.device != q.device:
        raise ValueError("decode_attention: q, ck, cv must share one device")
    return B, H, KV, S, hd


def _launcher():
    """The kernel's ``extern "C"`` launcher and its split length (keys
    per block), built and typed on first use."""
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 11
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn, lib.decode_attention_split()


def _launch(q, ck, cv, pos, window):
    global launches
    B, H, KV, S, hd = kernel_dims(q, ck, cv, window)
    pos = pos.to(device=q.device, dtype=torch.long)
    if pos.dim() > 1 or (pos.dim() == 1 and pos.shape[0] != B):
        raise ValueError(f"decode_attention: pos {tuple(pos.shape)} is "
                         f"neither 0-d nor ({B},)")
    fn, split = _launcher()
    n_splits = -(-S // split)
    G = H // KV
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    part_o = torch.empty((B * KV, n_splits, G, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((B * KV, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
                 part_o.data_ptr(), part_ml.data_ptr(), pos.data_ptr(),
                 q.stride(0), q.stride(2), ck.stride(0), ck.stride(1),
                 ck.stride(2), cv.stride(0), cv.stride(1), cv.stride(2),
                 out.stride(0), out.stride(2),
                 pos.stride(0) if pos.dim() else 0,
                 B, H, KV, S, hd, DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def decode_attention(q, ck, cv, pos, *, window=0):
    """Module doc. CUDA tensors run the kernel, any other the plain
    version."""
    if q.device.type != "cuda":
        return decode_attention_ref(q, ck, cv, pos, window=window)
    forbid_grad("decode_attention", q, ck, cv)
    return _launch(q, ck, cv, pos, window)
