"""RG-LRU linear recurrence: the Hopper kernel, its plain PyTorch
versions, and the wrapper the model calls.

Port of ``repro.kernels.rglru_scan`` (the Pallas kernel), of
``repro.models.rglru.rglru_scan_ref`` (the reference's XLA path) and of
``ref.rglru_reference`` (the sequential oracle):

    rglru_scan(a, b) -> h,   h_t = a_t h_{t-1} + b_t over axis 1 (time),
    a, b (B,S,W) float32 -> h (B,S,W) float32

The model's gates give a and b in float32, so the wrapper takes float32
only. Implementation choice is by the tensors' device only: a CUDA
tensor launches the hand-written kernel (``csrc/rglru_scan.cu``: any S
and W, read in place through strides) or raises; a CPU tensor takes
:func:`rglru_scan_ref`. A failed build or launch is never swapped for
the plain version. The plain versions, like the reference's, take any
float dtype.
"""
from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def rglru_scan_ref(a, b):
    """Plain version (port of ``rglru_scan_ref``): the inclusive parallel
    prefix of the affine maps, (a2,b2)o(a1,b1) = (a1 a2, a2 b1 + b2),
    combined at strides 1, 2, 4, ... (log-depth). Returns a's dtype."""
    dtype = a.dtype
    a, b = a.float(), b.float()
    S = a.shape[1]
    stride = 1
    while stride < S:
        b = torch.cat([b[:, :stride], a[:, stride:] * b[:, :-stride]
                       + b[:, stride:]], dim=1)
        a = torch.cat([a[:, :stride], a[:, stride:] * a[:, :-stride]], dim=1)
        stride *= 2
    return b.to(dtype)


def rglru_reference(a, b, h0=None):
    """The sequential recurrence in float32 (port of
    ``ref.rglru_reference``): the oracle of both versions."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    a, b = a.float(), b.float()
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _launcher():
    """The kernel's ``extern "C"`` launcher, built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = load("rglru_scan").rglru_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def _launch(a, b):
    global launches
    B, S, W = a.shape
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rglru_scan: the width axis must be contiguous")
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if h.numel() == 0:
        return h
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), a.stride(0),
                 a.stride(1), b.stride(0), b.stride(1), h.stride(0),
                 h.stride(1), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return h


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t (module doc). CUDA tensors run the kernel,
    CPU tensors :func:`rglru_scan_ref`; anything else raises."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan wants a, b of one (B,S,W) shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError("rglru_scan: a and b must share dtype and device")
    if a.dtype != torch.float32:
        raise ValueError(f"rglru_scan takes float32, got {a.dtype}")
    if a.device.type == "cuda":
        return _launch(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"rglru_scan: no implementation for device "
                         f"{a.device}")
    return rglru_scan_ref(a, b)
