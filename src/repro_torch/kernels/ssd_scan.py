"""Mamba-2 SSD scan: the Hopper kernel, its plain PyTorch versions, and
the wrapper the model calls.

Port of ``repro.kernels.ssd_scan`` (the Pallas kernel), of
``repro.models.ssd.ssd_chunked`` (the reference's XLA path) and of
``ref.ssd_reference`` (the sequential oracle):

    ssd_scan(x, dt, A, Bm, Cm, chunk=Q) -> (y, final_state)
    x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative,
    Bm/Cm (B,S,N) shared across heads -> y (B,S,H,P), state (B,H,P,N)

Implementation choice is by the tensors' device only: a CUDA tensor
launches the hand-written kernel (``csrc/ssd_scan.cu``: float32 or
bfloat16 x/B/C, P and N up to 128, any S, x and B/C read in place through
strides) or raises; a CPU tensor takes :func:`ssd_chunked`. A failed
build or launch is never swapped for the plain version.

Where the two differ in rounding: the kernel follows the Pallas kernel
(everything in float32, y and the state rounded once to x's dtype);
:func:`ssd_chunked` follows the reference's XLA path, which rounds the
intra-chunk matrix, the chunk states and the carried state to x's dtype,
and takes one chunk of S steps when the chunk does not divide S (the
kernel instead masks a ragged last chunk). In float32 they agree to
roundoff; in bfloat16 they differ by more (PERF.md).
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PN = 128
MAX_CHUNK = 1024

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Plain version: the chunked dual form of ``repro.models.ssd
    .ssd_chunked``, op for op (module doc)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q != 0:
        Q = S
    nc = S // Q
    xr = x.reshape(Bsz, nc, Q, H, P)
    dtr = dt.reshape(Bsz, nc, Q, H).float()
    Br = Bm.reshape(Bsz, nc, Q, N)
    Cr = Cm.reshape(Bsz, nc, Q, N)

    da = dtr * A                                    # (B,nc,Q,H), negative
    cs = torch.cumsum(da, dim=2)                    # within-chunk cumsum
    seg_last = cs[:, :, -1:, :]                     # (B,nc,1,H)

    # intra-chunk: Y[i] = sum_{j<=i} exp(cs_i - cs_j) (C_i . B_j) dt_j x_j
    scores = torch.einsum("bcin,bcjn->bcij", Cr.float(), Br.float())
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(decay), 0.0)
    M = scores[..., None] * L * dtr[:, :, None, :, :]        # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M.to(x.dtype), xr)

    # chunk input states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    w = torch.exp(seg_last - cs) * dtr                       # (B,nc,Q,H)
    chunk_state = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w.to(x.dtype),
                               Br.to(x.dtype), xr)

    # inter-chunk recurrence over the chunk axis
    seg_decay = torch.exp(seg_last[:, :, 0, :]).to(x.dtype)   # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * seg_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,H,P,N)

    y_inter = torch.einsum("bcin,bchpn->bcihp", Cr.to(x.dtype), h_prevs)
    y_inter = y_inter * torch.exp(cs)[..., None].to(x.dtype)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def ssd_reference(x, dt, A, Bm, Cm):
    """The sequential state-space recurrence in float32 (port of
    ``ref.ssd_reference``): the oracle of both versions."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)                     # (B,H)
        h = h * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)


def _check(x, dt, A, Bm, Cm):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError("ssd_scan wants x (B,S,H,P), dt (B,S,H), A (H,), "
                         "Bm/Cm (B,S,N)")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("ssd_scan: x, Bm and Cm must share one dtype")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd_scan: all inputs must share one device")
    return Bsz, S, H, P, N


def _launcher():
    """The kernel's ``extern "C"`` launcher, built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = load("ssd_scan").ssd_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 13
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def _launch(x, dt, A, Bm, Cm, chunk, dims):
    global launches
    Bsz, S, H, P, N = dims
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan kernel takes float32/bfloat16, got "
                         f"{x.dtype}")
    if P > MAX_PN or N > MAX_PN or not 1 <= chunk <= MAX_CHUNK or S < 1:
        raise ValueError(f"ssd_scan kernel takes P, N <= {MAX_PN}, a chunk "
                         f"in 1..{MAX_CHUNK} and S >= 1; got P={P}, N={N}, "
                         f"chunk={chunk}, S={S}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssd_scan: P of x and N of Bm/Cm must be "
                         "contiguous")
    dt = dt.float()            # no copy on the model path (already float32)
    A = A.float().contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 y.stride(0), y.stride(1), y.stride(2),
                 Bsz, S, H, P, N, min(chunk, S), DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """(y, final_state) of the SSD scan (module doc). CUDA tensors run
    the kernel, CPU tensors :func:`ssd_chunked`; anything else raises."""
    dims = _check(x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, chunk, dims)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no implementation for device "
                         f"{x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)
