"""Mamba-2 SSD scan: the Hopper kernels, their plain PyTorch versions, and
the wrapper the model calls.

Port of ``repro.kernels.ssd_scan`` (the Pallas kernel), of
``repro.models.ssd.ssd_chunked`` (the reference's XLA path) and of
``ref.ssd_reference`` (the sequential oracle):

    ssd_scan(x, dt, A, Bm, Cm, chunk=Q) -> (y, final_state)
    x (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative,
    Bm/Cm (B,S,N) shared across heads -> y (B,S,H,P), state (B,H,P,N)

Implementation choice is by the tensors' device only: a CUDA tensor
launches the hand-written kernels (``csrc/ssd_scan.cu``: float32 or
bfloat16 x/B/C, P and N up to 128, any S, x and B/C read in place through
strides) or raises; a CPU tensor takes :func:`ssd_chunked`. A failed
build or launch is never swapped for the plain version. The kernels have
no backward: a CUDA call with an input that requires grad raises under
grad mode (:func:`~repro_torch.kernels._grad.forbid_grad`); the plain
versions are torch and differentiate.

On the card there are two routes, chosen by :func:`tensor_core_route`:

* **tensor cores** (bfloat16, P 64, N 64 or 128, a chunk that is a multiple
  of 64 up to 256, 16-byte aligned rows: mamba2-1.3b's prefill): three
  chunk-parallel kernels with ``wgmma`` products (``csrc/hopper.cuh``).
  Kernel 1 computes each chunk's cumulative log decay ``cs`` and its own
  state, kernel 2 carries the states across the chunks, kernel 3 computes
  y per 64-row query tile for a group of heads, which share its scores
  C·Bᵀ. Operands that are not bf16 go through the tensor cores as a bf16
  hi + lo pair. The wrapper allocates the scratch they pass on.
  :func:`chunk_states_ref`, :func:`state_pass_ref` and
  :func:`chunk_scan_ref` are the plain versions of the three kernels, with
  their rounding points (``split=True`` emulates the hi + lo pairs);
* **CUDA cores** (everything else): one block per (batch, head) walking
  its chunks in order, float32 FMAs.

Each call counts as one launch, whichever route it takes.

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

from repro_torch.kernels._grad import forbid_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PN = 128
MAX_CHUNK = 1024
# The tensor-core route's shapes: head dim, state dims, chunk granularity.
TC_P = 64
TC_N = (64, 128)
TC_TILE = 64
TC_MAX_CHUNK = 256

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


def _split(v):
    """v as the kernels feed it to the tensor cores: bf16 hi + bf16 lo."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _pad_chunks(t, nc, Q):
    """(B,S,...) -> (B,nc,Q,...), float32, zero rows past S."""
    S = t.shape[1]
    pad = torch.zeros((t.shape[0], nc * Q - S) + tuple(t.shape[2:]),
                      dtype=torch.float32, device=t.device)
    out = torch.cat([t.float(), pad], dim=1)
    return out.reshape((t.shape[0], nc, Q) + tuple(t.shape[2:]))


def chunk_states_ref(x, dt, A, Bm, chunk, split=False):
    """Plain version of the tensor-core route's kernel 1, in float32:
    (cs (B,nc,H,Q), the cumulative log decay within each chunk; states
    (B,nc,H,P,N), each chunk's own state sum_j exp(cs_Q - cs_j) dt_j x_j^T
    B_j). S is padded to whole chunks with x = B = 0, dt = 0; ``split``
    feeds x w as bf16 hi + lo, as the kernel does."""
    Q = chunk
    nc = -(-x.shape[1] // Q)
    xr, dtr, Br = (_pad_chunks(t, nc, Q) for t in (x, dt, Bm))
    cs = torch.cumsum(dtr * A.float(), dim=2)                # (B,nc,Q,H)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtr
    xw = xr * w[..., None]                                   # (B,nc,Q,H,P)
    if split:
        xw = _split(xw)
    states = torch.einsum("bcjhp,bcjn->bchpn", xw, Br)
    return cs.permute(0, 1, 3, 2).contiguous(), states


def state_pass_ref(cs, states):
    """Plain version of kernel 2: (h_prev (B,nc,H,P,N), the state entering
    each chunk; the final state (B,H,P,N)), float32, unrounded."""
    seg = torch.exp(cs[..., -1])                             # (B,nc,H)
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(states.shape[1]):
        h_prev.append(h)
        h = seg[:, c, :, None, None] * h + states[:, c]
    return torch.stack(h_prev, dim=1), h


def chunk_scan_ref(x, dt, Bm, Cm, cs, h_prev, split=False):
    """Plain version of kernel 3: y (B,S,H,P) in float32, unrounded:
    exp(cs_i) C_i h_prev^T + sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j)
    dt_j x_j, the exponent taken only at or below the diagonal; ``split``
    feeds M and h_prev as bf16 hi + lo, as the kernel does."""
    S = x.shape[1]
    nc, Q = cs.shape[1], cs.shape[3]
    xr, dtr, Br, Cr = (_pad_chunks(t, nc, Q) for t in (x, dt, Bm, Cm))
    csr = cs.permute(0, 1, 3, 2)                             # (B,nc,Q,H)
    G = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    diff = csr[:, :, :, None, :] - csr[:, :, None, :, :]     # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    M = G[..., None] * decay * dtr[:, :, None, :, :]
    hp = h_prev
    if split:
        M, hp = _split(M), _split(h_prev)
    y = torch.einsum("bcin,bchpn->bcihp", Cr, hp) * torch.exp(csr)[..., None]
    y = y + torch.einsum("bcijh,bcjhp->bcihp", M, xr)
    return y.reshape(x.shape[0], nc * Q, x.shape[2], x.shape[3])[:, :S]


def ssd_staged(x, dt, A, Bm, Cm, chunk, split=False):
    """The three plain stages in a row: (y, final state) in x's dtype,
    each rounded once, as the tensor-core route gives them."""
    cs, states = chunk_states_ref(x, dt, A, Bm, chunk, split)
    h_prev, h = state_pass_ref(cs, states)
    y = chunk_scan_ref(x, dt, Bm, Cm, cs, h_prev, split)
    return y.to(x.dtype), h.to(x.dtype)


def tensor_core_route(x, Bm, Cm, chunk) -> bool:
    """Whether a call takes the tensor-core route (module doc): bfloat16,
    P 64, N 64 or 128, a chunk that is a multiple of 64 up to 256, every
    pointer 16-byte aligned and every outer stride of x, Bm and Cm a
    multiple of 8 elements and not 0 (a dimension of extent 1 has no
    stride that matters). Everything else runs on the CUDA cores."""
    if (x.dtype != torch.bfloat16 or x.shape[3] != TC_P
            or Bm.shape[-1] not in TC_N or chunk % TC_TILE
            or not TC_TILE <= chunk <= TC_MAX_CHUNK):
        return False
    for t in (x, Bm, Cm):
        if t.data_ptr() % 16 or t.stride(-1) != 1:
            return False
        for n, s in zip(t.shape[:-1], t.stride()[:-1]):
            if n > 1 and (s % 8 or s == 0):
                return False
    return True


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


# argtypes of the library's two ``extern "C"`` launchers: the CUDA-core
# kernel's and the tensor-core route's
_ARGTYPES = {
    "ssd_scan_launch": ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 13
                        + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
    "ssd_scan_tc_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 13
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
}


def _launcher(name="ssd_scan_launch"):
    """A launcher of the library (``_ARGTYPES``), built and typed on first
    use."""
    from repro_torch.kernels.build import load

    fn = getattr(load("ssd_scan"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return fn


def _launch_tc(x, dt, A, Bm, Cm, chunk, dims):
    """The tensor-core route: (y, state, cs (B,nc,H,Q), the chunks' own
    states (B,nc,H,P,N)), the last two float32 scratch that the kernels
    leave behind (they also pass dt and the entering states, as bf16 hi
    and lo planes, through scratch)."""
    Bsz, S, H, P, N = dims
    nc = -(-S // chunk)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    cs = torch.empty((Bsz, nc, H, 2, chunk), dtype=torch.float32,
                     device=x.device)
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    planes = torch.empty((Bsz, nc, H, 2, P, N), dtype=torch.bfloat16,
                         device=x.device)
    fn = _launcher("ssd_scan_tc_launch")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                 cs.data_ptr(), states.data_ptr(), planes.data_ptr(),
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
                 y.stride(0), y.stride(1), y.stride(2),
                 Bsz, S, H, N, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan tensor-core launch failed: CUDA error "
                           f"{err}")
    return y, state, cs[:, :, :, 0], states


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
    if tensor_core_route(x, Bm, Cm, chunk):
        y, state, _, _ = _launch_tc(x, dt, A, Bm, Cm, chunk, dims)
        launches += 1
        return y, state
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


def chunk_states(x, dt, A, Bm, Cm, *, chunk: int):
    """(cs, the chunks' own states) as the tensor-core route's first kernel
    leaves them, for checking it against :func:`chunk_states_ref`. CUDA
    tensors run the route (the call must take it; it counts as a launch),
    CPU tensors the plain version with the hi + lo split."""
    global launches
    dims = _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return chunk_states_ref(x, dt, A, Bm, chunk, split=True)
    if x.device.type != "cuda" or not tensor_core_route(x, Bm, Cm, chunk):
        raise ValueError("chunk_states: only a CUDA call that takes the "
                         "tensor-core route runs the chunk-state kernel")
    forbid_grad("chunk_states", x, dt, A, Bm, Cm)
    _, _, cs, states = _launch_tc(x, dt.float(), A.float().contiguous(), Bm,
                                  Cm, chunk, dims)
    launches += 1
    return cs, states


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """(y, final_state) of the SSD scan (module doc). CUDA tensors run
    the kernel, CPU tensors :func:`ssd_chunked`; anything else raises."""
    dims = _check(x, dt, A, Bm, Cm)
    if x.device.type == "cuda":
        forbid_grad("ssd_scan", x, dt, A, Bm, Cm)
        return _launch(x, dt, A, Bm, Cm, chunk, dims)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan: no implementation for device "
                         f"{x.device}")
    return ssd_chunked(x, dt, A, Bm, Cm, chunk)
