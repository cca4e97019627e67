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
the plain version. The kernel has no backward: a CUDA call with an input
that requires grad raises under grad mode
(:func:`~repro_torch.kernels._grad.forbid_grad`); the plain versions are
torch and differentiate. The plain versions, like the reference's, take
any float dtype.

The kernel is one pass over device memory: a thread-block cluster per
(batch row, group of channels) whose blocks take consecutive time chunks,
stage them in shared memory, and carry the state across the cluster in
rank order (the source's header). :func:`launch_plan` lays it out,
:func:`tma_route` picks how a block stages its tiles, and
:func:`rglru_chunked_ref` is the plain version of its decomposition.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._grad import forbid_grad

# The kernel's layout (csrc/rglru_scan.cu): threads per block, the channel
# groups it is compiled for, the largest portable cluster, the longest
# chunk (a TMA box holds at most 256 rows), the most floats of a chunk x
# group tile (two stages of a and b tiles in 128 KB of shared memory) and
# the chunk granularity.
THREADS = 256
GROUPS = (32, 64)
MAX_CLUSTER = 8
MAX_CHUNK = 256
MAX_TILE = 8192
CHUNK_STEP = 8
# launch_plan's choices, timed on an H100 (scripts/torch_rglru_plan.py,
# PERF.md): the clusters of 64 channels from which groups of 64 pay off;
# the blocks a launch aims for (about two per SM of the card's 132); the
# floats of a chunk x group tile where the launch has a block for every SM
# (else MAX_TILE); and the shortest chunk a cluster's block gets.
SMS = 132
WIDE_CLUSTERS = 128
BLOCKS = 256
TILE = 4096
MIN_CHUNK = 32

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


def _fma(a, h, b):
    """float32 a h + b rounded once, as the kernel's ``fmaf`` (float64
    holds the product exactly; the sum is rounded to float32 through
    float64)."""
    return (a.double() * h.double() + b.double()).float()


def rglru_chunked_ref(a, b, *, chunks, segs, chunk):
    """The kernel's decomposition in plain torch (float32): windows of
    ``chunks`` chunks of ``chunk`` steps (one block each), each chunk cut
    into ``segs`` segments (one thread per channel each). Every segment
    composes its maps from a zero state into (prod a, h); the segments fold
    in order into the chunk's aggregate; the aggregates fold in rank order,
    window after window, from h = 0, giving each chunk's incoming state and
    from it each segment's; then each segment walks again. Steps past S
    are zeros, as the kernel stages them. Every step and fold is one
    rounding (:func:`_fma`), as the kernel's ``fmaf``. For the tests."""
    if chunk % segs:
        raise ValueError(f"chunk {chunk} is not a multiple of segs {segs}")
    B, S, W = a.shape
    dtype = a.dtype
    span = chunks * chunk
    nwin = -(-S // span)
    pad = nwin * span - S
    L = chunk // segs
    a = F.pad(a.float(), (0, 0, 0, pad)).reshape(B, nwin, chunks, segs, L, W)
    b = F.pad(b.float(), (0, 0, 0, pad)).reshape(B, nwin, chunks, segs, L, W)
    # pass 1: each segment from a zero state
    P = torch.ones_like(a[..., 0, :])
    H = torch.zeros_like(P)
    for j in range(L):
        H = _fma(a[..., j, :], H, b[..., j, :])
        P = P * a[..., j, :]
    # the chunks' aggregates, segments in order
    Pc = torch.ones_like(P[..., 0, :])
    Hc = torch.zeros_like(Pc)
    for q in range(segs):
        Hc = _fma(P[..., q, :], Hc, H[..., q, :])
        Pc = Pc * P[..., q, :]
    # the chunks' incoming states: ranks in order, windows in order
    h_in = torch.empty_like(Pc)
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for w in range(nwin):
        for r in range(chunks):
            h_in[:, w, r] = h
            h = _fma(Pc[:, w, r], h, Hc[:, w, r])
    # the segments' incoming states, then pass 2
    seg_in = torch.empty_like(P)
    h = h_in
    for q in range(segs):
        seg_in[..., q, :] = h
        h = _fma(P[..., q, :], h, H[..., q, :])
    out = torch.empty_like(a)
    h = seg_in
    for j in range(L):
        h = _fma(a[..., j, :], h, b[..., j, :])
        out[..., j, :] = h
    return out.reshape(B, nwin * span, W)[:, :S].to(dtype)


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


class LaunchPlan(NamedTuple):
    """The kernel's layout: ``group`` channels per cluster, ``cluster``
    blocks per cluster on consecutive time chunks of ``chunk`` steps."""
    group: int
    cluster: int
    chunk: int

    def windows(self, S: int) -> int:
        """Windows of ``cluster * chunk`` steps the cluster walks."""
        return -(-S // (self.cluster * self.chunk))

    def chunked_ref_args(self) -> dict:
        """:func:`rglru_chunked_ref`'s arguments for this layout."""
        return {"chunks": self.cluster, "segs": THREADS // self.group,
                "chunk": self.chunk}


def launch_plan(B: int, S: int, W: int) -> LaunchPlan:
    """The layout of a launch: channel groups of 64 where there are at
    least ``WIDE_CLUSTERS`` of them, else 32; the fewest blocks per
    cluster (<= 8, each with at least ``MIN_CHUNK`` steps) that give about
    ``BLOCKS`` blocks; chunks of ``TILE`` floats (``MAX_TILE`` where the
    launch has fewer blocks than SMs), spread evenly over the windows and
    rounded up to ``CHUNK_STEP``."""
    group = 64 if B * -(-W // 64) >= WIDE_CLUSTERS else 32
    clusters = B * -(-W // group)
    cluster = max(1, min(MAX_CLUSTER, -(-S // MIN_CHUNK),
                         -(-BLOCKS // clusters)))
    tile = TILE if cluster * clusters >= SMS else MAX_TILE
    target = min(MAX_CHUNK, tile // group)
    windows = -(-S // (cluster * target))
    chunk = -(-S // (cluster * windows))
    return LaunchPlan(group, cluster, -(-chunk // CHUNK_STEP) * CHUNK_STEP)


def tma_route(*tensors) -> bool:
    """Whether a launch stages its tiles through TMA: W a multiple of 4
    and, for every tensor, a 16-byte aligned base and time and batch
    strides that are multiples of 4 elements and nest (time stride >= W,
    batch stride >= S times it; an extent-1 axis takes the stride that
    continues the one before it, as the kernel's tensor map does).
    Anything else (an odd width, an offset view, a broadcast axis) stages
    by 4-byte ``cp.async`` copies."""
    B, S, W = tensors[0].shape
    if W % 4:
        return False
    for t in tensors:
        ss = t.stride(1) if S > 1 else W
        sb = t.stride(0) if B > 1 else S * ss
        if t.data_ptr() % 16 or ss % 4 or sb % 4 or ss < W or sb < S * ss:
            return False
    return True


def _launcher():
    """The kernel's ``extern "C"`` launcher, built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = load("rglru_scan").rglru_scan_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return fn


def _launch(a, b, plan=None, tma=None):
    """Launch the kernel under ``plan`` (default :func:`launch_plan`) on
    the route ``tma`` (default :func:`tma_route`)."""
    global launches
    B, S, W = a.shape
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("rglru_scan: the width axis must be contiguous")
    h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if h.numel() == 0:
        return h
    plan = plan or launch_plan(B, S, W)
    if (plan.group not in GROUPS or not 1 <= plan.cluster <= MAX_CLUSTER
            or not CHUNK_STEP <= plan.chunk <= MAX_CHUNK
            or plan.chunk % CHUNK_STEP or plan.chunk * plan.group > MAX_TILE):
        raise ValueError(f"rglru_scan: no kernel for {plan}")
    if tma is None:
        tma = tma_route(a, b, h)
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), a.stride(0),
                 a.stride(1), b.stride(0), b.stride(1), h.stride(0),
                 h.stride(1), B, S, W, plan.group, plan.cluster, plan.chunk,
                 int(bool(tma)), stream)
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
        forbid_grad("rglru_scan", a, b)
        return _launch(a, b)
    if a.device.type != "cpu":
        raise ValueError(f"rglru_scan: no implementation for device "
                         f"{a.device}")
    return rglru_scan_ref(a, b)
