"""GreedyTL's leave-one-out trial scorer: the Hopper kernel, its plain
PyTorch version, and the float64 oracles the tests hold both against.

Port of ``repro.kernels.loo_trials`` (the Pallas kernel) and of the
``loo_trials`` dispatch in ``repro.kernels.ops``. The contract is
fleet-batched: every argument carries a leading DC axis L,

    ut (L,R,D), cc (L,D,M), a_cand (L,R,M),
    fitted_base / h_base / y / rmask (L,R), zj / dinv (L,M)  ->  (L,M),

so one launch scores every candidate of every DC of a fleet bucket (the
reference maps one launch per DC). :func:`loo_trials_single` keeps the
reference's single-system signature for like-with-like tests.
:func:`loo_trials_step` is the incremental refine's greedy step in one
launch: it computes ``dinv`` and ``zj`` from the carries (the step's
prologue) and then scores the trials, returning all three.

Implementation choice is by the tensors' device only — there is no
autotuner and no override: a CUDA tensor launches the hand-written kernel
(``csrc/loo_trials.cu``, one thread-block cluster per DC and candidate
tile, laid out by :func:`launch_plan`) or raises; a CPU tensor takes
:func:`loo_trials_ref` (or :func:`loo_trials_step_ref`). A failed build or
launch is never swapped for the plain version. The kernel has no backward:
a CUDA call with an input that requires grad raises under grad mode
(:func:`~repro_torch.kernels._grad.forbid_grad`); the plain versions are
torch and differentiate.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels._grad import forbid_grad

MAX_CANDIDATES = 128
MAX_D = 128
# The kernel's tiling (csrc/loo_trials.cu): candidates per cluster, rows
# per staged sub-tile, the most rows a block should hold (3 sub-tiles: one
# pass of its 256 threads, with its last warps idle), the D buckets it is
# compiled for, the largest portable cluster, and the blocks a launch aims
# for when the rows allow more (on an H100, blocks of <= 192 rows beat
# blocks of 256, and 8-block clusters beat fewer only at small L:
# scripts/torch_loo_plan.py, PERF.md §6).
CAND_TILE = 16
ROW_TILE = 64
BLOCK_ROWS = 192
D_BUCKETS = (16, 32, 64, 128)
MAX_CLUSTER = 8
TARGET_BLOCKS = 96

# Launches of the CUDA kernel (incremented only where it launches), through
# either entry point; ``step_launches`` counts those of the fused one.
launches = 0
step_launches = 0


def reset_launches() -> None:
    global launches, step_launches
    launches = step_launches = 0


def loo_trials_ref(ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv):
    """Plain PyTorch version of the kernel, batched: shapes as in the
    module doc, returns the per-candidate LOO SSE (L, M)."""
    t = (a_cand - torch.bmm(ut, cc)) * dinv[:, None, :]         # (L, R, M)
    fitted = fitted_base[:, :, None] + t * zj[:, None, :]
    resid = (fitted - y[:, :, None]) * rmask[:, :, None]
    h = h_base[:, :, None] + t * t
    loo = resid / torch.clamp(1.0 - h, min=0.1)
    return torch.sum(loo * loo, dim=1)


def loo_trials_step_ref(ut, cc, a_cand, fitted, h, y, rmask, diag_g, aty_m,
                        z, sel, src_mask):
    """Plain PyTorch version of the fused greedy step: the step's prologue
    (the Schur pivots' inverses ``dinv`` and the bordered right-hand sides
    ``zj`` of every candidate, from the carries) followed by
    :func:`loo_trials_ref`. Shapes as in the module doc, plus diag_g /
    aty_m / sel / src_mask (L,M) and z (L,D); returns (objs, dinv, zj),
    each (L,M)."""
    active = sel * src_mask
    dsq = diag_g - torch.sum(cc ** 2, dim=1)
    dinv = torch.rsqrt(torch.clamp(dsq, min=1e-8)) * (1.0 - active)
    zj = (aty_m - torch.bmm(cc.transpose(1, 2), z[:, :, None])[:, :, 0]) \
        * dinv
    objs = loo_trials_ref(ut, cc, a_cand, fitted, h, y, rmask, zj, dinv)
    return objs, dinv, zj


_NAMES = ("ut", "cc", "a_cand", "fitted_base", "h_base", "y", "rmask", "zj",
          "dinv")
_STEP_NAMES = ("ut", "cc", "a_cand", "fitted", "h", "y", "rmask", "diag_g",
               "aty_m", "z", "sel", "src_mask")
_ROW_ARGS = ("fitted_base", "h_base", "fitted", "h", "y", "rmask")


def _check(entry, names, args):
    ut, cc = args[0], args[1]
    if ut.dim() != 3 or cc.dim() != 3:
        raise ValueError(f"{entry} wants ut (L,R,D) and cc (L,D,M), got "
                         f"{tuple(ut.shape)} and {tuple(cc.shape)}")
    L, R, D = ut.shape
    M = cc.shape[2]
    shapes = {"ut": (L, R, D), "cc": (L, D, M), "a_cand": (L, R, M),
              "z": (L, D)}
    for name, a in zip(names, args):
        shape = shapes.get(name, (L, R) if name in _ROW_ARGS else (L, M))
        if tuple(a.shape) != shape:
            raise ValueError(f"{entry}: {name} has shape "
                             f"{tuple(a.shape)}, want {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"{entry}: {name} is {a.dtype}, want float32")
        if a.device != ut.device:
            raise ValueError(f"{entry}: {name} is on {a.device}, ut on "
                             f"{ut.device}")
    return L, R, D, M


class LaunchPlan(NamedTuple):
    cluster: int      # blocks per (DC, candidate tile); they split the rows
    d_bucket: int     # D zero-padded to this (the kernel's template)
    m_tiles: int      # candidate tiles of CAND_TILE
    row_tiles: int    # row tiles of ROW_TILE per DC


def launch_plan(L, R, D, M) -> LaunchPlan:
    """How the kernel covers an (L, R, D, M) call: one cluster per DC and
    candidate tile. A cluster has enough blocks that none holds more than
    ``BLOCK_ROWS`` rows, and more, up to about ``TARGET_BLOCKS`` in the
    grid, while the rows allow; at most ``MAX_CLUSTER`` (the portable
    cluster size) and at most one block per row tile. D goes up to the next
    bucket."""
    m_tiles = -(-M // CAND_TILE)
    row_tiles = -(-R // ROW_TILE)
    short = -(-row_tiles // (BLOCK_ROWS // ROW_TILE))
    spread = TARGET_BLOCKS // max(1, L * m_tiles)
    cluster = max(1, min(MAX_CLUSTER, row_tiles, max(short, spread)))
    d_bucket = next((b for b in D_BUCKETS if D <= b), None)
    if d_bucket is None:
        raise ValueError(f"loo_trials kernel takes D <= {MAX_D}, got D={D}")
    return LaunchPlan(cluster, d_bucket, m_tiles, row_tiles)


def block_rows(plan: LaunchPlan, R, rank):
    """Rows [lo, hi) that block ``rank`` of a cluster scores: whole row
    tiles, split as evenly as the tiles allow (the kernel's own formula)."""
    t_lo = rank * plan.row_tiles // plan.cluster
    t_hi = (rank + 1) * plan.row_tiles // plan.cluster
    return t_lo * ROW_TILE, min(R, t_hi * ROW_TILE)


def _launcher(entry="loo_trials"):
    """An ``extern "C"`` launcher of the kernel (``loo_trials`` or
    ``loo_trials_step``), built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = getattr(load("loo_trials"), f"{entry}_launch")
    if fn.argtypes is None:
        pointers = len(_STEP_NAMES) + 3 if entry == "loo_trials_step" \
            else len(_NAMES) + 1
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def _launch(entry, args, n_out, L, R, D, M):
    global launches, step_launches
    for a in args:
        if not a.is_contiguous():
            raise ValueError(f"{entry}: CUDA inputs must be contiguous")
    if M > MAX_CANDIDATES or D > MAX_D:
        raise ValueError(f"loo_trials kernel takes M <= {MAX_CANDIDATES} "
                         f"and D <= {MAX_D}, got M={M}, D={D}")
    plan = launch_plan(L, R, D, M)
    fn = _launcher(entry)
    outs = [torch.empty((L, M), dtype=torch.float32, device=args[0].device)
            for _ in range(n_out)]
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() for a in args),
                 *(o.data_ptr() for o in outs), L, R, D, M, plan.cluster,
                 plan.d_bucket, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    if entry == "loo_trials_step":
        step_launches += 1
    return outs


def loo_trials(ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv):
    """Fleet-batched trial scorer (module doc). CUDA tensors run the
    kernel, CPU tensors the plain version; anything else raises."""
    args = (ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv)
    L, R, D, M = _check("loo_trials", _NAMES, args)
    if ut.device.type == "cuda":
        forbid_grad("loo_trials", *args)
        return _launch("loo_trials", args, 1, L, R, D, M)[0]
    if ut.device.type == "cpu":
        return loo_trials_ref(*args)
    raise ValueError(f"loo_trials: no implementation for device "
                     f"{ut.device}")


def loo_trials_step(ut, cc, a_cand, fitted, h, y, rmask, diag_g, aty_m, z,
                    sel, src_mask):
    """One greedy step of the incremental refine in one launch: the step's
    prologue fused into the trial scorer (:func:`loo_trials_step_ref`).
    Returns (objs, dinv, zj), each (L,M). CUDA tensors run the kernel, CPU
    tensors the plain version; anything else raises."""
    args = (ut, cc, a_cand, fitted, h, y, rmask, diag_g, aty_m, z, sel,
            src_mask)
    L, R, D, M = _check("loo_trials_step", _STEP_NAMES, args)
    if ut.device.type == "cuda":
        forbid_grad("loo_trials_step", *args)
        return tuple(_launch("loo_trials_step", args, 3, L, R, D, M))
    if ut.device.type == "cpu":
        return loo_trials_step_ref(*args)
    raise ValueError(f"loo_trials_step: no implementation for device "
                     f"{ut.device}")


def loo_trials_single(ut, cc, a_cand, fitted_base, h_base, y, rmask, zj,
                      dinv):
    """Single-system form with the reference's signature: ut (R,D),
    cc (D,M), a_cand (R,M), four (R,) rows, zj/dinv (M,) -> (M,)."""
    args = (ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv)
    return loo_trials(*(a.unsqueeze(0).contiguous() for a in args))[0]


# ---------------------------------------------------------------------------
# float64 oracles (ports of repro/kernels/ref.py), for the tests
# ---------------------------------------------------------------------------

def loo_trials_inv_reference(AtA, Aty, A_rm, y, rmask, cmask, lam_d, M):
    """Inverse-based greedy-trial scorer in float64: for each candidate
    j < M, solve the column-masked ridge over active ∪ {j} with an explicit
    inverse and return its closed-form LOO SSE (M,)."""
    AtA, Aty, A_rm, y, rmask, cmask, lam_d = (
        torch.as_tensor(np.asarray(v), dtype=torch.float64)
        for v in (AtA, Aty, A_rm, y, rmask, cmask, lam_d))
    out = torch.empty(M, dtype=torch.float64)
    for j in range(M):
        cm = cmask.clone()
        cm[j] = 1.0
        cm2 = cm[:, None] * cm[None, :]
        Ginv = torch.linalg.inv(AtA * cm2 + torch.diag(lam_d))
        v = (Ginv @ (Aty * cm)) * cm
        resid = (A_rm @ v - y) * rmask
        h = torch.sum((A_rm @ (Ginv * cm2)) * A_rm, dim=-1)
        loo = resid / torch.clamp(1.0 - h, min=0.1)
        out[j] = torch.sum(loo ** 2)
    return out


def greedy_select_refactor_reference(AtA, Aty, A_rm, y, rmask, src_mask,
                                     lam_d, M, k_max=16):
    """Full-refactorization greedy source selection in float64: every step
    re-solves the ridge of active ∪ {j} for each candidate and accepts the
    best iff it improves the LOO SSE. Returns (sel (M,) 0/1 numpy,
    objective trajectory)."""
    AtA, Aty, A_rm, y, rmask, lam_d, src_mask = (
        torch.as_tensor(np.asarray(v), dtype=torch.float64)
        for v in (AtA, Aty, A_rm, y, rmask, lam_d, src_mask))
    C = AtA.shape[0] - M

    def loo_full(cm):
        cm2 = cm[:, None] * cm[None, :]
        Ginv = torch.linalg.inv(AtA * cm2 + torch.diag(lam_d))
        v = (Ginv @ (Aty * cm)) * cm
        resid = (A_rm @ v - y) * rmask
        h = torch.sum(((A_rm * cm) @ Ginv) * (A_rm * cm), dim=-1)
        loo = resid / torch.clamp(1.0 - h, min=0.1)
        return float(torch.sum(loo ** 2))

    sel = torch.zeros(M, dtype=torch.float64)
    ones = torch.ones(C, dtype=torch.float64)
    best = loo_full(torch.cat([torch.zeros(M, dtype=torch.float64), ones]))
    traj = [best]
    for _ in range(min(k_max, M)):
        objs = np.full(M, np.inf)
        for j in range(M):
            if sel[j] or not src_mask[j]:
                continue
            cm = torch.cat([sel * src_mask, ones])
            cm[j] = 1.0
            objs[j] = loo_full(cm)
        j = int(np.argmin(objs))
        if not np.isfinite(objs[j]) or objs[j] >= best:
            break
        sel[j] = 1.0
        best = float(objs[j])
        traj.append(best)
    return sel.numpy(), traj
