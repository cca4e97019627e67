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

Implementation choice is by the tensors' device only — there is no
autotuner and no override: a CUDA tensor launches the hand-written kernel
(``csrc/loo_trials.cu``) or raises; a CPU tensor takes
:func:`loo_trials_ref`. A failed build or launch is never swapped for the
plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_CANDIDATES = 128
MAX_D = 128

# Launches of the CUDA kernel (incremented only where it launches).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def loo_trials_ref(ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv):
    """Plain PyTorch version of the kernel, batched: shapes as in the
    module doc, returns the per-candidate LOO SSE (L, M)."""
    t = (a_cand - torch.bmm(ut, cc)) * dinv[:, None, :]         # (L, R, M)
    fitted = fitted_base[:, :, None] + t * zj[:, None, :]
    resid = (fitted - y[:, :, None]) * rmask[:, :, None]
    h = h_base[:, :, None] + t * t
    loo = resid / torch.clamp(1.0 - h, min=0.1)
    return torch.sum(loo * loo, dim=1)


def _check(args):
    ut, cc = args[0], args[1]
    if ut.dim() != 3 or cc.dim() != 3:
        raise ValueError(f"loo_trials wants ut (L,R,D) and cc (L,D,M), got "
                         f"{tuple(ut.shape)} and {tuple(cc.shape)}")
    L, R, D = ut.shape
    M = cc.shape[2]
    want = [(L, R, D), (L, D, M), (L, R, M), (L, R), (L, R), (L, R), (L, R),
            (L, M), (L, M)]
    names = ("ut", "cc", "a_cand", "fitted_base", "h_base", "y", "rmask",
             "zj", "dinv")
    for name, a, shape in zip(names, args, want):
        if tuple(a.shape) != shape:
            raise ValueError(f"loo_trials: {name} has shape "
                             f"{tuple(a.shape)}, want {shape}")
        if a.dtype != torch.float32:
            raise TypeError(f"loo_trials: {name} is {a.dtype}, want float32")
        if a.device != ut.device:
            raise ValueError(f"loo_trials: {name} is on {a.device}, ut on "
                             f"{ut.device}")
    return L, R, D, M


def _launcher():
    """The kernel's ``extern "C"`` launcher, built and typed on first use."""
    from repro_torch.kernels.build import load

    fn = load("loo_trials").loo_trials_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def _launch(args, L, R, D, M):
    global launches
    for a in args:
        if not a.is_contiguous():
            raise ValueError("loo_trials: CUDA inputs must be contiguous")
    if M > MAX_CANDIDATES or D > MAX_D:
        raise ValueError(f"loo_trials kernel takes M <= {MAX_CANDIDATES} "
                         f"and D <= {MAX_D}, got M={M}, D={D}")
    fn = _launcher()
    out = torch.empty((L, M), dtype=torch.float32, device=args[0].device)
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() for a in args), out.data_ptr(), L, R, D, M,
                 stream)
    if err != 0:
        raise RuntimeError(f"loo_trials kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def loo_trials(ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv):
    """Fleet-batched trial scorer (module doc). CUDA tensors run the
    kernel, CPU tensors the plain version; anything else raises."""
    args = (ut, cc, a_cand, fitted_base, h_base, y, rmask, zj, dinv)
    L, R, D, M = _check(args)
    if ut.device.type == "cuda":
        return _launch(args, L, R, D, M)
    if ut.device.type == "cpu":
        return loo_trials_ref(*args)
    raise ValueError(f"loo_trials: no implementation for device "
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
