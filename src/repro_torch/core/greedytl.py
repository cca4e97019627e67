"""GreedyTL — transfer learning through greedy source selection
(Kuzborskij, Orabona, Caputo), ported from ``repro.core.greedytl``.

Same algorithm, same factorized leave-one-out (LOO) criterion: Stage 1
greedily adds source hypotheses (one scalar coefficient each) to a ridge
over the stacked (n·C)-row system, scoring every candidate through the
Cholesky bordering identity in one ``loo_trials`` kernel launch per greedy
step; Stage 2 fits a per-class ridge correction on the residual, kept only
if it lowers the LOO error. The result collapses into one linear model
``w_eff (F+1, C)``.

Differences from the reference, all in how it runs, none in what it
computes:

* Everything is batched over a leading DC axis L (the reference
  ``lax.map``s one DC at a time), so one kernel launch per greedy step
  serves a whole fleet bucket.
* The greedy loop runs a fixed ``min(k_max, M)`` steps under the
  reference's ``done``/``pick`` masking instead of exiting early, so the
  refine never synchronises the host per step. Once a DC stops improving,
  its state is frozen by ``torch.where``; its selections are the same as
  with the early exit.
* Cholesky factors come from ``torch.linalg.cholesky_ex`` (no error
  check, no host sync); the systems here are ridge-regularised and
  positive definite, and padding DCs give ``diag(λ)`` systems.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.dispatch import count_dispatch
from repro_torch.core.svm import svm_scores
from repro_torch.kernels import loo_trials as kernel


def _tri(Lc, B, upper=False):
    return torch.linalg.solve_triangular(Lc, B, upper=upper)


def _chol(G):
    return torch.linalg.cholesky_ex(G, check_errors=False).L


def _chol_masked(AtA, lam_d, cmask):
    """Cholesky factors (L, D, D) of the column-masked ridge Gram systems:
    masked-out rows/columns reduce to their diagonal λ."""
    cm2 = cmask[:, :, None] * cmask[:, None, :]
    return _chol(AtA * cm2 + torch.diag_embed(lam_d.expand_as(cmask)))


def _loo_ridge_chol(AtA, Aty, A_rm, y, rmask, cmask, lam_d):
    """Column-masked ridge + closed-form LOO error from precomputed Gram
    systems, batched: AtA (L,D,D), Aty (L,D), A_rm (L,R,D), y/rmask (L,R),
    cmask (L,D), lam_d (D,). Returns (loo_sse (L,), coeffs (L,D))."""
    Lc = _chol_masked(AtA, lam_d, cmask)
    Am = A_rm * cmask[:, None, :]
    Ut = _tri(Lc, Am.transpose(1, 2)).transpose(1, 2)          # (L, R, D)
    z = _tri(Lc, (Aty * cmask)[:, :, None])                     # (L, D, 1)
    v = _tri(Lc.transpose(1, 2), z, upper=True)[:, :, 0] * cmask
    resid = (torch.bmm(Ut, z)[:, :, 0] - y) * rmask
    h = torch.sum(Ut ** 2, dim=-1)
    loo = resid / torch.clamp(1.0 - h, min=0.1)
    return torch.sum(loo ** 2, dim=-1), v


def _loo_ridge(A, y, rmask, cmask, lam):
    """Ridge with LOO error from raw data, batched: A (L,R,D), y/rmask
    (L,R), cmask (L,D); ``lam`` a scalar ridge weight."""
    D = A.shape[-1]
    A_rm = A * rmask[:, :, None]
    lam_d = torch.full((D,), lam, dtype=A.dtype, device=A.device) + 1e-4
    AtA = torch.bmm(A_rm.transpose(1, 2), A_rm)
    Aty = torch.bmm(A_rm.transpose(1, 2), (y * rmask)[:, :, None])[:, :, 0]
    return _loo_ridge_chol(AtA, Aty, A_rm, y, rmask, cmask, lam_d)


def _matvec_t(Cc, z):
    """Cc (L,D,M), z (L,D) -> Ccᵀz (L,M)."""
    return torch.bmm(Cc.transpose(1, 2), z[:, :, None])[:, :, 0]


def _score_trials(AtA, Aty, A_rm, y, rmask, cmask, lam_d, M):
    """LOO SSE (L, M) of every candidate bordering j < M of the active set
    ``cmask``: factor the active system once, then score all M candidates
    by the rank-1 bordering identity in one kernel launch. Already-active
    candidates get dinv = 0 (finite garbage; the greedy loop masks them)."""
    Lc = _chol_masked(AtA, lam_d, cmask)
    Am = A_rm * cmask[:, None, :]
    Ut = _tri(Lc, Am.transpose(1, 2)).transpose(1, 2).contiguous()
    z = _tri(Lc, (Aty * cmask)[:, :, None])[:, :, 0]
    h_base = torch.sum(Ut ** 2, dim=-1)
    fitted_base = torch.bmm(Ut, z[:, :, None])[:, :, 0]
    Cc = _tri(Lc, AtA[:, :, :M] * cmask[:, :, None]).contiguous()
    dsq = (torch.diagonal(AtA, dim1=1, dim2=2)[:, :M] + lam_d[:M]
           - torch.sum(Cc ** 2, dim=1))
    dinv = torch.rsqrt(torch.clamp(dsq, min=1e-8)) * (1.0 - cmask[:, :M])
    zj = (Aty[:, :M] - _matvec_t(Cc, z)) * dinv
    return kernel.loo_trials(Ut, Cc, A_rm[:, :, :M].contiguous(),
                             fitted_base, h_base, y, rmask, zj, dinv)


def _pick_best(objs, sel, src_mask, best, done):
    """The greedy step's choice per DC: masked argmin (first minimum, as
    ``jnp.argmin``), and whether it improves; an all-inf row never does."""
    objs = torch.where((sel > 0) | (src_mask == 0), torch.inf, objs)
    j = torch.argmin(objs, dim=-1)
    obj_j = objs.gather(1, j[:, None])[:, 0]
    improved = (obj_j < best) & ~done
    return j, obj_j, improved


def _greedy_select_refactor(AtA, Aty, A_rm, yr, rmask, src_mask, lam_d, *,
                            M: int, C: int, k_max: int):
    """Greedy selection with a full masked refactorization per step — the
    in-tree oracle of the incremental carry. Returns (sel (L,M), best)."""
    Lb = AtA.shape[0]
    ones = torch.ones((Lb, C), dtype=AtA.dtype, device=AtA.device)
    bias_cols = torch.cat([torch.zeros_like(src_mask), ones], dim=1)
    best, _ = _loo_ridge_chol(AtA, Aty, A_rm, yr, rmask, bias_cols, lam_d)
    sel = torch.zeros_like(src_mask)
    done = torch.zeros(Lb, dtype=torch.bool, device=AtA.device)
    for _ in range(min(k_max, M)):
        cm = torch.cat([sel * src_mask, ones], dim=1)
        objs = _score_trials(AtA, Aty, A_rm, yr, rmask, cm, lam_d, M)
        j, obj_j, improved = _pick_best(objs, sel, src_mask, best, done)
        sel = torch.where(improved[:, None], sel.scatter(1, j[:, None], 1.0),
                          sel)
        best = torch.where(improved, obj_j, best)
        done = done | ~improved
    return sel, best


def _greedy_select_incremental(AtA, Aty, A_rm, yr, rmask, src_mask, lam_d, *,
                               M: int, C: int, k_max: int):
    """Greedy selection with the active set's Cholesky factor CARRIED
    across steps (``repro.core.greedytl._greedy_select_incremental``),
    batched over DCs, in fixed-shape carries padded to Dk = C + min(k_max,
    M) slots:

        Ut (L,R,Dk) whitened rows, Cc (L,Dk,M) candidate borderings,
        z (L,Dk) whitened RHS, fitted / h (L,R) active-set fit / leverage.

    Every DC still improving has accepted at every earlier step, so the
    append slot C + k is the same for all of them; DCs that stopped keep
    their carries. Each step's prologue (the candidates' ``dinv`` and
    ``zj`` from the carries) runs inside the same kernel launch as the
    trial sweep (``loo_trials_step``). Returns (sel (L,M), best (L,))."""
    Lb, R, _ = A_rm.shape
    Kmax = min(k_max, M)
    Dk = C + Kmax
    dev, f32 = AtA.device, AtA.dtype

    L0 = _chol(AtA[:, M:, M:] + torch.diag(lam_d[M:]))
    Utb = _tri(L0, A_rm[:, :, M:].transpose(1, 2)).transpose(1, 2)
    zb = _tri(L0, Aty[:, M:, None])[:, :, 0]
    Ccb = _tri(L0, AtA[:, M:, :M])

    Ut = torch.zeros((Lb, R, Dk), dtype=f32, device=dev)
    Ut[:, :, :C] = Utb
    Cc = torch.zeros((Lb, Dk, M), dtype=f32, device=dev)
    Cc[:, :C] = Ccb
    z = torch.zeros((Lb, Dk), dtype=f32, device=dev)
    z[:, :C] = zb
    fitted = torch.bmm(Utb, zb[:, :, None])[:, :, 0]
    h = torch.sum(Utb ** 2, dim=-1)
    resid0 = (fitted - yr) * rmask
    best = torch.sum((resid0 / torch.clamp(1.0 - h, min=0.1)) ** 2, dim=-1)
    diagG = torch.diagonal(AtA, dim1=1, dim2=2)[:, :M] + lam_d[:M]
    a_cand = A_rm[:, :, :M].contiguous()
    aty_m = Aty[:, :M].contiguous()
    src = src_mask.contiguous()
    sel = torch.zeros_like(src)
    done = torch.zeros(Lb, dtype=torch.bool, device=dev)
    ar = torch.arange(Lb, device=dev)

    for k in range(Kmax):
        # the step's prologue (dinv, zj from the carries) and the trial
        # sweep, in one kernel launch
        objs, dinv, zj = kernel.loo_trials_step(Ut, Cc, a_cand, fitted, h,
                                                yr, rmask, diagG, aty_m, z,
                                                sel, src)
        j, obj_j, improved = _pick_best(objs, sel, src, best, done)
        # border append at slot C + k (see docstring)
        slot = C + k
        cj = Cc[ar, :, j]                                        # (L, Dk)
        d_j = dinv[ar, j]
        z_j = zj[ar, j]
        tcol = (A_rm[ar, :, j] - torch.bmm(Ut, cj[:, :, None])[:, :, 0]) \
            * d_j[:, None]                                       # (L, R)
        ccrow = (AtA[ar, j, :M] - _matvec_t(Cc, cj)) * d_j[:, None]
        imp = improved[:, None]
        sel = torch.where(imp, sel.scatter(1, j[:, None], 1.0), sel)
        best = torch.where(improved, obj_j, best)
        done = done | ~improved
        Ut[:, :, slot] = torch.where(imp, tcol, Ut[:, :, slot])
        Cc[:, slot] = torch.where(imp, ccrow, Cc[:, slot])
        z[:, slot] = torch.where(improved, z_j, z[:, slot])
        fitted = torch.where(imp, fitted + tcol * z_j[:, None], fitted)
        h = torch.where(imp, h + tcol * tcol, h)
    return sel, best


def _greedytl(x, y, mask, src_w, src_mask, *, num_classes: int,
              lam_src: float = 0.1, lam_x: float = 10.0,
              lam_bias: float = 2.0, k_max: int = 16,
              incremental: bool = True):
    """Batched GreedyTL core. x (L,n,F), y/mask (L,n), src_w (L,M,F+1,C),
    src_mask (L,M). Returns (w_eff (L,F+1,C), sel (L,M))."""
    Lb, n, F = x.shape
    M, C = src_w.shape[1], num_classes
    dev, f32 = x.device, torch.float32
    xm = x * mask[:, :, None]
    Yoh = (2.0 * torch.nn.functional.one_hot(y.long(), C).to(f32) - 1.0) \
        * mask[:, :, None]                                       # (L,n,C)

    # source predictions H (L,M,n,C), normalised per source to unit RMS
    H = svm_scores(src_w, xm[:, None]) * mask[:, None, :, None]
    denom = torch.clamp(mask.sum(dim=1), min=1.0) * C
    s = torch.sqrt(torch.sum(H ** 2, dim=(2, 3)) / denom[:, None]) + 1e-6
    Hn = H / s[:, :, None, None]

    # ---- Stage 1: stacked system over (n*C) rows, unknowns = alpha + bias
    R = n * C
    A_src = Hn.permute(0, 2, 3, 1).reshape(Lb, R, M)
    A_bias = torch.eye(C, dtype=f32, device=dev).repeat(n, 1)
    A = torch.cat([A_src, A_bias.expand(Lb, R, C)], dim=2)      # (L,R,M+C)
    yr = Yoh.reshape(Lb, R)
    rmask = torch.repeat_interleave(mask, C, dim=1)
    lam_d = torch.cat([torch.full((M,), lam_src, dtype=f32, device=dev),
                       torch.full((C,), lam_bias, dtype=f32, device=dev)]
                      ) + 1e-4

    A_rm = A * rmask[:, :, None]
    AtA = torch.bmm(A_rm.transpose(1, 2), A_rm)
    Aty = torch.bmm(A_rm.transpose(1, 2), (yr * rmask)[:, :, None])[:, :, 0]

    select = (_greedy_select_incremental if incremental
              else _greedy_select_refactor)
    sel, _ = select(AtA, Aty, A_rm, yr, rmask, src_mask, lam_d,
                    M=M, C=C, k_max=k_max)

    cm = torch.cat([sel * src_mask,
                    torch.ones((Lb, C), dtype=f32, device=dev)], dim=1)
    # one full factorization of the SELECTED set per call
    _, v1 = _loo_ridge_chol(AtA, Aty, A_rm, yr, rmask, cm, lam_d)
    alpha = v1[:, :M] / s                                # undo normalisation
    bias1 = v1[:, M:]                                    # (L, C)

    w_src = torch.einsum("lm,lmfc->lfc", alpha, src_w)
    w_src[:, F] += bias1

    # ---- Stage 2: per-class local correction on the residual, LOO-gated;
    # the C per-class ridges of every DC run as one batch of L*C systems
    fitted = torch.einsum("lm,lmnc->lnc", v1[:, :M], Hn) + bias1[:, None, :]
    resid = (Yoh - fitted) * mask[:, :, None]                    # (L,n,C)
    loo_x, Vx = _loo_ridge(
        xm[:, None].expand(Lb, C, n, F).reshape(Lb * C, n, F),
        resid.transpose(1, 2).reshape(Lb * C, n),
        mask[:, None].expand(Lb, C, n).reshape(Lb * C, n),
        torch.ones((Lb * C, F), dtype=f32, device=dev), lam_x)
    loo_zero = torch.sum(resid ** 2, dim=(1, 2))
    keep = torch.sum(loo_x.view(Lb, C), dim=1) < loo_zero
    Vx = torch.where(keep[:, None, None],
                     Vx.view(Lb, C, F).transpose(1, 2), 0.0)     # (L,F,C)

    w_src[:, :F] += Vx
    return w_src, sel


def _inputs(x, y, mask, src_w, src_mask, device):
    dev = resolve_device(device)
    f32 = torch.float32
    return (torch.as_tensor(x, dtype=f32, device=dev),
            torch.as_tensor(y, dtype=torch.int64, device=dev),
            torch.as_tensor(mask, dtype=f32, device=dev),
            torch.as_tensor(src_w, dtype=f32, device=dev),
            torch.as_tensor(src_mask, dtype=f32, device=dev))


@count_dispatch("greedytl")
def greedytl(x, y, mask, src_w, src_mask, *, num_classes: int,
             lam_src: float = 0.1, lam_x: float = 10.0,
             lam_bias: float = 2.0, k_max: int = 16,
             incremental: bool = True, device="cuda"):
    """Greedy source combination + gated local correction at one DC.

    x: (n, F) padded local data; y: (n,); mask: (n,) row validity.
    src_w: (M, F+1, C) stacked source hypotheses; src_mask: (M,).
    Returns (w_eff (F+1, C), selected (M,) 0/1) on ``device``.
    ``incremental=False`` selects the refactorize-per-step oracle."""
    x, y, mask, src_w, src_mask = _inputs(x, y, mask, src_w, src_mask,
                                          device)
    w, sel = _greedytl(x[None], y[None], mask[None], src_w[None],
                       src_mask[None], num_classes=num_classes,
                       lam_src=lam_src, lam_x=lam_x, lam_bias=lam_bias,
                       k_max=k_max, incremental=incremental)
    return w[0], sel[0]


@count_dispatch("greedytl_fleet")
def greedytl_fleet(x, y, mask, src_w, src_mask, *, num_classes: int,
                   lam_src: float = 0.1, lam_x: float = 10.0,
                   lam_bias: float = 2.0, k_max: int = 16,
                   incremental: bool = True, device="cuda"):
    """GreedyTL at every DC of a padded fleet against ONE shared source
    pool. x: (L, cap, F); y/mask: (L, cap); src_w (M, F+1, C); src_mask
    (M,). Returns (w_eff (L, F+1, C), selected (L, M))."""
    x, y, mask, src_w, src_mask = _inputs(x, y, mask, src_w, src_mask,
                                          device)
    Lb = x.shape[0]
    return _greedytl(x, y, mask, src_w.expand(Lb, *src_w.shape),
                     src_mask.expand(Lb, *src_mask.shape),
                     num_classes=num_classes, lam_src=lam_src, lam_x=lam_x,
                     lam_bias=lam_bias, k_max=k_max, incremental=incremental)


@count_dispatch("greedytl_fleet_stacked")
def greedytl_fleet_stacked(x, y, mask, src_w, src_mask, *, num_classes: int,
                           lam_src: float = 0.1, lam_x: float = 10.0,
                           lam_bias: float = 2.0, k_max: int = 16,
                           incremental: bool = True, device="cuda"):
    """GreedyTL over a fleet where every DC carries its OWN source pool.
    x: (N, cap, F); y/mask: (N, cap); src_w: (N, M, F+1, C); src_mask:
    (N, M). Returns (w_eff (N, F+1, C), selected (N, M))."""
    x, y, mask, src_w, src_mask = _inputs(x, y, mask, src_w, src_mask,
                                          device)
    return _greedytl(x, y, mask, src_w, src_mask, num_classes=num_classes,
                     lam_src=lam_src, lam_x=lam_x, lam_bias=lam_bias,
                     k_max=k_max, incremental=incremental)
