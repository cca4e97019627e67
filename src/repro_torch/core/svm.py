"""Linear multiclass SVM (one-vs-rest hinge + L2), trained in PyTorch.

Port of ``repro.core.svm``: the paper's Step-0 base learner, full-batch
gradient descent with momentum on the masked hinge objective. Masking lets
one trainer handle every Data Collector whatever its local sample count
(samples are padded to a fixed capacity).

The reference differentiates the loss with ``jax.grad``; here the
subgradient is written out. At a tie (margin exactly 0) ``jax.grad`` of
``jnp.maximum(0, m)`` splits the gradient 0.5/0.5, and so does
:func:`_hinge_grad`. The cosine step size is computed in float32, as the
reference's traced loop index makes it. The DC axis of the fleet trainer
is a batch dimension written out (the reference ``vmap``s it).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.dispatch import count_dispatch

SAMPLE_BUCKETS = (16, 64)   # bucketed per-DC sample capacities (< config cap)


def sample_cap(n: int, cap: int) -> int:
    """Bucketed per-DC sample capacity for n local samples (see
    ``repro.core.svm.sample_cap``): masked rows contribute exactly zero, so
    the smallest bucket that holds the data gives the same model as the
    full ``cap`` while skipping the dead rows' compute."""
    n = min(n, cap)
    for b in SAMPLE_BUCKETS:
        if n <= b < cap:
            return b
    return cap


def svm_scores(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w: (..., F+1, C) with bias row last; x: (..., n, F) -> (..., n, C)."""
    return torch.matmul(x, w[..., :-1, :]) + w[..., -1:, :]


def svm_predict(w, x) -> torch.Tensor:
    return torch.argmax(svm_scores(w, x), dim=-1)


def _hinge_grad(w, x, xt, y_pm, neg_y_scaled, lam2):
    """Subgradient of the masked hinge loss of ``repro.core.svm`` at w
    (L, F+1, C). ``neg_y_scaled`` = -y_pm * mask / max(1, sum(mask)), so
    the cotangent of the scores is exact in float32 whatever the order of
    its factors; ties (margin 0) take half the gradient, as jax.grad does."""
    F = x.shape[-1]
    scores = torch.bmm(x, w[:, :F]) + w[:, F:]
    margin = 1.0 - y_pm * scores
    g = torch.where(margin > 0, 1.0, torch.where(margin == 0, 0.5, 0.0))
    ct = g * neg_y_scaled                                     # (L, n, C)
    return torch.cat([torch.bmm(xt, ct) + lam2 * w[:, :F],
                      ct.sum(dim=1, keepdim=True)], dim=1)


def _train_svm(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, *,
               num_classes: int, lam: float = 1e-3, lr: float = 0.5,
               iters: int = 200, w0: torch.Tensor = None) -> torch.Tensor:
    """Batched trainer core: x (L, n, F), y (L, n), mask (L, n);
    returns w (L, F+1, C)."""
    L, n, F = x.shape
    f32 = torch.float32
    y_pm = 2.0 * torch.nn.functional.one_hot(
        y.long(), num_classes).to(f32) - 1.0
    inv_denom = 1.0 / torch.clamp(mask.sum(dim=1), min=1.0)   # (L,)
    neg_y_scaled = -y_pm * (mask * inv_denom[:, None])[:, :, None]
    xt = x.transpose(1, 2).contiguous()
    w = (torch.zeros((L, F + 1, num_classes), dtype=f32, device=x.device)
         if w0 is None else w0.to(f32).clone())
    v = torch.zeros_like(w)
    i = torch.arange(iters, dtype=f32, device=x.device)
    lr_sched = (lr * 0.5) * (1.0 + torch.cos(i * math.pi / iters))
    for k in range(iters):
        g = _hinge_grad(w, x, xt, y_pm, neg_y_scaled, 2.0 * lam)
        v = 0.9 * v - lr_sched[k] * g
        w = w + v
    return w


def _as(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=dev)


@count_dispatch("train_svm")
def train_svm(x, y, mask, *, num_classes: int, lam: float = 1e-3,
              lr: float = 0.5, iters: int = 200, w0=None,
              device="cuda") -> torch.Tensor:
    """x: (n,F) padded; y: (n,) int labels; mask: (n,) {0,1}.

    Returns w: (F+1, C) on ``device``. Momentum GD with cosine-decayed lr;
    warm start w0."""
    dev = resolve_device(device)
    f32 = torch.float32
    w = _train_svm(_as(x, f32, dev)[None], _as(y, torch.int64, dev)[None],
                   _as(mask, f32, dev)[None], num_classes=num_classes,
                   lam=lam, lr=lr, iters=iters,
                   w0=None if w0 is None else _as(w0, f32, dev)[None])
    return w[0]


@count_dispatch("train_svm_fleet")
def train_svm_fleet(x, y, mask, *, num_classes: int, lam: float = 1e-3,
                    lr: float = 0.5, iters: int = 200,
                    device="cuda") -> torch.Tensor:
    """Batched base training over a padded DC fleet.

    x: (L, cap, F); y: (L, cap); mask: (L, cap) row validity (an all-zero
    mask row is a padding DC). Returns w: (L, F+1, C) on ``device``."""
    dev = resolve_device(device)
    return _train_svm(_as(x, torch.float32, dev), _as(y, torch.int64, dev),
                      _as(mask, torch.float32, dev), num_classes=num_classes,
                      lam=lam, lr=lr, iters=iters)


def pad_fleet(xs, ys, cap: int, fleet_cap: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a list of local datasets to a (fleet_cap, cap, F) fleet block.

    Returns (x, y, mask, dc_mask) where dc_mask (fleet_cap,) marks real DCs.
    """
    assert len(xs) <= fleet_cap
    F = xs[0].shape[1]
    x = np.zeros((fleet_cap, cap, F), np.float32)
    y = np.zeros((fleet_cap, cap), np.int32)
    m = np.zeros((fleet_cap, cap), np.float32)
    dcm = np.zeros((fleet_cap,), np.float32)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        x[i], y[i], m[i] = pad_local(xi, yi, cap)
        dcm[i] = 1.0
    return x, y, m, dcm


def pad_local(x: np.ndarray, y: np.ndarray, cap: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a local dataset to ``cap`` rows with a validity mask."""
    n = min(len(x), cap)
    F = x.shape[1]
    xp = np.zeros((cap, F), np.float32)
    yp = np.zeros((cap,), np.int32)
    mp = np.zeros((cap,), np.float32)
    xp[:n] = x[:n]
    yp[:n] = y[:n]
    mp[:n] = 1.0
    return xp, yp, mp
