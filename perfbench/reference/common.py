"""Pieces both plain references share: float32 settings, RMSNorm, the
matrix product in the reference's precision, and the fake float8 (e4m3)
rounding that the control puts in the reference's place.

Precision ``"float32"``: every product in full float32 (TF32 off).
Precision ``"fp8"`` (the control, one step below the bfloat16 that the
configurations state): both operands of every weight product rounded to
float8 e4m3 with one scale per row of the activations and per output
column of the weights, then multiplied in float32.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def full_float32() -> None:
    """No reduced-precision float32 products anywhere in the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms(x, scale, eps):
    """RMSNorm over the last dim, in float32."""
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def fp8(t, dim):
    """``t`` rounded through float8 e4m3, scaled per slice along ``dim``
    (the dim that the product contracts)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x, w, prec):
    """x (..., K) @ w (K, N) in the reference's precision (module doc)."""
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    elif prec != "float32":
        raise ValueError(f"unknown precision {prec!r}")
    return x @ w
