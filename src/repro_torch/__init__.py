"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

Module paths mirror ``src/repro/``: ``repro_torch.core.greedytl`` is the
port of ``repro.core.greedytl`` and so on, so every ported module has
exactly one reference module. The port never imports ``jax`` or anything
under ``repro``; the numpy-only modules it needs are copied.

Numerics: float32 throughout, and the Gram products and every other
float32 matrix product run in full float32 — TF32 is switched off for both
cuBLAS and cuDNN right here, when the package is imported, so no caller can
get reduced-precision products by accident.

Device: every entry point takes ``device=`` and defaults to ``"cuda"``.
:func:`resolve_device` raises when CUDA is missing and the caller did not
ask for the CPU explicitly — the port never falls back to the CPU quietly.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises
    :class:`RuntimeError` for a CUDA device when CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; pass "
            f"device='cpu' to run the port on the CPU")
    return dev
