"""The guard every CUDA kernel wrapper calls before it launches.

The kernels are forward-only, like the Pallas kernels they replace (the
reference defines no VJP for them, and ``jax.grad`` through one raises).
A kernel fills a ``torch.empty`` output through ``ctypes``, so autograd
would see an output with no gradient path and stop there without a word.
:func:`forbid_grad` turns that into an error. The CPU branches are plain
torch and stay differentiable.
"""
from __future__ import annotations

import torch


def forbid_grad(name: str, *tensors) -> None:
    """Raise :class:`RuntimeError` when grad mode is on and any tensor
    argument requires grad: kernel ``name`` has no backward."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad
           for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (like the reference's "
            f"Pallas kernel), so its output would carry no gradient; call "
            f"it under torch.no_grad(), or run the plain version for a "
            f"loss")
