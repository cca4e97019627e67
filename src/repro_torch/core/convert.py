"""Carry the system's state between the JAX reference and the port.

The system's parameters are its linear models, each ``(F+1, C)`` float32
with the bias row last: a global model, a list of base models stacked
``(K, F+1, C)``, or a GreedyTL source pool ``(M, F+1, C)`` with its 0/1
mask ``(M,)``. The reference keeps them as numpy arrays on the host;
:func:`from_reference` checks such arrays and hands back the port's
tensors, :func:`to_reference` goes the other way. A mapping converts
key by key; the key ``"src_mask"`` holds a pool mask and must match the
``"src"`` pool beside it.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device

MASK_KEY = "src_mask"


def _check_model(name: str, a: np.ndarray) -> None:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{name}: want a numpy array, got {type(a).__name__}")
    if a.dtype != np.float32:
        raise TypeError(f"{name}: want float32, got {a.dtype}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name}: want a C-contiguous array")
    if a.ndim not in (2, 3) or a.shape[-2] < 2 or a.shape[-1] < 1:
        raise ValueError(f"{name}: want (F+1, C) or (K, F+1, C) with the "
                         f"bias row last, got shape {a.shape}")


def _check_mask(arrays: Mapping[str, np.ndarray]) -> None:
    m = arrays[MASK_KEY]
    if not isinstance(m, np.ndarray) or m.dtype != np.float32 \
            or m.ndim != 1 or not np.isin(m, (0.0, 1.0)).all():
        raise ValueError(f"{MASK_KEY}: want a 0/1 float32 vector (M,)")
    src = arrays.get("src")
    if src is None or src.ndim != 3 or src.shape[0] != m.shape[0]:
        raise ValueError(f"{MASK_KEY} needs a 'src' pool (M, F+1, C) with "
                         f"M = {m.shape[0]}")


def from_reference(arrays: Any, device="cuda") -> Any:
    """The reference's numpy model array(s) as float32 tensors on
    ``device`` (copies); ``arrays`` is one array or a mapping of them."""
    dev = resolve_device(device)
    if isinstance(arrays, Mapping):
        for k, a in arrays.items():
            if k != MASK_KEY:
                _check_model(k, a)
        if MASK_KEY in arrays:
            _check_mask(arrays)
        return {k: torch.tensor(a, device=dev) for k, a in arrays.items()}
    _check_model("model", arrays)
    return torch.tensor(arrays, device=dev)


def to_reference(tensors: Any) -> Any:
    """The port's model tensor(s) as the reference's numpy float32 arrays
    (same layouts; a mapping converts key by key)."""
    if isinstance(tensors, Mapping):
        out = {k: _to_reference_one(k, t) for k, t in tensors.items()}
        if MASK_KEY in out:
            _check_mask(out)
        return out
    return _to_reference_one("model", tensors)


def _to_reference_one(name: str, t: torch.Tensor) -> np.ndarray:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"{name}: want a float32 tensor")
    a = np.ascontiguousarray(t.detach().cpu().numpy())
    if name != MASK_KEY:
        _check_model(name, a)
    return a
