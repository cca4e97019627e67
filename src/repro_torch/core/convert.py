"""Carry the system's state between the JAX reference and the port.

The system's parameters are its linear models, each ``(F+1, C)`` float32
with the bias row last: a global model, a list of base models stacked
``(K, F+1, C)``, or a GreedyTL source pool ``(M, F+1, C)`` with its 0/1
mask ``(M,)``. The reference keeps them as numpy arrays on the host;
:func:`from_reference` checks such arrays and hands back the port's
tensors, :func:`to_reference` goes the other way. A mapping converts
key by key; the key ``"src_mask"`` holds a pool mask and must match the
``"src"`` pool beside it.

Language models: :func:`lm_from_reference` builds the port's
:class:`~repro_torch.models.model.Model` from the reference's parameter
leaves, a mapping from ``/``-joined tree path to numpy array (what
``repro.checkpoint.save_checkpoint`` writes and
:func:`repro_torch.checkpoint.load_checkpoint` reads back), e.g.
``layers/attn/wq`` of shape (L, D, H, hd), split across the port's layers.
Training state: :func:`adamw_from_reference` and
:func:`htl_state_from_reference` take the reference's ``AdamWState`` and
``HTLState`` flattened the same way (``.count``, ``.mu/<path>``, ...;
the keys its checkpointer writes), so that both packages can start from
one state.
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


def reference_tensor(a) -> torch.Tensor:
    """A reference array as a CPU tensor, bit for bit. A bfloat16 leaf
    (``ml_dtypes.bfloat16``, or the 2-byte void dtype ``np.load`` gives it
    back as) goes through an int16 view, never through float."""
    a = np.array(a)              # a writable copy: torch shares its memory
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V"
                                  or a.dtype.name == "bfloat16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_from_reference(cfg, arrays: Mapping[str, Any], device="cuda",
                      dtype=None):
    """The port's model for ``cfg`` (on ``device``, in ``dtype`` or the
    config's) holding the reference's weights ``arrays`` (module doc).
    Raises on a missing, unexpected or misshapen leaf."""
    from repro_torch.models.model import Model

    model = Model(cfg, device=device, dtype=dtype)
    return model.load_params({k: reference_tensor(a)
                              for k, a in arrays.items()})


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


def subtree(arrays: Mapping[str, Any], prefix: str) -> dict:
    """{path: value} of the entries whose path starts with ``prefix``,
    the prefix removed (``subtree(ckpt, "params/")``)."""
    n = len(prefix)
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix)}


def adamw_from_reference(arrays: Mapping[str, Any], device="cuda"):
    """The port's :class:`~repro_torch.optim.AdamWState` on ``device``
    from the reference's, flattened: ``.count`` (int32 scalar),
    ``.mu/<path>`` and ``.nu/<path>`` (float32, stacked as the
    reference stacks them)."""
    from repro_torch.optim import AdamWState

    dev = resolve_device(device)
    mu, nu = subtree(arrays, ".mu/"), subtree(arrays, ".nu/")
    if set(mu) != set(nu) or not mu:
        raise ValueError("AdamWState: .mu and .nu hold different paths")
    count = reference_tensor(arrays[".count"])
    if count.dim() != 0 or count.dtype != torch.int32:
        raise ValueError(f".count: want an int32 scalar, got "
                         f"{count.dtype} {tuple(count.shape)}")

    def moments(tree):
        out = {}
        for k, a in tree.items():
            t = reference_tensor(a)
            if t.dtype != torch.float32:
                raise TypeError(f"moment {k}: want float32, got {t.dtype}")
            out[k] = t.to(dev)
        return out
    return AdamWState(count.to(dev), moments(mu), moments(nu))


def htl_state_from_reference(arrays: Mapping[str, Any], device="cuda"):
    """The port's :class:`~repro_torch.core.htl_trainer.HTLState` on
    ``device`` from the reference's ``HTLState`` flattened:
    ``.params/<path>`` (stacked (L, ...) over the collectors, unless the
    mode is sync), ``.opt/...`` (as :func:`adamw_from_reference`) and
    ``.step``."""
    from repro_torch.core.htl_trainer import HTLState

    dev = resolve_device(device)
    params = {k: reference_tensor(a).to(dev)
              for k, a in subtree(arrays, ".params/").items()}
    step = reference_tensor(arrays[".step"]).to(dev)
    return HTLState(params, adamw_from_reference(subtree(arrays, ".opt/"),
                                                 dev), step)
