"""AdamW and gradient clipping (port of ``repro.optim.adamw``).

Optimizer moments are float32 whatever the parameters' dtype (bf16
parameters, float32 moments); parameters keep their dtype.

Trees are ``{path: leaf}`` dicts keyed by the reference's ``/``-joined
leaf paths (``layers/attn/wq``). A leaf is a tensor, or, for a leaf the
reference stacks over layers and the port's :class:`~repro_torch.models.
model.Model` splits across its ``ModuleList``, the list of per-layer
tensors (:meth:`Model.param_tree`); the moments of such a leaf are one
stacked float32 tensor, the reference's layout, and layer ``l`` is
updated through its row ``l``.

The update goes leaf by leaf (layer by layer for a split leaf) and in
place: parameters, ``mu`` and ``nu`` are overwritten and returned, so the
transient at full width is one leaf's float32 copies, not a second model.

Weight decay follows the reference to the letter: a leaf decays when it
has at least two dimensions, judged on the reference's **stacked** leaf.
So every per-layer norm and bias (``layers/ln1``: (layers, d)) decays, and
only the top-level vectors (``final_norm``, ``enc_norm``, ...) escape,
although the reference's docstring says "no decay on norms/biases"
(ROADMAP Queue 3, "Reference faults the port mirrors for parity"). A
split leaf counts its layer dimension.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from repro_torch.configs.base import OptimizerConfig


class AdamWState(NamedTuple):
    count: torch.Tensor            # 0-d int32
    mu: Dict[str, torch.Tensor]    # {path: float32 tensor, stacked}
    nu: Dict[str, torch.Tensor]


def _parts(leaf) -> List[torch.Tensor]:
    """The tensors of a leaf: itself, or its per-layer tensors."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _rows(moment, leaf) -> List[torch.Tensor]:
    """A moment's views matching :func:`_parts` of its leaf."""
    return list(moment.unbind(0)) if isinstance(leaf, (list, tuple)) \
        else [moment]


def _stacked_ndim(leaf) -> int:
    if isinstance(leaf, (list, tuple)):
        return leaf[0].dim() + 1
    return leaf.dim()


def adamw_init(params: Dict[str, Any]) -> AdamWState:
    """Zero float32 moments shaped like the (stacked) leaves, count 0."""
    def zeros(leaf):
        parts = _parts(leaf)
        shape = ((len(parts),) if isinstance(leaf, (list, tuple)) else ()) \
            + tuple(parts[0].shape)
        return torch.zeros(shape, dtype=torch.float32,
                           device=parts[0].device)
    dev = _parts(next(iter(params.values())))[0].device
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: zeros(v) for k, v in params.items()},
        nu={k: zeros(v) for k, v in params.items()})


def global_norm(tree: Dict[str, Any]) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf (leaves in path
    order, as the reference's ``jax.tree.leaves``)."""
    total = None
    for key in sorted(tree):
        for x in _parts(tree[key]):
            s = x.float().square().sum()
            total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, Any], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, rounded
    back to each gradient's dtype, in place; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for key in grads:
        for g in _parts(grads[key]):
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr,
                 cfg: OptimizerConfig):
    """One AdamW step (module doc): ``params``, ``state.mu`` and
    ``state.nu`` are updated in place (so are the gradients, when
    clipped). ``lr`` may be a 0-d tensor (from a schedule). Returns
    (params, AdamWState(count + 1, mu, nu), global norm before
    clipping)."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    b1, b2 = cfg.betas
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    for key, leaf in params.items():
        decay = cfg.weight_decay > 0 and _stacked_ndim(leaf) >= 2
        for g, m, v, p in zip(_parts(grads[key]), _rows(state.mu[key], leaf),
                              _rows(state.nu[key], leaf), _parts(leaf)):
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_((1 - b2) * g32.square())
            del g32
            step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if decay:
                step.add_(cfg.weight_decay * p.float())
            p.copy_(p.float().sub_(lr * step))
    return params, AdamWState(count, state.mu, state.nu), gnorm


@torch.no_grad()
def sgd_update(grads, params, lr):
    """p - lr * g in float32, rounded to p's dtype, in place."""
    for key, leaf in params.items():
        for g, p in zip(_parts(grads[key]), _parts(leaf)):
            p.copy_(p.float().sub_(lr * g.float()))
    return params
