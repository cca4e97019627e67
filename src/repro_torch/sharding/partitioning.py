"""Parameter templates and their initialisation (port of the
``ParamSpec`` / ``init_params`` part of ``repro.sharding.partitioning``).

Models declare parameters as :class:`ParamSpec` templates: shape, logical
axis names, an initialiser tag and an optional dtype. The port uses the
templates to allocate parameters (a :class:`ParamModule` per template), to
initialise them and to size caches; the
logical axes are kept for the mesh rules, which wait for ROADMAP Queue 1
item 10 (there is no mesh and no ``hint`` in the port: the reference's
``hint`` is a no-op without one).

Initialisers are the reference's: ``normal``, ``scaled_normal`` and
``embed`` draw N(0, 0.02^2) in float32 and cast, ``ones`` and ``zeros``
fill; ``conv`` draws N(0, 1/shape[0]) and ``fan_in`` N(0, 1/shape[-2])
(of the stacked leaf, as the reference does); ``ssm_a`` is log U[1, 16)
and ``dt_bias`` the inverse softplus of U[1e-3, 1e-1). Every draw is in
float32, then cast. The random stream is not JAX's: the reference folds
the leaf index into a threefry key, which torch cannot reproduce, so here
leaf ``i`` is drawn from a ``torch.Generator`` on the target device
seeded with ``seed * 1_000_003 + i``. Weights that must equal the
reference's are carried across with
:func:`repro_torch.core.convert.lm_from_reference`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import DEFAULT_DEVICE, resolve_device

STD = 0.02


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal|zeros|ones|scaled_normal|embed
    #                                   |conv|fan_in|ssm_a|dt_bias
    dtype: Any = None                 # None => model default


def flatten(template, prefix: str = "") -> Iterator[Tuple[str, ParamSpec]]:
    """(``/``-joined path, spec) for every leaf, in the reference's order
    (JAX flattens dicts by sorted key)."""
    for key in sorted(template):
        node = template[key]
        path = f"{prefix}{key}"
        if isinstance(node, ParamSpec):
            yield path, node
        else:
            yield from flatten(node, path + "/")


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"bfloat16"``)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def _normal_scale(spec: ParamSpec) -> float:
    shape = spec.shape
    if spec.init in ("normal", "scaled_normal", "embed"):
        return STD
    if spec.init == "conv":
        return 1.0 / math.sqrt(max(1, shape[0]))
    if spec.init == "fan_in":
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return 1.0 / math.sqrt(max(1, fan_in))
    raise NotImplementedError(f"unknown initialiser {spec.init!r}")


def init_leaf(spec: ParamSpec, generator: torch.Generator, default_dtype,
              device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("ssm_a", "dt_bias"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = lo + (hi - lo) * torch.rand(spec.shape, generator=generator,
                                        dtype=torch.float32, device=device)
        # mamba: A_log = log U[1, 16); dt_bias = softplus^-1(U[1e-3, 1e-1))
        out = torch.log(u) if spec.init == "ssm_a" \
            else torch.log(torch.expm1(u))
        return out.to(dtype)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(_normal_scale(spec)).to(dtype)


def iter_init(template, seed: int = 0, default_dtype=torch.float32,
              device=DEFAULT_DEVICE) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, initialised tensor) leaf by leaf, so a caller can copy each
    one away before the next is drawn. On the card unless ``device``
    asks for another (raises without CUDA, as every entry point does)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    for i, (path, spec) in enumerate(flatten(template)):
        gen.manual_seed(seed * 1_000_003 + i)
        yield path, init_leaf(spec, gen, default_dtype, device)


def init_params(template, seed: int = 0, default_dtype=torch.float32,
                device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Materialise a template: {``/``-joined path: tensor on ``device``}."""
    return dict(iter_init(template, seed, default_dtype, device))


class ParamModule(nn.Module):
    """The parameters of a (nested) template as an ``nn.Module``: one
    uninitialised, gradient-free ``nn.Parameter`` per leaf, one submodule
    per nested dict. Indexed like the reference's parameter dicts
    (``p["wq"]``)."""

    def __init__(self, template: dict, device, dtype):
        super().__init__()
        for name, node in sorted(template.items()):
            if isinstance(node, ParamSpec):
                t = torch.empty(node.shape, device=device,
                                dtype=torch_dtype(node.dtype or dtype))
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=False))
            else:
                self.add_module(name, ParamModule(node, device, dtype))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def leaf(self, path: str) -> torch.Tensor:
        """The parameter at a ``/``-joined path."""
        node = self
        for part in path.split("/"):
            node = node[part]
        return node
