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
fill. The random stream is not JAX's: the reference folds the leaf index
into a threefry key, which torch cannot reproduce, so here leaf ``i`` is
drawn from a ``torch.Generator`` on the target device seeded with
``seed * 1_000_003 + i``. Weights that must equal the reference's are
carried across with :func:`repro_torch.core.convert.lm_from_reference`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn

STD = 0.02


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal|zeros|ones|scaled_normal|embed
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


def init_leaf(spec: ParamSpec, generator: torch.Generator, default_dtype,
              device) -> torch.Tensor:
    dtype = torch_dtype(spec.dtype or default_dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "scaled_normal", "embed"):
        raise NotImplementedError(f"initialiser {spec.init!r} belongs to a "
                                  f"family the port does not run yet")
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * STD).to(dtype)


def iter_init(template, seed: int = 0, default_dtype=torch.float32,
              device="cpu") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, initialised tensor) leaf by leaf, so a caller can copy each
    one away before the next is drawn."""
    gen = torch.Generator(device=device)
    for i, (path, spec) in enumerate(flatten(template)):
        gen.manual_seed(seed * 1_000_003 + i)
        yield path, init_leaf(spec, gen, default_dtype, device)


def init_params(template, seed: int = 0, default_dtype=torch.float32,
                device="cpu") -> Dict[str, torch.Tensor]:
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

    def leaf(self, path: str) -> torch.Tensor:
        """The parameter at a ``/``-joined path."""
        node = self
        for part in path.split("/"):
            node = node[part]
        return node
