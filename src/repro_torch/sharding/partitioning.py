"""Parameter templates, their initialisation and the logical-axis
partitioning rules (port of ``repro.sharding.partitioning``).

Models declare parameters as :class:`ParamSpec` templates: shape, logical
axis names, an initialiser tag and an optional dtype. One template tree
serves three consumers:

* :func:`init_params` / :class:`ParamModule` — allocate and draw the
  parameters;
* :func:`param_pspecs` — map logical axes to mesh axes
  (:class:`PartitionSpec`), and :func:`to_placements` a spec to the
  DTensor placements of a ``DeviceMesh``;
* :func:`param_shape_structs` — meta tensors for the dry-run (no
  allocation).

Rules follow the reference's MaxText-style FSDP+TP recipe: the
contraction/embed dim of large kernels shards over ``data``,
heads/mlp/experts/vocab over ``model``, batch over ``data`` (and ``pod``
when present). A logical axis is replicated when the dim does not divide
by the mesh axes' size. :func:`logical_to_pspec` takes any mesh object
whose ``.shape`` maps axis name to size (a ``DeviceMesh`` too, through
:func:`mesh_axes`), so the validator and the specs need no process
group. The city's DC axis (:func:`fleet_mesh`, :func:`dc_shards`) is
split over the ranks of the default process group, one rank standing for
each of the reference's devices.

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
from contextlib import contextmanager
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

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


def template_bytes(template, default_dtype=torch.bfloat16) -> int:
    """Bytes of every leaf of a template, each in its own dtype or
    ``default_dtype``."""
    return sum(math.prod(s.shape) *
               torch_dtype(s.dtype or default_dtype).itemsize
               for _, s in flatten(template))


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

    def tensors(self) -> dict:
        """The current tensors as nested dicts, indexed like the module
        (those of a ``torch.func.functional_call`` while one runs)."""
        out = {name: getattr(self, name) for name in self._parameters}
        out.update((name, mod.tensors()) for name, mod in
                   self._modules.items())
        return out

    def leaf(self, path: str) -> torch.Tensor:
        """The parameter at a ``/``-joined path."""
        node = self
        for part in path.split("/"):
            node = node[part]
        return node


# ---------------------------------------------------------------------------
# Logical axes -> mesh axes
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "dc": None,               # stacked Data-Collector dim (HTL trainer)
    "batch": "data",
    "cache_len": "model",
    "vocab": "model",
    "embed": "data",          # FSDP: shard the embed/contraction dim of kernels
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    # expert parallelism: 'model' alone for training/prefill; decode uses
    # 'experts_both' = ('data', 'model') through the workload's rules
    "experts": "model",
    "experts_both": ("data", "model"),
    "lru": "model",
    "layers": None,
    "head_dim": None,
    "state": None,
    "seq": None,
    "qseq": "model",          # context-parallel attention
    "conv": None,
    "qk_rope": None,
    "latent": None,
}

MULTIPOD_RULES = dict(DEFAULT_RULES, batch=("pod", "data"), dc="pod")

# The million-DC city (repro_torch.core.cityscan): the stacked DC dim is a
# real mesh axis, each rank holding its slice of the fleet.
FLEET_RULES = dict(DEFAULT_RULES, dc="dc")

FLEET_AXIS = "dc"

_FLEET_MESHES: Dict[tuple, Any] = {}


def fleet_world() -> Tuple[int, int]:
    """(world size, rank) of the default process group as the city counts
    devices: (1, 0) without a group, and on the ``"fake"`` backend
    (:func:`repro_torch.launch.mesh.fake_world`), whose ranks are not
    devices."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_backend() == "fake":
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def fleet_mesh(n_shards: Optional[int] = None, device_type: str = None):
    """1-D ``DeviceMesh`` named ``"dc"`` over ranks ``0..n_shards-1`` of
    the default process group, on ``device_type`` (default: the entry
    points' device). ``None`` takes every rank. Building a mesh is
    collective, so every rank of the world calls this with the same
    arguments; a rank outside the mesh gets it too, with no coordinate on
    it. Cached per (shards, device type, world group). Without a process
    group a one-rank ``gloo`` group on an in-process store is started, as
    :func:`repro_torch.launch.mesh.make_host_mesh` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world, _ = fleet_world()
    n = world if n_shards is None else int(n_shards)
    if not 1 <= n <= world:
        fake = dist.is_initialized() and dist.get_backend() == "fake"
        raise ValueError(f"fleet_mesh wants 1..{world} shards, got {n}"
                         + (" (the ranks of a fake world are not devices)"
                            if fake else ""))
    device_type = device_type or torch.device(DEFAULT_DEVICE).type
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    key = (n, device_type, dist.group.WORLD)
    mesh = _FLEET_MESHES.get(key)
    if mesh is None:
        mesh = _FLEET_MESHES[key] = DeviceMesh(
            device_type, torch.arange(n), mesh_dim_names=(FLEET_AXIS,))
    return mesh


def dc_shards(n_padded: int, max_shards: Optional[int] = None) -> int:
    """Largest usable shard count for a padded DC axis: the biggest rank
    count of the world (capped by ``max_shards``) that divides
    ``n_padded``, so no shard is ragged. Padded fleet capacities are
    multiples of 32 beyond 16 DCs (:func:`repro_torch.core.fleet.
    fleet_cap`), so any power-of-two count <= 32 divides them."""
    world, _ = fleet_world()
    n = world if max_shards is None else min(int(max_shards), world)
    n = max(1, n)
    while n > 1 and n_padded % n != 0:
        n -= 1
    return n


class PartitionSpec(tuple):
    """How a tensor's dims map onto mesh axes, one entry per leading dim:
    ``None`` (replicated), an axis name, or a tuple of axis names (the dim
    split over their product, the first axis major). Dims past the last
    entry are replicated. A tuple, as ``jax.sharding.PartitionSpec`` is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object whose
    ``.shape`` maps axis name to size (the validator's mesh stand-in)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def dc_pspec(ndim: int) -> PartitionSpec:
    """Spec sharding the leading (DC) dim, the rest replicated."""
    return P(*((FLEET_AXIS,) + (None,) * (ndim - 1)))


def logical_to_pspec(axes: Sequence[Optional[str]], shape: Sequence[int],
                     mesh, rules: dict) -> PartitionSpec:
    """Resolve logical axes to a spec, replicating non-divisible dims; a
    mesh axis is never used twice in one spec, and a multi-axis rule drops
    its leading axes until the dim divides (64 experts cannot shard
    256-way on ('data', 'model') but can 16-way on 'model')."""
    sizes = mesh_axes(mesh)
    out = []
    used: set = set()
    for dim, name in zip(shape, axes):
        mesh_ax = rules.get(name) if name is not None else None
        if mesh_ax is None:
            out.append(None)
            continue
        flat = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        flat = tuple(a for a in flat if a not in used and a in sizes)
        while flat and dim % math.prod(sizes[a] for a in flat) != 0:
            flat = flat[1:]
        if not flat:
            out.append(None)
            continue
        used.update(flat)
        out.append(flat[0] if len(flat) == 1 else flat)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _map_template(fn, template):
    if isinstance(template, ParamSpec):
        return fn(template)
    return {k: _map_template(fn, v) for k, v in template.items()}


def param_pspecs(template, mesh, rules: dict = None):
    """The template's tree with a :class:`PartitionSpec` per leaf."""
    rules = rules or DEFAULT_RULES
    return _map_template(
        lambda s: logical_to_pspec(s.axes, s.shape, mesh, rules), template)


def param_shape_structs(template, default_dtype=torch.bfloat16):
    """The template's tree with a meta tensor per leaf (shape and dtype,
    no storage)."""
    return _map_template(
        lambda s: torch.empty(s.shape, device="meta", dtype=torch_dtype(
            s.dtype or default_dtype)), template)


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements, one per mesh dim, that give every rank the
    slice JAX's ``NamedSharding(mesh, spec)`` gives the device at the same
    mesh coordinate.

    An entry of several axes shards one tensor dim over several mesh dims:
    DTensor splits such a dim over its mesh dims in mesh order, the first
    major, which is JAX's order when the entry names its axes in the
    mesh's order (every rule here does; another order raises). A dim that
    one axis does not divide gets ``torch.chunk``'s uneven shards, as JAX
    pads; over several axes it must divide (as :func:`logical_to_pspec`
    guarantees), since DTensor's nested split then differs from JAX's."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in spec_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Sequence):
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    ``spec``: each rank keeps its slice, nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    sizes = mesh_axes(mesh)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if len(axes) > 1 and t.shape[dim] % math.prod(
                sizes[a] for a in axes):
            raise ValueError(f"dim {dim} ({t.shape[dim]}) does not divide "
                             f"over {axes}")
    return distribute_tensor(t, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Ambient mesh + activation sharding hints
#
# FSDP shards the embed/contraction dim of the *weights* over 'data'; the
# models call ``hint(x, logical_axes)`` at activation boundaries so that
# activations stay batch-sharded. Without a ``use_compute_mesh`` context,
# or on a plain tensor, ``hint`` returns its input.
# ---------------------------------------------------------------------------

_CURRENT_MESH = None


@contextmanager
def use_compute_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of :func:`hint`
    and of ``moe_ffn_shard_map`` inside the block."""
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def current_mesh():
    return _CURRENT_MESH


def hint(x, axes: Sequence[Optional[str]], units: Sequence[int] = None):
    """Redistribute a DTensor to its logical sharding under the ambient
    mesh (extra leading dims, such as the HTL trainer's stacked collectors,
    are the 'dc' axis). A plain tensor, or any tensor without an ambient
    mesh, comes back as it is. ``units`` (one size per dim, default the
    shape) is what the rules' divisibility is judged on: a flattened dim
    of H heads x head_dim shards only as its H heads divide, so that the
    view back to heads finds whole heads on every rank.

    The reference strips the axes of a ``shard_map`` manual region from
    the constraint (:func:`_strip_axes`); the port's manual regions
    (``moe_ffn_shard_map``, ``local_phase_podwise``) compute on local
    tensors, where ``hint`` is already a no-op."""
    mesh = _CURRENT_MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or x.device_mesh != mesh:
        return x
    axes = tuple(axes)
    while len(axes) < x.ndim:
        axes = ("dc",) + axes
    if len(axes) != x.ndim:
        return x
    rules = MULTIPOD_RULES if "pod" in mesh_axes(mesh) else DEFAULT_RULES
    placements = to_placements(logical_to_pspec(
        axes, x.shape if units is None else units, mesh, rules), mesh)
    return _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """A sharding constraint: the value is redistributed to
    ``placements``, and so is its gradient (as the transpose of
    ``jax.lax.with_sharding_constraint`` constrains the cotangent)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def _strip_axes(entry, manual: set):
    """A spec entry without the axes in ``manual``."""
    if entry is None:
        return None
    t = tuple(a for a in spec_axes(entry) if a not in manual)
    if not t:
        return None
    return t[0] if len(t) == 1 else t
