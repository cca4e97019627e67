"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group. The dry-run (and only the dry-run) calls
:func:`fake_world` first, which stands up a process group of 256 or 512
ranks on the ``"fake"`` backend: it runs no communication, and rank 0
traces the step as one device of the production cluster.

Single pod: (16, 16) = 256 GPUs, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 GPUs, axes (pod, data, model): the 'pod'
axis is the expensive boundary the paper's technique minimises traffic on.
"""
from __future__ import annotations

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device

POD1 = ((16, 16), ("data", "model"))
POD2 = ((2, 16, 16), ("pod", "data", "model"))


def fake_world(n: int, rank: int = 0) -> None:
    """Initialise the default process group as ``n`` ranks on the
    ``"fake"`` backend, this process being ``rank``. The backend's store
    lives in torch's internal testing package, whose path may move between
    releases: this function is the port's one use of it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def mesh_device_type() -> str:
    """The device type of a mesh over the current world: ``cpu`` for the
    fake backend (its tensors are fake and never reach a card), ``cuda``
    for a real NCCL world."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, shape=None):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the current world
    (256 or 512 ranks); ``shape`` scales the same axes down (tests)."""
    from torch.distributed.device_mesh import init_device_mesh
    default, names = POD2 if multi_pod else POD1
    return init_device_mesh(mesh_device_type(), tuple(shape or default),
                            mesh_dim_names=names)


def make_host_mesh(device=DEFAULT_DEVICE):
    """The degenerate 1x1 ``(data, model)`` mesh over the local device
    (the card unless the caller asks for the CPU); a one-rank ``gloo``
    process group on an in-process store is started on first use."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data",
                                                              "model"))
