"""FLOPs, bytes and collective traffic of one traced call: the port's
counterpart of ``repro.roofline.hlo`` (which walks XLA's partitioned HLO
text).

:func:`analyze_trace` runs a function under a ``TorchDispatchMode`` and
counts the aten ops it issues, on real, fake or meta tensors:

* **FLOPs** of the matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  the convolutions and their backward), with ``torch.utils.flop_counter``'s
  formulas, as ``analyze_hlo`` counts ``dot`` and ``convolution``;
* **bytes**: operand plus result bytes of every op that is not a view.
  Ops are unfused, so this overstates the card's traffic (as the
  reference says of CPU HLO); the roofline's memory term uses
  :func:`repro_torch.roofline.analysis.analytic_memory_bytes`;
* **collectives**: the result bytes of each ``_c10d_functional``
  collective, by op (``all-reduce``, ``all-gather``, ...). A group whose
  ranks lie in different pods (rank // ``pod_size``) adds to
  ``dcn_bytes``, one whose ranks lie in different NVLink nodes (rank //
  ``node_size``) to ``internode_bytes``.

Under DTensor the mode sees the local ops of every rank-0 shard (per-device
numbers, as the reference's post-partitioning HLO) and the collectives
that redistributions issue; DTensor's sharding propagation, which runs
each op once more on global-shape fake tensors to learn the output's
shape, is not counted.

**Regions.** ``with region(name, cost):`` counts ``cost`` (bytes, flops)
once and none of the ops inside (collectives excepted). The models wrap
their mixers (attention, the SSD scan, the RG-LRU scan) in one, with the
costs of :mod:`repro_torch.roofline.costs`, so a step counts the work the
function needs whichever route runs: a CUDA kernel launched through
``ctypes`` is invisible to any dispatch mode, and the plain route's
``chunked_attention`` computes whole masked blocks. Outside a trace a
region counts nothing. A region is also the span ``repro_torch.<name>``
(:func:`repro_torch.spans.span`), so a profiled run sees the mixers'
boundaries too.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.spans import PREFIX, span

# The analyze_hlo names of the functional collectives.
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward")
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "detach",
               "lift_fresh")

_ACTIVE: list = []       # the counters of the traces in progress


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_ranks(name: str):
    from torch.distributed import distributed_c10d as c10d
    return c10d.get_process_group_ranks(c10d._resolve_process_group(name))


class _Counter(TorchDispatchMode):
    def __init__(self, pod_size: int, node_size: int):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flop = {p: flop_registry[getattr(torch.ops.aten, p)]
                      for p in _MATMULS}
        self.pod_size, self.node_size = pod_size, node_size
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = defaultdict(float)
        self.total = self.dcn = self.internode = 0.0
        self.n_ops = 0
        self.regions = {}
        self.suppress = 0        # inside a region
        self.hidden = 0          # inside DTensor's sharding propagation
        self._groups = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented         # let DTensor issue its local ops
        out = func(*args, **kwargs)
        if not self.hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVES:
                self._collective(_COLLECTIVES[name], args, kwargs, out)
            return
        if self.suppress or func.namespace != "aten" or name in _NO_TRAFFIC:
            return
        if name in self._flop:
            self.flops += self._flop[name](*args, out_val=out, **kwargs)
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns):
            return                                  # a view moves nothing
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)

    def _collective(self, op, args, kwargs, out):
        b = float(_nbytes(out))
        self.bytes += _nbytes(args) + b
        self.total += b
        self.by_op[op] += b
        self.n_ops += 1
        group = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, str)][-1]
        if group not in self._groups:
            ranks = _group_ranks(group)
            self._groups[group] = (
                len({r // self.pod_size for r in ranks}) > 1,
                len({r // self.node_size for r in ranks}) > 1)
        crosses_pod, crosses_node = self._groups[group]
        self.dcn += b if crosses_pod else 0.0
        self.internode += b if crosses_node else 0.0

    def add_region(self, name, nbytes, flops):
        r = self.regions.setdefault(name, {"bytes": 0.0, "flops": 0.0,
                                           "calls": 0})
        r["bytes"] += nbytes
        r["flops"] += flops
        r["calls"] += 1
        self.bytes += nbytes
        self.flops += flops

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": {"total_bytes": self.total,
                                "dcn_bytes": self.dcn,
                                "internode_bytes": self.internode,
                                "by_op": dict(self.by_op),
                                "n_ops": self.n_ops},
                "regions": self.regions}


@contextmanager
def region(name: str, cost):
    """Count ``cost`` ((bytes, flops), or a function returning them, called
    only inside a trace) once for the block, and none of its ops. Nested
    regions count as the outer one. The block is the span
    ``repro_torch.<name>``."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    with span(PREFIX + name):
        if counter is None or counter.suppress:
            yield
            return
        counter.add_region(name, *(cost() if callable(cost) else cost))
        counter.suppress += 1
        try:
            yield
        finally:
            counter.suppress -= 1


@contextmanager
def _hide_sharding_propagation(counter):
    """Count none of the ops DTensor runs on global-shape fake tensors to
    propagate an op's output metadata."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    orig = prop._propagate_tensor_meta_non_cached

    def hidden(*args, **kwargs):
        counter.hidden += 1
        try:
            return orig(*args, **kwargs)
        finally:
            counter.hidden -= 1
    prop._propagate_tensor_meta_non_cached = hidden
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


def analyze_trace(fn, *args, pod_size: int = 256, node_size: int = 8,
                  **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and count what it issues:
    ``{"flops", "bytes", "collectives": {"total_bytes", "dcn_bytes",
    "internode_bytes", "by_op", "n_ops"}, "regions"}`` (module doc)."""
    counter = _Counter(pod_size, node_size)
    _ACTIVE.append(counter)
    try:
        with _hide_sharding_propagation(counter), counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return counter.result()
