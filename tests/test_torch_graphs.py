"""The port's one CUDA-graph layer (``repro_torch/graphs.py``), its CPU
side: the tensors' half of a refusal, reached directly and through the
decode and prefill graphs' own refusals (a CPU leaf, meta leaves, tokens
and ``pos``, fake tensors, an ambient mesh, DTensors on a one-rank
``gloo`` world, a meta model); the counters behind the decode, prefill and
city stats; and the layering (every capture, the capture lock and the
side streams live in ``graphs.py``, and ``models/`` imports nothing of
``repro_torch.core``). The card side (every warm-up and capture on the
one side stream) is ``tests/test_torch_graphs_cuda.py``. Imports no JAX.
"""
import ast
import contextlib
import os

import pytest
import torch

from repro_torch import graphs
from repro_torch.configs import get_config
from repro_torch.core import cityscan
from repro_torch.models import build_model
from repro_torch.models import decode_graph as dg
from repro_torch.models import prefill_graph as pg
from repro_torch.sharding.partitioning import use_compute_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src",
                   "repro_torch")
B, S = 2, 12
MODELS = {}


def _model(device="cpu"):
    if device not in MODELS:
        cfg = get_config("llama3.2-3b").reduced()
        model = build_model(cfg, device=device)
        MODELS[device] = model.init(seed=0) if device == "cpu" else model
    return MODELS[device]


def _fake(t):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        return mode.from_tensor(t)


def _dtensor(t):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, DeviceMesh("cpu", [0]), [Replicate()])


def _decode(leaf=None, pos=None):
    """(held, inputs, the decode graph's refusal) of a decode call."""
    leaf = torch.zeros(2, B, 16, 2, 8) if leaf is None else leaf
    tok = torch.zeros((B, 1), dtype=torch.long)
    pos = torch.full((B,), S) if pos is None else pos
    return [leaf], (tok, pos), lambda: dg.refusal({"k": leaf}, tok, pos)


def _prefill(tokens=None, model=None):
    """(held, inputs, the prefill graph's refusal) of a prefill call."""
    model = _model() if model is None else model
    tok = torch.zeros((1, 8), dtype=torch.long) if tokens is None else tokens
    return ([model.top["embed"]], (tok,),
            lambda: pg.refusal(model, {"tokens": tok}, False))


_TOK = torch.zeros((1, 8), dtype=torch.long)
# case: (reason, context: None, "mesh" or "world", call)
REFUSALS = {
    "decode-cpu-leaf": ("device", None, lambda: _decode()),
    "decode-meta-leaf": ("meta", None,
                         lambda: _decode(leaf=torch.zeros(2, B, 16, 2, 8,
                                                          device="meta"))),
    "decode-meta-pos": ("meta", None,
                        lambda: _decode(pos=torch.full((B,), S,
                                                       device="meta"))),
    "decode-fake-leaf": ("fake", None,
                         lambda: _decode(leaf=_fake(torch.zeros(2, B, 16, 2,
                                                                8)))),
    "decode-mesh": ("mesh", "mesh", lambda: _decode()),
    "decode-dtensor-leaf": ("dtensor", "world",
                            lambda: _decode(leaf=_dtensor(
                                torch.zeros(2, B, 16, 2, 8)))),
    "prefill-meta-tokens": ("meta", None,
                            lambda: _prefill(tokens=_TOK.to("meta"))),
    "prefill-fake-tokens": ("fake", None,
                            lambda: _prefill(tokens=_fake(_TOK))),
    "prefill-mesh": ("mesh", "mesh", lambda: _prefill()),
    "prefill-dtensor-tokens": ("dtensor", "world",
                               lambda: _prefill(tokens=_dtensor(_TOK))),
    "prefill-meta-model": ("meta", None,
                           lambda: _prefill(model=_model("meta"))),
}


@contextlib.contextmanager
def _context(kind, tmp_path):
    if kind == "mesh":
        with use_compute_mesh(object()):
            yield
    elif kind == "world":
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()
    else:
        yield


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusal(case, tmp_path):
    """Each input is refused for its own reason, by ``graphs.refusal``
    over the tensors a graph holds and those a call copies in, and so by
    the decode and prefill graphs' refusals."""
    reason, context, call = REFUSALS[case]
    with torch.no_grad(), _context(context, tmp_path):
        held, inputs, wrapper = call()
        assert graphs.refusal(held, inputs) == reason
        assert wrapper() == reason


def test_refusal_reads_the_device_of_the_held_tensors_only():
    """A call's inputs may come from any device (they are copied in); an
    empty holding is refused."""
    leaf = torch.zeros(2, 3)
    assert graphs.refusal([leaf], (torch.zeros(2, device="meta"),)) == "meta"
    assert graphs.refusal([], ()) == "device"
    assert graphs.refusal([leaf], (3,)) == "device"


# owner: (module, stats, reset, increments, what they add up to)
STATS = {
    "prefill": (pg, "prefill_graph_stats", "reset_prefill_graph_stats",
                [dict(replays=2, tokens=10, pad_tokens=3,
                      launches={"ssd_scan": 96}),
                 dict(eager=1, refused={"plain": 1}),
                 dict(eager=1, refused={"plain": 1}, replays=1,
                      launches={"ssd_scan": 48, "flash_attention": 2})],
                {"captures": 0, "capture_s": 0.0, "replays": 3, "eager": 2,
                 "dropped": 0, "refused": {"plain": 2},
                 "launches": {"ssd_scan": 144, "flash_attention": 2},
                 "tokens": 10, "pad_tokens": 3}),
    "city": (cityscan, "graph_stats", "reset_graph_stats",
             [dict(captures=1, capture_s=0.5),
              dict(replays=4, loo_trials_launches=8,
                   loo_trials_step_launches=4),
              dict(collectives=1), dict(collectives=1, replays=2)],
             {"captures": 1, "capture_s": 0.5, "replays": 6,
              "loo_trials_launches": 8, "loo_trials_step_launches": 4,
              "collectives": 2}),
}


@pytest.mark.parametrize("owner", list(STATS))
def test_stats_count_and_reset(owner):
    """Counts add up by key and, in a tally, by reason or kernel; a reset
    zeroes them and a snapshot is a copy. The prefill graphs' and the
    city's stats are one ``graphs.Counts`` each."""
    module, stats, reset, incs, want = STATS[owner]
    stats, reset = getattr(module, stats), getattr(module, reset)
    assert isinstance(module._COUNTS, graphs.Counts)
    reset()
    for inc in incs:
        module.count(**inc)
    snap = stats()
    assert snap == want
    for k, v in snap.items():
        if isinstance(v, dict):
            v.clear()
        else:
            snap[k] = -1
    assert stats() == want
    reset()
    assert stats() == {k: {} if isinstance(v, dict) else type(v)(0)
                       for k, v in want.items()}


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _port_files():
    for root, _, names in os.walk(SRC):
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                yield os.path.relpath(path, SRC), _tree(path)


def _dotted(node):
    if isinstance(node, ast.Attribute):
        inner = _dotted(node.value)
        return inner and f"{inner}.{node.attr}"
    return node.id if isinstance(node, ast.Name) else None


def test_models_import_nothing_of_core():
    """The decode and prefill graphs take their plumbing from
    ``repro_torch.graphs``: no module under ``models/`` imports
    ``repro_torch.core`` (the HTL engines)."""
    seen = []
    for rel, tree in _port_files():
        if not rel.startswith("models" + os.sep):
            continue
        seen.append(rel)
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert not n.startswith("repro_torch.core"), (rel, n)
    assert os.path.join("models", "decode_graph.py") in seen


def test_captures_streams_and_the_lock_live_in_graphs_alone():
    """Only ``graphs.py`` builds a CUDA graph or a stream, captures, or
    defines a capture lock: ``core/cityscan.py`` no longer does."""
    made = {}
    for rel, tree in _port_files():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in ("torch.cuda.graph", "torch.cuda.CUDAGraph",
                            "torch.cuda.Stream"):
                    made.setdefault(rel, set()).add(name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and "CAPTURE_LOCK" in t.id:
                        made.setdefault(rel, set()).add(t.id)
    assert made == {"graphs.py": {"torch.cuda.graph", "torch.cuda.CUDAGraph",
                                  "torch.cuda.Stream", "CAPTURE_LOCK"}}
