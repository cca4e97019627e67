"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) combo
as one device of a 256- or 512-GPU cluster (port of
``repro.launch.dryrun``).

For each combo this shows that the distribution config is coherent (the
specs resolve, every op has a sharding rule, the collectives are issued)
and records one device's FLOPs, bytes and collective traffic, without any
hardware:

* the process calls :func:`~repro_torch.launch.mesh.fake_world` (256 or
  512 ranks on the ``"fake"`` backend: no communication) before anything
  else, and builds the production ``DeviceMesh``;
* it builds the model on the meta device (shapes, no storage), lays
  every parameter, input and cache out as a DTensor of meta shards by
  :func:`~repro_torch.launch.specs.input_specs`' rules, and runs one step (``make_train_step``'s step,
  ``prefill`` or ``decode_step``) through :func:`~repro_torch.roofline.
  trace.analyze_trace` on the plain route (``plain=True``: a CUDA kernel
  cannot take a meta tensor, and the mixer regions count its work). Meta
  shards, not ``FakeTensorMode``: DTensor computes a strided shard's
  offsets with ``.tolist()``, which a fake tensor refuses;
* the step's outputs are redistributed to their declared specs inside
  the trace (a jitted function's output shardings), so DTensor's lazy
  ``Partial`` reductions are issued and counted;
* an op without a DTensor sharding rule fails the combo (``status:
  "error"`` with the traceback): nothing is replicated behind the caller's
  back. Plain tensors that the model makes itself (positions, masks) are
  replicated (``implicit_replication``).

Records are cached as JSON under ``results/dryrun_torch/`` (one file per
combo, resumable). The reference's ``REPRO_CP_ATTN``, ``REPRO_REMAT`` and
``REPRO_EXPERT_PARALLEL`` environment variables are keywords and flags
here; only the recorded value changes with them.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --mesh pod1
    python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import (TensorSpec, arch_for_shape,
                                      input_specs, shape_supported)
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.roofline.analysis import model_flops_for
from repro_torch.roofline.trace import analyze_trace
from repro_torch.sharding.partitioning import (
    P, distribute, to_placements, use_compute_mesh,
)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESH_SIZES = {"pod1": 256, "pod2": 512}


def world(mesh_kind: str):
    """The production mesh of ``mesh_kind`` over a fake world of its size
    (started, or restarted at another size, here)."""
    import torch.distributed as dist
    n = MESH_SIZES[mesh_kind]
    if not (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() == n):
        fake_world(n)
    return make_production_mesh(multi_pod=(mesh_kind == "pod2"))


def _walk(tree, prefix=""):
    """(path, TensorSpec) of a nested spec tree."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, TensorSpec):
            yield prefix + k, v
        else:
            yield from _walk(v, f"{prefix}{k}/")


def dtensor(ts: TensorSpec, mesh):
    """A DTensor of a :class:`TensorSpec` over meta shards."""
    return distribute(ts.meta(), mesh, ts.spec)


def place_params(model: Model, pspecs: dict, mesh) -> None:
    """Replace every parameter of ``model`` by a DTensor laid out by its
    stacked leaf's spec (a layer's row drops the leading layers entry)."""
    for path, ts in _walk(pspecs):
        head, _, sub = path.partition("/")
        if head in Model.STACKED:
            spec = P(*ts.spec[1:])
            targets = [(layer, sub) for layer in getattr(model, head)]
        else:
            spec, targets = ts.spec, [(model.top, path)]
        for mod, leaf_path in targets:
            parent_path, _, name = leaf_path.rpartition("/")
            parent = mod.leaf(parent_path) if parent_path else mod
            t = getattr(parent, name)
            setattr(parent, name, torch.nn.Parameter(
                distribute(t.detach(), mesh, spec), requires_grad=False))


def finish(x, ts: TensorSpec, mesh):
    """Redistribute a step output to its declared spec (issues pending
    ``Partial`` reductions)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(ts.spec, mesh))


def _step(model, cfg, shape, specs, mesh):
    """(the step's function, its arguments): DTensors from ``specs``."""
    batch = {k: dtensor(v, mesh) if v.shape else v.meta()
             for k, v in specs["batch"].items()}
    B = shape.global_batch
    logit_spec = TensorSpec((B, cfg.vocab_size), model.dtype,
                            P(specs["batch"]["tokens"].spec[0]
                              if specs["batch"]["tokens"].spec else None))
    if shape.kind == "train":
        from repro_torch.launch.train import make_train_step
        opt = specs["opt_state"]
        state = AdamWState(TensorSpec((), torch.int32).meta(),
                           {k: dtensor(v, mesh) for k, v in _walk(opt.mu)},
                           {k: dtensor(v, mesh) for k, v in _walk(opt.nu)})
        step = make_train_step(model, OptimizerConfig())
        pspecs = dict(_walk(specs["params"]))

        def train(state, batch):
            state, metrics = step(state, batch,
                                  TensorSpec((), torch.int32).meta())
            for k, v in state.mu.items():
                finish(v, pspecs[k]._replace(dtype=torch.float32), mesh)
            return state, metrics
        return train, (state, batch)
    if shape.kind == "prefill":
        def prefill(batch):
            logits, cache = model.prefill(batch, plain=True)
            return finish(logits, logit_spec, mesh), cache
        return prefill, (batch,)
    cache = {k: dtensor(v, mesh) for k, v in _walk(specs["cache"])}
    cspecs = dict(_walk(specs["cache"]))

    def decode(cache, tokens, pos):
        logits, cache = model.decode_step(cache, tokens, pos)
        return finish(logits, logit_spec, mesh), {
            k: finish(v, cspecs[k], mesh) for k, v in cache.items()}
    return decode, (cache, batch["tokens"], batch["pos"])


def local_bytes(tree) -> int:
    """Bytes of the local shards of every DTensor in a tree."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        t = tree.to_local()
        return t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(local_bytes(x) for x in tree.values())
    return 0


def run_combo(arch: str, shape_name: str, mesh_kind: str,
              out_dir: str = RESULTS_DIR,
              weight_stationary_decode: bool = False,
              context_parallel_attention: bool = None, remat: str = None,
              expert_parallel: str = None) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch)
    ok, reason = shape_supported(cfg0, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "skipped", "reason": reason}
    if not ok:
        return rec

    cfg = arch_for_shape(cfg0, shape)
    if context_parallel_attention:
        cfg = dataclasses.replace(cfg, context_parallel_attention=True)
        rec["context_parallel_attention"] = True
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
        rec["remat"] = cfg.remat
    if expert_parallel:
        cfg = dataclasses.replace(cfg, expert_parallel=expert_parallel)
        rec["expert_parallel"] = cfg.expert_parallel
    mesh = world(mesh_kind)
    rec["num_devices"] = mesh.size()

    t0 = time.time()
    model = build_model(cfg, device="meta")
    specs = input_specs(cfg, shape, mesh, model,
                        weight_stationary_decode=weight_stationary_decode)
    rec["weight_stationary_decode"] = weight_stationary_decode
    place_params(model, specs["params"], mesh)
    fn, args = _step(model, cfg, shape, specs, mesh)
    rec["memory"] = {"argument_size_in_bytes":
                     local_bytes(dict(model.named_parameters()))
                     + local_bytes(args)}
    rec["setup_s"] = time.time() - t0
    t1 = time.time()
    with use_compute_mesh(mesh), implicit_replication():
        ana = analyze_trace(fn, *args, pod_size=256, node_size=8)
    rec["trace_s"] = time.time() - t1

    rec["flops"] = rec["hlo_flops"] = ana["flops"]
    rec["bytes_accessed"] = rec["hlo_bytes_accessed"] = ana["bytes"]
    rec["collectives"] = ana["collectives"]
    rec["regions"] = ana["regions"]
    rec["model_flops"] = model_flops_for(cfg, shape)
    rec["param_count"] = cfg.param_count()
    rec["active_param_count"] = cfg.active_param_count()
    rec["status"] = "ok"
    return rec


def _result_path(out_dir, arch, shape, mesh_kind):
    return os.path.join(out_dir, f"{arch}_{shape}_{mesh_kind}.json")


def run_and_save(arch, shape, mesh_kind, out_dir, **kwargs) -> dict:
    """:func:`run_combo`, a failure recorded as ``status: "error"`` with
    its traceback; the record is written to ``out_dir``."""
    t0 = time.time()
    try:
        rec = run_combo(arch, shape, mesh_kind, out_dir, **kwargs)
    except Exception:             # noqa: BLE001
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "error", "traceback": traceback.format_exc()}
    rec["wall_s"] = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(_result_path(out_dir, arch, shape, mesh_kind), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--ws-decode", action="store_true",
                    help="weight-stationary decode sharding")
    ap.add_argument("--context-parallel-attention", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--expert-parallel", default=None)
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.all:
        combos = [(a, s, m) for m in meshes for a in ALL_ARCHS
                  for s in INPUT_SHAPES]
    else:
        combos = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape, mesh_kind in combos:
        path = _result_path(args.out, arch, shape, mesh_kind)
        if os.path.exists(path) and not args.force:
            print(f"[skip cached] {arch} x {shape} x {mesh_kind}")
            continue
        print(f"[run ] {arch} x {shape} x {mesh_kind} ...", flush=True)
        rec = run_and_save(
            arch, shape, mesh_kind, args.out,
            weight_stationary_decode=args.ws_decode,
            context_parallel_attention=args.context_parallel_attention,
            remat=args.remat, expert_parallel=args.expert_parallel)
        failures += rec["status"] == "error"
        msg = rec["status"]
        if rec["status"] == "ok":
            msg += (f" trace={rec['trace_s']:.1f}s "
                    f"flops={rec.get('flops', 0):.3g} "
                    f"coll={rec['collectives']['total_bytes']:.3g}B")
        elif rec["status"] == "error":
            msg += "\n" + rec["traceback"].splitlines()[-1]
        print(f"[done] {arch} x {shape} x {mesh_kind}: {msg}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
