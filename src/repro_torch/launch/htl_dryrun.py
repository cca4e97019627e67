"""The paper's technique at datacenter scale, traced (port of
``repro.launch.htl_dryrun``).

Traces one HTL round (local phase + hypothesis transfer) of the trainer
on the 2-pod production mesh, as rank 0 of a 512-rank fake world, with
the stacked Data-Collector dim sharded over the 'pod' axis, and measures
the bytes of collectives that cross pods (``dcn_bytes``) against the
synchronous data-parallel baseline: the paper's Table-3 experiment with
radios replaced by the links between pods.

The reference's ``REPRO_PODWISE``, ``REPRO_MIXING``, ``REPRO_MIX_SEQ`` and
``REPRO_ONEHOT_EMBED`` environment variables are keywords and flags here.
``reduced`` runs the architecture's reduced config (for tests).

    python -m repro_torch.launch.htl_dryrun [--mode star|a2a|sync|all]
        [--local-steps N] [--podwise]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import HTLConfig, InputShape, OptimizerConfig
from repro_torch.core.htl_trainer import HTLState, HTLTrainer
from repro_torch.launch.dryrun import _walk, dtensor, place_params, world
from repro_torch.launch.specs import TensorSpec, input_specs, param_specs
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.roofline.trace import analyze_trace
from repro_torch.sharding.partitioning import P, use_compute_mesh

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "perf_torch")


def run(mode: str, local_steps: int, arch: str = "llama3.2-3b",
        seq: int = 4096, global_batch: int = 256, podwise: bool = False,
        mixing_mode: str = "gd", mix_seq: int = None,
        onehot_embed: bool = False, reduced: bool = False) -> dict:
    """One round's traced collective bytes: ``dcn_bytes_per_round`` and
    ``total_bytes_per_round`` (sync: one step's times ``local_steps``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = world("pod2")
    L = mesh.size(0)
    pod_size = mesh.size() // L
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    if onehot_embed:
        cfg = dataclasses.replace(cfg, embedding_impl="one_hot")
    opt_cfg = OptimizerConfig()
    out = {"mode": mode, "arch": arch, "local_steps": local_steps,
           "num_collectors": L, "reduced": reduced}
    model = build_model(cfg, device="meta")
    if mode == "sync":
        from repro_torch.launch.dryrun import _step
        shape = InputShape("train_4k", seq, global_batch, "train")
        specs = input_specs(cfg, shape, mesh, model)
        place_params(model, specs["params"], mesh)
        fn, args = _step(model, cfg, shape, specs, mesh)
        t0 = time.time()
        with use_compute_mesh(mesh), implicit_replication():
            ana = analyze_trace(fn, *args, pod_size=pod_size)
        out["trace_s"] = time.time() - t0
        # one step's traffic x local_steps, for a like-for-like round
        out["dcn_bytes_per_round"] = ana["collectives"]["dcn_bytes"] * \
            local_steps
        out["total_bytes_per_round"] = (
            ana["collectives"]["total_bytes"] * local_steps)
        return out

    htl = HTLConfig(mode=mode, num_collectors=L, local_steps=local_steps,
                    mixing_steps=2, mixing_mode=mixing_mode)
    tr = HTLTrainer(model, opt_cfg, htl)
    ps = dict(_walk(param_specs(model, mesh)))
    stacked = {k: s._replace(shape=(L,) + s.shape, spec=P("pod", *s.spec))
               for k, s in ps.items()}
    b_per = global_batch // L
    mix_seq = mix_seq or seq
    out["mix_seq"] = mix_seq
    params = {k: dtensor(s, mesh) for k, s in stacked.items()}
    moments = [{k: dtensor(s._replace(dtype=torch.float32), mesh)
                for k, s in stacked.items()} for _ in range(2)]
    scalar = TensorSpec((), torch.int32)
    state = HTLState(params, AdamWState(scalar.meta(), *moments),
                     scalar.meta())
    tok = P(None, "pod", "data")
    batches = {k: dtensor(TensorSpec((local_steps, L, b_per, seq),
                                     torch.int32, tok), mesh)
               for k in ("tokens", "targets")}
    mix = {k: dtensor(TensorSpec((L, b_per, mix_seq), torch.int32,
                                 P("pod", "data")), mesh)
           for k in ("tokens", "targets")}
    if podwise:
        out["podwise"] = True

        def local_fn(st, b):
            return tr.local_phase_podwise(st, b, mesh)
    else:
        local_fn = tr.local_phase
    with use_compute_mesh(mesh), implicit_replication():
        t0 = time.time()
        a_local = analyze_trace(local_fn, state, batches,
                                pod_size=pod_size)
        out["trace_local_s"] = time.time() - t0
        t0 = time.time()
        a_transfer = analyze_trace(tr.transfer_phase, state, mix,
                                   pod_size=pod_size)
        out["trace_transfer_s"] = time.time() - t0
    out["dcn_local"] = a_local["collectives"]["dcn_bytes"]
    out["dcn_transfer"] = a_transfer["collectives"]["dcn_bytes"]
    out["dcn_bytes_per_round"] = out["dcn_local"] + out["dcn_transfer"]
    out["total_bytes_per_round"] = (
        a_local["collectives"]["total_bytes"]
        + a_transfer["collectives"]["total_bytes"])
    return out


def run_all(modes, local_steps: int, **kwargs) -> dict:
    """:func:`run` for each mode, with star's and a2a's
    ``dcn_ratio_vs_sync`` when sync is among them."""
    results = {m: run(m, local_steps, **kwargs) for m in modes}
    if "sync" in results:
        for m in ("star", "a2a"):
            if m in results:
                results[m]["dcn_ratio_vs_sync"] = \
                    results[m]["dcn_bytes_per_round"] / max(
                        1.0, results["sync"]["dcn_bytes_per_round"])
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="all",
                    choices=["sync", "star", "a2a", "all"])
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--podwise", action="store_true")
    ap.add_argument("--mixing", default="gd",
                    choices=["gd", "loss_softmax"])
    ap.add_argument("--mix-seq", type=int, default=None)
    ap.add_argument("--onehot-embed", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args(argv)
    modes = ["sync", "star", "a2a"] if args.mode == "all" else [args.mode]
    results = run_all(modes, args.local_steps, arch=args.arch, seq=args.seq,
                      global_batch=args.global_batch, podwise=args.podwise,
                      mixing_mode=args.mixing, mix_seq=args.mix_seq,
                      onehot_embed=args.onehot_embed, reduced=args.reduced)
    for m, r in results.items():
        print(f"{m:5s}: DCN/round {r['dcn_bytes_per_round']:.4g} B "
              f"(total {r['total_bytes_per_round']:.4g} B)"
              + (f", ratio vs sync {r['dcn_ratio_vs_sync']:.4f}"
                 if "dcn_ratio_vs_sync" in r else ""), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"htl_round_{args.arch}.json"),
              "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
