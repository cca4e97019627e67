"""Static config validation (port of ``repro.launch.validate``): for every
(arch x shape x mesh), which logical axes shard and which replicate
(divisibility), the per-device parameter / optimizer / cache memory, and
whether it fits one card's memory. Pure metadata: no allocation, no
process group.

    PYTHONPATH=src python -m repro_torch.launch.validate [--arch ...]
        [--multi-pod | --mesh host]

``--mesh host`` is the 1x1 mesh of one card (:func:`repro_torch.launch.
mesh.make_host_mesh`): everything on the card, nothing sharded.
"""
from __future__ import annotations

import argparse
import math

from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.specs import (arch_for_shape, param_rules_for,
                                      shape_supported)
from repro_torch.models.model import build_model
from repro_torch.sharding.partitioning import (
    flatten, logical_to_pspec, mesh_axes, spec_axes, torch_dtype,
)

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at a 700 W power limit, torch 2.11.0+cu128 (chip_smoke.py's
# validate phase holds the card's value against it).
HBM_BYTES = 85_017_493_504

MESH_SHAPES = {"pod1": {"data": 16, "model": 16},
               "pod2": {"pod": 2, "data": 16, "model": 16},
               "host": {"data": 1, "model": 1}}


class _MeshMeta:
    """Just the axis sizes (``logical_to_pspec`` only needs ``.shape``)."""

    def __init__(self, multi_pod=False, kind=None):
        kind = kind or ("pod2" if multi_pod else "pod1")
        self.shape = dict(MESH_SHAPES[kind])


def _tree_device_bytes(template, rules, mesh, default_itemsize=2):
    """(per-device bytes after sharding, replicated leaves, leaves); a
    replicated dim counts fully."""
    sizes = mesh_axes(mesh)
    total = 0.0
    n_repl = 0
    leaves = [s for _, s in flatten(template)]
    for s in leaves:
        spec = logical_to_pspec(s.axes, s.shape, mesh, rules)
        shards = math.prod(sizes[a] for e in spec for a in spec_axes(e))
        itemsize = torch_dtype(s.dtype).itemsize if s.dtype \
            else default_itemsize
        total += math.prod(s.shape) * itemsize / shards
        if shards == 1:
            n_repl += 1
    return total, n_repl, len(leaves)


def validate(arch: str, shape_name: str, multi_pod=False,
             hbm_bytes: int = HBM_BYTES, mesh: str = None) -> dict:
    """The fit record of one combo; ``mesh`` ("pod1", "pod2", "host")
    overrides ``multi_pod``."""
    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch)
    ok, reason = shape_supported(cfg0, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    cfg = arch_for_shape(cfg0, shape)
    model = build_model(cfg, device="meta")
    mm = _MeshMeta(multi_pod, mesh)
    rules = param_rules_for(mm, shape, cfg)

    p_bytes, p_repl, p_n = _tree_device_bytes(model.template(), rules, mm)
    out = {"arch": arch, "shape": shape_name, "status": "ok",
           "params_gib": p_bytes / 2**30,
           "replicated_weight_leaves": f"{p_repl}/{p_n}"}
    total = p_bytes
    if shape.kind == "train":
        total += p_bytes + 2 * p_bytes * 2      # grads bf16 + adam f32 m,v
        out["train_state_gib"] = total / 2**30
    if shape.kind == "decode":
        c_bytes, _, _ = _tree_device_bytes(
            model.cache_template(shape.global_batch, shape.seq_len), rules,
            mm)
        out["cache_gib"] = c_bytes / 2**30
        total += c_bytes
    out["fits_hbm"] = bool(total <= hbm_bytes)
    out["hbm_gib"] = hbm_bytes / 2**30
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None, choices=sorted(MESH_SHAPES),
                    help="pod1, pod2 or host (the 1x1 card mesh)")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else ALL_ARCHS
    n_bad = 0
    rows = []
    for a in archs:
        for s in INPUT_SHAPES:
            r = validate(a, s, args.multi_pod, mesh=args.mesh)
            if r["status"] == "skip":
                continue
            rows.append(r)
            flag = "" if r["fits_hbm"] else \
                f"  ** EXCEEDS {r['hbm_gib']:.1f} GiB **"
            n_bad += not r["fits_hbm"]
            extra = ""
            if "train_state_gib" in r:
                extra = f" train-state {r['train_state_gib']:.1f} GiB"
            if "cache_gib" in r:
                extra = f" cache {r['cache_gib']:.1f} GiB"
            print(f"{a:24s} {s:11s} params/dev {r['params_gib']:7.2f} GiB"
                  f"{extra} repl {r['replicated_weight_leaves']}{flag}")
    print(f"\n{n_bad} combos exceed one device's memory")
    return rows


if __name__ == "__main__":
    main()
