"""Roofline report over the port's dry-run records (port of
``repro.roofline.report``).

    python -m repro_torch.roofline.report [--dir results/dryrun_torch]
        [--mesh pod1] [--markdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline.analysis import roofline_from_record

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load_records(dirname: str, mesh: str = None):
    recs = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def analyze(rec: dict) -> dict:
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.specs import arch_for_shape
    from repro_torch.roofline.analysis import analytic_memory_bytes

    r = dict(rec)
    r["flops"] = rec.get("hlo_flops", 0.0)
    r["bytes_accessed"] = rec.get("hlo_bytes_accessed", 0.0)
    cfg = arch_for_shape(get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]])
    r["analytic_bytes"] = analytic_memory_bytes(
        cfg, INPUT_SHAPES[rec["shape"]], rec["num_devices"])
    out = roofline_from_record(r)
    out.update({k: rec[k] for k in ("arch", "shape", "mesh", "status")})
    out["trace_s"] = rec.get("trace_s")
    coll = rec.get("collectives", {})
    out["coll_bytes"] = coll.get("total_bytes", 0.0)
    out["dcn_bytes"] = coll.get("dcn_bytes", 0.0)
    out["internode_bytes"] = coll.get("internode_bytes", 0.0)
    return out


def one_liner(a: dict) -> str:
    uf = a.get("useful_fraction")
    return (f"{a['arch']:24s} {a['shape']:11s} {a['mesh']:5s} "
            f"compute={a['compute_s']:9.3e}s memory={a['memory_s']:9.3e}s "
            f"coll={a['collective_s']:9.3e}s dom={a['dominant']:10s} "
            f"useful={uf:.3f}" if uf is not None else
            f"{a['arch']:24s} {a['shape']:11s} {a['mesh']:5s} (no flops)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=RESULTS_DIR)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    rows = [analyze(r) for r in load_records(args.dir, args.mesh)
            if r["status"] == "ok"]
    rows.sort(key=lambda a: (a["arch"], SHAPE_ORDER.index(a["shape"]),
                             a["mesh"]))

    if args.markdown:
        print("| arch | shape | mesh | compute (s) | memory (s) | "
              "collective (s) | dominant | useful frac | bound-MFU |")
        print("|---|---|---|---|---|---|---|---|---|")
        for a in rows:
            uf = a.get("useful_fraction")
            mfu = a.get("mfu_bound")
            print(f"| {a['arch']} | {a['shape']} | {a['mesh']} "
                  f"| {a['compute_s']:.3e} | {a['memory_s']:.3e} "
                  f"| {a['collective_s']:.3e} | **{a['dominant']}** "
                  f"| {uf:.3f} | {mfu:.3f} |" if uf is not None else
                  f"| {a['arch']} | {a['shape']} | {a['mesh']} | - | - | - "
                  f"| {a['dominant']} | - | - |")
    else:
        for a in rows:
            print(one_liner(a))

    doms = {}
    for a in rows:
        doms[a["dominant"]] = doms.get(a["dominant"], 0) + 1
    print(f"\n# {len(rows)} rows; dominant-term distribution: {doms}",
          flush=True)
    return rows


if __name__ == "__main__":
    main()
