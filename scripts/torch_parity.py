#!/usr/bin/env python
"""Hold the PyTorch port against the JAX package on one preset grid, both
on the CPU, and against the committed reference result file.

    PYTHONPATH=src python scripts/torch_parity.py [--preset paper_tables]
        [--windows 30] [--n-seeds 1] [--out parity.json]

Runs the preset through ``repro.core.experiment`` (JAX) and
``repro_torch.core.experiment`` (``device="cpu"``) on
``make_covtype_like(seed=0)`` and prints, per label, the relative energy
difference and the absolute differences of converged F1 and of the
per-window F1 curve; then one JSON line with the worst of each, also
against ``results/benchmarks/paper_tables.json`` for that preset. These
are the numbers behind the port's F1 bound (PERF.md).
"""
import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def diffs(a, b):
    e = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-300)
            for k in ("energy_mj", "collection_mj", "learning_mj"))
    c = max(abs(x - y) for x, y in zip(a["f1_curve"], b["f1_curve"]))
    return {"energy_rel": e, "f1": abs(a["f1"] - b["f1"]), "curve": c}


def worst(rows):
    return {k: max(r[k] for r in rows) for k in rows[0]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="paper_tables")
    ap.add_argument("--windows", type=int, default=30)
    ap.add_argument("--n-seeds", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from repro.core.experiment import get_preset as j_preset
    from repro_torch.core.experiment import get_preset as t_preset
    from repro_torch.data.synthetic_covtype import make_covtype_like

    data = make_covtype_like(seed=0)
    kw = dict(windows=args.windows, n_seeds=args.n_seeds)
    t0 = time.perf_counter()
    ref = j_preset(args.preset, **kw).run(data)
    t1 = time.perf_counter()
    port = t_preset(args.preset, **kw).run(data, device="cpu")
    t2 = time.perf_counter()
    events_equal = all(a.events == b.events
                       for a, b in zip(port.records, ref.records))
    ref_s = {lbl: ref.summary(lbl) for lbl in ref.labels()}
    port_s = {lbl: port.summary(lbl) for lbl in port.labels()}
    rows = []
    for lbl in ref.labels():
        d = diffs(port_s[lbl], ref_s[lbl])
        rows.append(d)
        print(lbl, json.dumps(d))
    out = {"preset": args.preset, **kw, "events_equal": events_equal,
           "port_vs_jax": worst(rows), "jax_s": t1 - t0, "port_s": t2 - t1}
    committed = os.path.join(ROOT, "results", "benchmarks",
                             f"{args.preset}.json")
    if os.path.exists(committed):
        with open(committed) as fh:
            saved = json.load(fh)
        if saved.get("windows") == args.windows and \
                saved.get("n_seeds") == args.n_seeds:
            out["port_vs_committed"] = worst(
                [diffs(port_s[lbl], saved[lbl]) for lbl in port.labels()])
            out["jax_vs_committed"] = worst(
                [diffs(ref_s[lbl], saved[lbl]) for lbl in ref.labels()])
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"summary": out, "port": port_s, "jax": ref_s}, fh)


if __name__ == "__main__":
    main()
