"""The readings a cell's limit is set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--fault <name>[,<name>...]] [--out results.jsonl]

For each seed, a whole run of the cell (set-up, the window at the cell's
load, the comparison) with the control's readings added: the program's
numbers (the lower reading comes from the largest over the seeds) and
the control's (the reference in fake float8, ``reference/common.py``,
put in the program's place; the upper reading comes from the smallest),
each judged against the cell's limits (``correct``,
``control_correct``). With ``--fault``, each seed runs once for each
fault named, the timed path broken by that fault of
:mod:`perfbench.faults` (no control then): ``correct`` has to come out
false; ``none`` in that list is the sound program, with the control.
One JSON line per seed on standard output, and appended to ``--out``.
The benchmark's own runs do not run the control.
"""
import time

T_LAUNCH = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from perfbench.cell import run_cell
    from perfbench.faults import FAULTS
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    t = T_LAUNCH
    faults = args.fault.split(",") if args.fault else [None]
    runs = [(f, int(s)) for f in faults for s in args.seeds.split(",")]
    for fault, seed in runs:
        hook = FAULTS[fault] if fault not in (None, "none") else None
        r = run_cell(bench, args.workload, seed, args.seconds, False,
                     t_launch=t, hook=hook, control=hook is None)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": fault, "correct": r["correct"],
                           "checks": r["checks"],
                           "program": r.get("numbers"),
                           "control": r.get("control"),
                           "control_correct": r.get("control_correct"),
                           "metrics": r["metrics"], "window": r["window"],
                           "rows": r.get("rows")})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
