"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``)
and ``BENCHMARK.json``. Prints the numbers compared beside their limits as
the last lines of standard error, and the result as one JSON object on
the last line of standard output. Exits non-zero without a result when
CUDA is missing or has fewer devices than the cell asks for, when the
program cannot be found, and when JAX or the JAX package were loaded.
"""
import time

T_LAUNCH = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = os.path.join(ROOT, "build", "cache")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is JAX
    or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"run: no workload named {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"run: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2

    from perfbench.cell import power_limit, run_cell
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_launch=T_LAUNCH)
    found = forbidden_modules()
    if found:
        print(f"run: loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    result["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks
    print(f"card: {result['power_limit']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
