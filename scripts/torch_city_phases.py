"""Phase 8d of ``chip_smoke.py`` (the one-shard city) alone on the card,
and with ``--shards`` phase 8g (the city over worlds of ``gloo`` ranks).

    python scripts/torch_city_phases.py [--root DIR] [--shards]

``--root`` takes ``chip_smoke.py`` and ``src/`` from another checkout (an
earlier commit unpacked with ``git archive`` into ``build/``), so a parent
and a change run in turns in one call. Phase 8d runs twice in the
process, the program cache emptied before each: the first run warms the
libraries (cuBLAS, cuSOLVER, the kernel library), the second, after the
``{"run": 2}`` line, is the one to read, as chip_smoke's 8d runs after its
earlier phases. Imports neither JAX nor the JAX package.
"""
import argparse
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--shards", action="store_true",
                    help="also run phase 8g after the second 8d run")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    from repro_torch.core import cityscan
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.kernels import build
    from repro_torch.kernels import loo_trials as loo

    print(cs.nvidia_smi_line(), flush=True)
    build.build(["loo_trials"])
    loo._launcher()
    for run in (1, 2):
        cityscan._PROGRAMS.clear()
        print(json.dumps({"root": root, "run": run}), flush=True)
        rows = cs.phase_city(loo, make_covtype_like(seed=0))
    if args.shards:
        cs.phase_city_shards(rows)


if __name__ == "__main__":
    main()
