#!/usr/bin/env python
"""Time the ``loo_trials`` kernel under every cluster size at the given
shapes, beside the size that ``launch_plan`` picks.

    python scripts/torch_loo_plan.py [--shape L R D M ...]

For each (L, R, D, M) (default: the main path's widest calls, L 1/16/32 at
R 1120, D 23, M 16) the kernel runs with 1 to 8 blocks per DC (at most one
per 64-row tile), each result held against the plain version (rtol 1e-5,
atol 1e-5), and its median CUDA-event time is printed, one JSON line per
shape, with the card's name and power limit. Needs a CUDA device; imports
neither JAX nor ``repro``.
"""
import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

DEFAULT_SHAPES = [(1, 1120, 23, 16), (16, 1120, 23, 16), (32, 1120, 23, 16)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, action="append",
                    metavar=("L", "R", "D", "M"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_loo_plan: needs a CUDA device")

    from chip_smoke import (KERNEL_ATOL, KERNEL_RTOL, device_time_us,
                            kernel_inputs, nvidia_smi_line)
    from repro_torch.kernels import loo_trials as loo

    fn = loo._launcher()
    smi = nvidia_smi_line()
    for L, R, D, M in args.shape or DEFAULT_SHAPES:
        ins = kernel_inputs(L, R, D, M, seed=1, device="cuda")
        ref = loo.loo_trials_ref(*ins)
        plan = loo.launch_plan(L, R, D, M)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for cluster in range(1, min(loo.MAX_CLUSTER, plan.row_tiles) + 1):
            out = torch.empty((L, M), device="cuda")

            def call(cluster=cluster, out=out):
                err = fn(*(a.data_ptr() for a in ins), out.data_ptr(), L, R,
                         D, M, cluster, plan.d_bucket, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            call()
            if not torch.allclose(out, ref, rtol=KERNEL_RTOL,
                                  atol=KERNEL_ATOL):
                raise RuntimeError(f"cluster {cluster} disagrees at "
                                   f"{(L, R, D, M)}")
            times[cluster] = device_time_us(call, ())
        print(json.dumps({"shape": [L, R, D, M], "plan_cluster": plan.cluster,
                          "us_by_cluster": times, "nvidia_smi": smi}),
              flush=True)


if __name__ == "__main__":
    main()
