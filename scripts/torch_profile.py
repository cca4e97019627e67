#!/usr/bin/env python
"""Where the PyTorch port's time goes on the GPU, for one preset grid.

    python scripts/torch_profile.py [--preset paper_tables] [--windows 6]
        [--n-seeds 1] [--trace chiprun_out/torch_trace.json]

Runs the grid once unprofiled on ``cuda`` (host wall time per engine
phase: base training, GreedyTL refine, F1 eval, the rest), then once under
``torch.profiler`` and prints one JSON line: wall time, summed device
kernel time and the device idle share, and the top CUDA kernels by device
time with their launch counts. Needs a CUDA device; imports neither JAX
nor ``repro``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


class PhaseClock:
    """Host wall time of the fleet engine's phases. Each phase ends in a
    device-to-host copy of its result, so host time covers its device
    work."""

    def __init__(self):
        from repro_torch.core import fleet, scenario

        self.targets = [(fleet, "train_base_bucketed", "train"),
                        (fleet, "refine_bucketed", "refine"),
                        (scenario, "_eval", "eval")]
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    def _wrap(self, fn, name):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return timed

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.targets]
        for (m, a, name), (_, _, fn) in zip(self.targets, self.saved):
            setattr(m, a, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for m, a, fn in self.saved:
            setattr(m, a, fn)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="paper_tables")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--n-seeds", type=int, default=1)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.experiment import get_preset
    from repro_torch.data.synthetic_covtype import make_covtype_like

    data = make_covtype_like(seed=0)
    spec = get_preset(args.preset, windows=args.windows,
                      n_seeds=args.n_seeds)
    get_preset("smoke", windows=1, n_seeds=1).run(data)       # warm up

    with PhaseClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spec.run(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        spec.run(data)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "preset": args.preset, "windows": args.windows,
        "n_seeds": args.n_seeds, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "wall_s": wall,
        "phase_s": dict(clock.seconds), "phase_calls": dict(clock.calls),
        "profiled_wall_s": wall_prof,
        "device_kernel_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_prof,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:90], "launches": c, "ms": t / 1e3}
                        for n, (c, t) in top]}))


if __name__ == "__main__":
    main()
