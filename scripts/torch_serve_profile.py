#!/usr/bin/env python
"""Where the PyTorch port's serving time goes on the GPU: a model
(``--arch``: any arch that ``chip_smoke.py`` serves) at full width and at
the depth ``chip_smoke.py`` serves it, bfloat16, random weights from the
port's seeded initialiser, with the frontend or encoder embeddings its
family takes.

    python scripts/torch_serve_profile.py [--arch llama3.2-3b] [--batch 4]
        [--prompt 2048] [--steps 16] [--trace serve_trace.json]

Runs one prefill of ``batch`` x ``prompt`` tokens and ``steps`` decode
steps once unprofiled (host wall time, each phase ending in a
synchronise; both before any profiler session, so that no profiler cost
on the host enters the host-bound decode timing), then once under
``torch.profiler``, and prints one JSON line per phase: wall time, summed
device kernel time, the device idle share, kernel launches, and the top
CUDA kernels by device time with their launch counts. Needs a CUDA
device; imports neither JAX nor ``repro``.
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
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def profiled(fn):
    """(wall seconds, device kernel events) of ``fn()`` under the
    profiler, synchronised at the end."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, kernels, prof


def summary(name, wall, wall_prof, kernels, top=12):
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    best = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"phase": name, "wall_s": wall, "profiled_wall_s": wall_prof,
            "device_kernel_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_prof,
            "kernel_launches": len(kernels),
            "top_kernels": [{"name": n[:90], "launches": c, "ms": t / 1e3,
                             "share": t / busy_us}
                            for n, (c, t) in best]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_serve_profile: needs a CUDA device")

    from chip_smoke import cache_len, lm_batch, serve_config
    from repro_torch.models import build_model
    from repro_torch.serving import pad_cache

    cfg = serve_config(args.arch)
    model = build_model(cfg).init(seed=0)
    batch = lm_batch(cfg, args.batch, args.prompt, seed=0)
    B, S = batch["tokens"].shape[0], cache_len(batch)
    state = {}

    def prefill():
        logits, cache = model.prefill(batch)
        state["cache"] = pad_cache(model, cache, args.steps, B, S)
        state["tok"] = logits.argmax(-1)[:, None]

    def decode():
        cache, tok = state["cache"], state["tok"]
        for i in range(args.steps):
            pos = torch.full((), S + i, dtype=torch.long, device=tok.device)
            logits, cache = model.decode_step(cache, tok, pos)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()

    prefill()                                   # warm up both phases
    decode()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    phases = (("prefill", prefill), ("decode", decode))
    walls = {}
    for name, fn in phases:          # unprofiled first: no profiler yet
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    for name, fn in phases:
        wall_prof, kernels, prof = profiled(fn)
        out = summary(name, walls[name], wall_prof, kernels)
        out.update({"arch": args.arch, "batch": B, "prompt": args.prompt,
                    "positions": S,
                    "steps": args.steps if name == "decode" else 0,
                    "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": smi})
        print(json.dumps(out), flush=True)
        if args.trace and name == "prefill":
            prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
