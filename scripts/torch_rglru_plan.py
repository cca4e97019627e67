#!/usr/bin/env python
"""Time the ``rglru_scan`` kernel at every row of chip_smoke's rglru phase:
under ``launch_plan``'s layout, on the cp.async route beside the TMA route,
under every candidate layout, and beside an earlier kernel's source.

    python scripts/torch_rglru_plan.py [--parent OLD.cu] [--candidates]
        [--serve REPS] [--out FILE]

Every row (chip_smoke's ``RGLRU_SHAPES`` then ``RGLRU_EXTRA``) is held
against the plain version (``RGLRU_TOL``, absolute) under every layout it
runs, and its median CUDA-event time is printed with the bound, one JSON
line per row. ``--parent`` builds another ``rglru_scan.cu`` that has the
launcher of PRs 13-20 (``rglru_scan_launch(a, b, h, a_sb, a_ss, b_sb, b_ss,
h_sb, h_ss, B, S, W, stream)``; for instance the file from ``git archive``
of an earlier commit) and times it in turns with the current kernel
(earlier, current, current, earlier). ``--candidates`` times every channel
group x cluster x chunk, twice, at the rows of width 4096 or S >= 10000. ``--serve REPS`` builds recurrentgemma-9b as
chip_smoke serves it (bf16, full width, random weights) and times
``model.prefill`` of 4 x 2048 tokens REPS times with each kernel, in turns
(needs ``--parent``). Prints the card's name and power limit. Needs a CUDA
device; imports neither JAX nor ``repro``.
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CLUSTERS = (1, 2, 3, 4, 8)
CHUNKS = (32, 40, 48, 64, 96, 120, 128, 160, 192, 256)
CANDIDATE_REPS = 20


def load_parent(src):
    """Build ``src`` with the port's nvcc flags into the build directory
    and return its typed launcher."""
    from repro_torch.kernels import build

    src = os.path.abspath(src)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / f"libparent_rglru_{digest}.so"
    if not lib.exists():
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                        src], check=True, stdout=subprocess.DEVNULL)
    fn = ctypes.CDLL(str(lib)).rglru_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def scan(a, b):
        B, S, W = a.shape
        h = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), a.stride(0),
                 a.stride(1), b.stride(0), b.stride(1), h.stride(0),
                 h.stride(1), B, S, W,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier kernel: CUDA error {err}")
        return h
    return scan


def held(h, want, tol, what):
    err = float((h - want).abs().max())
    if not err <= tol:
        raise RuntimeError(f"{what}: max abs err {err} > {tol}")
    return err


def time_rows(rg, parent, candidates, emit):
    from chip_smoke import (RGLRU_TOL, bound, device_time_us, rglru_cost,
                            rglru_inputs, rglru_rows)

    for i, (B, S, W, offset) in enumerate(rglru_rows()):
        shape = (B, S, W)
        a, b = rglru_inputs(shape, seed=400 + i, device="cuda",
                            offset=offset)
        want = rg.rglru_scan_ref(a, b)
        plan = rg.launch_plan(B, S, W)
        tma = rg.tma_route(a, b, want)
        row = {"shape": list(shape), "offset": offset, "plan":
               plan._asdict(), "windows": plan.windows(S),
               "route": "tma" if tma else "cp.async"}
        row["bound_us"], row["bound_by"] = bound(*rglru_cost(shape),
                                                 "float32")
        h = rg._launch(a, b)
        row["max_abs_err"] = held(h, want, RGLRU_TOL, f"{shape}")
        if not torch.equal(h, rg._launch(a, b)):
            raise RuntimeError(f"{shape}: two launches differ")
        if parent is not None:
            held(parent(a, b), want, RGLRU_TOL, f"earlier kernel {shape}")
            t = [device_time_us(parent, (a, b)),
                 device_time_us(rg._launch, (a, b)),
                 device_time_us(rg._launch, (a, b)),
                 device_time_us(parent, (a, b))]
            row["earlier_us"] = (t[0] + t[3]) / 2
            row["kernel_us"] = (t[1] + t[2]) / 2
            row["turns_us"] = t
        else:
            row["kernel_us"] = device_time_us(rg._launch, (a, b))
        row["bound_share"] = row["bound_us"] / row["kernel_us"]
        if tma:
            held(rg._launch(a, b, tma=False), want, RGLRU_TOL,
                 f"{shape} cp.async")
            row["cp_async_us"] = device_time_us(
                lambda: rg._launch(a, b, tma=False), ())
        if candidates and (W >= 4096 or S >= 10000):
            # every layout, in two passes (their spread is the noise)
            times = {}
            for _ in range(2):
                for g in rg.GROUPS:
                    for c in CLUSTERS:
                        for t in CHUNKS:
                            if t * g > rg.MAX_TILE:
                                continue
                            p = rg.LaunchPlan(g, c, t)
                            held(rg._launch(a, b, p), want, RGLRU_TOL,
                                 f"{shape} {p}")
                            times.setdefault(f"{g},{c},{t}", []).append(
                                device_time_us(rg._launch, (a, b, p),
                                               CANDIDATE_REPS))
            best = min(times, key=lambda k: min(times[k]))
            row["candidates_us"] = times
            row["best"] = {"plan": best, "us": min(times[best])}
        emit(row)


def time_serve(rg, parent, reps, emit):
    """recurrentgemma-9b's prefill (4 x 2048, bf16, full width) with the
    current kernel and the earlier one, in turns."""
    from chip_smoke import (SERVE_BATCH, SERVE_PROMPT, lm_batch,
                            serve_config)
    from repro_torch.models import build_model

    cfg = serve_config("recurrentgemma-9b")
    model = build_model(cfg).init(seed=0)
    batch = lm_batch(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0)
    current = rg._launch
    out = {"current": [], "earlier": []}

    def prefill(which):
        rg._launch = current if which == "current" else \
            (lambda a, b: parent(a, b))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(batch)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        finally:
            rg._launch = current
        del cache
        return logits, s

    lk, _ = prefill("current")                      # warm-up, both kernels
    lp, _ = prefill("earlier")
    rel = float((lk.float() - lp.float()).abs().max()
                / lp.float().abs().max())
    for _ in range(reps):
        for which in ("earlier", "current", "current", "earlier"):
            out[which].append(SERVE_BATCH * SERVE_PROMPT / prefill(which)[1])
    emit({"serve": "recurrentgemma-9b", "prefill": [SERVE_BATCH,
          SERVE_PROMPT], "tokens_per_s": out, "median": {
              k: float(sorted(v)[len(v) // 2]) for k, v in out.items()},
          "logits_rel_err_current_vs_earlier": rel})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier rglru_scan.cu to time "
                    "beside the current kernel")
    ap.add_argument("--candidates", action="store_true",
                    help="time every channel group x cluster x chunk")
    ap.add_argument("--serve", type=int, default=0, metavar="REPS",
                    help="time recurrentgemma-9b's prefill with both "
                    "kernels (needs --parent)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_rglru_plan: needs a CUDA device")
    if args.serve and not args.parent:
        sys.exit("torch_rglru_plan: --serve needs --parent")

    from chip_smoke import nvidia_smi_line
    from repro_torch.kernels import rglru_scan as rg

    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    emit({"nvidia_smi": nvidia_smi_line(),
          "device": torch.cuda.get_device_name(0)})
    rg._launcher()
    parent = load_parent(args.parent) if args.parent else None
    time_rows(rg, parent, args.candidates, emit)
    if args.serve:
        time_serve(rg, parent, args.serve, emit)
    emit({"nvidia_smi": nvidia_smi_line()})
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
