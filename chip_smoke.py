#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line; any failure raises and the
script exits non-zero without printing a result:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile the CUDA kernel(s) from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``;
3. kernel — ``loo_trials`` against its plain PyTorch version on the card at
   every main-path shape (rtol 1e-5, atol floor 1e-5), two launches
   bitwise equal, and CUDA-event times of kernel, plain version and bound;
4. smoke — the ``smoke`` preset (4 windows, 2 seeds) against
   ``tests/golden/smoke_golden.json``;
5. paper — the 32-label ``paper_tables`` grid at the paper's data size
   (30 windows, 1 seed, fleet engine, stacked) against
   ``results/benchmarks/paper_tables.json``; the main-path run whose
   kernel launches are counted.

Then the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line. Imports neither JAX nor the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
ENERGY_RTOL = 1e-6
# Bound on |F1_port - F1_golden| for converged F1 and per-window F1 (see
# PERF.md, "F1 bound"): the port and the JAX reference agree exactly on
# every host-side quantity, but a float32 rounding difference can flip a
# hinge-subgradient kink or a test prediction, which moves an F1 value by
# a few 1e-4; the CPU comparison of the two packages stays below 2e-3.
F1_ATOL = 5e-3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM float32, outside tensor cores
KERNEL_SHAPES = [(L, R, D, 16) for L in (1, 8, 16, 32)
                 for R in (1, 112, 448, 1120) for D in (11, 23)]
HEADLINE_SHAPE = (16, 1120, 23, 16)
TIMING_REPS = 60


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def kernel_inputs(L, R, D, M, seed, device):
    """The kernel's arguments in the state of the first greedy step of
    the incremental refine (bias-only factor, ``D - 7`` empty slots), from
    a random ridge system: realistic magnitudes (leverage below 1). The
    last DC of a fleet is a padding DC (all-zero rows and rmask) and every
    fifth candidate is masked (dinv = 0)."""
    C = 7
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((L, R, M + C), generator=g)
    y = torch.randn((L, R), generator=g)
    rmask = (torch.rand((L, R), generator=g) < 0.8).float()
    if L > 1:
        rmask[-1] = 0.0
    A_rm = A * rmask[:, :, None]
    AtA = A_rm.transpose(1, 2) @ A_rm
    Aty = (A_rm.transpose(1, 2) @ (y * rmask)[:, :, None])[:, :, 0]
    lam_d = 0.5 + torch.rand(M + C, generator=g)
    Lb = torch.linalg.cholesky(AtA[:, M:, M:] + torch.diag(lam_d[M:]))
    Utb = torch.linalg.solve_triangular(
        Lb, A_rm[:, :, M:].transpose(1, 2), upper=False).transpose(1, 2)
    zb = torch.linalg.solve_triangular(Lb, Aty[:, M:, None], upper=False)
    Ccb = torch.linalg.solve_triangular(Lb, AtA[:, M:, :M], upper=False)
    ut = torch.zeros((L, R, D))
    ut[:, :, :C] = Utb
    cc = torch.zeros((L, D, M))
    cc[:, :C] = Ccb
    fitted = (Utb @ zb)[:, :, 0]
    h = torch.sum(Utb ** 2, dim=-1)
    dsq = (torch.diagonal(AtA, dim1=1, dim2=2)[:, :M] + lam_d[:M]
           - torch.sum(cc ** 2, dim=1))
    dinv = torch.rsqrt(torch.clamp(dsq, min=1e-8))
    dinv[:, ::5] = 0.0
    zj = (Aty[:, :M] - (cc[:, :C].transpose(1, 2) @ zb)[:, :, 0]) * dinv
    args = (ut, cc, A_rm[:, :, :M], fitted, h, y, rmask, zj, dinv)
    return tuple(a.contiguous().to(device) for a in args)


def kernel_cost(L, R, D, M):
    """(bytes, flops) the function needs: every input read once, the
    output written once; 2·R·D·M for the products plus 13 operations per
    (row, candidate) for the epilogue and the row sum."""
    floats = L * (R * D + D * M + R * M + 4 * R + 2 * M) + L * M
    return 4 * floats, L * (2 * R * D * M + 13 * R * M)


def device_time_us(fn, args, reps=TIMING_REPS) -> float:
    """Median device time of one call, by CUDA events. A sleep kernel
    queued ahead of each timed call keeps the card busy while the host
    enqueues, so the events bracket the call's kernels and not the
    Python around them."""
    fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) * 1e3 for a, b in pairs]))


def phase_kernel(loo):
    rows, worst = [], 0.0
    for i, (L, R, D, M) in enumerate(KERNEL_SHAPES):
        args = kernel_inputs(L, R, D, M, seed=i, device="cuda")
        out = loo.loo_trials(*args)
        out2 = loo.loo_trials(*args)
        ref = loo.loo_trials_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, out2),
              f"loo_trials not bitwise deterministic at {(L, R, D, M)}")
        check(bool(torch.isfinite(out).all()), f"non-finite at {(L, R, D)}")
        err = float((out - ref).abs().max())
        ok = torch.allclose(out, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        check(ok, f"loo_trials vs plain at {(L, R, D, M)}: max abs err "
                  f"{err}")
        worst = max(worst, err)
        nbytes, flops = kernel_cost(L, R, D, M)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
        t_ops = flops / F32_FLOPS_PER_S * 1e6
        rows.append({"L": L, "R": R, "D": D, "M": M, "max_abs_err": err,
                     "kernel_us": device_time_us(loo.loo_trials, args),
                     "plain_us": device_time_us(loo.loo_trials_ref, args),
                     "bound_us": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"})
    emit({"phase": "kernel", "kernel": "loo_trials", "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "max_abs_err": worst, "shapes": rows})
    return rows, worst


def summaries(result):
    return {lbl: result.summary(lbl) for lbl in result.labels()}


def compare(got, want, labels):
    """(max energy rel err, max converged-F1 err, max curve err)."""
    e = f = c = 0.0
    for lbl in labels:
        g, w = got[lbl], want[lbl]
        for k in ("energy_mj", "collection_mj", "learning_mj"):
            e = max(e, abs(g[k] - w[k]) / max(abs(w[k]), 1e-300))
        f = max(f, abs(g["f1"] - w["f1"]))
        c = max(c, max(abs(a - b) for a, b in zip(g["f1_curve"],
                                                  w["f1_curve"])))
    return e, f, c


class GreedyStepTally:
    """Wraps the fleet engine's refine call to count, per call, the greedy
    steps the port runs (fixed ``min(k_max, M)``, one kernel launch each)
    against the steps an early exit would need: per DC ``min(K, accepted
    + 1)`` — summed over DCs for the reference's one-launch-per-DC-step
    ``lax.map``, and the max over DCs for a batched early exit."""

    def __init__(self, fleet, k_max=16):
        self.fleet, self.orig = fleet, fleet.greedytl_fleet_stacked
        self.k_max = k_max
        self.calls = self.fixed = self.per_dc_exit = self.batched_exit = 0

    def __call__(self, *a, **kw):
        w, sel = self.orig(*a, **kw)
        K = min(self.k_max, sel.shape[1])
        need = torch.clamp(sel.sum(dim=1) + 1, max=K).cpu().numpy()
        self.calls += 1
        self.fixed += K
        self.per_dc_exit += int(need.sum())
        self.batched_exit += int(need.max())
        return w, sel

    def __enter__(self):
        self.fleet.greedytl_fleet_stacked = self
        return self

    def __exit__(self, *exc):
        self.fleet.greedytl_fleet_stacked = self.orig

    def as_dict(self):
        return {"refine_calls": self.calls, "launches_fixed": self.fixed,
                "launches_reference_per_dc": self.per_dc_exit,
                "launches_batched_early_exit": self.batched_exit}


def phase_preset(name, overrides, golden, labels, loo, fleet, data):
    from repro_torch.core.experiment import get_preset

    loo.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GreedyStepTally(fleet) as tally:
        res = get_preset(name, **overrides).run(data, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = loo.launches
    got = summaries(res)
    check(res.labels() == labels, f"{name}: labels {res.labels()}")
    for lbl in labels:
        curve = np.asarray(got[lbl]["f1_curve"])
        check(bool(np.isfinite(curve).all()) and len(curve) > 0,
              f"{name}: bad F1 curve for {lbl}")
    e, f, c = compare(got, golden, labels)
    out = {"phase": name, "runs": len(res.records), "labels": len(labels),
           "wall_s": wall, "s_per_window": wall / overrides["windows"],
           "energy_max_rel_err": e, "f1_max_abs_err": f,
           "f1_curve_max_abs_err": c, "f1_atol": F1_ATOL,
           "loo_trials_launches": launches, **tally.as_dict()}
    emit(out)
    check(e <= ENERGY_RTOL, f"{name}: energy rel err {e} > {ENERGY_RTOL}")
    check(f <= F1_ATOL, f"{name}: converged F1 err {f} > {F1_ATOL}")
    check(c <= F1_ATOL, f"{name}: F1 curve err {c} > {F1_ATOL}")
    check(launches > 0, f"{name}: loo_trials kernel never launched")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import fleet
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.kernels import build
    from repro_torch.kernels import loo_trials as loo

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    libs = build.build(["loo_trials"])
    loo._launcher()
    ptxas = [ln.strip() for ln in libs["loo_trials"].with_suffix(".log")
             .read_text().splitlines() if "registers" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": " ".join(build.NVCC_FLAGS),
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas})

    # 3. kernel against its plain version
    rows, worst = phase_kernel(loo)

    # 4. smoke preset against the golden fixture
    with open(os.path.join(ROOT, "tests", "golden", "smoke_golden.json")) \
            as fh:
        golden = json.load(fh)
    data = make_covtype_like(seed=golden["data_seed"])
    phase_preset("smoke", {"windows": golden["windows"],
                           "n_seeds": golden["n_seeds"]},
                 golden["per_label"], list(golden["per_label"]), loo, fleet,
                 data)

    # 5. the paper grid at full data size: the counted main-path run
    with open(os.path.join(ROOT, "results", "benchmarks",
                           "paper_tables.json")) as fh:
        paper = json.load(fh)
    labels = [k for k, v in paper.items() if isinstance(v, dict)]
    main_run = phase_preset("paper_tables", {"windows": paper["windows"],
                                             "n_seeds": paper["n_seeds"]},
                            paper, labels, loo, fleet,
                            make_covtype_like(seed=0))

    head = next(r for r in rows
                if (r["L"], r["R"], r["D"], r["M"]) == HEADLINE_SHAPE)
    emit({"kernels": [{
        "name": "loo_trials", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/loo_trials.cu",
        "replaces": "src/repro/kernels/loo_trials.py:51",
        "launches": main_run["loo_trials_launches"],
        "max_abs_err": worst,
        "ms": head["kernel_us"] / 1e3, "plain_ms": head["plain_us"] / 1e3,
        "bound_ms": head["bound_us"] / 1e3, "bound_by": head["bound_by"],
        "library_ms": None, "shape": list(HEADLINE_SHAPE)}]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
