#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line with its seconds; any
failure raises and the script exits non-zero without printing a result:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile both CUDA kernels (``loo_trials``, ``flash_attention``)
   from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``, one
   ``nvcc`` per source, all started together;
3. kernel — ``loo_trials`` against its plain PyTorch version on the card at
   every main-path shape (rtol 1e-5, atol floor 1e-5), two launches
   bitwise equal, and CUDA-event times of kernel, plain version and bound;
4. flash — ``flash_attention`` against its plain version at every shape
   the serve phase gives it (llama3.2-3b: H 24, KV 8, d 128, bfloat16,
   causal; B 4 x S 2048 and B 1 at each batcher prompt length) plus
   float32, a 512 window, MQA, d 32/64/256, non-causal and q_offset > 0
   (max abs error 2e-5 in float32, 2e-2 in bfloat16: the JAX sweep's
   bounds), two launches bitwise equal; kernel, plain,
   ``scaled_dot_product_attention`` (library, never on the path) and bound
   times;
5. smoke — the ``smoke`` preset (4 windows, 2 seeds) against
   ``tests/golden/smoke_golden.json``;
6. paper — the 32-label ``paper_tables`` grid at the paper's data size
   (30 windows, 1 seed, fleet engine, stacked) against
   ``results/benchmarks/paper_tables.json``; the main-path run whose
   ``loo_trials`` launches are counted;
7. serve — llama3.2-3b at full width and depth in bfloat16 (weights from
   the port's seeded initialiser): ``ServeEngine.generate`` on 4 prompts
   of 2048 tokens (32 new), then a ``ContinuousBatcher`` with 4 slots
   answering 8 requests of mixed lengths; the main-path run whose
   ``flash_attention`` launches are counted (28 per prefill). Then, not
   counted: prefill logits with the kernel against the plain version
   swapped in, one-step decode against a full prefill, and the kernel's
   share of prefill device time (``torch.profiler``);
8. reduced — the reduced llama3.2-3b config in float32, the port on the
   card against the port on the CPU with the same weights.

Then the whole script's seconds, the ``{"kernels": [...]}`` line and,
last, the ``{"ok": true, ...}`` line. Imports neither JAX nor the JAX package ``repro``.
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

# flash_attention: the JAX sweep's bounds (tests/test_kernels.py:15)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PEAK_FLOPS_PER_S = {"bfloat16": 989e12,    # H100 SXM tensor cores, dense
                    "float32": F32_FLOPS_PER_S}
FLASH_REPS = 10
# The serve phase: llama3.2-3b at full width and depth, bfloat16.
SERVE_ARCH = "llama3.2-3b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
BATCHER_PROMPTS = (64, 129, 250, 511, 777, 1024, 1500, 2000)
BATCHER_BUDGETS = (32, 8, 24, 16, 32, 12, 20, 28)
BATCHER_SLOTS, BATCHER_MAX_LEN = 4, 2112
# Relative logit error (max |a - b| / max |b|) between two bfloat16 runs of
# the full model: kernel vs plain attention in prefill, and one-step decode
# (chunked attention) vs prefill. Each bfloat16 run drifts from its float32
# twin by up to 5.2e-2 (scripts/torch_serve_numerics.py on the H100; the
# same comparisons in float32 agree to 1.7e-5), so two of them may lie up
# to twice that apart.
SERVE_LOGIT_RTOL = 1e-1
# The reduced float32 config, card against CPU: other summation orders.
REDUCED_LOGIT_RTOL = 1e-5
# (B, H, KV, Sq, Skv, d, causal, window, q_offset, dtype); the first one is
# the headline (the generate prefill), the next eight the batcher's.
FLASH_MAIN = [(SERVE_BATCH, 24, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, 0,
               0, "bfloat16")] + [(1, 24, 8, n, n, 128, True, 0, 0,
                                   "bfloat16") for n in BATCHER_PROMPTS]
FLASH_EXTRA = [
    (1, 24, 8, 777, 777, 128, True, 0, 0, "float32"),
    (1, 24, 8, 2000, 2000, 128, True, 512, 0, "bfloat16"),
    (2, 24, 8, 1000, 1000, 128, True, 512, 0, "float32"),
    (2, 16, 1, 1024, 1024, 256, True, 512, 0, "bfloat16"),   # MQA + window
    (2, 8, 4, 513, 513, 32, True, 0, 0, "bfloat16"),
    (2, 8, 4, 513, 513, 64, True, 0, 0, "float32"),
    (2, 8, 2, 300, 300, 256, True, 0, 0, "float32"),
    (2, 8, 8, 300, 300, 64, False, 0, 0, "bfloat16"),
    (2, 8, 2, 200, 450, 128, False, 0, 0, "float32"),
    (2, 24, 8, 64, 1024, 128, True, 0, 960, "float32"),       # q_offset
    (4, 24, 8, 1, 2049, 128, True, 0, 2048, "bfloat16"),      # decode-like
]


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
    t0 = time.perf_counter()
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
          "atol": KERNEL_ATOL, "max_abs_err": worst,
          "seconds": time.perf_counter() - t0, "shapes": rows})
    return rows, worst


def flash_inputs(shape, seed, device):
    """q (B,Sq,H,d), k/v (B,Skv,KV,d) standard normal in the shape's
    dtype: the (B,S,H,d) layout that ``models.blocks`` hands the kernel."""
    B, H, KV, Sq, Skv, d, _, _, _, dtype = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    return tuple(torch.randn(s, generator=g, device=device).to(dt)
                 for s in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d)))


def flash_kwargs(shape):
    return dict(causal=shape[6], window=shape[7], q_offset=shape[8])


def flash_pairs(shape) -> int:
    """(query, key) pairs the mask keeps, per (batch, head)."""
    _, _, _, Sq, Skv, _, causal, window, q_offset, _ = shape
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(Sq)
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(shape):
    """(bytes, flops) the function needs: q, k, v read once and o written
    once; 2·2·d operations per kept (query, key) pair (q·k and p·v)."""
    B, H, KV, Sq, Skv, d, *_, dtype = shape
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * d * B * (2 * H * Sq + 2 * KV * Skv)
    return nbytes, 4 * B * H * d * flash_pairs(shape)


def phase_flash(fa):
    t0 = time.perf_counter()
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, shape in enumerate(FLASH_MAIN + FLASH_EXTRA):
        dtype, kw = shape[9], flash_kwargs(shape)
        q, k, v = flash_inputs(shape, seed=i, device="cuda")
        out = fa.flash_attention_bshd(q, k, v, **kw)
        out2 = fa.flash_attention_bshd(q, k, v, **kw)
        ref = fa.flash_attention_bshd_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, out2),
              f"flash_attention not bitwise deterministic at {shape}")
        check(bool(torch.isfinite(out).all()), f"non-finite at {shape}")
        err = float((out.float() - ref.float()).abs().max())
        check(err <= FLASH_TOL[dtype], f"flash_attention vs plain at "
                                       f"{shape}: max abs err {err}")
        worst[dtype] = max(worst[dtype], err)
        nbytes, flops = flash_cost(shape)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
        t_ops = flops / PEAK_FLOPS_PER_S[dtype] * 1e6
        kernel_us = device_time_us(
            lambda: fa.flash_attention_bshd(q, k, v, **kw), (), FLASH_REPS)
        plain_us = device_time_us(lambda: fa.flash_attention_bshd_ref(q, k, v, **kw),
                                  (), FLASH_REPS)
        library_us = None
        if shape[7] == 0 and shape[8] == 0:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            library_us = device_time_us(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=shape[6], enable_gqa=True), (),
                FLASH_REPS)
        rows.append({"shape": list(shape), "max_abs_err": err,
                     "kernel_us": kernel_us, "plain_us": plain_us,
                     "library_us": library_us,
                     "bound_us": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"})
    emit({"phase": "flash", "kernel": "flash_attention", "tol": FLASH_TOL,
          "max_abs_err": worst, "seconds": time.perf_counter() - t0,
          "shapes": rows})
    return rows, max(worst.values())


class PrefillTally:
    """Wraps ``model.prefill`` (on the instance) to count prefill calls
    and tokens and their host time, each call synchronised so the time
    covers its device work."""

    def __init__(self, model):
        self.model = model
        self.calls = self.tokens = 0
        self.seconds = 0.0

    def __call__(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(batch)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.tokens += batch["tokens"].numel()
        return out

    def __enter__(self):
        self.orig = self.model.prefill
        self.model.prefill = self
        return self

    def __exit__(self, *exc):
        del self.model.prefill


class PlainAttention:
    """Swaps the plain version in for the flash kernel where the model
    calls it (``models.blocks.flash_attention_bshd``), for one
    comparison; the package itself has no switch."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bshd_ref)
        from repro_torch.models import blocks

        self.blocks, self.orig = blocks, blocks.flash_attention_bshd
        blocks.flash_attention_bshd = flash_attention_bshd_ref
        return self

    def __exit__(self, *exc):
        self.blocks.flash_attention_bshd = self.orig


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def batcher_requests(vocab, seed=1):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int64), budget)
            for i, (n, budget) in enumerate(zip(BATCHER_PROMPTS,
                                                BATCHER_BUDGETS))]


def flash_share_of_prefill(model, batch):
    """Share of one prefill's device kernel time spent in the flash kernel
    (``torch.profiler``), and that device time in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels)
    flash = sum(e.time_range.elapsed_us() for e in kernels
                if "flash_attention" in e.name)
    check(total > 0, "profiler saw no device time in prefill")
    return flash / total, total / 1e3


def phase_serve(fa):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.serving import ServeEngine, pad_cache
    from repro_torch.serving.scheduler import ContinuousBatcher

    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg).init(seed=0)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    batch = make_lm_batch(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, seed=0)
    # warm-up outside the counted run: cuBLAS handles, allocator
    _, c = model.prefill({"tokens": batch["tokens"][:1, :64]})
    model.decode_step(pad_cache(model, c, 1, 1, 64),
                      batch["tokens"][:1, :1], 64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the main-path run: counts from 0 just before, read just after ---
    reqs = batcher_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    with PrefillTally(model) as tally:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = ServeEngine(model, max_new_tokens=SERVE_NEW).generate(batch)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t1
        gen_prefill_s = tally.seconds
        batcher = ContinuousBatcher(model, slots=BATCHER_SLOTS,
                                    max_len=BATCHER_MAX_LEN)
        for r in reqs:
            batcher.submit(r)
        steps = 0
        t2 = time.perf_counter()
        while batcher.step():
            steps += 1
        torch.cuda.synchronize()
        bat_s = time.perf_counter() - t2
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()

    check(tuple(gen.shape) == (SERVE_BATCH, SERVE_NEW), f"generate shape "
          f"{tuple(gen.shape)}")
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          "generated ids out of the vocabulary")
    for r in reqs:
        check(r.done and len(r.out) == r.max_new_tokens,
              f"request {r.rid}: done={r.done}, {len(r.out)} tokens of "
              f"{r.max_new_tokens}")
    check(tally.calls == 1 + len(reqs), f"{tally.calls} prefill calls")
    check(launches == cfg.num_layers * tally.calls,
          f"flash launches {launches} != {cfg.num_layers} x {tally.calls} "
          f"prefills")
    decode_s = gen_s - gen_prefill_s

    # --- checks against the plain version and prefill (not counted) ---
    logits_k, _ = model.prefill(batch)
    with PlainAttention():
        logits_p, _ = model.prefill(batch)
    kernel_vs_plain = rel_err(logits_k, logits_p)
    S = SERVE_PROMPT
    _, cache = model.prefill({"tokens": batch["tokens"][:, :S - 1]})
    cache = pad_cache(model, cache, 1, SERVE_BATCH, S - 1)
    logits_d, _ = model.decode_step(cache, batch["tokens"][:, S - 1:], S - 1)
    decode_vs_prefill = rel_err(logits_d, logits_k)
    for name, lg in (("kernel", logits_k), ("plain", logits_p),
                     ("decode", logits_d)):
        check(bool(torch.isfinite(lg).all()) and tuple(lg.shape) ==
              (SERVE_BATCH, cfg.vocab_size), f"bad {name} logits")
    share, prefill_device_ms = flash_share_of_prefill(model, batch)
    out = {"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "params": int(sum(
               p.numel() for p in model.parameters())),
           "weight_bytes": weight_bytes, "peak_memory_bytes": peak,
           "generate": {"batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
                        "new_tokens": SERVE_NEW, "seconds": gen_s,
                        "prefill_s": gen_prefill_s,
                        "prefill_tokens_per_s":
                            SERVE_BATCH * SERVE_PROMPT / gen_prefill_s,
                        "decode_steps": SERVE_NEW,
                        "decode_ms_per_step": decode_s / SERVE_NEW * 1e3,
                        "decode_tokens_per_s":
                            SERVE_BATCH * SERVE_NEW / decode_s},
           "batcher": {"slots": BATCHER_SLOTS, "requests": len(reqs),
                       "prompts": list(BATCHER_PROMPTS),
                       "budgets": list(BATCHER_BUDGETS), "steps": steps,
                       "seconds": bat_s,
                       "tokens_out": sum(len(r.out) for r in reqs)},
           "prefill_calls": tally.calls, "prefill_tokens": tally.tokens,
           "prefill_seconds": tally.seconds,
           "flash_launches": launches,
           "flash_share_of_prefill_device_time": share,
           "prefill_device_ms": prefill_device_ms,
           "kernel_vs_plain_logit_rel_err": kernel_vs_plain,
           "decode_vs_prefill_logit_rel_err": decode_vs_prefill,
           "logit_rtol": SERVE_LOGIT_RTOL, "setup_s": setup_s,
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(kernel_vs_plain <= SERVE_LOGIT_RTOL, f"kernel vs plain prefill "
          f"logits: rel err {kernel_vs_plain} > {SERVE_LOGIT_RTOL}")
    check(decode_vs_prefill <= SERVE_LOGIT_RTOL, f"decode vs prefill "
          f"logits: rel err {decode_vs_prefill} > {SERVE_LOGIT_RTOL}")
    return out


def reduced_card_vs_cpu(seed=0):
    """The reduced llama3.2-3b config in float32: (max relative logit error
    of prefill, of a scalar-position decode, of a per-sequence decode),
    the port on the card against the port on the CPU, same weights."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batch
    from repro_torch.models import build_model
    from repro_torch.serving import pad_cache

    cfg = get_config(SERVE_ARCH).reduced()
    cpu = build_model(cfg, device="cpu").init(seed=seed)
    card = copy.deepcopy(cpu).to("cuda")
    toks = make_lm_batch(cfg.vocab_size, 2, 64, seed=3, device="cpu")
    errs = []
    caches = {}
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        lg, cache = m.prefill({"tokens": toks["tokens"].to(dev)})
        caches[dev] = (lg, pad_cache(m, cache, 4, 2, 64))
    errs.append(rel_err(caches["cuda"][0].cpu(), caches["cpu"][0]))
    for pos in (torch.tensor(64), torch.tensor([64, 61])):
        lgs = {}
        for m, dev in ((cpu, "cpu"), (card, "cuda")):
            cache = {k: v.clone() for k, v in caches[dev][1].items()}
            nxt = caches["cpu"][0].argmax(-1)[:, None]
            lgs[dev], _ = m.decode_step(cache, nxt.to(dev), pos)
        errs.append(rel_err(lgs["cuda"].cpu(), lgs["cpu"]))
    return errs


def phase_reduced():
    t0 = time.perf_counter()
    errs = reduced_card_vs_cpu()
    emit({"phase": "reduced", "arch": SERVE_ARCH + " reduced (float32)",
          "prefill_rel_err": errs[0], "decode_rel_err": errs[1],
          "decode_per_sequence_rel_err": errs[2],
          "rtol": REDUCED_LOGIT_RTOL, "seconds": time.perf_counter() - t0})
    check(max(errs) <= REDUCED_LOGIT_RTOL, f"reduced config card vs CPU: "
          f"rel errs {errs} > {REDUCED_LOGIT_RTOL}")


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
    t_start = time.perf_counter()
    from repro_torch.core import fleet
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import loo_trials as loo

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    libs = build.build(["loo_trials", "flash_attention"])
    loo._launcher()
    fa._launcher()
    ptxas = {k: [ln.strip() for ln in v.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
             for k, v in libs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": " ".join(build.NVCC_FLAGS),
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": ptxas})

    # 3. loo_trials against its plain version
    rows, worst = phase_kernel(loo)

    # 4. flash_attention against its plain version
    flash_rows, flash_worst = phase_flash(fa)

    # 5. smoke preset against the golden fixture
    with open(os.path.join(ROOT, "tests", "golden", "smoke_golden.json")) \
            as fh:
        golden = json.load(fh)
    data = make_covtype_like(seed=golden["data_seed"])
    phase_preset("smoke", {"windows": golden["windows"],
                           "n_seeds": golden["n_seeds"]},
                 golden["per_label"], list(golden["per_label"]), loo, fleet,
                 data)

    # 6. the paper grid at full data size: loo_trials' counted main path
    with open(os.path.join(ROOT, "results", "benchmarks",
                           "paper_tables.json")) as fh:
        paper = json.load(fh)
    labels = [k for k, v in paper.items() if isinstance(v, dict)]
    main_run = phase_preset("paper_tables", {"windows": paper["windows"],
                                             "n_seeds": paper["n_seeds"]},
                            paper, labels, loo, fleet,
                            make_covtype_like(seed=0))

    # 7. llama3.2-3b serving: flash_attention's counted main path
    serve = phase_serve(fa)

    # 8. the reduced config, card against CPU
    phase_reduced()

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    head = next(r for r in rows
                if (r["L"], r["R"], r["D"], r["M"]) == HEADLINE_SHAPE)
    fhead = flash_rows[0]
    emit({"kernels": [{
        "name": "loo_trials", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/loo_trials.cu",
        "replaces": "src/repro/kernels/loo_trials.py:51",
        "launches": main_run["loo_trials_launches"],
        "max_abs_err": worst,
        "ms": head["kernel_us"] / 1e3, "plain_ms": head["plain_us"] / 1e3,
        "bound_ms": head["bound_us"] / 1e3, "bound_by": head["bound_by"],
        "library_ms": None, "shape": list(HEADLINE_SHAPE)}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": serve["flash_launches"],
        "max_abs_err": flash_worst,
        "ms": fhead["kernel_us"] / 1e3, "plain_ms": fhead["plain_us"] / 1e3,
        "bound_ms": fhead["bound_us"] / 1e3, "bound_by": fhead["bound_by"],
        "library_ms": fhead["library_us"] / 1e3,
        "shape": fhead["shape"]}]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
