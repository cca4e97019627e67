#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printing one JSON line with its seconds; any
failure raises and the script exits non-zero without printing a result:

1. device — the card's name and power limit (``nvidia-smi``);
2. build — compile all five CUDA kernels (``loo_trials``,
   ``flash_attention``, ``ssd_scan``, ``rglru_scan``,
   ``decode_attention``) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``, one
   ``nvcc`` per source, all started together; then a ``{"ptxas": ...}``
   line with the registers and spill bytes of every kernel function, and a
   check that no instantiation of the bf16 tensor-core flash kernel (head
   dims 32, 64, 128, 256), of the three tensor-core ``ssd_scan`` kernels
   (N 64, 128), of the ``loo_trials`` kernel (D buckets 16-128, plain
   and fused), of the ``rglru_scan`` kernel (channel groups 32, 64; TMA
   and cp.async routes) or of the bf16 ``decode_attention`` kernel (head
   dims 32, 64, 128, query heads per KV head up to 1, 2, 4, 8) spills;
3. kernel — ``loo_trials`` against its plain PyTorch version on the card at
   every main-path shape (a grid of L, R and D, and the shapes beyond it
   that phases 7-8d launch, the city's refine among them; rtol 1e-5, atol
   floor 1e-5), two launches
   bitwise equal, and CUDA-event times of kernel, plain version and bound,
   beside the first kernel's time (``earlier_us``) and the time of the
   most trivial launch (``floor_us``);
3b. loo_trials_step — the greedy step's fused kernel (prologue + scorer,
   the refine's main path) against ``loo_trials_step_ref`` at the same
   shapes: objs, dinv and zj within the same tolerance, bitwise equal
   across launches, with times;
4. flash — ``flash_attention`` against its plain version at every shape
   the serve phases give it (llama3.2-3b: H 24, KV 8, d 128, causal;
   recurrentgemma-9b: H 16, KV 1, d 256, window 2048; olmoe-1b-7b: H 16,
   KV 16, d 128; bfloat16, B 4 x S 2048 and B 1 at each batcher prompt
   length; llava-next-mistral-7b: B 4 x 4928 positions, H 32, KV 8, d
   128; whisper-medium: its non-causal encoder, B 4 x 1500 frames, and its
   causal decoder, B 4 x 224, H 16, KV 16, d 64) plus float32, a 512
   window, d 32/64, non-causal and q_offset > 0 (max abs error 2e-5 in
   float32, 2e-2 in bfloat16: the JAX sweep's bounds), two launches
   bitwise equal; kernel, plain, ``scaled_dot_product_attention``
   (library, never on the path) and bound times;
4b. decode_attention — the split-K decode kernel against its plain
   version at olmoe-1b-7b chat's buffer (64 x 1,537, 16 heads of 128),
   long-prompt's (16 x 3,043), llama3.2-3b's GQA (G 3), whisper-medium's
   d 64 and reduced float32 shapes, each slot at a random depth with 0
   and S - 1 among them, elementwise within ``DECODE_ATTN_TOL`` (one bf16
   rounding of the output: 2^-7 of |plain| in bfloat16); the same limit
   must refuse the plain version with one split of keys left out (a
   planted fault, printed as ``fault_tol_use``); two launches bitwise
   equal; then kernel, plain, SDPA (library, over the whole buffer with
   the depth mask, never on the path) and bound (the attended K/V rows
   read once) times at olmoe chat's and long-prompt's mix depths
   (``perfbench/mixes/<mix>.json``) and at full buffers;
5. ssd — ``ssd_scan`` against its plain version (``ssd_chunked``) at
   mamba2-1.3b's prefill shapes (H 64, P 64, N 128, chunk 256; B 4 x
   S 2048 in bfloat16 and float32, B 1 at each batcher prompt length, which
   the chunk does not divide) and the JAX sweep's four shapes, the latter
   also against the sequential oracle (relative error 3e-5 in float32,
   5e-2 in bfloat16, on y and on the state), two launches bitwise equal;
   each row names its route (``tensor_cores`` or ``cuda_cores``) and
   keeps the CUDA-core kernel's earlier time as ``earlier_us``;
6. rglru — ``rglru_scan`` against its plain version and the sequential
   oracle at recurrentgemma-9b's prefill shapes (W 4096, float32; B 4 x
   S 2048 and B 1 at each batcher prompt length), the JAX sweep's four
   shapes and ``RGLRU_EXTRA``'s long, odd-width and offset rows (max abs
   error 1e-4, two launches bitwise equal); each row names its launch
   plan, route and share of the bound, and keeps the two-pass kernel's
   time as ``earlier_us``;
7. smoke — the ``smoke`` preset (4 windows, 2 seeds) against
   ``tests/golden/smoke_golden.json``;
8. paper — the 32-label ``paper_tables`` grid at the paper's data size
   (30 windows, 1 seed, fleet engine, stacked) against
   ``results/benchmarks/paper_tables.json``; the main-path run whose
   ``loo_trials`` launches are counted (``loo_trials_launches`` counts both
   entry points, one per greedy step; ``loo_trials_step_launches`` the
   fused one, which the incremental refine calls);
8b. scan_parity — the ``smoke`` preset (the golden file's windows and
   seeds) and ``transport_grid`` at 5 windows on the scan engine
   (``engine="scan"``: one captured CUDA graph per block shape, one replay
   per window) and on the fleet engine, both unstacked: every ledger event
   equal, every F1 within 1e-4 (the reference's fleet-vs-loop bar), one
   ``scan_windows`` dispatch per scenario; prints how many F1 values differ
   and whether the ``SweepResult`` JSON, engine field normalised, is
   byte-equal (the reference's own gate, ``scripts/scan_parity.py``);
8c. paper_tables_scan — the 31 HTL labels of the paper grid (all but
   ``fig2_edge_only``, which the scan engine refuses) at 30 windows on the
   scan engine, against the committed results as in phase 8; wall time
   beside the fleet engine's for the same labels (phase 8's wall less its
   edge-only run), the host seconds of planning, packing and the dispatches
   (upload, capture, replays, the one sync), graphs captured and their
   seconds, replays, and ``loo_trials_step`` launches (captured per window
   × replays); then, not counted, one A2A scenario of the grid at 5
   windows on each engine: its wall without the profiler, then under
   ``torch.profiler`` (device activity) its profiled wall, device kernel
   time and kernel launches per window; the idle share is read against
   the unprofiled wall;
8d. city — the ``city`` preset at its defaults (100,000 DCs, 4
   observations each, 6 base-SVM iterations, wifi, StarHTL) at 2 and then
   6 windows: one ``city_scan`` dispatch per run, an F1 curve of W values
   in (0, 1] ending at >= 0.15, peak device memory and host peak RSS each
   within 1.15x from 2 to 6 windows, every ledger event equal to an
   independent count (the fleet's collection as ``fleet_size``
   ``collect_to_mule`` events; the learning messages as the fleet engine's
   per-pair ``Topology`` patterns give them, a quadratic in the fleet size,
   with the center's role read from the run's center ids); then a 40-DC,
   3-window city on the card and on the CPU with the same injected draw
   indices: centers equal, F1 within 1e-4 (one shard throughout: no
   process group);
8f. orchestration — the sweep backends, the service and the Pareto
   search on the card, each held byte-equal to the sequential runs:
   ``devices:n=2`` and ``processes:n=4`` (four CUDA contexts time-sliced
   on one card) on phase 8's paper grid, against phase 8's JSON, walls
   beside phase 8's; ``hosts:channel=local,n=2,retries=1`` on phase 7's
   smoke grid, clean and with shard 0's first worker SIGKILLed
   (``inject_kill=0``: one ``crash`` attempt, its retry on the other
   slot), against phase 7's JSON; the sweep service on ``127.0.0.1:0``
   (``inline`` backend, on the card): a streamed run, a cache hit
   (``cached: true``) and a stream resumed across one-event connections
   (``max_events=1``), each against phase 7's JSON, and the hit in
   ``/v1/metrics``; the ``pareto`` preset at its defaults (24 windows, 2
   seeds, full data) under ``exhaustive`` and
   ``halving:rungs=3,keep=0.5``: equal
   frontier labels, each ``frontier_result`` byte-equal to a plain run of
   ``frontier_spec``, a candidate pruned before the last rung, walls,
   window-evaluation ``cost`` and ``loo_trials`` launches per search;
8g. city_shards — the city's DC axis split over worlds of 2 and then 4
   ranks (``run_city``'s sharded path: ``dc_shards`` over ``fleet_mesh``),
   each rank a fresh interpreter started by ``multiprocessing``'s spawn
   (never forked: the parent holds a CUDA context), all on ``cuda:0``
   under ``gloo`` with a file store in a temporary directory (NCCL refuses
   two ranks on one device; four CUDA contexts time-slice the card, as 8f's
   ``processes:n=4`` do); a sharded window runs eagerly. Each world runs
   the 40-DC city with ``CITY_SMALL``'s injected draw indices (centers
   equal to 8d's one-shard card run, F1 within 1e-4) and then the ``city``
   preset at its defaults at 2 windows with every rank a shard (the
   default ``max_shards``, the world size) and the default hash draw:
   centers and every ledger event equal to 8d's 2-window run, F1 within
   1e-4 (the card-vs-CPU bar), whether F1 is bitwise equal and, if not,
   the first window whose confusion counts differ (cuBLAS may pick another
   ``bmm`` kernel for another batch of DCs); per world the wall (each
   rank's, from a barrier), each rank's peak device memory, collectives
   per window (``all_reduce``) beside the one final broadcast, graph
   replays (none) and each rank's ``loo_trials_step`` launches (each
   rank runs the center's refine, replicated: > 0 on every rank). A rank
   that fails fails the world at once; no rank outlives the phase;
8e. loo_shapes — every (L, R, D, M) that phases 7-8d, the in-process
   runs of 8f (devices, service, Pareto) and 8g's ranks gave the
   ``loo_trials`` wrappers (a graph's at its capture) is a row of phases 3
   and 3b (printed after 8g; the worker processes of 8f run the
   sequential run's shapes);
9.-16. serve — llama3.2-3b, mamba2-1.3b, recurrentgemma-9b, olmoe-1b-7b,
   minicpm3-4b, deepseek-v3-671b, llava-next-mistral-7b and whisper-medium,
   one at a time, each at full width in bfloat16 (weights from the port's
   seeded initialiser) and freed before the next loads; every one at full
   depth but deepseek, cut to its 3 dense-MLP layers and 1 MoE layer,
   without its MTP block (``SERVES[...]["cut"]``, PERF.md §4):
   ``ServeEngine.generate`` on 4 prompts of 2048 tokens (32 new; llava's
   after 2880 frontend embeddings, whisper's 224 tokens after a 24-layer
   encoder over 1500 frames), then, for the text-only families, a
   ``ContinuousBatcher`` with 4 slots answering 8 requests of mixed
   lengths; the main-path runs whose kernel launches are counted
   (``flash_attention`` 28 per llama prefill, 12 per recurrentgemma, 16
   per olmoe, 32 per llava, 48 per whisper (24 encoder + 24 decoder);
   ``ssd_scan`` 48 per mamba2 prefill, ``rglru_scan`` 26 per
   recurrentgemma prefill; MLA runs no kernel), for every prefill, and
   ``decode_attention``'s, one a layer for every decode step of the run
   where the decoder attends through a K/V buffer (llama, olmoe, llava,
   whisper; none for MLA, SSM and the hybrid's window cache), the
   replays' launches read from ``decode_graph_stats()``: the
   set-up captures the prefill graph of each of the run's (batch, bucket)
   (``models/prefill_graph.py``), so the run's prefills are replays (or
   eager, where the family is refused), and a replay's launches are the
   ones its graph captured, which the graph's counts add up. Then, not
   counted:
   prefill logits with the kernels against the plain versions swapped in
   (where the path has a kernel; the eager body, as a replay would run
   the kernels it captured), one-step decode against a full prefill
   (the MoE families at capacity factor 8, as the reference's test), and
   each kernel's share of prefill device time (``torch.profiler``);
17. reduced — the reduced configs of those eight archs (recurrentgemma with
   5 layers: one period with attention, two tail layers) in float32, the
   port on the card against the port on the CPU with the same weights;
18. train — llama3.2-3b at full width and depth in bfloat16 with its
   config's ``remat="full"`` (per-layer recomputation): 8 AdamW steps of
   ``launch.train.make_train_step`` under ``train_loop``'s schedule (20
   warmup steps) at a peak lr of 1e-4 (``TRAIN_PEAK_LR``: its 1e-3
   overshoots at this width) on ``TokenStream`` batches of 4 x 2048;
   per step loss, gnorm, lr and ms, then tokens/s (median step after the
   first) and peak device memory; every loss and gnorm finite, the mean
   of the last two losses below the first, and no kernel launched (the
   loss takes the plain route of every mixer: the kernels have no
   backward);
19. train_card_vs_cpu — reduced llama3.2-3b and deepseek-v3-671b (MoE,
   MLA, MTP) in float32, one seed: the loss within 1e-5 relative and every
   gradient within 1e-4 of its leaf's max |g| (+1e-9) of the CPU's;
20. train_resume — reduced llama3.2-3b on the card: 4 steps and a
   checkpoint, a resume to 8 (finite, and not the uninterrupted run's
   parameters: the stream is reseeded, as ``tests/test_train_resume.py``
   asserts); the checkpoint loads bit for bit into a fresh model and
   optimizer state, and a save of those loads back bit for bit;
21. htl — the hypothesis-transfer trainer with the reference driver's
   model (``examples/train_htl_lm.py``: 12 layers x 768, vocab 32768,
   float32, ~100M parameters), 4 collectors, 8 local steps, 8 sequences
   of 256 per step split over the collectors: 4 rounds each of ``sync``,
   ``star`` and ``a2a`` (``"gd"`` mixing, 4 steps), their round losses,
   seconds per round and ``round_traffic_bytes``; losses finite and
   falling, every DC's hypothesis identical after each transfer;
22. validate — ``launch.validate`` on the 1x1 host mesh for every arch x
   shape, with ``HBM_BYTES`` held equal to this card's total memory, and
   llama3.2-3b's train state fitting and within 5% of the 38.5 GB PR 22
   measured;
23. dryrun — ``python -m repro_torch.launch.dryrun`` for llama3.2-3b
   ``decode_32k`` on pod1 in its own process (256 ranks on the fake
   backend, DTensor placements, meta shards): ``status`` ok, 256 devices,
   FLOPs > 0;
24. roofline — each served prefill and llama's train step traced on meta
   tensors (``roofline.trace.analyze_trace``, the plain route with the
   mixer regions' counts from ``roofline.costs``), the roofline terms on
   the H100's peaks and the dominant one, beside the measured device time
   and measured / roofline; and the reduced llama, mamba2 and
   recurrentgemma traced on the kernel route (a card model) and on the
   plain route: equal FLOPs.

Then the whole script's seconds, the ``{"kernels": [...]}`` line (the
four ported kernels, the fused step as a fifth line of the
``loo_trials`` source, and ``decode_attention``; ``launches`` is phase
8's count for ``loo_trials``, the serve phases' for the others; the
``loo_trials``
lines add ``launches_by_path`` for phases 8, 8c, 8d, each Pareto
search of 8f and each world of 8g (its ranks' launches summed), the flash
line one entry per served arch)
and, last, the ``{"ok": true, ...}`` line. Imports neither JAX nor the JAX
package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The kernels' work counts and their bound on the H100's peaks (the
# kernel rows; the same counts are the roofline phase's mixer regions).
from repro_torch.roofline.costs import (  # noqa: E402,F401
    bound, decode_attention_cost, flash_cost, flash_pairs, kernel_cost,
    rglru_cost, ssd_cost, step_cost,
)

KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
ENERGY_RTOL = 1e-6
# Scan engine against fleet engine, and the small city card against CPU:
# the reference's fleet-vs-loop bar (tests/test_fleet_engine.py:38).
SCAN_F1_ATOL = 1e-4
# The city phase: the reference's city_smoke.py gates (peak memory growth
# from 2 to 6 windows, final F1 sanity floor).
CITY_WINDOWS = (2, 6)
CITY_MEMORY_RATIO = 1.15
CITY_F1_FLOOR = 0.15
CITY_SMALL = dict(windows=3, eval_every=1, algo="star", engine="scan",
                  tech="wifi", fleet_size=40, obs_per_dc=4, train_iters=5)
# Phase 8g: the city's DC axis over worlds of 2 and 4 ``gloo`` ranks, all
# on one card (NCCL refuses two ranks on one device), each rank a spawned
# interpreter; the city preset at phase 8d's first window count, and the
# seconds a world may take (the ranks' collectives time out then too).
CITY_SHARD_WORLDS = (2, 4)
CITY_SHARD_WINDOWS = CITY_WINDOWS[0]
CITY_SHARD_TIMEOUT_S = 300
# The one scenario of the paper grid that phase 8c profiles on both engines
# (an A2A label: a refine at every DC), at a few windows to keep the
# profiler's bookkeeping short.
PROFILE_LABEL, PROFILE_WINDOWS = "table3_a2a_4g", 5
# Bound on |F1_port - F1_golden| for converged F1 and per-window F1 (see
# PERF.md, "F1 bound"): the port and the JAX reference agree exactly on
# every host-side quantity, but a float32 rounding difference can flip a
# hinge-subgradient kink or a test prediction, which moves an F1 value by
# a few 1e-4; the CPU comparison of the two packages stays below 2e-3.
F1_ATOL = 5e-3
GRID_SHAPES = [(L, R, D, 16) for L in (1, 8, 16, 32)
               for R in (1, 112, 448, 1120) for D in (11, 23)]
# The (L, R, D, M) shapes that phases 7-8d give the loo_trials wrappers
# beyond GRID_SHAPES: the fleet engine's DC groups of 2, 4, 64 and 96, and
# the city's one refine over its center's obs_per_dc x 7 rows. The
# ``loo_shapes`` phase fails if those phases launch a shape that is not a
# KERNEL_SHAPES row.
MAIN_PATH_SHAPES = [(1, 28, 23, 16), (2, 112, 23, 16), (2, 448, 23, 16),
                    (2, 1120, 23, 16), (4, 112, 23, 16), (4, 448, 23, 16),
                    (4, 1120, 23, 16), (64, 112, 23, 16), (64, 448, 23, 16),
                    (96, 112, 23, 16)]
KERNEL_SHAPES = GRID_SHAPES + MAIN_PATH_SHAPES
HEADLINE_SHAPE = (16, 1120, 23, 16)
# Phase 8f: the backends held byte-equal to phase 8 (paper grid) and to
# phase 7 (smoke grid), the service's backend, and the Pareto searches on
# the ``pareto`` preset at its defaults.
ORCH_BACKENDS = ("devices:n=2", "processes:n=4")
ORCH_HOSTS = "hosts:channel=local,n=2,retries=1"
SERVICE_BACKEND = "hosts:channel=inline,n=2"
PARETO_HALVING = "halving:rungs=3,keep=0.5"
PARETO_SEARCHES = ("exhaustive", PARETO_HALVING)
# The preset's defaults. Cut to 12 windows and 1 seed (to keep the script
# near 220 s), the halving search pruned ``star_wifi``, a member of the
# exhaustive frontier, before its last rung, so the cut defeats the
# frontier check and the phase keeps the defaults (PERF.md §6).
PARETO_GRID = {"windows": 24, "n_seeds": 2}
TIMING_REPS = 60
# Each GRID_SHAPES row's time (us) under the first loo_trials kernel (one
# block per DC, rows read straight from device memory), before the
# cluster redesign (PERF.md §6; chip_smoke on an H100 80GB HBM3, 700 W);
# the MAIN_PATH_SHAPES rows were not timed then.
LOO_EARLIER_US = dict(zip(GRID_SHAPES, [
    7.74, 8.53, 9.92, 11.39, 14.72, 17.57, 28.1, 34.59, 9.47, 10.37, 9.98,
    11.49, 14.88, 17.6, 28.16, 34.78, 9.57, 10.34, 9.95, 11.49, 14.94,
    17.63, 28.22, 34.94, 9.6, 10.34, 10.05, 11.62, 15.04, 17.86, 28.51,
    35.41]))

# flash_attention: the JAX sweep's bounds (tests/test_kernels.py:15)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_REPS = 10
# The bf16 tensor-core flash kernel, one instantiation per head dim; none
# may spill (ptxas report of the build).
FLASH_TC_KERNEL = "flash_attention_wgmma_kernel"
# The serve phases: each model at full width and depth, bfloat16.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
BATCHER_PROMPTS = (64, 129, 250, 511, 777, 1024, 1500, 2000)
BATCHER_BUDGETS = (32, 8, 24, 16, 32, 12, 20, 28)
# recurrentgemma's batcher: prompts at least its 2048 attention window (a
# shorter prompt gets a window cache that rolls too early and cannot be
# spliced beside one of another length, in both packages: ROADMAP Queue 3)
HYBRID_PROMPTS = (2048, 2100, 2300, 2500, 2650, 2800, 2900, 3000)
BATCHER_SLOTS = 4
# whisper's decoder prompt: within its 448-token decoder context
# (``max_decode_kv``) with the 32 new tokens
AUDIO_PROMPT = 224
# The MoE families' decode-vs-prefill check runs at this capacity factor,
# as the reference's tests/test_decode_equivalence.py does: capacity drops
# depend on the token set, so only a drop-free dispatch can agree.
MOE_CHECK_CAPACITY = 8.0
# Per served arch: its batcher's prompts and cache budget (None: the
# family has no batcher, as in the reference), its generate prompt length,
# cuts of its config (``cut``, PERF.md §4), the launches of each kernel of
# its prefill per prefill call, and the bound on the relative logit error
# (max |a - b| / max |b|) between two bfloat16 runs of the full model:
# kernels vs plain versions in prefill, and one-step decode vs prefill.
# Each bound is set from the bfloat16 drift measured against a float32
# twin on the same weights (scripts/torch_serve_numerics.py on the H100;
# PERF.md): two bfloat16 runs may lie up to twice that drift apart
# (rounded up to two digits). Drift, and kernels vs plain in float32:
# llama3.2-3b 5.2e-2 (1.7e-5), mamba2-1.3b 5.73e-2 (9.7e-6),
# recurrentgemma-9b 3.79e-2 (8.2e-6); the largest of the four bf16 vs f32
# errors the script prints: olmoe-1b-7b 2.92e-2 (4.6e-5), minicpm3-4b
# 6.68e-2, deepseek-v3-671b 1.54e-2 (at batch 1: its float32 twin takes 60
# GB), llava-next-mistral-7b 6.24e-2 (2.1e-5), whisper-medium 1.81e-2
# (1.4e-6); MLA runs no kernel.
SERVES = {
    "llama3.2-3b": dict(prompts=BATCHER_PROMPTS, max_len=2112,
                        per_prefill={"flash_attention": 28},
                        logit_rtol=1e-1),
    "mamba2-1.3b": dict(prompts=BATCHER_PROMPTS, max_len=2112,
                        per_prefill={"ssd_scan": 48}, logit_rtol=1.2e-1),
    "recurrentgemma-9b": dict(prompts=HYBRID_PROMPTS, max_len=3072,
                              per_prefill={"rglru_scan": 26,
                                           "flash_attention": 12},
                              logit_rtol=7.6e-2),
    "olmoe-1b-7b": dict(prompts=BATCHER_PROMPTS, max_len=2112,
                        per_prefill={"flash_attention": 16},
                        logit_rtol=5.9e-2),
    "minicpm3-4b": dict(prompts=BATCHER_PROMPTS, max_len=2112,
                        per_prefill={}, logit_rtol=1.4e-1),
    # 4 of 61 layers: the 3 dense-MLP layers and 1 MoE layer; no MTP block
    "deepseek-v3-671b": dict(prompts=BATCHER_PROMPTS, max_len=2112,
                             per_prefill={}, logit_rtol=3.1e-2,
                             cut=dict(num_layers=4, num_mtp_modules=0)),
    "llava-next-mistral-7b": dict(prompts=None,
                                  per_prefill={"flash_attention": 32},
                                  logit_rtol=1.3e-1),
    "whisper-medium": dict(prompts=None, prompt=AUDIO_PROMPT,
                           per_prefill={"flash_attention": 48},
                           logit_rtol=3.7e-2),
}
# The reduced configs in float32, card against CPU: other summation orders.
REDUCED_LOGIT_RTOL = 1e-5
REDUCED = (("llama3.2-3b", None), ("mamba2-1.3b", None),
           ("recurrentgemma-9b", 5),      # 1 period (attention) + 2 tail
           ("minicpm3-4b", None), ("olmoe-1b-7b", None),
           ("deepseek-v3-671b", None), ("llava-next-mistral-7b", None),
           ("whisper-medium", None))
# (B, H, KV, Sq, Skv, d, causal, window, q_offset, dtype); the first one is
# the headline (llama's generate prefill), then llama's batcher, then
# recurrentgemma's MQA local attention (head_dim 256, window 2048): its
# generate prefill and its batcher; then olmoe's MHA (generate, batcher),
# llava's 2880 image + 2048 text positions, and whisper's non-causal
# encoder over 1500 frames (ragged against the tiles) and causal decoder.
FLASH_MAIN = [(SERVE_BATCH, 24, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, 0,
               0, "bfloat16")] + [(1, 24, 8, n, n, 128, True, 0, 0,
                                   "bfloat16") for n in BATCHER_PROMPTS] + [
    (SERVE_BATCH, 16, 1, SERVE_PROMPT, SERVE_PROMPT, 256, True, 2048, 0,
     "bfloat16")] + [(1, 16, 1, n, n, 256, True, 2048, 0, "bfloat16")
                     for n in HYBRID_PROMPTS] + [
    (SERVE_BATCH, 16, 16, SERVE_PROMPT, SERVE_PROMPT, 128, True, 0, 0,
     "bfloat16")] + [(1, 16, 16, n, n, 128, True, 0, 0, "bfloat16")
                     for n in BATCHER_PROMPTS] + [
    (SERVE_BATCH, 32, 8, 4928, 4928, 128, True, 0, 0, "bfloat16"),
    (SERVE_BATCH, 16, 16, 1500, 1500, 64, False, 0, 0, "bfloat16"),
    (SERVE_BATCH, 16, 16, AUDIO_PROMPT, AUDIO_PROMPT, 64, True, 0, 0,
     "bfloat16")]
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
# decode_attention (B, S, H, KV, d, dtype): olmoe-1b-7b chat's buffer (64
# slots x 1,537 positions) and long-prompt's (16 x 3,043), llama3.2-3b's
# GQA (G 3) at its batcher's max_len, whisper-medium's decoder (d 64), and
# reduced float32 shapes (G 2 and 8). Each slot's depth is drawn at
# random, 0 and S - 1 among them.
DECODE_ATTN_SHAPES = [(64, 1537, 16, 16, 128, "bfloat16"),
                      (16, 3043, 16, 16, 128, "bfloat16"),
                      (4, 2112, 24, 8, 128, "bfloat16"),
                      (4, 256, 16, 16, 64, "bfloat16"),
                      (2, 40, 4, 2, 32, "float32"),
                      (3, 300, 16, 2, 64, "float32")]
# (rtol, atol) of |kernel - plain| <= atol + rtol * |plain|, elementwise.
# Both round the same float32 attention to the output type once, so in
# bfloat16 they differ by at most one bf16 step (2^-7 of the value) plus
# float32 summation order; in float32 by summation order alone (flash's
# 2e-5).
DECODE_ATTN_TOL = {"float32": (0.0, 2e-5), "bfloat16": (2 ** -7, 1e-5)}
# The kernel's keys per block (``decode_attention_split()``): the planted
# fault leaves the first such split of keys out.
DECODE_ATTN_SPLIT = 256
# The timed rows: (shape index, depths) with the depths of the closed loop
# under a benchmark mix (``perfbench/mixes/<mix>.json``: a slot's prompt
# plus a uniform share of its budget, slots drawn in proportion to their
# budget: mean 482 in chat) or a full buffer.
DECODE_ATTN_TIMED = [(0, "chat"), (0, "full"), (1, "long-prompt"),
                     (1, "full"), (2, "full")]

# ssd_scan: the JAX sweep's bounds (tests/test_kernels.py:75), relative to
# the largest |value| of y and of the final state.
SSD_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
# (B, S, H, P, N, chunk, dtype): mamba2-1.3b's generate prefill (the
# headline), its batcher's prompts (B 1, ragged against the chunk), the
# headline in float32, and the JAX sweep's four shapes in both dtypes.
SSD_TEST_SHAPES = [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 64, 128),
                   (2, 512, 8, 64, 128, 128), (1, 256, 1, 128, 16, 32)]
SSD_SHAPES = [(SERVE_BATCH, SERVE_PROMPT, 64, 64, 128, 256, "bfloat16")] + [
    (1, n, 64, 64, 128, 256, "bfloat16") for n in BATCHER_PROMPTS] + [
    (SERVE_BATCH, SERVE_PROMPT, 64, 64, 128, 256, "float32")] + [
    s + (dt,) for dt in ("float32", "bfloat16") for s in SSD_TEST_SHAPES]
# rglru_scan: the JAX sweep's float32 bound (tests/test_kernels.py:96),
# absolute; the kernel takes float32 only, as the model's gates give it.
RGLRU_TOL = 1e-4
# (B, S, W): recurrentgemma-9b's generate prefill (the headline), its
# batcher's prompts, and the JAX sweep's four shapes.
RGLRU_SHAPES = [(SERVE_BATCH, SERVE_PROMPT, 4096)] + [
    (1, n, 4096) for n in HYBRID_PROMPTS] + [
    (2, 256, 256), (1, 128, 128), (3, 512, 384), (1, 64, 512)]
# (B, S, W, offset): a time axis that takes many cluster windows, widths
# off the 4-float (16-byte) grain, and views that start `offset` floats
# into each row of a wider tensor (a misaligned base: the cp.async route).
RGLRU_EXTRA = [(1, 20000, 256, 0), (2, 300, 77, 0), (1, 2048, 4094, 0),
               (2, 1000, 384, 1), (1, 2048, 4096, 1)]
# Each row's time (us) under the two-pass kernel of PRs 13-20, RGLRU_SHAPES
# then RGLRU_EXTRA (scripts/torch_rglru_plan.py --parent, in turns with the
# one-pass kernel's first version; H100 80GB HBM3, 700 W).
RGLRU_EARLIER_US = [237.8, 72.6, 73.8, 79.3, 86.1, 90.7, 95.6, 99.2, 102.6,
                    9.5, 7.5, 13.6, 7.2, 383.0, 11.0, 76.5, 21.5, 75.9]
# The rglru_scan kernel's instantiations (channel group, TMA route); none
# may spill.
RGLRU_KERNELS = tuple(f"rglru_scan_kernel<{g},{t}>" for g in (32, 64)
                      for t in (0, 1))
SCAN_REPS = 10
# The bf16 tensor-core ssd_scan kernels (ptxas labels); none may spill.
SSD_TC_KERNELS = ("ssd_chunk_state_kernel<64>", "ssd_chunk_state_kernel<128>",
                  "ssd_state_pass_kernel", "ssd_chunk_scan_kernel<64>",
                  "ssd_chunk_scan_kernel<128>")
# Each SSD_SHAPES row's time (us) under the CUDA-core kernel alone, before
# the tensor-core route existed (PERF.md §6; H100 80GB HBM3, 700 W).
SSD_EARLIER_US = [3180.8, 35.9, 117.7, 190.3, 378.5, 588.4, 742.9, 1113.8,
                  1505.9, 3178.8, 80.0, 49.6, 278.0, 207.8, 81.2, 50.7,
                  271.0, 205.3]
# The device kernels a wrapper launches, by name, where its own name is not
# part of theirs (profiler shares).
DEVICE_KERNELS = {"ssd_scan": ("ssd_scan_kernel", "ssd_chunk_state_kernel",
                               "ssd_state_pass_kernel",
                               "ssd_chunk_scan_kernel")}
# The loo_trials kernel's instantiations (D bucket, fused prologue); none
# may spill.
LOO_KERNELS = tuple(f"loo_trials_kernel<{d},{s}>" for d in (16, 32, 64, 128)
                    for s in (0, 1))
# The decode_attention kernel's bf16 instantiations (head dim, query heads
# per KV head up to 1, 2, 4, 8); none may spill.
DECODE_ATTN_KERNELS = tuple(f"decode_attention_kernel<bf16,{d},{g}>"
                            for d in (32, 64, 128) for g in (1, 2, 4, 8))
# The TPU kernel (Pallas body, file:line) each CUDA kernel replaces.
REPLACES = {"loo_trials": "src/repro/kernels/loo_trials.py:51",
            "loo_trials_step": "src/repro/kernels/loo_trials.py:51",
            "flash_attention": "src/repro/kernels/flash_attention.py:25",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:22",
            "rglru_scan": "src/repro/kernels/rglru_scan.py:21",
            "decode_attention": "none: the JAX package decodes through "
                                "einsums (src/repro/models/model.py)"}


# The training phases. ``train``: llama3.2-3b at full width and depth in
# bfloat16 with its config's ``remat="full"``, TRAIN_STEPS AdamW steps of
# make_train_step on TokenStream batches of TRAIN_BATCH x TRAIN_SEQ (the
# serve headline's tokens), under train_loop's schedule (20 warmup steps,
# cosine to total_steps) at a peak lr of TRAIN_PEAK_LR, not its 1e-3: at
# this width the first nonzero step of that schedule (5e-5) overshoots
# from the seeded weights (the loss rose 12.32 -> 13.63 over 8 steps),
# while the bf16 gradient is within cos 0.999 of a float32 twin's and one
# step of 2e-5 takes the loss to 10.48 (scripts/torch_train_probe.py on
# the H100; PERF.md, PR 22).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "llama3.2-3b", 4, 2048, 8
TRAIN_PEAK_LR = 1e-4
# ``train_card_vs_cpu``: reduced configs in float32, the loss within 1e-5
# relative and every gradient within 1e-4 of its leaf's max |g| (+1e-9:
# leaves the loss does not depend on give rounding noise), the CPU tests'
# bounds against JAX; expected: float32 reduction order only, ~1e-5.
TRAIN_REDUCED = ("llama3.2-3b", "deepseek-v3-671b")
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-5, 1e-4, 1e-9
# ``htl``: the reference's end-to-end driver's model
# (examples/train_htl_lm.py:make_cfg(small=False): 12 layers x 768, vocab
# 32768, float32, ~100M parameters), L collectors, H local steps, 8
# sequences of 256 per step split over the collectors, HTL_ROUNDS rounds
# of each mode, the example's mixing steps and optimizer.
HTL_COLLECTORS, HTL_LOCAL, HTL_SEQS, HTL_SEQ, HTL_ROUNDS = 4, 8, 8, 256, 4
HTL_MIXING_STEPS = 4
# ``validate``: llama3.2-3b's train state (bf16 weights and gradients,
# float32 moments) on the 1x1 host mesh against the 38.5 GB PR 22's train
# phase held (PERF.md, PR 22), within 5%.
VALIDATE_TRAIN_STATE_BYTES, VALIDATE_RTOL = 38.5e9, 0.05
# ``dryrun``: one combo of launch/dryrun.py in its own process (a fake
# world of 256 ranks on the fake backend, DTensor placements).
DRYRUN_COMBO = ("llama3.2-3b", "decode_32k", "pod1")
DRYRUN_TIMEOUT_S = 300
# ``roofline``: the reduced configs whose traced FLOPs must agree between
# the kernel route (a card model) and the plain route (the mixer regions
# count the same work either way); recurrentgemma with 5 layers, so a
# period with attention runs.
ROOFLINE_REDUCED = {"llama3.2-3b": None, "mamba2-1.3b": None,
                    "recurrentgemma-9b": 5}
HTL_MODES = ("sync", "star", "a2a")


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


def first_step(L, R, D, M, seed):
    """The incremental refine's carries at its first greedy step (bias-only
    factor in the first 7 of D slots), from a random ridge system:
    realistic magnitudes (leverage below 1). The last DC of a fleet is a
    padding DC (all-zero rows and rmask). A dict of CPU tensors."""
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
    z = torch.zeros((L, D))
    z[:, :C] = zb[:, :, 0]
    return {"ut": ut, "cc": cc, "a_cand": A_rm[:, :, :M],
            "fitted": (Utb @ zb)[:, :, 0], "h": torch.sum(Utb ** 2, dim=-1),
            "y": y, "rmask": rmask,
            "diag_g": torch.diagonal(AtA, dim1=1, dim2=2)[:, :M] + lam_d[:M],
            "aty_m": Aty[:, :M], "z": z}


def _on(device, args):
    return tuple(a.contiguous().to(device) for a in args)


def kernel_inputs(L, R, D, M, seed, device):
    """``loo_trials``' arguments at the first greedy step (:func:`first_step`)
    with every fifth candidate masked (dinv = 0)."""
    s = first_step(L, R, D, M, seed)
    dsq = s["diag_g"] - torch.sum(s["cc"] ** 2, dim=1)
    dinv = torch.rsqrt(torch.clamp(dsq, min=1e-8))
    dinv[:, ::5] = 0.0
    zj = (s["aty_m"] - (s["cc"].transpose(1, 2) @ s["z"][:, :, None])
          [:, :, 0]) * dinv
    return _on(device, (s["ut"], s["cc"], s["a_cand"], s["fitted"], s["h"],
                        s["y"], s["rmask"], zj, dinv))


def step_inputs(L, R, D, M, seed, device):
    """``loo_trials_step``'s arguments at the first greedy step
    (:func:`first_step`): every fifth candidate already selected (dinv =
    0), and every tenth source masked out (selected but not active)."""
    s = first_step(L, R, D, M, seed)
    sel = torch.zeros((L, M))
    sel[:, ::5] = 1.0
    src_mask = torch.ones((L, M))
    src_mask[:, ::10] = 0.0
    return _on(device, (s["ut"], s["cc"], s["a_cand"], s["fitted"], s["h"],
                        s["y"], s["rmask"], s["diag_g"], s["aty_m"], s["z"],
                        sel, src_mask))


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


def floor_us() -> float:
    """The device time of the most trivial launch (a one-cycle sleep
    kernel), timed as every kernel here is: the floor under any row."""
    return device_time_us(lambda: torch.cuda._sleep(1), ())


def phase_kernel(loo):
    t0 = time.perf_counter()
    rows, worst = [], 0.0
    floor = floor_us()
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
        bound_us, bound_by = bound(*kernel_cost(L, R, D, M), "float32")
        rows.append({"L": L, "R": R, "D": D, "M": M, "max_abs_err": err,
                     "cluster": loo.launch_plan(L, R, D, M).cluster,
                     "kernel_us": device_time_us(loo.loo_trials, args),
                     "earlier_us": LOO_EARLIER_US.get((L, R, D, M)),
                     "plain_us": device_time_us(loo.loo_trials_ref, args),
                     "bound_us": bound_us, "bound_by": bound_by})
    emit({"phase": "kernel", "kernel": "loo_trials", "rtol": KERNEL_RTOL,
          "atol": KERNEL_ATOL, "max_abs_err": worst, "floor_us": floor,
          "seconds": time.perf_counter() - t0, "shapes": rows})
    return rows, worst


def phase_step(loo):
    """The fused greedy step against its plain version at every
    KERNEL_SHAPES row: objs, dinv and zj within the kernel tolerance, two
    launches bitwise equal, and times of kernel, plain version and bound."""
    t0 = time.perf_counter()
    rows, worst = [], 0.0
    for i, (L, R, D, M) in enumerate(KERNEL_SHAPES):
        args = step_inputs(L, R, D, M, seed=400 + i, device="cuda")
        out = loo.loo_trials_step(*args)
        out2 = loo.loo_trials_step(*args)
        ref = loo.loo_trials_step_ref(*args)
        torch.cuda.synchronize()
        err = 0.0
        for name, a, b, c in zip(("objs", "dinv", "zj"), out, out2, ref):
            check(torch.equal(a, b), f"loo_trials_step {name} not bitwise "
                                     f"deterministic at {(L, R, D, M)}")
            check(bool(torch.isfinite(a).all()),
                  f"loo_trials_step {name} non-finite at {(L, R, D, M)}")
            check(torch.allclose(a, c, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
                  f"loo_trials_step {name} vs plain at {(L, R, D, M)}: max "
                  f"abs err {float((a - c).abs().max())}")
            err = max(err, float((a - c).abs().max()))
        worst = max(worst, err)
        bound_us, bound_by = bound(*step_cost(L, R, D, M), "float32")
        rows.append({"L": L, "R": R, "D": D, "M": M, "max_abs_err": err,
                     "kernel_us": device_time_us(loo.loo_trials_step, args),
                     "plain_us": device_time_us(loo.loo_trials_step_ref,
                                                args),
                     "bound_us": bound_us, "bound_by": bound_by})
    emit({"phase": "loo_trials_step", "kernel": "loo_trials_step",
          "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, "max_abs_err": worst,
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
        kernel_us = device_time_us(
            lambda: fa.flash_attention_bshd(q, k, v, **kw), (), FLASH_REPS)
        plain_us = device_time_us(
            lambda: fa.flash_attention_bshd_ref(q, k, v, **kw), (),
            FLASH_REPS)
        library_us = None
        if (shape[7] == 0 or shape[7] >= shape[4]) and shape[8] == 0:
            # no window, or one that covers every key: plain causal
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            library_us = device_time_us(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=shape[6], enable_gqa=True), (),
                FLASH_REPS)
        rows.append({"shape": list(shape), "max_abs_err": err,
                     "kernel_us": kernel_us, "plain_us": plain_us,
                     "library_us": library_us})
        rows[-1]["bound_us"], rows[-1]["bound_by"] = bound(
            *flash_cost(shape), dtype)
    emit({"phase": "flash", "kernel": "flash_attention", "tol": FLASH_TOL,
          "max_abs_err": worst, "seconds": time.perf_counter() - t0,
          "shapes": rows})
    return rows, max(worst.values())


def decode_attention_inputs(shape, seed, device, depths=None):
    """q (B,1,H,d), ck/cv (B,S,KV,d) standard normal in the shape's dtype
    and a (B,) position tensor: ``depths``, or random ones with 0 and
    S - 1 among them."""
    B, S, H, KV, d, dtype = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, ck, cv = (torch.randn(s, generator=g, device=device).to(dt)
                 for s in ((B, 1, H, d), (B, S, KV, d), (B, S, KV, d)))
    if depths is None:
        depths = np.random.default_rng(seed).integers(0, S, B)
        depths[0], depths[-1] = 0, S - 1
    return q, ck, cv, torch.as_tensor(np.asarray(depths), dtype=torch.long,
                                      device=device)


def decode_attention_tol_use(out, ref, dtype):
    """max over elements of |out - ref| / (atol + rtol |ref|) under
    ``DECODE_ATTN_TOL[dtype]``: at most 1 within the limit."""
    rtol, atol = DECODE_ATTN_TOL[dtype]
    ref = ref.float()
    return float(((out.float() - ref).abs() / (atol + rtol * ref.abs()))
                 .max())


def split_left_out(q, ck, cv, pos, split=DECODE_ATTN_SPLIT):
    """The plain version with a planted fault: every slot deeper than one
    split attends without its first ``split`` keys, as a kernel that
    dropped a split's partials would."""
    B, _, H, d = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, KV, H // KV, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, ck.float()) / d ** 0.5
    p = pos.reshape(-1, 1, 1, 1)
    j = torch.arange(S, device=q.device)
    keep = (j <= p) & ((j >= split) | (p < split))
    s = s.masked_fill(~keep, float("-inf"))
    o = torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, -1), cv.float())
    return o.reshape(q.shape).to(q.dtype)


def mix_depths(B, S, mix, seed):
    """(B,) slot depths of a closed loop under the benchmark mix ``mix``
    (``perfbench/mixes/<mix>.json``, log-uniform prompts and outputs): a
    prompt plus a uniform share of an output budget, the budget drawn in
    proportion to its length (a slot holds a request for as many steps as
    its budget), at most S - 1."""
    with open(os.path.join(ROOT, "perfbench", "mixes", f"{mix}.json")) as f:
        spec = json.load(f)
    p_lo, p_hi = (spec["prompt_tokens"][k] for k in ("lo", "hi"))
    o_lo, o_hi = (spec["output_tokens"][k] for k in ("lo", "hi"))
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < B:
        o = np.exp(rng.uniform(np.log(o_lo), np.log(o_hi)))
        if rng.uniform() * o_hi > o:
            continue
        p = np.exp(rng.uniform(np.log(p_lo), np.log(p_hi)))
        out.append(min(int(p + rng.uniform() * o), S - 1))
    return np.array(out)


def phase_decode_attention(da):
    """``decode_attention`` against its plain version at every
    DECODE_ATTN_SHAPES row within DECODE_ATTN_TOL, the planted fault
    (:func:`split_left_out`) beyond it wherever a slot is deeper than a
    split, two launches bitwise equal, one launch counted a call; then
    kernel, plain version, SDPA (library, over the whole buffer with the
    depth mask; never on the path) and bound (the attended K/V rows read
    once) times at DECODE_ATTN_TIMED's rows."""
    t0 = time.perf_counter()
    check(da._launcher()[1] == DECODE_ATTN_SPLIT, "decode_attention split "
          f"{da._launcher()[1]} != DECODE_ATTN_SPLIT")
    rows = []
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, shape in enumerate(DECODE_ATTN_SHAPES):
        dtype = shape[-1]
        q, ck, cv, pos = decode_attention_inputs(shape, seed=i,
                                                 device="cuda")
        before = da.launches
        out = da.decode_attention(q, ck, cv, pos)
        out2 = da.decode_attention(q, ck, cv, pos)
        ref = da.decode_attention_ref(q, ck, cv, pos)
        torch.cuda.synchronize()
        check(da.launches == before + 2, f"decode_attention launches "
                                         f"{da.launches - before} != 2")
        check(torch.equal(out, out2),
              f"decode_attention not bitwise deterministic at {shape}")
        check(bool(torch.isfinite(out).all()), f"non-finite at {shape}")
        use = decode_attention_tol_use(out, ref, dtype)
        row = {"shape": list(shape),
               "max_abs_err": float((out.float() - ref.float()).abs().max()),
               "tol_use": use}
        check(use <= 1, f"decode_attention vs plain at {shape}: "
                        f"{use} of DECODE_ATTN_TOL")
        if int(pos.max()) >= DECODE_ATTN_SPLIT:
            fault = split_left_out(q, ck, cv, pos)
            row["fault_tol_use"] = decode_attention_tol_use(fault, ref,
                                                            dtype)
            row["fault_max_abs"] = float((fault.float() - ref.float())
                                         .abs().max())
            check(row["fault_tol_use"] > 1, f"DECODE_ATTN_TOL passes a "
                  f"split left out at {shape}: {row}")
        worst[dtype] = max(worst[dtype], row["max_abs_err"])
        rows.append(row)
        del q, ck, cv, out, out2, ref
    timed = []
    for i, (row, kind) in enumerate(DECODE_ATTN_TIMED):
        shape = DECODE_ATTN_SHAPES[row]
        B, S, H, KV, d, dtype = shape
        depths = np.full(B, S - 1) if kind == "full" else \
            mix_depths(B, S, kind, seed=i)
        q, ck, cv, pos = decode_attention_inputs(shape, seed=100 + i,
                                                 device="cuda",
                                                 depths=depths)
        kernel_us = device_time_us(
            lambda: da.decode_attention(q, ck, cv, pos), (), FLASH_REPS)
        plain_us = device_time_us(
            lambda: da.decode_attention_ref(q, ck, cv, pos), (), FLASH_REPS)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ck, cv))
        mask = (torch.arange(S, device="cuda") <= pos[:, None])[:, None,
                                                                None]
        library_us = device_time_us(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), (),
            FLASH_REPS)
        bound_us, bound_by = bound(*decode_attention_cost(
            H, KV, d, dtype, np.minimum(depths + 1, S)), dtype)
        timed.append({"shape": list(shape), "depths": kind,
                      "mean_depth": float(np.mean(depths)),
                      "kernel_us": kernel_us, "plain_us": plain_us,
                      "library_us": library_us, "bound_us": bound_us,
                      "bound_by": bound_by,
                      "bound_share": bound_us / kernel_us})
        del q, ck, cv, qt, kt, vt
    emit({"phase": "decode_attention", "kernel": "decode_attention",
          "tol": DECODE_ATTN_TOL, "max_abs_err": worst, "shapes": rows,
          "timed": timed, "seconds": time.perf_counter() - t0})
    return timed, max(worst.values())


def time_pair(fn, plain, reps=SCAN_REPS):
    return device_time_us(fn, (), reps), device_time_us(plain, (), reps)


def ssd_inputs(shape, seed, device):
    """The JAX sweep's inputs (tests/test_kernels.py:63-67): x normal in
    the dtype, dt = softplus(normal) in float32 (as the model gives it),
    A = -exp(normal / 2), B and C normal / 2 in the dtype."""
    B, S, H, P, N, _, dtype = shape
    g = torch.Generator(device=device).manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def randn(*s):
        return torch.randn(s, generator=g, device=device)
    return (randn(B, S, H, P).to(dt_),
            torch.nn.functional.softplus(randn(B, S, H)),
            -torch.exp(randn(H) * 0.5),
            (randn(B, S, N) * 0.5).to(dt_), (randn(B, S, N) * 0.5).to(dt_))


def phase_ssd(ss):
    t0 = time.perf_counter()
    rows, worst = [], {"float32": 0.0, "bfloat16": 0.0}
    for i, shape in enumerate(SSD_SHAPES):
        dtype, Q = shape[6], shape[5]
        args = ssd_inputs(shape, seed=300 + i, device="cuda")
        y, st = ss.ssd_scan(*args, chunk=Q)
        y2, st2 = ss.ssd_scan(*args, chunk=Q)
        yp, stp = ss.ssd_chunked(*args, Q)
        torch.cuda.synchronize()
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"ssd_scan not bitwise deterministic at {shape}")
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"ssd_scan non-finite at {shape}")
        err = max(rel_err(y, yp), rel_err(st, stp))
        check(err <= SSD_TOL[dtype], f"ssd_scan vs plain at {shape}: rel "
                                     f"err {err}")
        row = {"shape": list(shape), "route": "tensor_cores" if
               ss.tensor_core_route(args[0], args[3], args[4], Q) else
               "cuda_cores", "rel_err": err, "max_abs_err": max(
                   float((y.float() - yp.float()).abs().max()),
                   float((st.float() - stp.float()).abs().max())),
               "earlier_us": SSD_EARLIER_US[i]}
        if shape[:6] in SSD_TEST_SHAPES:
            yo, sto = ss.ssd_reference(*args)          # the sequential oracle
            row["rel_err_oracle"] = max(rel_err(y, yo), rel_err(st, sto))
            check(row["rel_err_oracle"] <= SSD_TOL[dtype],
                  f"ssd_scan vs oracle at {shape}: {row['rel_err_oracle']}")
        worst[dtype] = max(worst[dtype], err)
        row["kernel_us"], row["plain_us"] = time_pair(
            lambda: ss.ssd_scan(*args, chunk=Q),
            lambda: ss.ssd_chunked(*args, Q))
        row["bound_us"], row["bound_by"] = bound(*ssd_cost(shape), dtype)
        row["library_us"] = None
        rows.append(row)
    emit({"phase": "ssd", "kernel": "ssd_scan", "rtol": SSD_TOL,
          "rel_err": worst, "seconds": time.perf_counter() - t0,
          "shapes": rows})
    return rows, max(worst.values())


def rglru_inputs(shape, seed, device, offset=0):
    """The JAX sweep's inputs (tests/test_kernels.py:91-92), float32: a =
    sigmoid(normal), b = normal / 2. With ``offset``, views ``[..., offset:]``
    of (B, S, W + offset) tensors."""
    B, S, W = shape
    g = torch.Generator(device=device).manual_seed(seed)
    full = (B, S, W + offset)
    a = torch.sigmoid(torch.randn(full, generator=g, device=device))
    b = torch.randn(full, generator=g, device=device) * 0.5
    return a[..., offset:], b[..., offset:]


def rglru_rows():
    """(B, S, W, offset) of every row of the rglru phase: RGLRU_SHAPES,
    then RGLRU_EXTRA."""
    return [s + (0,) for s in RGLRU_SHAPES] + RGLRU_EXTRA


def phase_rglru(rg):
    t0 = time.perf_counter()
    rows, worst = [], 0.0
    for i, (B, S, W, offset) in enumerate(rglru_rows()):
        shape = (B, S, W)
        a, b = rglru_inputs(shape, seed=400 + i, device="cuda",
                            offset=offset)
        h = rg.rglru_scan(a, b)
        h2 = rg.rglru_scan(a, b)
        hp = rg.rglru_scan_ref(a, b)
        ho = rg.rglru_reference(a, b)                  # the sequential oracle
        torch.cuda.synchronize()
        check(torch.equal(h, h2),
              f"rglru_scan not bitwise deterministic at {shape}")
        check(bool(torch.isfinite(h).all()), f"rglru_scan non-finite at "
                                             f"{shape}")
        err = float((h - hp).abs().max())
        err_o = float((h - ho).abs().max())
        check(max(err, err_o) <= RGLRU_TOL,
              f"rglru_scan at {shape}: max abs err {err} (plain), {err_o} "
              f"(oracle)")
        worst = max(worst, err)
        plan = rg.launch_plan(B, S, W)
        row = {"shape": list(shape), "offset": offset,
               "route": "tma" if rg.tma_route(a, b, h) else "cp.async",
               "plan": plan._asdict(), "windows": plan.windows(S),
               "max_abs_err": err, "max_abs_err_oracle": err_o}
        row["kernel_us"], row["plain_us"] = time_pair(
            lambda: rg.rglru_scan(a, b), lambda: rg.rglru_scan_ref(a, b))
        row["bound_us"], row["bound_by"] = bound(*rglru_cost(shape),
                                                 "float32")
        row["bound_share"] = row["bound_us"] / row["kernel_us"]
        row["earlier_us"] = RGLRU_EARLIER_US[i]
        row["library_us"] = None
        rows.append(row)
    emit({"phase": "rglru", "kernel": "rglru_scan", "tol": RGLRU_TOL,
          "max_abs_err": worst, "seconds": time.perf_counter() - t0,
          "shapes": rows})
    return rows, worst


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


class PlainKernels:
    """Swaps the plain versions in for the kernels where the model calls
    them (``models.blocks.flash_attention_bshd``, ``models.ssd.ssd_scan``,
    ``models.rglru.rglru_scan``), for one comparison; the package itself
    has no switch."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import (
            flash_attention_bshd_ref)
        from repro_torch.kernels.rglru_scan import rglru_scan_ref
        from repro_torch.kernels.ssd_scan import ssd_chunked
        from repro_torch.models import blocks, rglru, ssd

        def ssd_plain(x, dt, A, Bm, Cm, *, chunk):
            return ssd_chunked(x, dt, A, Bm, Cm, chunk)

        def flash_plain(q, k, v, **kw):
            # one sequence at a time: llava's float32 scores at B = 4 x
            # 4928 positions would take 12 GB at once
            return torch.cat([flash_attention_bshd_ref(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw)
                for i in range(q.shape[0])])

        self.swaps = [(blocks, "flash_attention_bshd", flash_plain),
                      (ssd, "ssd_scan", ssd_plain),
                      (rglru, "rglru_scan", rglru_scan_ref)]
        self.orig = [getattr(m, n) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.swaps, self.orig):
            setattr(m, n, f)


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def batcher_requests(vocab, prompts, seed=1):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, n).astype(np.int64), budget)
            for i, (n, budget) in enumerate(zip(prompts, BATCHER_BUDGETS))]


def kernel_shares_of_prefill(model, batch, names):
    """Share of one prefill's device kernel time spent in each named
    kernel (``torch.profiler``), and that device time in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels)
    check(total > 0, "profiler saw no device time in prefill")
    return {n: sum(e.time_range.elapsed_us() for e in kernels
                   if any(k in e.name for k in DEVICE_KERNELS.get(n, (n,))))
            / total for n in names}, total / 1e3


def lm_batch(cfg, batch, seq, seed, device="cuda"):
    """``make_lm_batch`` with what the family's prefill takes beside the
    tokens: the frontend's embeddings (vlm) or the encoder's frames
    (audio), as the reference's serve launcher makes them."""
    from repro_torch.data.pipeline import make_lm_batch

    return make_lm_batch(
        cfg.vocab_size, batch, seq, seed=seed, d_model=cfg.d_model,
        frontend_tokens=(cfg.frontend.num_tokens
                         if cfg.family == "vlm" else 0),
        encoder_len=(cfg.encoder_seq_len if cfg.family == "audio" else 0),
        device=device)


def cache_len(batch) -> int:
    """Positions a prefill of ``batch`` fills: the tokens, after the
    frontend's embeddings for a vlm."""
    front = batch.get("frontend_embeds")
    return batch["tokens"].shape[1] + (0 if front is None
                                       else front.shape[1])


def decode_vs_prefill(model, batch):
    """(logits of a full prefill of all S + 1 tokens, logits of a prefill
    of the first S then one decode step at the next position), with the
    batch's frontend or encoder embeddings. The split prompt of S = 2048
    tokens keeps recurrentgemma's window cache full (a shorter one rolls
    too early: ROADMAP Queue 3). A MoE model runs both at capacity factor
    ``MOE_CHECK_CAPACITY`` (a copy of its config, the same weights)."""
    from repro_torch.serving import pad_cache

    cfg = model.cfg
    tokens = batch["tokens"]
    T = cache_len(batch) - 1
    if cfg.moe is not None:
        model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CHECK_CAPACITY))
    try:
        full, _ = model.prefill(batch)
        _, cache = model.prefill(dict(batch, tokens=tokens[:, :-1]))
        cache = pad_cache(model, cache, 1, tokens.shape[0], T)
        dec, _ = model.decode_step(cache, tokens[:, -1:], T)
    finally:
        model.cfg = cfg
    return full, dec


def serve_config(arch):
    """The served config: the registered one with the spec's cuts."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **SERVES[arch].get("cut",
                                                                    {}))


def buffered_decode_layers(cfg) -> int:
    """The layers of a decode step that attend through a K/V buffer, one
    ``decode_attention`` launch each: every layer of a dense, vlm, moe or
    audio decoder without MLA or a sliding window; none of an MLA, SSM or
    hybrid model."""
    buffered = (cfg.family in ("dense", "vlm", "moe", "audio")
                and cfg.mla is None and not cfg.sliding_window)
    return cfg.num_layers if buffered else 0


def phase_serve(arch, kernel_mods):
    """Serve ``arch`` at full width in bfloat16, at full depth unless its
    spec cuts it (module doc). ``kernel_mods``: {kernel name: wrapper
    module}; the counts of the kernels of this path are set to 0 just
    before its counted run and read just after."""
    from repro_torch.models import build_model
    from repro_torch.models import decode_graph as dg
    from repro_torch.models import prefill_graph as pg
    from repro_torch.serving import ServeEngine, pad_cache
    from repro_torch.serving.scheduler import ContinuousBatcher

    spec = SERVES[arch]
    prompt = spec.get("prompt", SERVE_PROMPT)
    t0 = time.perf_counter()
    cfg = serve_config(arch)
    model = build_model(cfg).init(seed=0)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    batch = lm_batch(cfg, SERVE_BATCH, prompt, seed=0)
    # warm-up outside the counted run: cuBLAS handles, allocator
    warm = {k: v[:1, :64] if k != "encoder_embeds" else v[:1]
            for k, v in batch.items()}
    _, c = model.prefill(warm)
    model.decode_step(pad_cache(model, c, 1, 1, cache_len(warm)),
                      warm["tokens"][:, :1], cache_len(warm))
    del c
    # the prefill graphs of the counted run's shapes, so that it replays
    reqs = batcher_requests(cfg.vocab_size, spec["prompts"]) \
        if spec["prompts"] else []
    model.prefill(batch)
    for r in {len(r.tokens): r for r in reqs}.values():
        model.prefill({"tokens": torch.as_tensor(r.tokens[None]).to(
            model.device)})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # --- the main-path run: counts from 0 just before, read just after ---
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_mods.values():
        mod.reset_launches()
    pg.reset_prefill_graph_stats()
    dg.reset_decode_graph_stats()
    steps, bat_s = 0, None
    with PrefillTally(model) as tally:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen = ServeEngine(model, max_new_tokens=SERVE_NEW).generate(batch)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t1
        gen_prefill_s = tally.seconds
        if reqs:
            batcher = ContinuousBatcher(model, slots=BATCHER_SLOTS,
                                        max_len=spec["max_len"])
            for r in reqs:
                batcher.submit(r)
            t2 = time.perf_counter()
            while batcher.step():
                steps += 1
            torch.cuda.synchronize()
            bat_s = time.perf_counter() - t2
            del batcher
    graphs, dgraphs = pg.prefill_graph_stats(), dg.decode_graph_stats()
    launches = {n: mod.launches + graphs["launches"].get(n, 0)   # replays'
                + dgraphs["launches"].get(n, 0)
                for n, mod in kernel_mods.items()}
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
    check(graphs["captures"] == 0 and
          graphs["eager"] + graphs["replays"] == tally.calls,
          f"{arch}: prefill graph counts {graphs} for {tally.calls} calls")
    for name, per in spec["per_prefill"].items():
        check(launches[name] == per * tally.calls,
              f"{arch}: {name} launches {launches[name]} != {per} x "
              f"{tally.calls} prefills")
    # decode_attention: one launch a buffered layer in every decode step;
    # the wrapper counts the eager steps and each graph's capture (which
    # runs nothing), the stats the replays
    per_layer = buffered_decode_layers(cfg)
    decode_steps = dgraphs["eager"] + dgraphs["replays"]
    eager_da = kernel_mods["decode_attention"].launches
    replay_da = dgraphs["launches"].get("decode_attention", 0)
    check(decode_steps == SERVE_NEW + steps and dgraphs["replays"] > 0,
          f"{arch}: decode graph counts {dgraphs}, {steps} batcher steps")
    check(eager_da == per_layer * (dgraphs["eager"] + dgraphs["captures"])
          and replay_da == per_layer * dgraphs["replays"],
          f"{arch}: decode_attention launches {eager_da} (eager, captures) "
          f"and {replay_da} (replays) for {per_layer} a step, {dgraphs}")
    launches["decode_attention"] = \
        eager_da - per_layer * dgraphs["captures"] + replay_da
    per_step = launches["decode_attention"] / decode_steps
    decode_s = gen_s - gen_prefill_s

    # --- checks against the plain versions and prefill (not counted) ---
    logits_k, _ = model.prefill(batch)
    kernel_vs_plain = None
    if spec["per_prefill"]:
        with PlainKernels():
            logits_p, _ = model._prefill_body(batch)
        kernel_vs_plain = rel_err(logits_k, logits_p)
        check(bool(torch.isfinite(logits_p).all()), "bad plain logits")
        del logits_p
    chk = lm_batch(cfg, SERVE_BATCH, prompt + 1, seed=2)
    logits_f, logits_d = decode_vs_prefill(model, chk)
    dec_vs_pre = rel_err(logits_d, logits_f)
    for name, lg in (("kernel", logits_k), ("prefill", logits_f),
                     ("decode", logits_d)):
        check(bool(torch.isfinite(lg).all()) and tuple(lg.shape) ==
              (SERVE_BATCH, cfg.vocab_size), f"bad {name} logits")
    shares, prefill_device_ms = kernel_shares_of_prefill(
        model, batch, list(spec["per_prefill"]))
    n_front = cache_len(batch) - prompt
    out = {"phase": "serve", "arch": arch, "dtype": cfg.dtype,
           "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers,
           "cut": spec.get("cut"), "params": int(sum(
               p.numel() for p in model.parameters())),
           "weight_bytes": weight_bytes, "peak_memory_bytes": peak,
           "generate": {"batch": SERVE_BATCH, "prompt": prompt,
                        "frontend_positions": n_front,
                        "encoder_frames": cfg.encoder_seq_len
                        if "encoder_embeds" in batch else 0,
                        "new_tokens": SERVE_NEW, "seconds": gen_s,
                        "prefill_s": gen_prefill_s,
                        "prefill_tokens_per_s":
                            SERVE_BATCH * prompt / gen_prefill_s,
                        "prefill_positions_per_s":
                            SERVE_BATCH * (prompt + n_front) / gen_prefill_s,
                        "decode_steps": SERVE_NEW,
                        "decode_ms_per_step": decode_s / SERVE_NEW * 1e3,
                        "decode_tokens_per_s":
                            SERVE_BATCH * SERVE_NEW / decode_s},
           "batcher": None if not reqs else {
               "slots": BATCHER_SLOTS, "requests": len(reqs),
               "prompts": list(spec["prompts"]),
               "budgets": list(BATCHER_BUDGETS), "steps": steps,
               "seconds": bat_s, "tokens_out": sum(len(r.out)
                                                   for r in reqs)},
           "prefill_calls": tally.calls, "prefill_tokens": tally.tokens,
           "prefill_seconds": tally.seconds,
           "prefill_graph": graphs,
           "decode_graph": dgraphs,
           "launches": launches,
           "decode_steps": decode_steps,
           "decode_attention_per_step": per_step,
           "kernel_share_of_prefill_device_time": shares,
           "prefill_device_ms": prefill_device_ms,
           "kernel_vs_plain_logit_rel_err": kernel_vs_plain,
           "decode_vs_prefill_logit_rel_err": dec_vs_pre,
           "moe_check_capacity": MOE_CHECK_CAPACITY
           if cfg.moe is not None else None,
           "logit_rtol": spec["logit_rtol"], "setup_s": setup_s,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if kernel_vs_plain is not None:
        check(kernel_vs_plain <= spec["logit_rtol"], f"{arch}: kernels vs "
              f"plain prefill logits: rel err {kernel_vs_plain} > "
              f"{spec['logit_rtol']}")
    check(dec_vs_pre <= spec["logit_rtol"], f"{arch}: decode vs prefill "
          f"logits: rel err {dec_vs_pre} > {spec['logit_rtol']}")
    del model, batch, chk, logits_k, logits_f, logits_d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reduced_card_vs_cpu(arch, seed=0, num_layers=None):
    """A reduced config (``num_layers`` overriding its depth) in float32:
    (max relative logit error of prefill, of a scalar-position decode, of
    a per-sequence decode), the port on the card against the port on the
    CPU, same weights and inputs (with the family's frontend or encoder
    embeddings)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import pad_cache

    cfg = get_config(arch).reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    cpu = build_model(cfg, device="cpu").init(seed=seed)
    card = copy.deepcopy(cpu).to("cuda")
    batch = lm_batch(cfg, 2, 64, seed=3, device="cpu")
    T = cache_len(batch)
    errs = []
    caches = {}
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        lg, cache = m.prefill({k: v.to(dev) for k, v in batch.items()})
        caches[dev] = (lg, pad_cache(m, cache, 4, 2, T))
    errs.append(rel_err(caches["cuda"][0].cpu(), caches["cpu"][0]))
    for pos in (torch.tensor(T), torch.tensor([T, T - 3])):
        lgs = {}
        for m, dev in ((cpu, "cpu"), (card, "cuda")):
            cache = {k: v.clone() for k, v in caches[dev][1].items()}
            nxt = caches["cpu"][0].argmax(-1)[:, None]
            lgs[dev], _ = m.decode_step(cache, nxt.to(dev), pos)
        errs.append(rel_err(lgs["cuda"].cpu(), lgs["cpu"]))
    return errs


def phase_reduced():
    t0 = time.perf_counter()
    for arch, num_layers in REDUCED:
        errs = reduced_card_vs_cpu(arch, num_layers=num_layers)
        emit({"phase": "reduced", "arch": f"{arch} reduced (float32)",
              "num_layers": num_layers, "prefill_rel_err": errs[0],
              "decode_rel_err": errs[1],
              "decode_per_sequence_rel_err": errs[2],
              "rtol": REDUCED_LOGIT_RTOL,
              "seconds": time.perf_counter() - t0})
        check(max(errs) <= REDUCED_LOGIT_RTOL, f"reduced {arch} card vs "
              f"CPU: rel errs {errs} > {REDUCED_LOGIT_RTOL}")


def phase_train(mods):
    """llama3.2-3b at full width: TRAIN_STEPS AdamW steps (module doc);
    per step loss, gnorm, lr and ms (synchronised host clock), tokens/s,
    peak device memory. The loss takes the plain route of every mixer, so
    no kernel launches (the counts of ``mods`` stay 0)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{TRAIN_ARCH}: remat {cfg.remat}, dtype {cfg.dtype}")
    # the tokens are drawn before the clock starts (a Python loop per token)
    it = TokenStream(cfg.vocab_size, seed=0).batches(TRAIN_BATCH, TRAIN_SEQ)
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    model = build_model(cfg).init(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = OptimizerConfig(lr=TRAIN_PEAK_LR, warmup_steps=20,
                              total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt_cfg)
    opt = adamw_init(model.param_tree())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for mod in mods.values():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt, m = step_fn(opt, b, i)
        torch.cuda.synchronize()
        rows.append({"step": i, "ms": (time.perf_counter() - t1) * 1e3,
                     **{k: float(m[k]) for k in ("loss", "gnorm", "lr")}})
    peak = torch.cuda.max_memory_allocated()
    launches = {name: mod.launches for name, mod in mods.items()}
    steady = sorted(r["ms"] for r in rows[1:])
    median_ms = steady[len(steady) // 2]
    losses = [r["loss"] for r in rows]
    out = {"phase": "train", "arch": TRAIN_ARCH, "dtype": cfg.dtype,
           "remat": cfg.remat, "layers": cfg.num_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "optimizer": dataclasses.asdict(opt_cfg), "steps": rows,
           "first_step_ms": rows[0]["ms"], "median_ms_after_first": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
           "peak_memory_bytes": peak, "launches": launches,
           "setup_s": setup_s, "seconds": time.perf_counter() - t0}
    emit(out)
    check(all(np.isfinite([r["loss"], r["gnorm"]]).all() for r in rows),
          f"train: non-finite loss or gnorm: {rows}")
    check(sum(losses[-2:]) / 2 < losses[0],
          f"train: the loss did not fall: {losses}")
    check(not any(launches.values()), f"train: the loss path launched "
          f"kernels {launches}: it takes the plain route")
    del model, opt, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(arch, seed=0, num_layers=None):
    """A reduced config (``num_layers`` overriding its depth) in float32,
    one seed: (relative error of the loss, worst gradient error over its
    leaf's max |g| with the 1e-9 floor subtracted out as the bound does,
    the leaf), ``loss_fn`` on the card against the CPU, same weights and
    batch."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    cpu = build_model(cfg, device="cpu").init(seed=seed)
    card = copy.deepcopy(cpu).to("cuda")
    batch = lm_batch(cfg, 2, 64, seed=5, device="cpu")
    out = {}
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        m.requires_grad_(True)
        total, _ = m.loss_fn({k: v.to(dev) for k, v in batch.items()})
        total.backward()
        out[dev] = (float(total.detach()), {k: (torch.stack([t.grad for t in v])
                                       if isinstance(v, list) else v.grad)
                                   .detach().cpu()
                                   for k, v in m.param_tree().items()})
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, leaf = 0.0, None
    for k, want in out["cpu"][1].items():
        err = float((out["cuda"][1][k] - want).abs().max())
        rel = max(err - TRAIN_GRAD_ATOL, 0.0) / max(
            float(want.abs().max()), 1e-30)
        if rel >= worst:
            worst, leaf = rel, k
    return loss_err, worst, leaf


def phase_train_card_vs_cpu():
    t0 = time.perf_counter()
    for arch in TRAIN_REDUCED:
        loss_err, grad_err, leaf = train_card_vs_cpu(arch)
        emit({"phase": "train_card_vs_cpu", "arch": f"{arch} reduced "
              "(float32)", "loss_rel_err": loss_err,
              "grad_err_over_leaf_max": grad_err, "worst_leaf": leaf,
              "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL,
              "grad_atol": TRAIN_GRAD_ATOL,
              "seconds": time.perf_counter() - t0})
        check(loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL,
              f"{arch}: card vs CPU loss {loss_err}, gradient {grad_err} "
              f"({leaf})")


def phase_train_resume():
    """tests/test_train_resume.py on the card (reduced llama3.2-3b): 4
    steps and a checkpoint, a resume to 8, against 8 uninterrupted steps;
    a load of the checkpoint is bit for bit the model it saved, and a save
    of what was loaded loads back bit for bit."""
    import tempfile

    from repro_torch.checkpoint import load_train_state, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    kw = dict(batch=2, seq_len=32, log_every=100)

    def tree(model):
        return {k: (torch.stack(v) if isinstance(v, list) else v).detach()
                for k, v in model.param_tree().items()}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)

    with tempfile.TemporaryDirectory() as d:
        full, _ = train_loop(TRAIN_ARCH, steps=8, **kw)
        at4, _ = train_loop(TRAIN_ARCH, steps=4, ckpt_dir=d, ckpt_every=4,
                            **kw)
        cfg = get_config(TRAIN_ARCH).reduced()
        loaded = build_model(cfg)
        opt, step = load_train_state(d, loaded)
        d2 = os.path.join(d, "again")
        save_checkpoint(d2, {"params": loaded.param_tree(), "opt": opt},
                        step=step)
        again = build_model(cfg)
        opt2, step2 = load_train_state(d2, again)
        resumed, _ = train_loop(TRAIN_ARCH, steps=8, ckpt_dir=d,
                                ckpt_every=100, **kw)
    p_full, p_res = tree(full), tree(resumed)
    finite = all(bool(torch.isfinite(v).all()) for v in p_res.values())
    diff = sum(float((p_full[k] - p_res[k]).abs().sum()) for k in p_full)
    bit_for_bit = (same(tree(at4), tree(loaded)) and same(tree(loaded),
                                                          tree(again))
                   and step == step2 == 4 and torch.equal(opt.count,
                                                          opt2.count)
                   and same(opt.mu, opt2.mu) and same(opt.nu, opt2.nu))
    emit({"phase": "train_resume", "arch": f"{TRAIN_ARCH} reduced",
          "resumed_finite": finite, "diff_vs_uninterrupted": diff,
          "save_load_bit_for_bit": bit_for_bit,
          "seconds": time.perf_counter() - t0})
    check(finite and diff > 0, f"train_resume: finite {finite}, diff {diff}")
    check(bit_for_bit, "train_resume: a save and a load are not bit for bit")


def htl_config():
    """examples/train_htl_lm.py:make_cfg(small=False), ~100M parameters."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("llama3.2-3b"), num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        remat="none", dtype="float32")


def phase_htl():
    """The hypothesis-transfer trainer on the card, as the reference's
    driver runs it: HTL_ROUNDS rounds of each mode (a local phase of
    HTL_LOCAL steps, then a transfer, HTL or not), s/round, the traffic
    ledger; losses finite and falling, every DC's hypothesis the same
    after each transfer."""
    from repro_torch.configs.base import HTLConfig, OptimizerConfig
    from repro_torch.core.htl_trainer import HTLTrainer
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = htl_config()
    model = build_model(cfg)
    L, H, seq = HTL_COLLECTORS, HTL_LOCAL, HTL_SEQ
    steps = HTL_ROUNDS * H
    n_params = sum(p.numel() for p in model.parameters())
    out = {"phase": "htl", "params": n_params, "collectors": L,
           "local_steps": H, "sequences": HTL_SEQS, "seq": seq,
           "rounds": HTL_ROUNDS, "modes": {}}
    for mode in HTL_MODES:
        tr = HTLTrainer(model, OptimizerConfig(lr=1e-3, warmup_steps=20,
                                               total_steps=steps),
                        HTLConfig(mode=mode, num_collectors=L,
                                  local_steps=H,
                                  mixing_steps=HTL_MIXING_STEPS))
        state = tr.init(0)
        stream = TokenStream(cfg.vocab_size, seed=0)
        per_dc = HTL_SEQS if mode == "sync" else HTL_SEQS // L
        lead = () if mode == "sync" else (L,)

        def batches(h):
            toks = np.stack([stream.tokens(int(np.prod(lead)) * per_dc
                                           * (seq + 1))
                             .reshape(lead + (per_dc, seq + 1))
                             for _ in range(h)])
            t = torch.from_numpy(toks).cuda()
            return {"tokens": t[..., :-1], "targets": t[..., 1:]}

        losses, walls, same = [], [], True
        for _ in range(HTL_ROUNDS):
            local, mix = batches(H), batches(1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, ls = tr.local_phase(state, local)
            if mode != "sync":
                state = tr.transfer_phase(state, {k: v[0]
                                                  for k, v in mix.items()})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            losses.append(float(ls.mean()))
            if mode != "sync":
                same &= all(bool((v == v[:1]).all())
                            for v in state.params.values())
        out["modes"][mode] = {"losses": losses, "s_per_round": walls,
                              "traffic": tr.round_traffic_bytes(),
                              "hypotheses_equal_after_transfer": same}
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"htl {mode}: losses {losses}")
        check(same, f"htl {mode}: DC hypotheses differ after a transfer")
        del state, tr
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def phase_validate():
    """The static validator on the 1x1 host mesh (everything on this card,
    nothing sharded) for every arch x shape, with the card's memory
    (``launch.validate.HBM_BYTES``, held against this card's total)."""
    from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES
    from repro_torch.launch import validate as V

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    rows = [V.validate(a, s, mesh="host") for a in ALL_ARCHS
            for s in INPUT_SHAPES]
    table = {f"{r['arch']} {r['shape']}": {k: r[k] for k in r if k not in (
        "arch", "shape")} for r in rows}
    train = table["llama3.2-3b train_4k"]
    err = abs(train["train_state_gib"] * 2**30 / VALIDATE_TRAIN_STATE_BYTES
              - 1.0)
    emit({"phase": "validate", "mesh": "host (1x1)",
          "total_memory": total, "hbm_bytes": V.HBM_BYTES,
          "llama_train_state_bytes": train["train_state_gib"] * 2**30,
          "llama_train_state_rel_err_vs_measured": err,
          "fits": sum(r.get("fits_hbm", False) for r in rows),
          "skipped": sum(r["status"] == "skip" for r in rows),
          "rows": table, "seconds": time.perf_counter() - t0})
    check(total == V.HBM_BYTES, f"the card has {total} bytes, "
                                f"launch.validate.HBM_BYTES {V.HBM_BYTES}")
    check(train["fits_hbm"], "llama3.2-3b's train state does not fit")
    check(err <= VALIDATE_RTOL, f"llama3.2-3b train state "
          f"{train['train_state_gib']:.2f} GiB vs the measured 38.5 GB: "
          f"{err:.3f}")


def phase_dryrun():
    """One dry-run combo in its own process: rank 0 of a 256-rank fake
    world traces llama3.2-3b's decode step under DTensor placements."""
    import tempfile

    arch, shape, mesh = DRYRUN_COMBO
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", out,
             "--force"], cwd=ROOT, capture_output=True, text=True,
            timeout=DRYRUN_TIMEOUT_S,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        path = os.path.join(out, f"{arch}_{shape}_{mesh}.json")
        rec = json.load(open(path)) if os.path.exists(path) else {}
    emit({"phase": "dryrun", "combo": list(DRYRUN_COMBO),
          "returncode": proc.returncode, "record": rec,
          "stderr_tail": proc.stderr[-1500:] if proc.returncode else "",
          "seconds": time.perf_counter() - t0})
    check(proc.returncode == 0 and rec.get("status") == "ok",
          f"dry-run of {DRYRUN_COMBO}: rc {proc.returncode}, "
          f"{rec.get('traceback', proc.stderr[-800:])}")
    check(rec["num_devices"] == 256 and rec["flops"] > 0,
          f"dry-run record {rec}")


def world1_roofline(cfg, shape, trace):
    """The roofline terms of one traced call on one card (H100 peaks)."""
    from repro_torch.roofline import analysis

    rec = {"num_devices": 1, "flops": trace["flops"],
           "bytes_accessed": trace["bytes"],
           "analytic_bytes": analysis.analytic_memory_bytes(cfg, shape, 1),
           "collectives": trace["collectives"],
           "model_flops": analysis.model_flops_for(cfg, shape)}
    return analysis.roofline_from_record(rec)


def phase_roofline(served, train_out):
    """Each served prefill (4 x 2048, full width, bf16) and llama's train
    step traced on meta tensors (the plain route, with the mixer regions'
    counts), their roofline terms on the H100's peaks beside the device
    time the serve and train phases measured; then the kernel route and
    the plain route of the reduced llama, mamba2 and recurrentgemma on the
    card, whose traced FLOPs must agree."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape, OptimizerConfig
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline.analysis import HW
    from repro_torch.roofline.trace import analyze_trace

    t0 = time.perf_counter()
    rows = {}
    for arch, out in served.items():
        cfg = serve_config(arch)
        prompt = SERVES[arch].get("prompt", SERVE_PROMPT)
        batch = lm_batch(cfg, SERVE_BATCH, prompt, seed=0, device="meta")
        model = build_model(cfg, device="meta")
        t1 = time.perf_counter()
        trace = analyze_trace(model.prefill, batch, plain=True)
        shape = InputShape("prefill", cache_len(batch), SERVE_BATCH,
                           "prefill")
        rl = world1_roofline(cfg, shape, trace)
        measured_s = out["prefill_device_ms"] / 1e3
        rows[f"{arch} prefill"] = dict(
            rl, flops=trace["flops"], traced_bytes=trace["bytes"],
            regions=trace["regions"], measured_s=measured_s,
            measured_by="torch.profiler device time",
            measured_over_roofline=measured_s / rl["roofline_step_s"],
            trace_s=time.perf_counter() - t1)
        del model, batch
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device="meta")
    step = make_train_step(model, OptimizerConfig())
    batch = {k: torch.zeros(TRAIN_BATCH, TRAIN_SEQ, dtype=torch.int32,
                            device="meta") for k in ("tokens", "targets")}
    t1 = time.perf_counter()
    trace = analyze_trace(step, adamw_init(model.param_tree()), batch, 0)
    rl = world1_roofline(cfg, InputShape("train", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"), trace)
    measured_s = train_out["median_ms_after_first"] / 1e3
    rows[f"{TRAIN_ARCH} train"] = dict(
        rl, flops=trace["flops"], traced_bytes=trace["bytes"],
        regions=trace["regions"], measured_s=measured_s,
        measured_by="host clock around a synchronised step (median)",
        measured_over_roofline=measured_s / rl["roofline_step_s"],
        trace_s=time.perf_counter() - t1)
    del model, step, batch

    routes = {}
    for arch, layers in ROOFLINE_REDUCED.items():
        cfg = get_config(arch).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(cfg).init(seed=0)
        batch = lm_batch(cfg, 2, 64, seed=0)
        kernel = analyze_trace(model.prefill, batch)
        plain = analyze_trace(model.prefill, batch, plain=True)
        routes[arch] = {"kernel_flops": kernel["flops"],
                        "plain_flops": plain["flops"],
                        "regions": kernel["regions"]}
        check(kernel["flops"] == plain["flops"] > 0
              and kernel["regions"] == plain["regions"],
              f"{arch}: traced FLOPs differ between the kernel route "
              f"({kernel['flops']}) and the plain route ({plain['flops']})")
        del model
    emit({"phase": "roofline", "hardware": {
        "peak_flops": HW.peak_flops, "hbm_bw": HW.hbm_bw,
        "nvlink_bw": HW.nvlink_bw, "ib_bw": HW.ib_bw},
        "rows": rows, "routes": routes,
        "seconds": time.perf_counter() - t0})
    for name, r in rows.items():
        check(r["flops"] > 0 and r["measured_over_roofline"] > 0,
              f"roofline of {name}: {r}")


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


class ShapeLog:
    """Wraps both ``loo_trials`` entry points to record the (L, R, D, M)
    of every call on a card tensor (a graph's calls are made once, at its
    capture); the launch counts stay the wrappers' own."""

    NAMES = ("loo_trials", "loo_trials_step")

    def __init__(self, loo):
        self.loo, self.shapes = loo, set()
        self.orig = {n: getattr(loo, n) for n in self.NAMES}

    def _wrap(self, fn):
        def call(ut, cc, *rest):
            if ut.is_cuda:
                self.shapes.add(tuple(ut.shape) + (cc.shape[-1],))
            return fn(ut, cc, *rest)
        return call

    def __enter__(self):
        for n, fn in self.orig.items():
            setattr(self.loo, n, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.loo, n, fn)


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


class Timed:
    """Wraps ``module.name`` (a function its module calls by name) to add
    up the host seconds of its calls and keep the last call's result: the
    edge-only runner, so a grid's wall time can be read without its
    edge-only labels, the scan engine's planner, packer and dispatch, and
    the city's dispatch (its center ids)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.seconds = 0.0
        self.last = None

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        self.last = self.orig(*a, **kw)
        self.seconds += time.perf_counter() - t0
        return self.last

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_preset(name, overrides, golden, labels, loo, fleet, data):
    from repro_torch.core import scenario
    from repro_torch.core.experiment import get_preset

    loo.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with GreedyStepTally(fleet) as tally, \
            Timed(scenario, "_run_edge_only") as edge:
        res = get_preset(name, **overrides).run(data, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, step_launches = loo.launches, loo.step_launches
    got = summaries(res)
    check(res.labels() == labels, f"{name}: labels {res.labels()}")
    for lbl in labels:
        curve = np.asarray(got[lbl]["f1_curve"])
        check(bool(np.isfinite(curve).all()) and len(curve) > 0,
              f"{name}: bad F1 curve for {lbl}")
    e, f, c = compare(got, golden, labels)
    out = {"phase": name, "runs": len(res.records), "labels": len(labels),
           "wall_s": wall, "s_per_window": wall / overrides["windows"],
           "edge_only_s": edge.seconds,
           "energy_max_rel_err": e, "f1_max_abs_err": f,
           "f1_curve_max_abs_err": c, "f1_atol": F1_ATOL,
           "loo_trials_launches": launches,
           "loo_trials_step_launches": step_launches, **tally.as_dict()}
    emit(out)
    out["result_json"] = res.to_json()      # phase 8f's reference bytes
    check(e <= ENERGY_RTOL, f"{name}: energy rel err {e} > {ENERGY_RTOL}")
    check(f <= F1_ATOL, f"{name}: converged F1 err {f} > {F1_ATOL}")
    check(c <= F1_ATOL, f"{name}: F1 curve err {c} > {F1_ATOL}")
    check(launches > 0, f"{name}: loo_trials kernel never launched")
    check(step_launches > 0, f"{name}: the fused greedy step never launched")
    return out


def normalised_json(result) -> str:
    """A ``SweepResult``'s JSON with every record's engine set to
    ``"fleet"`` (scripts/scan_parity.py's normalisation)."""
    from repro_torch.core.experiment import SweepResult

    return SweepResult(name=result.name, records=[
        dataclasses.replace(r, cfg=dataclasses.replace(r.cfg,
                                                       engine="fleet"))
        for r in result.records]).to_json()


def phase_scan_parity(runs):
    """Each (preset, overrides, data) of ``runs`` on the fleet engine and on
    the scan engine, both unstacked (module doc, 8b)."""
    from repro_torch.core.dispatch import dispatch_scope
    from repro_torch.core.experiment import get_preset

    rows = []
    for name, overrides, data in runs:
        t0 = time.perf_counter()
        ref = get_preset(name, engine="fleet", **overrides).run(
            data, stack="off", device="cuda")
        fleet_s = time.perf_counter() - t0
        with dispatch_scope() as counts:
            t0 = time.perf_counter()
            got = get_preset(name, engine="scan", **overrides).run(
                data, stack="off", device="cuda")
            scan_s = time.perf_counter() - t0
        diffs = [abs(a - b) for r, g in zip(ref.records, got.records)
                 for a, b in zip(r.f1_curve, g.f1_curve)]
        row = {"preset": name, **overrides, "runs": len(got.records),
               "scan_windows_dispatches": counts.get("scan_windows", 0),
               "ledgers_equal": all(r.events == g.events for r, g in
                                    zip(ref.records, got.records)),
               "f1_values": len(diffs),
               "f1_values_differing": sum(d != 0 for d in diffs),
               "f1_max_abs_diff": max(diffs),
               "json_byte_equal": normalised_json(got) == ref.to_json(),
               "fleet_s": fleet_s, "scan_s": scan_s}
        rows.append(row)
        check([r.label for r in got.records] ==
              [r.label for r in ref.records], f"{name}: labels differ")
        check(all(len(r.f1_curve) == len(g.f1_curve) for r, g in
                  zip(ref.records, got.records)), f"{name}: curve lengths")
        check(row["ledgers_equal"], f"{name}: scan ledgers differ from "
                                    f"the fleet engine's")
        check(row["f1_max_abs_diff"] <= SCAN_F1_ATOL, f"{name}: scan F1 "
              f"{row['f1_max_abs_diff']} from the fleet engine's > "
              f"{SCAN_F1_ATOL}")
        check(row["scan_windows_dispatches"] == len(got.records),
              f"{name}: {counts} dispatches for {len(got.records)} runs")
    emit({"phase": "scan_parity", "f1_atol": SCAN_F1_ATOL, "rows": rows})
    return rows


def scenario_profile(cfg, data):
    """One scenario on the card after a warm-up run (graphs captured,
    handles made): its wall without the profiler, then a run under
    ``torch.profiler`` (device activity only) for the summed device
    kernel time and the kernel launches. The profiler's bookkeeping per
    launch stretches the profiled wall (``profiled_wall_s``), the more so
    the more launches a run makes, so the idle share is read against the
    unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.scenario import run_scenario

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_scenario(cfg, data, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run_scenario(cfg, data, device="cuda")
    wall = timed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = timed()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    check(busy > 0, f"profiler saw no device time for {cfg.engine}")
    return {"wall_s": wall, "profiled_wall_s": profiled,
            "device_kernel_s": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": len(kernels),
            "launches_per_window": len(kernels) / cfg.windows}


def phase_paper_scan(paper, labels, loo, data, fleet_wall_s):
    """The paper grid's HTL labels on the scan engine (module doc, 8c);
    the counted main path of the scan engine."""
    from repro_torch.core import cityscan
    from repro_torch.core.experiment import SweepResult, records_from
    from repro_torch.core.experiment import get_preset
    from repro_torch.core.scenario import run_sweep

    spec = get_preset("paper_tables", windows=paper["windows"],
                      n_seeds=paper["n_seeds"], engine="scan")
    runs = [(lbl, cfg) for lbl, cfg in spec.configs()
            if cfg.algo != "edge_only"]
    labels = [lbl for lbl in labels if lbl != "fig2_edge_only"]
    loo.reset_launches()
    cityscan.reset_graph_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Timed(cityscan, "_plan_scenario") as plan, \
            Timed(cityscan, "_pack_plan") as pack, \
            Timed(cityscan, "_dispatch_scan") as dispatch:
        results = run_sweep([cfg for _, cfg in runs], data,
                            stack_seeds=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = cityscan.graph_stats()
    res = SweepResult(name="paper_tables_scan", records=records_from(
        [lbl for lbl, _ in runs], results))
    got = summaries(res)
    check(res.labels() == labels, f"paper_tables_scan: labels "
                                  f"{res.labels()}")
    e, f, c = compare(got, paper, labels)
    out = {"phase": "paper_tables_scan", "runs": len(res.records),
           "labels": len(labels), "wall_s": wall,
           "s_per_window": wall / paper["windows"],
           "fleet_wall_s_same_labels": fleet_wall_s,
           "plan_s": plan.seconds, "pack_s": pack.seconds,
           "dispatch_s": dispatch.seconds,
           "graphs_captured": stats["captures"],
           "capture_s": stats["capture_s"], "replays": stats["replays"],
           "loo_trials_step_captured_per_window":
               stats["loo_trials_step_launches"] / max(1, stats["replays"]),
           "loo_trials_launches": stats["loo_trials_launches"],
           "loo_trials_step_launches": stats["loo_trials_step_launches"],
           "energy_max_rel_err": e, "f1_max_abs_err": f,
           "f1_curve_max_abs_err": c, "f1_atol": F1_ATOL}
    emit(out)
    check(stats["replays"] == len(runs) * paper["windows"],
          f"paper_tables_scan: {stats['replays']} replays for "
          f"{len(runs)} x {paper['windows']} windows")
    check(e <= ENERGY_RTOL, f"paper_tables_scan: energy rel err {e}")
    check(f <= F1_ATOL and c <= F1_ATOL, f"paper_tables_scan: F1 errs "
                                         f"{f}, {c} > {F1_ATOL}")
    check(stats["loo_trials_step_launches"] > 0,
          "paper_tables_scan: the graphs never launched loo_trials_step")
    # not counted: one scenario of the grid profiled on both engines
    cfg = dataclasses.replace(dict(runs)[PROFILE_LABEL],
                              windows=PROFILE_WINDOWS)
    emit({"phase": "paper_tables_scan_profile", "label": PROFILE_LABEL,
          "windows": PROFILE_WINDOWS,
          "fleet": scenario_profile(dataclasses.replace(cfg, engine="fleet"),
                                    data),
          "scan": scenario_profile(cfg, data)})
    return out


def pair_counts(tech, n, center_is_ap):
    """{what: (bytes, n_tx, n_rx)} of one StarHTL window's learning
    messages among ``n`` live DCs (DC 0 the AP), summed over the fleet
    engine's per-pair ``Topology`` patterns: entropy index to every ordered
    pair, center id broadcast, m0 gathered at the center."""
    from repro_torch.core.energy import INDEX_BYTES, MODEL_BYTES, Ledger
    from repro_torch.core.topology import Node, Topology

    nodes = [Node(f"DC{i}", is_ap=(i == 0)) for i in range(n)]
    ledger = Ledger()
    topo = Topology(ledger, tech, nodes)
    center = nodes[0 if center_is_ap else 1]
    topo.exchange_all(INDEX_BYTES, what="entropy index")
    topo.broadcast(center, INDEX_BYTES, what="center id")
    topo.gather(center, MODEL_BYTES, what="m0 to center")
    out = {}
    for e in ledger.events:
        _, tx, rx = out.get(e["what"], (0, 0, 0))
        out[e["what"]] = (e["bytes"], tx + e["n_tx"], rx + e["n_rx"])
    return out


def city_learning_counts(tech, n, center_is_ap):
    """:func:`pair_counts` at ``n`` DCs from its values at 3, 4 and 5: a
    count over ordered pairs of per-role-pair constants is a quadratic in
    the fleet size (checked at 6), so a 10^5-DC fleet needs no 10^10-pair
    loop."""
    p = [pair_counts(tech, k, center_is_ap) for k in (3, 4, 5, 6)]

    def at(k, what, i):
        a, b, c = (q[what][i] for q in p[:3])
        return a + (b - a) * (k - 3) + (c - 2 * b + a) * (k - 3) * (k - 4) // 2

    for what in p[0]:
        check(all(at(6, what, i) == p[3][what][i] for i in (1, 2)),
              f"{tech} {what}: pair counts are not quadratic in the fleet")
    return {what: (p[0][what][0], at(n, what, 1), at(n, what, 2))
            for what in p[0]}


def city_ledger_mismatches(events, cfg, centers):
    """Windows whose ledger events differ from an independent count: the
    fleet's collection as ``fleet_size`` sensor->SM ``collect_to_mule``
    events, then :func:`city_learning_counts`, the center's role read from
    this run's center ids (no churn: every DC lives, DC 0 is the AP)."""
    from repro_torch.core.energy import Ledger

    check(cfg.battery_mj is None, "the city ledger check assumes no churn")
    L0 = cfg.fleet_size
    mule = Ledger()
    mule.collect_to_mule(cfg.obs_per_dc)
    col = mule.events[0]
    roles = {r: city_learning_counts(cfg.tech, L0, r) for r in (True, False)}
    got = [(e["tech"], e["bytes"], e["purpose"], e["n_tx"], e["n_rx"])
           for e in events]
    bad = []
    for t in range(cfg.windows):
        want = [(col["tech"], col["bytes"], "collection", L0 * col["n_tx"],
                 L0 * col["n_rx"])] + [
            (cfg.tech, nbytes, "learning", tx, rx)
            for nbytes, tx, rx in roles[int(centers[t]) == 0].values()]
        if got[4 * t:4 * t + 4] != want:
            bad.append(t)
    if len(got) != 4 * cfg.windows:
        bad.append("count")
    return bad


def small_city_indices(data, seed=0):
    """The 40-DC city's config and its injected draw indices (W, L, K)."""
    from repro_torch.core import cityscan
    from repro_torch.core.scenario import ScenarioConfig

    cfg = ScenarioConfig(**CITY_SMALL)
    L = cityscan.city_fleet_pad(cfg.fleet_size)
    return cfg, torch.from_numpy(np.random.default_rng(seed).integers(
        0, len(data.y_train), size=(cfg.windows, L, cfg.obs_per_dc)))


def small_city_card_vs_cpu(data, seed=0):
    """The 40-DC city on the card and on the CPU with the same injected
    draw indices: (max |F1 card - F1 CPU|, centers equal, curves)."""
    from repro_torch.core import cityscan

    cfg, idx = small_city_indices(data, seed)
    out = {}
    for dev in ("cuda", "cpu"):
        cms, centers, _ = cityscan._city_outputs(
            cfg, data, draw=cityscan.table_draw(idx.to(dev)), device=dev)
        out[dev] = (cityscan._f1_curve(cms, cfg.eval_every), centers)
    err = max(abs(a - b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    return err, bool(np.array_equal(out["cuda"][1], out["cpu"][1])), out


def phase_city(loo, data):
    """The city preset at 2 and 6 windows, and the small city card vs CPU
    (module doc, 8d); the counted main path of the city engine."""
    from repro_torch.core import cityscan
    from repro_torch.core.dispatch import dispatch_scope
    from repro_torch.core.energy import Ledger
    from repro_torch.core.experiment import get_preset

    rows = {}
    for W in CITY_WINDOWS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loo.reset_launches()
        cityscan.reset_graph_stats()
        with dispatch_scope() as counts, \
                Timed(cityscan, "_dispatch_city") as dispatch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = get_preset("city", windows=W).run(data, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = cityscan.graph_stats()
        rec = res.records[0]
        centers = dispatch.last[1]
        row = {"windows": W, "fleet_size": rec.cfg.fleet_size,
               "obs_per_dc": rec.cfg.obs_per_dc,
               "train_iters": rec.cfg.train_iters, "tech": rec.cfg.tech,
               "wall_s": wall, "s_per_window": wall / W,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "peak_rss_mb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 1024.0,
               "city_scan_dispatches": counts.get("city_scan", 0),
               "graphs_captured": stats["captures"],
               "capture_s": stats["capture_s"], "replays": stats["replays"],
               "loo_trials_launches": stats["loo_trials_launches"],
               "loo_trials_step_launches":
                   stats["loo_trials_step_launches"],
               "dispatch_s": dispatch.seconds, "f1_curve": rec.f1_curve,
               "centers": centers.tolist(),
               "ledger_events": len(rec.events),
               "ledger_total": Ledger(list(rec.events)).total(),
               "ledger_windows_off_count": city_ledger_mismatches(
                   rec.events, rec.cfg, centers)}
        emit({"phase": "city", **row})
        # phase 8g's reference: this run's confusion counts and events
        rows[W] = dict(row, cms=dispatch.last[0], events=list(rec.events))
        curve = rec.f1_curve
        check(row["city_scan_dispatches"] == 1, f"city W={W}: {counts}")
        check(len(curve) == W and all(0.0 < v <= 1.0 for v in curve),
              f"city W={W}: F1 curve {curve}")
        check(curve[-1] >= CITY_F1_FLOOR, f"city W={W}: final F1 "
                                          f"{curve[-1]} < {CITY_F1_FLOOR}")
        check(not row["ledger_windows_off_count"],
              f"city W={W}: ledger differs from the pairwise count in "
              f"windows {row['ledger_windows_off_count']}")
        check(row["replays"] == W and row["loo_trials_step_launches"] > 0,
              f"city W={W}: {stats}")
    lo, hi = (rows[W] for W in CITY_WINDOWS)
    mem = hi["peak_device_bytes"] / lo["peak_device_bytes"]
    rss = hi["peak_rss_mb"] / lo["peak_rss_mb"]
    err, same_centers, small = small_city_card_vs_cpu(data)
    out = {"phase": "city_summary", "device_memory_ratio": mem,
           "rss_ratio": rss, "max_ratio": CITY_MEMORY_RATIO,
           "small_city_f1_max_abs_diff": err,
           "small_city_centers_equal": same_centers,
           "small_city_f1_card": small["cuda"][0],
           "small_city_centers": small["cuda"][1].tolist()}
    emit(out)
    check(mem <= CITY_MEMORY_RATIO, f"city: device memory grew {mem}x")
    check(rss <= CITY_MEMORY_RATIO, f"city: host RSS grew {rss}x")
    check(same_centers, "small city: card and CPU centers differ")
    check(err <= SCAN_F1_ATOL, f"small city: card vs CPU F1 {err}")
    rows["small"] = small["cuda"]
    return rows


def city_shard_rank(rank, world, store, out_path, windows=None):
    """One rank of phase 8g (module doc), in a spawned interpreter: joins
    the ``gloo`` world of ``world`` ranks on ``cuda:0`` through the file
    ``store``, runs the 40-DC city with injected draws and then, with
    ``windows``, the ``city`` preset, both with every rank a shard, and
    writes what it saw to ``out_path`` (JSON)."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import cityscan
    from repro_torch.core.experiment import get_preset
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.kernels import loo_trials as loo

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=CITY_SHARD_TIMEOUT_S))
    try:
        data = make_covtype_like(seed=0)
        out = {"rank": rank}
        with ShapeLog(loo) as shapes, \
                Timed(cityscan, "_city_outputs") as outputs:
            cfg, idx = small_city_indices(data)
            cms, centers, _ = cityscan._city_outputs(
                cfg, data, max_shards=world,
                draw=cityscan.table_draw(idx.to("cuda")), device="cuda")
            out["small"] = {"f1_curve": cityscan._f1_curve(
                cms, cfg.eval_every), "centers": centers.tolist()}
            if windows is not None:
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                loo.reset_launches()
                cityscan.reset_graph_stats()
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = get_preset("city", windows=windows).run(
                    data, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                stats = cityscan.graph_stats()
                rec = res.records[0]
                cms, centers, _ = outputs.last
                out["city"] = {
                    "wall_s": wall,
                    "peak_device_bytes": torch.cuda.max_memory_allocated(),
                    "loo_trials_launches": loo.launches,
                    "loo_trials_step_launches": loo.step_launches,
                    "collectives": stats["collectives"],
                    "graphs_captured": stats["captures"],
                    "replays": stats["replays"], "f1_curve": rec.f1_curve,
                    "centers": centers.tolist(), "events": list(rec.events),
                    "cms": cms.tolist()}
        out["shapes"] = sorted(shapes.shapes)
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def run_city_world(world, windows=None):
    """Every rank's :func:`city_shard_rank` results for a world of
    ``world`` spawned (never forked) interpreters; fails as soon as one
    rank fails, or after :data:`CITY_SHARD_TIMEOUT_S`, and leaves no rank
    running."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=city_shard_rank, args=(
            r, world, os.path.join(tmp, "store"), paths[r], windows))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + CITY_SHARD_TIMEOUT_S
        try:
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"city_shards world {world}: rank exit "
                                    f"codes {codes}")
        results = []
        for path in paths:
            with open(path) as fh:
                results.append(json.load(fh))
        return results


def first_city_difference(got, want):
    """The first quantity in which a sharded city run differs from phase
    8d's: the window whose confusion counts differ, else None."""
    for t, (a, b) in enumerate(zip(got["cms"], want["cms"].tolist())):
        if a != b:
            return f"confusion counts of window {t}"
    return None


def phase_city_shards(city_runs):
    """Phase 8g (module doc): the city over worlds of 2 and 4 ranks on one
    card against phase 8d's one-shard runs; the ``loo_trials`` launches
    and the shapes each rank gave the wrappers."""
    one = city_runs[CITY_SHARD_WINDOWS]
    small_f1, small_centers = city_runs["small"]
    rows, shapes = {}, set()
    for world in CITY_SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = run_city_world(world, CITY_SHARD_WINDOWS)
        for r in ranks:
            shapes.update(tuple(s) for s in r["shapes"])
        runs = [r["city"] for r in ranks]
        f1_err = max(abs(a - b) for run in runs
                     for a, b in zip(run["f1_curve"], one["f1_curve"]))
        small_err = max(abs(a - b) for r in ranks
                        for a, b in zip(r["small"]["f1_curve"], small_f1))
        W = CITY_SHARD_WINDOWS
        row = {"world": world, "shards": world, "windows": W,
               "fleet_size": one["fleet_size"], "backend": "gloo",
               "device": "cuda:0 (every rank)",
               "world_s": time.perf_counter() - t0,
               "wall_s": max(run["wall_s"] for run in runs),
               "rank_wall_s": [run["wall_s"] for run in runs],
               "one_shard_wall_s": one["wall_s"],
               "peak_device_bytes": [run["peak_device_bytes"]
                                     for run in runs],
               "one_shard_peak_device_bytes": one["peak_device_bytes"],
               "collectives_per_window": [(run["collectives"] - 1) / W
                                          for run in runs],
               "broadcasts": 1,
               "graphs_captured": [run["graphs_captured"] for run in runs],
               "replays": [run["replays"] for run in runs],
               "loo_trials_launches": [run["loo_trials_launches"]
                                       for run in runs],
               "loo_trials_step_launches": [run["loo_trials_step_launches"]
                                            for run in runs],
               "centers": runs[0]["centers"],
               "centers_equal": all(run["centers"] == one["centers"]
                                    for run in runs),
               "ledger_equal": all(run["events"] == one["events"]
                                   for run in runs),
               "f1_max_abs_diff": f1_err,
               "f1_bitwise_equal": all(run["f1_curve"] == one["f1_curve"]
                                       for run in runs),
               "first_difference": next(
                   (d for d in (first_city_difference(run, one)
                                for run in runs) if d), None),
               "small_city_centers_equal": all(
                   r["small"]["centers"] == small_centers.tolist()
                   for r in ranks),
               "small_city_f1_max_abs_diff": small_err,
               "small_city_f1_bitwise_equal": all(
                   r["small"]["f1_curve"] == small_f1 for r in ranks)}
        rows[world] = row
        emit({"phase": "city_shards", **row})
        name = f"city_shards world {world}"
        check(row["centers_equal"], f"{name}: centers differ from 8d's")
        check(row["ledger_equal"], f"{name}: ledger differs from 8d's")
        check(f1_err <= SCAN_F1_ATOL, f"{name}: F1 {f1_err} from 8d's")
        check(row["small_city_centers_equal"],
              f"{name}: small city centers differ from one shard's")
        check(small_err <= SCAN_F1_ATOL,
              f"{name}: small city F1 {small_err} from one shard's")
        check(all(n > 0 for n in row["loo_trials_step_launches"]),
              f"{name}: a rank never launched loo_trials_step")
        check(row["replays"] == [0] * world,
              f"{name}: a sharded window replayed a graph")
    return rows, shapes


def phase_backends(paper_overrides, paper_run, data):
    """``devices:n=2`` and ``processes:n=4`` on the paper grid, each
    byte-equal to phase 8's sequential result (module doc, 8f)."""
    from repro_torch.core.experiment import get_preset

    rows = []
    for parallel in ORCH_BACKENDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = get_preset("paper_tables", **paper_overrides).run(
            data, parallel=parallel, device="cuda")
        torch.cuda.synchronize()
        row = {"parallel": parallel, "grid": "paper_tables",
               "runs": len(res.records),
               "wall_s": time.perf_counter() - t0,
               "sequential_wall_s": paper_run["wall_s"],
               "byte_equal": res.to_json() == paper_run["result_json"]}
        emit({"phase": "orchestration", **row})
        check(row["byte_equal"], f"{parallel}: paper_tables JSON differs "
                                 f"from the sequential run's")
        rows.append(row)
    return rows


def phase_hosts(smoke_overrides, smoke_run, data):
    """``hosts:channel=local`` on the smoke preset, clean and with shard
    0's first worker SIGKILLed, each byte-equal to phase 7's result; the
    killed run logs one crash on shard 0 and its retry on the other slot
    (module doc, 8f)."""
    from repro_torch.core.experiment import get_preset

    rows = []
    for kill in (False, True):
        parallel = ORCH_HOSTS + (",inject_kill=0" if kill else "")
        t0 = time.perf_counter()
        res = get_preset("smoke", **smoke_overrides).run(
            data, parallel=parallel, device="cuda")
        log = res.meta["launcher"]["shards"]
        attempts = [[(a["status"], a["slot"]) for a in s["attempts"]]
                    for s in log]
        row = {"parallel": parallel, "grid": "smoke",
               "runs": len(res.records),
               "wall_s": time.perf_counter() - t0,
               "sequential_wall_s": smoke_run["wall_s"],
               "byte_equal": res.to_json() == smoke_run["result_json"],
               "attempts": attempts}
        emit({"phase": "orchestration", **row})
        check(row["byte_equal"], f"{parallel}: smoke JSON differs from "
                                 f"the sequential run's")
        statuses = [[st for st, _ in shard] for shard in attempts]
        want = [["crash", "ok"] if kill else ["ok"]] + \
            [["ok"]] * (len(attempts) - 1)
        check(statuses == want, f"{parallel}: attempts {attempts}")
        if kill:
            check(attempts[0][0][1] != attempts[0][1][1],
                  f"{parallel}: the retry ran on the slot that crashed")
        rows.append(row)
    return rows


def phase_service(smoke_overrides, smoke_run, data):
    """The sweep service on ``127.0.0.1:0`` (``inline`` backend, on the
    card): a streamed run, a cache hit and a stream resumed across
    one-event connections, each byte-equal to phase 7's result, and the
    hit in ``/v1/metrics`` (module doc, 8f)."""
    import threading

    from repro_torch.core.experiment import get_preset
    from repro_torch.service.client import ServiceClient
    from repro_torch.service.server import make_server

    httpd, service = make_server(backend=SERVICE_BACKEND, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServiceClient(httpd.server_address[:2])
        spec = get_preset("smoke", **smoke_overrides)
        row = {"backend": SERVICE_BACKEND, "device": service.device}
        runs = (("first", {}), ("cached", {}),
                ("resumed", dict(cache="bypass", max_events_per_conn=1)))
        for name, kw in runs:
            t0 = time.perf_counter()
            res = client.run(spec, data, **kw)
            row[name] = {"wall_s": time.perf_counter() - t0,
                         "cached": res.meta["service"]["cached"],
                         "byte_equal":
                             res.to_json() == smoke_run["result_json"]}
        counters = client.metrics()["statsd"]["counters"]
        row["cache_hits"] = counters.get("service.cache.hit", 0)
        row["stream_connections"] = counters.get(
            "service.stream.connections", 0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    emit({"phase": "orchestration_service", **row})
    for name, _ in runs:
        check(row[name]["byte_equal"], f"service {name}: JSON differs from "
                                       f"the sequential run's")
    check(not row["first"]["cached"] and row["cached"]["cached"]
          and not row["resumed"]["cached"],
          f"service: cached flags {row}")
    check(row["cache_hits"] >= 1, "service: /v1/metrics shows no cache hit")
    check(row["stream_connections"] >= 3,
          "service: the bounded stream did not reconnect")
    return row


def phase_pareto(loo, data):
    """The Pareto search on the ``pareto`` preset (module doc, 8f): the
    frontiers of ``exhaustive`` and ``halving`` equal, each byte-equal to
    a plain run of ``frontier_spec``, a candidate pruned before the last
    rung; each search's ``loo_trials`` launches counted."""
    from repro_torch.core.experiment import get_preset
    from repro_torch.core.pareto import frontier_spec, get_search

    spec = get_preset("pareto", **PARETO_GRID)
    rows, results = [], {}
    for name in PARETO_SEARCHES:
        search = get_search(name)
        loo.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = search.run(spec, data, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = res
        early = [e["label"] for e in res.ledger if e["status"] == "pruned"
                 and e["pruned_at_rung"] < search.rungs - 1]
        rows.append({"search": name, "wall_s": wall,
                     "frontier": res.frontier_labels(), "cost": res.cost,
                     "statuses": res.dominated_counts(),
                     "pruned_before_last_rung": early,
                     "loo_trials_launches": loo.launches,
                     "loo_trials_step_launches": loo.step_launches})
    labels = rows[0]["frontier"]
    plain = {}                  # one plain run per distinct frontier
    for res in results.values():
        key = tuple(res.frontier_labels())
        if key not in plain:
            plain[key] = frontier_spec(spec, key).run(
                data, device="cuda").to_json()
    out = {"phase": "orchestration_pareto", "grid": PARETO_GRID,
           "labels": len(spec.rows()), "searches": rows,
           "frontiers_equal": all(r["frontier"] == labels for r in rows),
           "frontier_byte_equal": {
               n: r.frontier_result.to_json()
               == plain[tuple(r.frontier_labels())]
               for n, r in results.items()}}
    emit(out)
    check(out["frontiers_equal"], f"pareto: frontiers differ: "
                                  f"{[r['frontier'] for r in rows]}")
    check(all(out["frontier_byte_equal"].values()),
          f"pareto: frontier_result differs from a plain run "
          f"{out['frontier_byte_equal']}")
    halving = rows[PARETO_SEARCHES.index(PARETO_HALVING)]
    check(halving["pruned_before_last_rung"],
          "pareto: halving pruned no candidate before its last rung")
    for r in rows:
        check(r["loo_trials_step_launches"] > 0,
              f"pareto {r['search']}: the fused step never launched")
    return {r["search"]: r for r in rows}


def phase_orchestration(loo, smoke_overrides, smoke_run, smoke_data,
                        paper_overrides, paper_run, paper_data):
    """Phase 8f (module doc): every sweep backend, the service and the
    Pareto search on the card, each held byte-equal to the sequential
    runs of phases 7 and 8."""
    t0 = time.perf_counter()
    backends = phase_backends(paper_overrides, paper_run, paper_data)
    hosts = phase_hosts(smoke_overrides, smoke_run, smoke_data)
    service = phase_service(smoke_overrides, smoke_run, smoke_data)
    pareto = phase_pareto(loo, paper_data)
    emit({"phase": "orchestration_total",
          "seconds": time.perf_counter() - t0})
    return {"backends": backends, "hosts": hosts, "service": service,
            "pareto": pareto}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from repro_torch.core import fleet
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import loo_trials as loo
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ss

    # 1. device
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    mods = {"loo_trials": loo, "flash_attention": fa, "ssd_scan": ss,
            "rglru_scan": rg, "decode_attention": da}
    libs = build.build(list(mods))
    for mod in mods.values():
        mod._launcher()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": " ".join(build.NVCC_FLAGS),
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()}})
    # registers and spill bytes of every kernel function (ptxas -v)
    ptxas = {k: build.ptxas_report(v.with_suffix(".log").read_text())
             for k, v in libs.items()}
    emit({"ptxas": ptxas})
    for d in fa.HEAD_DIMS:
        rep = ptxas["flash_attention"].get(f"{FLASH_TC_KERNEL}<{d}>")
        check(rep is not None, f"no ptxas report for {FLASH_TC_KERNEL}<{d}>")
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
              f"{FLASH_TC_KERNEL}<{d}> spills: {rep}")
    for lib, names in (("ssd_scan", SSD_TC_KERNELS),
                       ("loo_trials", LOO_KERNELS),
                       ("rglru_scan", RGLRU_KERNELS),
                       ("decode_attention", DECODE_ATTN_KERNELS)):
        for name in names:
            rep = ptxas[lib].get(name)
            check(rep is not None, f"no ptxas report for {name}")
            check(rep.get("spill_stores") == 0
                  and rep.get("spill_loads") == 0, f"{name} spills: {rep}")

    # 3.-6. every kernel against its plain version
    rows, worst = phase_kernel(loo)
    step_rows, step_worst = phase_step(loo)
    flash_rows, flash_worst = phase_flash(fa)
    decode_rows, decode_worst = phase_decode_attention(da)
    ssd_rows, ssd_worst = phase_ssd(ss)
    rglru_rows, rglru_worst = phase_rglru(rg)

    # 7. smoke preset against the golden fixture
    with open(os.path.join(ROOT, "tests", "golden", "smoke_golden.json")) \
            as fh:
        golden = json.load(fh)
    data = make_covtype_like(seed=golden["data_seed"])
    # phases 7-8d and 8f log the shapes they give the loo_trials wrappers
    smoke_overrides = {"windows": golden["windows"],
                       "n_seeds": golden["n_seeds"]}
    with ShapeLog(loo) as shape_log:
        smoke_run = phase_preset("smoke", smoke_overrides,
                                 golden["per_label"],
                                 list(golden["per_label"]), loo, fleet, data)

        # 8. the paper grid at full data size: loo_trials' counted main
        # path
        with open(os.path.join(ROOT, "results", "benchmarks",
                               "paper_tables.json")) as fh:
            paper = json.load(fh)
        labels = [k for k, v in paper.items() if isinstance(v, dict)]
        paper_overrides = {"windows": paper["windows"],
                           "n_seeds": paper["n_seeds"]}
        main_run = phase_preset("paper_tables", paper_overrides, paper,
                                labels, loo, fleet,
                                make_covtype_like(seed=0))

        # 8b.-8d. the scan engine against the fleet engine, the paper grid
        # on the scan engine (its counted main path), the city
        phase_scan_parity([
            ("smoke", {"windows": golden["windows"],
                       "n_seeds": golden["n_seeds"]}, data),
            ("transport_grid", {"windows": 5}, make_covtype_like(seed=0))])
        scan_run = phase_paper_scan(
            paper, labels, loo, make_covtype_like(seed=0),
            main_run["wall_s"] - main_run["edge_only_s"])
        city_runs = phase_city(loo, make_covtype_like(seed=0))

        # 8f. the sweep backends, the service and the Pareto search
        orch = phase_orchestration(loo, smoke_overrides, smoke_run, data,
                                   paper_overrides, main_run,
                                   make_covtype_like(seed=0))

        # 8g. the city's DC axis over worlds of ranks on the card
        shard_runs, shard_shapes = phase_city_shards(city_runs)
    # every loo_trials shape of phases 7-8d, 8f and 8g's ranks was held
    # against its plain version in phases 3 and 3b
    shape_log.shapes |= shard_shapes
    unchecked = sorted(shape_log.shapes - set(KERNEL_SHAPES))
    emit({"phase": "loo_shapes", "main_path_shapes":
          sorted(shape_log.shapes), "unchecked": unchecked})
    check(not unchecked, f"loo_trials launched at shapes that phases 3 "
                         f"and 3b do not check: {unchecked}")

    # 9.-16. serving, one model at a time: the counted main paths of
    # flash_attention, ssd_scan and rglru_scan
    served = {arch: phase_serve(arch, {n: mods[n] for n in
                                       [*SERVES[arch]["per_prefill"],
                                        "decode_attention"]})
              for arch in SERVES}

    # 17. the reduced configs, card against CPU
    phase_reduced()

    # 18.-21. training: llama3.2-3b at full width, reduced configs card vs
    # CPU, checkpoint and resume, the hypothesis-transfer trainer
    lm_mods = {n: mods[n] for n in ("flash_attention", "ssd_scan",
                                    "rglru_scan")}
    train_out = phase_train(lm_mods)
    phase_train_card_vs_cpu()
    phase_train_resume()
    phase_htl()

    # 22.-24. the static validator on the card's memory, one dry-run
    # combo in a fake world, each served step's roofline
    phase_validate()
    phase_dryrun()
    phase_roofline(served, train_out)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    head = next(r for r in rows
                if (r["L"], r["R"], r["D"], r["M"]) == HEADLINE_SHAPE)

    def served_launches(name):
        return sum(out["launches"].get(name, 0) for out in served.values())

    def line(name, head, err, launches, library_us=None, source=None):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          f"{source or name}.cu",
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": err, "ms": head["kernel_us"] / 1e3,
                "plain_ms": head["plain_us"] / 1e3,
                "bound_ms": head["bound_us"] / 1e3,
                "bound_by": head["bound_by"],
                "library_ms": None if library_us is None
                else library_us / 1e3, "shape": head["shape"]}

    def by_path(key):
        city = city_runs[CITY_WINDOWS[-1]]
        return {"paper_tables (fleet)": main_run[key],
                "paper_tables_scan (graph replays)": scan_run[key],
                f"city {city['windows']} windows (graph replays)":
                    city[key],
                **{f"pareto {name} (fleet)": row[key]
                   for name, row in orch["pareto"].items()},
                **{f"city_shards {world} ranks, {row['windows']} windows "
                   f"(eager, all ranks)": sum(row[key])
                   for world, row in shard_runs.items()}}

    head["shape"] = list(HEADLINE_SHAPE)
    step_head = step_rows[KERNEL_SHAPES.index(HEADLINE_SHAPE)]
    step_head["shape"] = list(HEADLINE_SHAPE)
    fhead = flash_rows[0]
    emit({"kernels": [
        dict(line("loo_trials", head, worst,
                  main_run["loo_trials_launches"]),
             launches_by_path=by_path("loo_trials_launches")),
        dict(line("loo_trials_step", step_head, step_worst,
                  main_run["loo_trials_step_launches"], source="loo_trials"),
             launches_by_path=by_path("loo_trials_step_launches")),
        dict(line("flash_attention", fhead, flash_worst,
                  served_launches("flash_attention"), fhead["library_us"]),
             launches_by_path={arch: out["launches"]["flash_attention"]
                               for arch, out in served.items()
                               if "flash_attention" in out["launches"]}),
        line("ssd_scan", ssd_rows[0],
             max(r["max_abs_err"] for r in ssd_rows),
             served_launches("ssd_scan")),
        line("rglru_scan", rglru_rows[0], rglru_worst,
             served_launches("rglru_scan")),
        dict(line("decode_attention", decode_rows[0], decode_worst,
                  served_launches("decode_attention"),
                  decode_rows[0]["library_us"]),
             launches_by_path={arch: out["decode_attention_per_step"]
                               for arch, out in served.items()})]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
