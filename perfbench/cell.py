"""One run of one cell: set-up, the measured window, the traced span,
the comparison, and the result's line.

Set-up (counted in ``setup_s``, from the process's launch to the window's
opening): the weights made from the seed on the device and handed to the
port's ``Model.load_params``; the batcher; one prefill at the longest
prompt the mix sends (the allocator's largest blocks; the kernels built
on a checkout's first run); every client's first request, part-way
through its budget, and ``WARM_STEPS`` steps of the closed loop. Then the
window: whole steps of the closed loop until ``seconds`` have passed.
With ``trace``, the prefill and decode calls are timed on a synchronised
host clock in the window, and :mod:`perfbench.profiling` traces
``TRACE_SECONDS`` of the same loop after it. Where the cell's limits name
``mean_kv_error``, every decode step's cache writes are read back from
set-up on (:class:`perfbench.verify.CacheReadback`). Then the program's
state is freed, the weights are made again from the seed, and the plain
reference judges a sample of the requests the window finished
(:mod:`perfbench.verify`).
"""
from __future__ import annotations

import gc
import subprocess
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from perfbench import program, registry, verify, weights as wts
from perfbench.loop import ClosedLoop
from perfbench.timeline import WindowStats, window_stats
from perfbench.traffic import Traffic

WARM_STEPS = 3
TRACE_SECONDS = 2.0


@dataclass
class Run:
    """What a metric's reader reads."""
    cell: dict
    config: dict
    mix: dict
    setup_s: float
    stats: WindowStats
    prefill_calls: list = field(default_factory=list)   # (s, prompt len)
    decode_calls: list = field(default_factory=list)    # s
    profile: Optional[object] = None


def _timed(fn, into, sync, size=None):
    """``fn`` timed between two synchronisations, appended to ``into``."""
    def wrapped(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        dt = time.perf_counter() - t0
        into.append((dt, size(*args)) if size else dt)
        return out
    return wrapped


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, *, t_launch: float, device="cuda",
             root=registry.ROOT, hook=None, control=False):
    """The result's dict of one run (module doc). ``hook(model,
    batcher)``, if given, runs once both are built (a fault of
    :mod:`perfbench.faults` breaks the timed path through it);
    ``control`` adds the control's readings, judged against the same
    limits as ``control_correct`` (calibration only)."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    c = registry.config(cell["config"], root)
    mix = registry.mix(cell["traffic"], root)
    limits = registry.limits(name, root)
    ref = registry.reference_of(c, root)
    dtype = getattr(torch, c["dtype"])
    leaves = ref.leaves(c)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    phases = {"launch_to_cell": time.perf_counter() - t_launch}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        sync()
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    w = wts.make(leaves, seed, dtype, device)
    weight_bytes = wts.nbytes(w)
    phase("weights")
    model, batcher, request_cls = program.build(c, w, mix, device)
    del w
    phase("model")
    if hook:
        hook(model, batcher)
    readback = (verify.CacheReadback(model, batcher)
                if "mean_kv_error" in limits else None)
    traffic = Traffic(mix, seed)
    longest = torch.zeros((1, mix["prompt_tokens"]["hi"]), dtype=torch.int32,
                          device=device)
    model.prefill({"tokens": longest})
    del longest
    phase("longest_prefill")
    loop = ClosedLoop(batcher, request_cls, traffic, mix["clients"])
    loop.start()
    for _ in range(WARM_STEPS):
        loop.step()
    phase("warm_steps")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prefills, decodes = [], []
    if trace:
        model.prefill = _timed(model.prefill, prefills, sync,
                               lambda b: int(b["tokens"].shape[1]))
        model.decode_step = _timed(model.decode_step, decodes, sync)
    t_open = time.perf_counter()
    setup_s = t_open - t_launch
    while True:
        t_close = loop.step()
        if t_close - t_open >= seconds:
            break
    sync()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    stats = window_stats(loop.timeline, t_open, t_close)
    finished = loop.finished()
    profile = None
    if trace:
        del model.prefill, model.decode_step
        from perfbench.profiling import record
        profile = record(loop, model, TRACE_SECONDS, sync)

    run = Run(cell, c, mix, setup_s, stats, prefills, decodes, profile)
    metrics = {}
    for m in registry.cell_metrics(bench, name, trace):
        value = registry.metric(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    judged = verify.sample(finished, mix["check_tokens"],
                           mix["check_requests"], seed)
    written = readback.written([r.rid for r in judged]) if readback \
        else None
    del loop, batcher, model, readback
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    w = wts.make(leaves, seed, dtype, device)
    rows = verify.gaps(ref, c, w, judged, device, control=control,
                       written=written)
    del w, written
    got = verify.numbers(rows)
    correct, checks = verify.judge(got, limits)
    correct = correct and bool(rows)
    # a wrong run's failures: the judged requests whose own numbers break
    # a limit (a mean can break it over the sample and in none alone)
    bad = [r for r in rows if any(verify.numbers([r]).get(k, 0.0) > v
                                  for k, v in limits.items())]
    result = {
        "correct": correct,
        "attempted": stats.completed,
        "failed": 0 if correct else max(1, len(bad)),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s()
        result["device"]["window_s"] = profile.span_s
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": profile.idle_gaps()}
    result["setup"] = phases
    result["window"] = {
        "seconds": stats.seconds, "requests_completed": stats.completed,
        "prefills": stats.prefills, "prompt_tokens": stats.prompt_tokens,
        "output_tokens": stats.output_tokens,
        "judged_requests": len(rows),
        "judged_tokens": sum(r["served"] for r in rows),
        "weight_bytes": weight_bytes}
    if control:
        result["numbers"] = got
        result["control"] = verify.numbers(rows, "control_")
        result["control_correct"] = verify.judge(result["control"],
                                                 limits)[0]
        result["rows"] = rows
    result["checks"] = checks
    return result
