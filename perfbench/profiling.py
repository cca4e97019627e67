"""The traced span of a ``--trace 1`` run: ``torch.profiler`` over a few
seconds of the same closed loop, right after the measured window.

The harness labels what the host is doing with ``record_function`` spans
around its own calls into the program (on the instances, nothing inside
the program): ``client_loop`` (the harness's step, its bookkeeping
included), ``step`` (the batcher's step; its own time is the scheduler's
bookkeeping: the argmax copy and the per-slot loop), ``refill`` (slot
refills: splice and cache padding), ``prefill`` and ``decode_step``
(``Model.prefill`` and ``Model.decode_step``). From the trace:

* the device's busy time: the union of the kernels' intervals inside the
  span; the idle share is one less busy over the span;
* the kernels' device time by name, and of any set of kernels;
* the idle gaps between kernels, each labelled by the innermost host span
  open when it began, summed by label;
* the prompt lengths of the prefills the span holds, for the rooflines.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

SPAN = "bench.span"
LABELS = ("client_loop", "step", "refill", "prefill", "decode_step")


@dataclass
class Profile:
    span: Tuple[float, float]                       # us, profiler clock
    kernels: List[Tuple[str, float, float]]         # (name, start, end) us
    host: List[Tuple[str, float, float]]            # labelled host spans
    prefill_lens: List[int] = field(default_factory=list)

    @property
    def span_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e6

    def merged(self):
        """The union of the kernels' intervals, clipped to the span."""
        lo, hi = self.span
        out = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def kernel_s(self, match) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name ``match``
        accepts."""
        hits = [e - s for n, s, e in self.kernels if match(n)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n=10):
        by = defaultdict(float)
        for name, s, e in self.kernels:
            by[name[:160]] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def _segments(self):
        """Flat (start, innermost label) boundaries of the nested host
        spans."""
        marks = []
        for label, s, e in self.host:
            marks.append((s, 1, -(e - s), label))
            marks.append((e, 0, 0.0, label))
        marks.sort()
        stack, starts, labels = [], [], []
        for t, is_start, _, label in marks:
            if is_start:
                stack.append(label)
            elif label in stack:
                stack.reverse()
                stack.remove(label)
                stack.reverse()
            starts.append(t)
            labels.append(stack[-1] if stack else "other")
        return starts, labels

    def idle_gaps(self, n=10):
        """Idle seconds summed by the label open when each gap began."""
        starts, labels = self._segments()
        lo, hi = self.span
        by = defaultdict(float)
        prev = lo
        for s, e in self.merged() + [[hi, hi]]:
            if s > prev:
                i = bisect.bisect_right(starts, prev) - 1
                by[labels[i] if i >= 0 else "other"] += (s - prev) / 1e6
            prev = max(prev, e)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def _label(fn, name):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def record(loop, model, seconds: float, sync) -> Profile:
    """Run ``loop`` under the profiler for ``seconds`` (whole steps) and
    read the trace (module doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    batcher = loop.batcher
    lens = []
    prefill = model.prefill

    def counted_prefill(batch, **kw):
        lens.append(int(batch["tokens"].shape[1]))
        return prefill(batch, **kw)
    model.prefill = _label(counted_prefill, "prefill")
    model.decode_step = _label(model.decode_step, "decode_step")
    batcher._refill_slots = _label(batcher._refill_slots, "refill")
    batcher.step = _label(batcher.step, "step")
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with record_function("client_loop"):
                    loop.step()
            sync()
    kernels, host, span = [], [], None
    for e in prof.events():
        r = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the profiler mirrors record_function ranges onto the device's
            # timeline; they are no device work
            if e.name not in LABELS and e.name != SPAN and \
                    not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, r.start, r.end))
        elif e.name == SPAN:
            span = (r.start, r.end)
        elif e.name in LABELS:
            host.append((e.name, r.start, r.end))
    return Profile(span, kernels, host, lens)
