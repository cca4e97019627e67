"""The program's own spans in the traced span: which ``repro_torch.*`` span
launched each device op, and what each span cost.

The port marks its serve path's layer boundaries with spans
(``repro_torch.spans``; on by themselves while ``torch.profiler`` runs).
:func:`read` reads a profiler's events into a :class:`SpanProfile`: the
fields of :class:`perfbench.profiling.Profile`, read as
:func:`perfbench.profiling.record` reads them (the device timeline's
mirrors of the program's spans left out by name), and besides

* ``spans``: every host range named ``repro_torch.*``, with the index of
  the innermost program span enclosing it (-1 for none);
* ``launched_by``: for each entry of ``kernels``, the innermost program
  span open when the CUDA API call that launched it began
  (-1 for none). A device op and its launching call share the profiler's
  correlation id (CUPTI's), whether the op came through an aten op or,
  as the port's own kernels do, through ``ctypes``.

A device op is a kernel, copy or memset; an op "under X" is one whose
launching host op lies in a span named X or nested in one.
:meth:`SpanProfile.table` gives, per span name: calls, host ms, self host
ms (less its child spans), device ms and launches of the ops launched
directly under it, and idle ms (the idle gaps that began while it was the
innermost program span open).

The metrics ``decode_launches``, ``prefill_launches``,
``moe_decode_us_per_token``, ``moe_prefill_us_per_token``,
``decode_attention_us_per_token`` and ``ssd_mixer_us_per_token``
(``metrics/``) read a :class:`SpanProfile` and give nothing for a plain
``Profile``. ``BENCHMARK.json`` does not list them yet: ``cell.run_cell``
records a plain ``Profile``. Until it records this one, run

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a card: one ``--trace 1`` run of the cell
(``run.py``, the traced span recorded by :func:`record`), then one more
line of JSON: the span table, the six metrics, the share of device time
that links to a program span, and the mean length of the harness's
``prefill`` and ``decode_step`` labels.
"""
from __future__ import annotations

import bisect
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

from perfbench.profiling import LABELS, SPAN, Profile, _label

PREFIX = "repro_torch."
NONE = "(none)"      # the table's row for what no program span holds
RUNTIME = "cu"       # CUDA API calls: cudaLaunchKernel, cuLaunchKernelEx...

# the entries a BENCHMARK.json would list for the six metrics
METRICS = [
    {"name": "decode_launches.chat", "unit": "launches", "better": "lower",
     "source": "device_trace", "layer": "model",
     "moves": "output_tokens_per_s",
     "workloads": ["olmoe-1b-7b.chat", "mamba2-1.3b.chat"]},
    {"name": "prefill_launches.long-prompt", "unit": "launches",
     "better": "lower", "source": "device_trace", "layer": "model",
     "moves": "prompt_tokens_per_s",
     "workloads": ["olmoe-1b-7b.long-prompt", "mamba2-1.3b.long-prompt"]},
    {"name": "moe_decode_us_per_token", "unit": "us", "better": "lower",
     "source": "device_trace", "layer": "model",
     "moves": "output_tokens_per_s", "workloads": ["olmoe-1b-7b.chat"]},
    {"name": "moe_prefill_us_per_token", "unit": "us", "better": "lower",
     "source": "device_trace", "layer": "model",
     "moves": "prompt_tokens_per_s",
     "workloads": ["olmoe-1b-7b.long-prompt"]},
    {"name": "decode_attention_us_per_token", "unit": "us",
     "better": "lower", "source": "device_trace", "layer": "model",
     "moves": "output_tokens_per_s", "workloads": ["olmoe-1b-7b.chat"]},
    {"name": "ssd_mixer_us_per_token", "unit": "us", "better": "lower",
     "source": "device_trace", "layer": "model",
     "moves": "prompt_tokens_per_s",
     "workloads": ["mamba2-1.3b.long-prompt"]},
]


@dataclass
class SpanProfile(Profile):
    spans: List[Tuple[str, float, float, int]] = field(
        default_factory=list)          # (name, start, end, parent) us
    launched_by: List[int] = field(default_factory=list)

    def calls(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def chain(self, i: int) -> Tuple[str, ...]:
        """The names of span ``i`` and of every span enclosing it."""
        names = []
        while i >= 0:
            names.append(self.spans[i][0])
            i = self.spans[i][3]
        return tuple(names)

    def _indexed(self) -> Profile:
        """This trace with the program spans' indices as its host labels."""
        return Profile(self.span, self.kernels, [
            (i, s, e) for i, (_, s, e, _) in enumerate(self.spans)])

    def _launched(self):
        """(span index, device us) of each device op."""
        return [(i, e - s) for (_, s, e), i in
                zip(self.kernels, self.launched_by)]

    def under(self, match: str, inside: str = None) -> Tuple[float, int]:
        """(device us, launches) of the ops under a span named ``match``
        (a prefix where it ends in ``.``) and, where given, under one
        named ``inside``."""
        def hit(n):
            return n.startswith(match) if match.endswith(".") \
                else n == match
        chains, total, n = {}, 0.0, 0
        for i, us in self._launched():
            if i < 0:
                continue
            if i not in chains:
                chains[i] = self.chain(i)
            c = chains[i]
            if any(hit(x) for x in c) and (inside is None or inside in c):
                total += us
                n += 1
        return total, n

    def coverage(self) -> float:
        """The share of device time launched under some program span."""
        ops = self._launched()
        total = sum(us for _, us in ops)
        return sum(us for i, us in ops if i >= 0) / total if total else 0.0

    def table(self) -> dict:
        """Per span name (module doc); ``(none)`` holds the device ops and
        idle gaps outside every program span."""
        rows = defaultdict(lambda: {"calls": 0, "host_ms": 0.0,
                                    "self_host_ms": 0.0, "device_ms": 0.0,
                                    "launches": 0, "idle_ms": 0.0})
        for name, s, e, parent in self.spans:
            rows[name]["calls"] += 1
            rows[name]["host_ms"] += (e - s) / 1e3
            rows[name]["self_host_ms"] += (e - s) / 1e3
            if parent >= 0:
                rows[self.spans[parent][0]]["self_host_ms"] -= (e - s) / 1e3
        for i, us in self._launched():
            row = rows[self.spans[i][0] if i >= 0 else NONE]
            row["device_ms"] += us / 1e3
            row["launches"] += 1
        gaps = self._indexed().idle_gaps(len(self.spans) + 1) \
            if self.span else []
        for i, sec in gaps:
            rows[NONE if i == "other" else self.spans[i][0]]["idle_ms"] += \
                sec * 1e3
        return dict(sorted(rows.items()))

    def label_ms(self) -> dict:
        """Mean length (ms) of each harness label in the traced span."""
        by = defaultdict(list)
        for label, s, e in self.host:
            by[label].append((e - s) / 1e3)
        return {k: sum(v) / len(v) for k, v in sorted(by.items())}


def _nest(spans):
    """(name, start, end, parent) of host ranges (name, start, end) that
    nest, in order of start, the longer first."""
    out, stack = [], []
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and out[stack[-1]][2] <= s:
            stack.pop()
        out.append((name, s, e, stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


def _mirror(name: str) -> bool:
    """Whether a device event is the device timeline's mirror of a host
    range (no device work)."""
    return name in LABELS or name == SPAN or name.startswith(PREFIX)


def read(events, lens=()) -> SpanProfile:
    """A :class:`SpanProfile` of a profiler's events (module doc)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels, ids, host, ranges, span = [], [], [], [], None
    launch = {}             # correlation id -> start of the runtime call
    for e in events:
        r = e.time_range
        if e.device_type == cuda:
            if not _mirror(e.name) and \
                    not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, r.start, r.end))
                ids.append(e.id)
        elif e.name == SPAN:
            span = (r.start, r.end)
        elif e.name in LABELS:
            host.append((e.name, r.start, r.end))
        elif e.name.startswith(PREFIX):
            ranges.append((e.name, r.start, r.end))
        elif e.name.startswith(RUNTIME):
            launch[e.id] = r.start
    p = SpanProfile(span, kernels, host, list(lens), _nest(ranges))
    starts, inner = p._indexed()._segments()

    def innermost(t) -> int:
        j = bisect.bisect_right(starts, t) - 1
        return inner[j] if j >= 0 and inner[j] != "other" else -1
    p.launched_by = [innermost(launch[i]) if i in launch else -1
                     for i in ids]
    return p


def record(loop, model, seconds: float, sync) -> SpanProfile:
    """:func:`perfbench.profiling.record`, read by :func:`read`."""
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
    return read(prof.events(), lens)


def report(bench: dict, cell_name: str, profile: SpanProfile) -> dict:
    """The span table, the six metrics, the coverage and the labels'
    mean lengths of one traced span."""
    from perfbench import registry
    from perfbench.cell import Run

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    run = Run(cell, registry.config(cell["config"]),
              registry.mix(cell["traffic"]), 0.0, None, profile=profile)
    metrics = {}
    for m in METRICS:
        if cell_name in m["workloads"]:
            value = registry.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"workload": cell_name, "metrics": metrics,
            "coverage": profile.coverage(), "labels_ms": profile.label_ms(),
            "spans": profile.table()}


def main() -> int:
    """``run.py --trace 1`` with the traced span read by :func:`record`,
    then the report's line (module doc)."""
    from perfbench import profiling, run

    got = []

    def keep(*args, **kwargs):
        got.append(record(*args, **kwargs))
        return got[-1]
    profiling.record = keep
    sys.argv += ["--trace", "1"]
    rc = run.main()
    if rc or not got:
        return rc or 1
    with open(f"{run.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    name = sys.argv[sys.argv.index("--workload") + 1]
    print(json.dumps(report(bench, name, got[-1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
