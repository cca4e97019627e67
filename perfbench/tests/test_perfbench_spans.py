"""The program's spans as the benchmark reads them (``perfbench/spans.py``):
one batcher step of each tiny model yields every span at its place; a
synthetic trace with program spans and their device-side mirrors keeps
every field of today's ``Profile``; the six span metrics read the
expected numbers, and nothing where there is nothing to read."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import program, registry, weights as wts
from perfbench.cell import Run
from perfbench.loop import ClosedLoop
from perfbench.profiling import LABELS, SPAN, Profile
from perfbench.spans import METRICS, SpanProfile, read
from perfbench.tests.conftest import TINY, TINY_MIX
from perfbench.tests.test_perfbench_profile import synthetic
from perfbench.traffic import Traffic

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

SERVE = {"repro_torch.serve.step": {None},
         "repro_torch.serve.refill": {"repro_torch.serve.step"},
         "repro_torch.serve.prefill": {"repro_torch.serve.refill"},
         "repro_torch.serve.pad_cache": {"repro_torch.serve.prefill"},
         "repro_torch.serve.splice": {"repro_torch.serve.refill"},
         "repro_torch.serve.sample": {"repro_torch.serve.step"},
         "repro_torch.prefill": {"repro_torch.serve.prefill"},
         "repro_torch.decode_step": {"repro_torch.serve.step"},
         "repro_torch.head": {"repro_torch.prefill",
                              "repro_torch.decode_step"}}
BOTH = {"repro_torch.prefill", "repro_torch.decode_step"}
NESTED = {
    "olmoe-1b-7b": dict(SERVE, **{
        "repro_torch.attention": {"repro_torch.prefill"},
        "repro_torch.decode_attention": {"repro_torch.decode_step"},
        "repro_torch.moe.router": BOTH, "repro_torch.moe.dispatch": BOTH,
        "repro_torch.moe.experts": BOTH, "repro_torch.moe.combine": BOTH}),
    "mamba2-1.3b": dict(SERVE, **{
        "repro_torch.ssd.in_proj": {"repro_torch.prefill"},
        "repro_torch.ssd.conv": {"repro_torch.prefill"},
        "repro_torch.ssd_scan": {"repro_torch.prefill"},
        "repro_torch.ssd.out": {"repro_torch.prefill"},
        "repro_torch.ssd.decode": {"repro_torch.decode_step"}}),
}


@pytest.mark.parametrize("name", sorted(NESTED))
def test_one_step_yields_every_span_nested(name):
    """One ``ContinuousBatcher.step`` that refills every slot and decodes
    them, under a CPU profiler: each span of the family, inside the
    spans it belongs in."""
    c = registry.config(name)
    c.update(TINY[name])
    mix = registry.mix("chat")
    mix.update(TINY_MIX["chat"])
    w = wts.make(registry.reference_of(c).leaves(c), 3,
                 getattr(torch, c["dtype"]), "cpu")
    model, batcher, request_cls = program.build(c, w, mix, "cpu")
    loop = ClosedLoop(batcher, request_cls, Traffic(mix, 3), mix["clients"])
    loop.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.step()
    p = read(prof.events())
    parents = {}
    for n, _, _, i in p.spans:
        parents.setdefault(n, set()).add(p.spans[i][0] if i >= 0 else None)
    assert parents == NESTED[name]
    assert p.calls("repro_torch.prefill") == mix["slots"]
    assert p.calls("repro_torch.decode_step") == 1


class Ev:
    """The fields of a ``FunctionEvent`` that the readers use; a device op
    and the runtime call that launched it share an ``id``."""

    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    def __init__(self, name, start, end, *, device=False, id=0,
                 annotation=False):
        self.name, self.time_range = name, Ev.Range(start, end)
        self.device_type = CUDA if device else CPU
        self.id, self.is_user_annotation = id, annotation


def launch(at, name, start, end, id):
    """A kernel and the ``cudaLaunchKernel`` at ``at`` that launched it,
    inside an aten op that the profiler numbers apart (ids may collide)."""
    return [Ev("aten::op", at - 1, at + 5, id=id),
            Ev("cudaLaunchKernel", at, at + 3, id=id),
            Ev(name, start, end, device=True, id=id)]


def synthetic_events():
    """``synthetic()``'s trace as profiler events, with program spans, the
    host ops that launched each kernel, and the device timeline's mirrors
    of host ranges (one not flagged as an annotation)."""
    base = synthetic()
    ev = [Ev(SPAN, *base.span)] + [Ev(n, s, e) for n, s, e in base.host]
    ev += [Ev("repro_torch.serve.step", 52, 948),
           Ev("repro_torch.prefill", 101, 499),
           Ev("repro_torch.moe.router", 110, 130),
           Ev("repro_torch.attention", 200, 240),
           Ev("repro_torch.decode_step", 601, 899),
           Ev("repro_torch.decode_attention", 610, 640),
           Ev("repro_torch.head", 880, 890, id=9)]
    for i, (at, k) in enumerate(zip((112, 205, 620, 700), base.kernels)):
        ev += launch(at, *k, id=i + 1)
    ev += [Ev("repro_torch.prefill", 120, 400, device=True),
           Ev("repro_torch.decode_step", 650, 850, device=True,
              annotation=True),
           Ev("decode_step", 650, 850, device=True)]
    return base, ev


def test_program_spans_leave_the_profile_as_it_was():
    base, events = synthetic_events()
    p = read(events, base.prefill_lens)
    assert p.span == base.span and p.host == base.host
    assert p.kernels == base.kernels and p.prefill_lens == base.prefill_lens
    assert p.busy_s() == base.busy_s()
    assert p.top_ops() == base.top_ops()
    assert p.idle_gaps() == base.idle_gaps()
    assert not any(n.startswith("repro_torch.") for n, _ in p.top_ops())
    assert [s[0] for s in p.spans] == [
        "repro_torch.serve.step", "repro_torch.prefill",
        "repro_torch.moe.router", "repro_torch.attention",
        "repro_torch.decode_step", "repro_torch.decode_attention",
        "repro_torch.head"]
    assert [p.spans[i][0] for i in p.launched_by] == [
        "repro_torch.moe.router", "repro_torch.attention",
        "repro_torch.decode_attention", "repro_torch.decode_step"]
    assert p.coverage() == 1.0


def readers_trace():
    """Two prefills (100 and 300 tokens) and two decode steps of 4 slots;
    each kernel's device us and the span its launch lies in as noted."""
    spans = [("repro_torch.prefill", 100, 1000),
             ("repro_torch.moe.router", 110, 200),      # 10 us
             ("repro_torch.moe.experts", 200, 300),     # 40
             ("repro_torch.ssd.conv", 300, 400),        # 20
             ("repro_torch.ssd_scan", 400, 500),        # 100
             ("repro_torch.ssd.out", 500, 600),         # 5; prefill self 5
             ("repro_torch.prefill", 2000, 2500),
             ("repro_torch.moe.combine", 2100, 2200),   # 30
             ("repro_torch.decode_step", 3000, 4000),
             ("repro_torch.decode_attention", 3100, 3200),  # 80
             ("repro_torch.moe.dispatch", 3200, 3300),  # 12
             ("repro_torch.head", 3900, 3950),          # 8
             ("repro_torch.decode_step", 5000, 6000),
             ("repro_torch.decode_attention", 5100, 5200),  # 40
             ("repro_torch.moe.experts", 5200, 5300)]   # 60
    launches = [(120, 10), (210, 40), (310, 20), (410, 100), (510, 5),
                (700, 5), (2110, 30), (3110, 80), (3210, 12), (3910, 8),
                (5110, 40), (5210, 60), (7000, 10)]     # the last: no span
    ev = [Ev(SPAN, 0, 20000)] + [Ev(*s) for s in spans]
    t = 10000
    for i, (at, us) in enumerate(launches):
        ev += launch(at, f"k{i}", t, t + us, id=i + 1)
        t += us
    ev.append(Ev("unlinked", t, t + 10, device=True, id=99))
    return read(ev, [100, 300])


EXPECTED = {"decode_launches.chat": 5 / 2,
            "prefill_launches.long-prompt": 7 / 2,
            "moe_decode_us_per_token": (12 + 60) / (2 * 4),
            "moe_prefill_us_per_token": (10 + 40 + 30) / 400,
            "decode_attention_us_per_token": (80 + 40) / (2 * 4),
            "ssd_mixer_us_per_token": (20 + 5) / 400}


def _run(p):
    return Run({}, {}, {"slots": 4}, 1.0, None, profile=p)


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_span_metric_reads_its_spans(name):
    reader = registry.metric(name)
    assert reader.read(_run(readers_trace())) == pytest.approx(
        EXPECTED[name])
    empty = SpanProfile((0.0, 10.0), [], [], [])
    plain = Profile((0.0, 10.0), [], [], [100])
    assert reader.read(_run(empty)) is None
    assert reader.read(_run(plain)) is None


def test_span_table_and_coverage():
    p = readers_trace()
    t = p.table()
    assert t["repro_torch.prefill"]["calls"] == 2
    assert t["repro_torch.prefill"]["host_ms"] == pytest.approx(1.4)
    # less its children: 900 - 490 and 500 - 100 us
    assert t["repro_torch.prefill"]["self_host_ms"] == pytest.approx(0.81)
    assert t["repro_torch.prefill"]["launches"] == 1
    assert t["repro_torch.prefill"]["device_ms"] == pytest.approx(0.005)
    assert t["(none)"]["launches"] == 2
    assert sum(r["launches"] for r in t.values()) == len(p.kernels)
    assert sum(r["idle_ms"] for r in t.values()) == pytest.approx(
        1e3 * (p.span_s - p.busy_s()))
    assert p.coverage() == pytest.approx(410 / 430)


def test_metrics_name_only_cells_and_layers_the_benchmark_has():
    from perfbench.tests.conftest import bench
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    moved = {m["name"]: set(m.get("workloads", cells))
             for m in b["end_to_end"]}
    for m in METRICS:
        assert set(m["workloads"]) <= moved[m["moves"]]
        assert m["source"] == "device_trace" and m["better"] == "lower"
    assert set(LABELS) >= {"prefill", "decode_step"}
