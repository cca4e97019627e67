"""The serve path's spans (``repro_torch.spans``): off, a span makes no
``record_function`` call and allocates nothing; under a profiler it is
one ``record_function`` range of its name."""
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans

torch.set_num_threads(1)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    names = []

    def counted(name):
        names.append(name)
        return spans.nullcontext()
    monkeypatch.setattr(spans, "record_function", counted)
    for _ in range(3):
        with spans.span("repro_torch.decode_step") as got:
            assert got is None
    assert names == []
    assert spans.span("repro_torch.head") is spans.span("repro_torch.prefill")
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("repro_torch.decode_step"):
            pass
    assert names == ["repro_torch.decode_step"]


def test_span_is_a_range_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("repro_torch.decode_step"):
            with spans.span("repro_torch.head"):
                torch.ones(4).sum()
    ev = {e.name: e for e in prof.events()
          if e.name.startswith(spans.PREFIX)}
    assert set(ev) == {"repro_torch.decode_step", "repro_torch.head"}
    outer, inner = (ev["repro_torch.decode_step"].time_range,
                    ev["repro_torch.head"].time_range)
    assert outer.start <= inner.start <= inner.end <= outer.end
