"""The port's one CUDA-graph layer on the card (``repro_torch/graphs.py``):
a decode graph, a prefill graph, a scan program and a city program each
warm up and capture on the device's one side stream, and none of them
makes another stream. The CPU side is ``tests/test_torch_graphs.py``.
Imports no JAX: the card's machine has none.
"""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); CUDA graphs have no CPU "
                    "mode")
    return torch.device("cuda")


def test_every_warm_up_and_capture_runs_on_the_side_stream(cuda,
                                                           monkeypatch):
    """Each warm-up and each capture (a prefill bucket's, a decode key's,
    a scan scenario's and a city's program) runs its body on
    ``graphs.side_stream``, and no ``torch.cuda.Stream`` is built (the
    side stream made beforehand; streams that are only looked up, as
    ``torch.cuda.current_stream`` does, are not counted)."""
    from chip_smoke import CITY_SMALL
    from repro_torch import graphs
    from repro_torch.configs import get_config
    from repro_torch.core import cityscan, scenario
    from repro_torch.data.synthetic_covtype import make_covtype_like
    from repro_torch.models import build_model
    from repro_torch.models import decode_graph as dg
    from repro_torch.models import prefill_graph as pg
    from repro_torch.serving import pad_cache

    side = graphs.side_stream(cuda)
    # torch's own default capture stream, which some versions make at the
    # process's first ``torch.cuda.graph`` even when given a stream, and
    # on which nothing runs
    torch.cuda.graph(torch.cuda.CUDAGraph())
    made = []

    class Counted(torch.cuda.Stream):
        def __new__(cls, *args, **kwargs):
            if "stream_id" not in kwargs:
                made.append(args)
            return super().__new__(cls, *args, **kwargs)

    ran = []

    def spy(real, kind):
        def call(fn, device, **kw):
            def body():
                ran.append((kind, torch.cuda.current_stream(device)))
                return fn()
            return real(body, device, **kw)
        return call

    monkeypatch.setattr(torch.cuda, "Stream", Counted)
    monkeypatch.setattr(graphs, "warm_up", spy(graphs.warm_up, "warm_up"))
    monkeypatch.setattr(graphs, "capture", spy(graphs.capture, "capture"))
    dg.reset_decode_graph_stats()
    pg.reset_prefill_graph_stats()
    cityscan.reset_graph_stats()

    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg).init(seed=0)
    g = torch.Generator().manual_seed(0)
    model.prefill({"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                           generator=g).to(cuda)})
    logits, cache = model.prefill({"tokens": torch.randint(
        0, cfg.vocab_size, (2, 20), generator=g).to(cuda)})
    cache = pad_cache(model, cache, 4, 2, 20)
    tok = logits.argmax(-1)
    for i in range(3):
        logits, cache = model.decode_step(cache, tok[:, None], 20 + i)
        tok = logits.argmax(-1)

    data = make_covtype_like(n_total=3000, seed=0)
    cityscan._PROGRAMS.clear()
    scenario.run_scenario(scenario.ScenarioConfig(
        windows=2, eval_every=1, engine="scan", algo="a2a", tech="wifi",
        seed=1), data, device=cuda)
    scenario.run_scenario(dataclasses.replace(
        scenario.ScenarioConfig(**CITY_SMALL), windows=2), data,
        device=cuda)
    torch.cuda.synchronize()

    assert (pg.prefill_graph_stats()["captures"],
            dg.decode_graph_stats()["captures"],
            cityscan.graph_stats()["captures"]) == (1, 1, 2)
    assert [k for k, _ in ran] == ["warm_up", "capture"] * 4
    assert all(s == side for _, s in ran), ran
    assert made == []
