"""The prefill graph on the card (``repro_torch/models/prefill_graph.py``):
replays bitwise the eager padded body for every family it serves, one
capture per bucket, outputs a caller holds left intact by later replays,
every graph and the pool dropped once the pool passes its memory share;
at full width (olmoe-, mamba2- and minicpm3-shaped models at two layers,
bfloat16) as near the float32 prefill as the eager true-length prefill
is; a continuous batcher serving the tokens it serves with the graphs
bypassed; chip_smoke's decode-vs-prefill check through the graphs. The
CPU side is ``tests/test_torch_prefill_graph.py``. Imports no JAX: the
card's machine has none.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); CUDA graphs have no CPU "
                    "mode")
    return torch.device("cuda")


def _config(arch, **changes):
    """The arch's reduced config (``changes`` on top), an MoE at capacity
    factor 8 (top-2 of 4 experts: nothing can drop, so the graph
    engages)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _tokens(vocab, B, L, seed, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (B, L), generator=g).to(device)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


GRAPH_CASES = {"dense": "llama3.2-3b", "moe": "olmoe-1b-7b",
               "mla": "minicpm3-4b", "moe-mla": "deepseek-v3-671b",
               "ssm": "mamba2-1.3b"}
# (batch, length): the first call is the model's warm-up; 24 and 20 share
# the bucket 32, 200 and 190 the bucket 208; 3 pads to 16
CALLS = [(1, 40), (1, 24), (1, 200), (1, 20), (2, 37), (1, 190), (1, 3),
         (2, 37), (1, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_prefill_graph_replays_are_bitwise_the_eager_padded_body(cuda, case,
                                                                 dtype):
    """Each call through ``Model.prefill`` (one eager warm-up, then a
    capture for each new (batch, bucket) and replays) gives the logits
    and cache of the padded body run eagerly (``prefill_graph.eager``),
    bit for bit; logits and caches returned earlier are intact after
    replays in other buckets; the stats count one capture per bucket,
    every real and pad token, and the kernel launches of the replays as
    the eager padded body makes them."""
    from repro_torch import graphs
    from repro_torch.models import build_model
    from repro_torch.models import prefill_graph as pg

    cfg = _config(GRAPH_CASES[case])
    model = build_model(cfg, dtype=dtype).init(seed=0)
    pg.reset_prefill_graph_stats()
    kept = []
    launches = {}
    for i, (B, L) in enumerate(CALLS):
        tokens = _tokens(cfg.vocab_size, B, L, seed=i)
        logits, cache = model.prefill({"tokens": tokens})
        before = graphs.kernel_launches()
        want_logits, want = pg.eager(model, tokens)
        for k, n in graphs.kernel_launches().items():
            if i and n > before[k]:
                launches[k] = launches.get(k, 0) + n - before[k]
        assert torch.equal(logits, want_logits), (i, L)
        assert set(cache) == set(want)
        for k in want:
            assert cache[k].shape == want[k].shape, (i, k)
            assert torch.equal(cache[k], want[k]), (i, k)
        kept.append(((logits, cache),
                     (logits.clone(), {k: v.clone() for k, v in
                                       cache.items()})))
    for (logits, cache), (l0, c0) in kept:
        assert torch.equal(logits, l0)
        for k in c0:
            assert torch.equal(cache[k], c0[k]), k
    stats = pg.prefill_graph_stats()
    keys = {(B, pg.bucket(L)) for B, L in CALLS[1:]}
    assert (stats["eager"], stats["captures"], stats["replays"]) == \
        (1, len(keys), len(CALLS) - 1), stats
    assert stats["tokens"] == sum(B * L for B, L in CALLS)
    assert stats["pad_tokens"] == sum(B * (pg.bucket(L) - L)
                                      for B, L in CALLS)
    assert stats["launches"] == launches and stats["dropped"] == 0
    assert len(model._prefill_graphs.graphs) == len(keys)
    model.load_params({p: (torch.stack(v) if isinstance(v, list) else v)
                       for p, v in model.param_tree().items()})
    assert model._prefill_graphs is None


def _pools():
    """The private memory pools (CUDA graphs') that hold memory."""
    return {tuple(seg["segment_pool_id"]) for seg in
            torch.cuda.memory_snapshot()} - {(0, 0)}


def test_prefill_graphs_dropped_over_the_memory_share(cuda, monkeypatch):
    """Once the graphs' pool holds more than ``MEMORY_SHARE`` of the
    card, the next capture drops every graph and the pool, and the pool's
    memory goes back to the device: with a share of 0 a model holds one
    graph at a time in one pool, every call still gives the eager padded
    body bit for bit, and a dropped bucket is captured again."""
    from repro_torch.models import build_model
    from repro_torch.models import prefill_graph as pg

    cfg = _config("mamba2-1.3b")
    model = build_model(cfg).init(seed=0)
    model.prefill({"tokens": _tokens(cfg.vocab_size, 1, 40, seed=0)})
    model.prefill({"tokens": _tokens(cfg.vocab_size, 1, 24, seed=0)})
    state = model._prefill_graphs
    assert state.pool_bytes == pg.pool_bytes(state.pool) > 0
    monkeypatch.setattr(pg, "MEMORY_SHARE", 0.0)
    pg.reset_prefill_graph_stats()
    others = _pools() - {tuple(state.pool)}      # other tests' graphs
    lengths = [60, 90, 24, 60, 24, 120]      # buckets 64, 96, 32, 64, 32, 128
    for i, L in enumerate(lengths):
        tokens = _tokens(cfg.vocab_size, 1, L, seed=i)
        logits, cache = model.prefill({"tokens": tokens})
        want_logits, want = pg.eager(model, tokens)
        assert torch.equal(logits, want_logits), L
        for k in want:
            assert torch.equal(cache[k], want[k]), (L, k)
        assert [k[1] for k in state.graphs] == [pg.bucket(L)]
        assert _pools() - others == {tuple(state.pool)}
    stats = pg.prefill_graph_stats()
    assert (stats["captures"], stats["replays"], stats["dropped"]) == \
        (6, 6, 6), stats


# Full-width configurations at two layers, as the benchmark serves them:
# (arch, config changes).
FULL_WIDTH = {"olmoe-1b-7b": {"moe_capacity": 8.0},
              "mamba2-1.3b": {}, "minicpm3-4b": {}}


@pytest.mark.parametrize("arch", list(FULL_WIDTH))
def test_prefill_graph_at_full_width_keeps_the_eager_prefill_accuracy(cuda,
                                                                      arch):
    """At the benchmark's widths in bfloat16 (two layers), the graph's
    logits and caches lie as near a float32 twin's eager prefill as the
    bfloat16 eager true-length prefill does (within twice its error, the
    bar chip_smoke sets for served logits), at prompts from a chat mix's
    and a long-prompt mix's range."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import prefill_graph as pg

    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="bfloat16")
    if FULL_WIDTH[arch].get("moe_capacity"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=FULL_WIDTH[arch]["moe_capacity"]))
    model = build_model(cfg).init(seed=0)
    twin = build_model(cfg, dtype="float32").load_params(
        {p: (torch.stack(v) if isinstance(v, list) else v)
         for p, v in model.param_tree().items()})
    model.prefill({"tokens": _tokens(cfg.vocab_size, 1, 64, seed=9)})
    pg.reset_prefill_graph_stats()
    for L in (100, 1000, 1500):
        tokens = _tokens(cfg.vocab_size, 1, L, seed=L)
        logits, cache = model.prefill({"tokens": tokens})
        eager_logits, eager = model._prefill_body({"tokens": tokens})
        ref_logits, ref = twin._prefill_body({"tokens": tokens})
        e_graph, e_eager = _rel(logits, ref_logits), _rel(eager_logits,
                                                          ref_logits)
        assert e_graph <= 2 * e_eager, (L, e_graph, e_eager)
        for k in ref:
            assert cache[k].shape == ref[k].shape, k
            c_graph, c_eager = _rel(cache[k], ref[k]), _rel(eager[k], ref[k])
            assert c_graph <= 2 * c_eager + 1e-3, (L, k, c_graph, c_eager)
    assert pg.prefill_graph_stats()["replays"] == 3


SERVED = ("olmoe-1b-7b", "mamba2-1.3b", "minicpm3-4b")


@pytest.mark.parametrize("arch", SERVED)
def test_batcher_with_the_prefill_graphs_matches_the_eager_batcher(cuda,
                                                                   arch):
    """A continuous batcher in float32 serves the tokens it serves with
    the prefill graphs bypassed (``prefill`` bound to the eager body) and
    leaves a cache as near; every refill after the model's warm-up is a
    replay."""
    from repro_torch.models import build_model
    from repro_torch.models import prefill_graph as pg
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    cfg = _config(arch)
    model = build_model(cfg).init(seed=0)
    rng = np.random.default_rng(0)
    lens = [(int(rng.integers(4, 60)), int(rng.integers(3, 12)))
            for _ in range(9)]

    def serve(eager):
        if eager:
            model.prefill = model._prefill_body
        try:
            b = ContinuousBatcher(model, slots=3, max_len=80)
            reqs = [Request(i, np.random.default_rng(100 + i).integers(
                0, cfg.vocab_size, n), m) for i, (n, m) in enumerate(lens)]
            for r in reqs:
                b.submit(r)
            b.run()
        finally:
            if eager:
                del model.prefill
        return [r.out for r in reqs], b.cache

    pg.reset_prefill_graph_stats()
    out_g, cache_g = serve(eager=False)
    stats = pg.prefill_graph_stats()
    out_e, cache_e = serve(eager=True)
    assert out_g == out_e
    for k in cache_g:
        assert _rel(cache_g[k], cache_e[k]) < 1e-4, k
    assert (stats["eager"], stats["replays"]) == (1, len(lens) - 1), stats
    assert stats["captures"] == len({pg.bucket(n) for n, _ in lens[1:]})


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b",
                                  "minicpm3-4b", "deepseek-v3-671b",
                                  "mamba2-1.3b"])
def test_decode_vs_prefill_through_the_prefill_graphs(cuda, arch):
    """chip_smoke's decode-vs-prefill check (a full prefill of S + 1
    tokens against a prefill of S and one decode step; MoE at capacity
    factor 8) with both prefills replayed, on the reduced config in
    float32: within the port's decode == prefill bar (2e-3)."""
    from chip_smoke import decode_vs_prefill, lm_batch
    from repro_torch.models import build_model
    from repro_torch.models import prefill_graph as pg

    cfg = _config(arch)
    model = build_model(cfg).init(seed=0)
    model.prefill({"tokens": _tokens(cfg.vocab_size, 2, 8, seed=1)})
    pg.reset_prefill_graph_stats()
    full, dec = decode_vs_prefill(model, lm_batch(cfg, 2, 48, seed=2))
    assert _rel(dec, full) < 2e-3
    stats = pg.prefill_graph_stats()
    assert (stats["replays"], stats["eager"]) == (2, 0), stats
