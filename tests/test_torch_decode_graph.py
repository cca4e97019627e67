"""The decode graph's CPU side (``repro_torch/models/decode_graph.py``):
on the CPU ``Model.decode_step`` never captures and runs its eager body
bit for bit; a graph's key changes with the cache's buffers, ``pos``'s
rank and the batch, and with nothing else; a meta model decodes eagerly
(the refusals of DTensor, meta and fake inputs, an ambient mesh and the
CPU are ``tests/test_torch_graphs.py``'s); anything that rebinds
the model's tensors drops its graph, and so does the death of a cache
leaf it was captured on. The card side (replays
bitwise equal to the eager step for every family, the batcher with the
graph against the batcher without it) is in ``tests/test_torch_cuda.py``.
"""
import copy
import dataclasses
import threading

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import decode_graph as dg
from repro_torch.serving import pad_cache

torch.set_num_threads(1)

B, S, NEW = 2, 12, 4

ARCHS = [("llama3.2-3b", {}), ("llama3.2-3b", {"sliding_window": 8}),
         ("olmoe-1b-7b", {}), ("minicpm3-4b", {}), ("mamba2-1.3b", {}),
         ("recurrentgemma-9b", {"num_layers": 5})]


def _served(arch, changes, seed=0):
    """A reduced model on the CPU and its padded cache after a prefill of
    B x S tokens, with the argmax tokens of that prefill."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg, device="cpu").init(seed=seed)
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    logits, cache = model.prefill({"tokens": tokens})
    return model, pad_cache(model, cache, NEW, B, S), logits.argmax(-1)


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("arch,changes", ARCHS,
                         ids=[f"{a}{'-window' if c.get('sliding_window') else ''}"
                              for a, c in ARCHS])
def test_cpu_decode_never_captures(arch, changes):
    """Every step on the CPU is eager: the stats count only ``eager``,
    and logits and caches are the private body's on a clone, bit for
    bit, with per-sequence and shared positions."""
    model, cache, tok = _served(arch, changes)
    ref_cache, ref_tok = _clone(cache), tok.clone()
    dg.reset_decode_graph_stats()
    for i in range(NEW):
        pos = torch.full((B,), S + i) if i % 2 else torch.tensor(S + i)
        logits, out = model.decode_step(cache, tok[:, None], pos)
        ref, ref_cache = model._decode_body(ref_cache, ref_tok[:, None], pos)
        assert out is cache and torch.equal(logits, ref)
        tok, ref_tok = logits.argmax(-1), ref.argmax(-1)
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k])
    assert dg.decode_graph_stats() == {"captures": 0, "capture_s": 0.0,
                                       "replays": 0, "eager": NEW,
                                       "launches": {}}
    assert model._decode_graph is None


def test_graph_key_follows_buffers_pos_rank_and_batch():
    """A new cache object, another ``pos`` rank or another batch makes a
    new key; another position or token value, or an int in place of a 0-d
    long, does not."""
    model, cache, tok = _served("llama3.2-3b", {})
    cfg = model.cfg

    def key(c=cache, t=tok[:, None], p=torch.full((B,), S)):
        return dg.graph_key(c, t, p, cfg)

    assert key() == key(p=torch.full((B,), S + 3)) == key(t=tok[:, None] + 1)
    assert key() != key(c=_clone(cache))
    assert key(c=dict(cache)) == key()            # same buffers, new dict
    assert key() != key(p=torch.tensor(S))
    assert key(p=torch.tensor(S)) == key(p=S)
    other, other_cache, other_tok = _served("llama3.2-3b", {})
    assert key() != dg.graph_key(other_cache, other_tok[:, None],
                                 torch.full((B,), S), cfg)
    wider = {k: torch.cat([v, v[:, :1]], dim=1) for k, v in cache.items()}
    assert key() != key(c=wider, t=torch.cat([tok, tok[:1]])[:, None],
                        p=torch.full((B + 1,), S))
    assert key() != dg.graph_key(cache, tok[:, None], torch.full((B,), S),
                                 dataclasses.replace(cfg, norm_eps=1e-6))


def test_meta_model_decodes_eagerly():
    """The dry-run's shapes-only model decodes through the eager body."""
    cfg = get_config("mamba2-1.3b").reduced()
    model = build_model(cfg, device="meta")
    cache = {k: torch.zeros(s.shape, device="meta")
             for k, s in model.cache_template(B, S).items()}
    dg.reset_decode_graph_stats()
    logits, out = model.decode_step(cache, torch.zeros((B, 1),
                                                       dtype=torch.long,
                                                       device="meta"), S)
    assert logits.is_meta and logits.shape == (B, cfg.vocab_size)
    assert out is cache and dg.decode_graph_stats()["eager"] == 1


def _flat(model):
    return {p: (torch.stack(v) if isinstance(v, list) else v).clone()
            for p, v in model.param_tree().items()}


@pytest.mark.parametrize("rebind", ["load_params", "init", "to", "float"])
def test_rebinding_the_tensors_drops_the_graph(rebind):
    """``load_params``, ``init`` and a move or cast of the module drop
    the model's graph (a stand-in here: the CPU never captures one)."""
    model = build_model(get_config("llama3.2-3b").reduced(),
                        device="cpu").init(seed=0)
    flat = _flat(model)
    model._decode_graph = object()
    {"load_params": lambda: model.load_params(flat),
     "init": lambda: model.init(seed=1),
     "to": lambda: model.to("cpu"),
     "float": lambda: model.float()}[rebind]()
    assert model._decode_graph is None


def test_a_copy_of_the_model_starts_without_a_graph():
    """A deep copy (as the card tests make of a CPU model) leaves the
    graph, which cannot be copied, with the original."""
    model = build_model(get_config("llama3.2-3b").reduced(),
                        device="cpu").init(seed=0)
    held = threading.Lock()                  # copies as little as a graph
    model._decode_graph = held
    twin = copy.deepcopy(model)
    assert twin._decode_graph is None and model._decode_graph is held
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def test_a_dead_cache_leaf_drops_the_graph():
    """The graph holds its cache leaves weakly: the first leaf to die
    drops the model's graph (and with it the pool), a graph the model has
    already let go of drops nothing, and a dead model is no fault."""
    model = build_model(get_config("llama3.2-3b").reduced(),
                        device="cpu").init(seed=0)
    cache = {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)}
    old_cache = _clone(cache)
    old = dg.DecodeGraph(("old",), old_cache, model)
    model._decode_graph = g = dg.DecodeGraph(("new",), cache, model)
    del old_cache                                # not the model's graph
    assert model._decode_graph is g and old.leaves[0]() is None
    del g, cache["v"]
    assert model._decode_graph is None
    model._decode_graph = dg.DecodeGraph(("new",), cache, model)
    del model
    cache.clear()
