"""The prefill graph's CPU side (``repro_torch/models/prefill_graph.py``):
the padded body (``Model._prefill_body`` given a length, through
``prefill_graph.eager``, what a replay gives on the card) against the
true-length eager prefill on tiny GQA, MoE (capacity factor 8), MLA and
SSM models, at lengths 1-3, on each side of a bucket's edge and across
the SSD chunks; ``ssd_forward`` without a length as before; the bucket
rule; every refusal a CPU run shows, each running the eager body bit for
bit (those of tensors and a mesh, and the stats' counters, are
``tests/test_torch_graphs.py``'s); what drops the graphs. The card side
(replays bitwise the eager padded body, the batcher with the graphs
against the batcher without) is in
``tests/test_torch_prefill_graph_cuda.py``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_lm_batch
from repro_torch.models import build_model
from repro_torch.models import prefill_graph as pg
from repro_torch.models import ssd

torch.set_num_threads(1)


def _cfg(arch, **changes):
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    if cfg.moe is not None and "moe" not in changes:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _model(cfg, seed=0):
    return build_model(cfg, device="cpu").init(seed=seed)


def _tokens(cfg, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, L), generator=g)


def _rel(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


# tiny float32 models: GQA, MoE at capacity factor 8 (top-2 of 4: nothing
# drops), MLA, SSM (chunk 32, conv width 4)
ARCHS = {"gqa": "llama3.2-3b", "moe": "olmoe-1b-7b", "mla": "minicpm3-4b",
         "ssm": "mamba2-1.3b"}
# 1-3; 15, 16, 17 about the first bucket's edge; 33 -> 48 and 100 -> 112
# across SSD chunks of 32; 257 -> 288 past an octave's edge (steps of 32)
LENGTHS = [1, 2, 3, 15, 16, 17, 33, 100, 257]
MODELS = {}


def _served(kind):
    if kind not in MODELS:
        MODELS[kind] = _model(_cfg(ARCHS[kind]))
    return MODELS[kind]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", list(ARCHS))
def test_padded_body_matches_the_true_length_prefill(kind, L):
    """The padded body's logits and caches, cut to the prompt, are the
    eager prefill's within float32 rounding: the last logits, k/v or ckv
    up to L, the SSD state and conv tail. A conv tail of a prompt shorter
    than the conv window holds the conv's zero padding before position 0
    (the true-length prefill's holds fewer rows, which decode cannot take:
    its last rows are compared)."""
    model = _served(kind)
    tokens = _tokens(model.cfg, 2 if L in (3, 33) else 1, L, seed=L)
    want_logits, want = model.prefill({"tokens": tokens})
    got_logits, got = pg.eager(model, tokens)
    assert _rel(got_logits, want_logits) < 1e-5
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.is_contiguous(), name
        if name == "conv" and w.shape[2] < g.shape[2]:
            assert not g[:, :, :g.shape[2] - L].any()
            g = g[:, :, -w.shape[2]:]
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-5, name


def test_ssd_forward_without_a_length_is_unchanged():
    """Without a length the mixer runs as before: its state and conv tail
    are the unpadded path's, and a length equal to S (no pad) changes no
    bit of y, the state or the conv tail."""
    cfg = _cfg("mamba2-1.3b")
    model = _model(cfg)
    p = model.layers[0]["mixer"]
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, (h, tail) = ssd.ssd_forward(p, x, cfg)
    y2, (h2, tail2) = ssd.ssd_forward(p, x, cfg, length=torch.tensor(40))
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(tail, tail2)
    assert torch.equal(tail, (x @ p["w_xbc"])[:, 40 - 3:])


def _log_uniform_share(lo, hi):
    """(pad tokens over prompt tokens, buckets) of prompts log-uniform in
    lo..hi, as the benchmark's mixes draw them."""
    L = np.arange(lo, hi + 1)
    w = 1.0 / L
    Lb = np.array([pg.bucket(int(n)) for n in L])
    return float((w * (Lb - L)).sum() / (w * L).sum()), len(set(Lb))


@pytest.mark.parametrize("mix,lo,hi,buckets", [("long-prompt", 750, 3000, 17),
                                               ("chat", 64, 1024, 29)])
def test_bucket_rule(mix, lo, hi, buckets):
    """Each bucket holds its prompt, is its own bucket, grows with the
    length, pads by less than an eighth above 128 tokens and by less than
    16 below; over a mix's log-uniform prompts the mean padding is under
    5% of the prompt tokens, in a bucket count that the warm-up covers."""
    prev = 0
    for L in range(1, 4 * hi):
        Lb = pg.bucket(L)
        assert L <= Lb and prev <= Lb and pg.bucket(Lb) == Lb, L
        assert Lb - L < (16 if L <= 129 else L / 8), L
        prev = Lb
    share, n = _log_uniform_share(lo, hi)
    assert share < 0.05 and n == buckets, (mix, share, n)


def _stats_delta(fn):
    pg.reset_prefill_graph_stats()
    out = fn()
    return out, pg.prefill_graph_stats()


# Refusals a CPU run shows with its own eager prefill: (reason, arch,
# config changes, prefill kwargs); the CPU alone refuses "device".
RUN_REFUSALS = [
    ("device", "llama3.2-3b", {}, {}),
    ("plain", "mamba2-1.3b", {}, {"plain": True}),
    ("family", "recurrentgemma-9b", {"num_layers": 5}, {}),
    ("family", "llava-next-mistral-7b", {}, {}),
    ("family", "whisper-medium", {}, {}),
    ("window", "llama3.2-3b", {"sliding_window": 8}, {}),
    ("noncausal", "llama3.2-3b", {"causal": False}, {}),
    ("moe_capacity", "olmoe-1b-7b", {}, {}),
    ("moe_capacity", "deepseek-v3-671b", {}, {}),
]


@pytest.mark.parametrize("reason,arch,changes,kw", RUN_REFUSALS,
                         ids=[f"{r[0]}-{r[1]}" for r in RUN_REFUSALS])
def test_refused_prefill_runs_the_eager_body(reason, arch, changes, kw):
    """A refused call runs ``_prefill_body`` as it is, bit for bit, and
    the stats count it as eager, under its reason (the MoE's reduced
    capacity factor 1.25 x top-2 < 4 experts can drop a token)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = _model(cfg)
    batch = make_lm_batch(
        cfg.vocab_size, 2, 24, seed=1, d_model=cfg.d_model,
        frontend_tokens=cfg.frontend.num_tokens if cfg.family == "vlm"
        else 0, encoder_len=cfg.encoder_seq_len if cfg.family == "audio"
        else 0, device="cpu")
    assert pg.refusal(model, batch, kw.get("plain", False)) == reason
    (logits, cache), stats = _stats_delta(lambda: model.prefill(batch, **kw))
    want_logits, want = model._prefill_body(batch, **kw)
    assert torch.equal(logits, want_logits)
    assert set(cache) == set(want)
    for k in want:
        assert torch.equal(cache[k], want[k]), k
    assert stats == {"captures": 0, "capture_s": 0.0, "replays": 0,
                     "eager": 1, "dropped": 0, "refused": {reason: 1},
                     "launches": {}, "tokens": 0, "pad_tokens": 0}
    assert model._prefill_graphs is None


@pytest.mark.parametrize("rebind", ["load_params", "init", "to", "float",
                                    "deepcopy"])
def test_rebinding_the_tensors_drops_the_prefill_graphs(rebind):
    """``load_params``, ``init`` and a move or cast of the module drop
    the model's prefill graphs (a stand-in here: the CPU never captures
    one), with its decode graph; a deep copy starts without them."""
    model = _model(_cfg("llama3.2-3b"))
    flat = {p: (torch.stack(v) if isinstance(v, list) else v).clone()
            for p, v in model.param_tree().items()}
    model._prefill_graphs = held = pg.PrefillGraphs()
    model._decode_graph = object()
    if rebind == "deepcopy":
        twin = copy.deepcopy(model)
        assert twin._prefill_graphs is None and twin._decode_graph is None
        assert model._prefill_graphs is held
        return
    {"load_params": lambda: model.load_params(flat),
     "init": lambda: model.init(seed=1),
     "to": lambda: model.to("cpu"),
     "float": lambda: model.float()}[rebind]()
    assert model._prefill_graphs is None and model._decode_graph is None
