"""minicpm3-4b in the benchmark (``perfbench/``): the port's MLA model
against the benchmark's plain reference (``perfbench/reference/dense.py``)
at a tiny MLA-dense size on the CPU, in float32 on both sides; the frozen
yardstick of an MLA model (``perfbench/yardstick_mla.py``) against the
port's arithmetic at the cell's shapes; and MLA's spans and roofline
region (``repro_torch.mla.*``, ``repro_torch.attention``).

Tolerances: the port and the reference compute the same float32
products in another order (the port's decode attends in the absorbed
form, the k up-projection folded into q; the reference expands k and
v), so logits whose spread is about 1 agree to 2e-4; a served token's
gap is 0 where both pick the same token and at most twice that error at
a near-tie.
"""
import dataclasses
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from perfbench import program, registry, verify, weights  # noqa: E402
from perfbench import yardstick, yardstick_mla  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.roofline import analysis, costs  # noqa: E402
from repro_torch.roofline.trace import analyze_trace  # noqa: E402
from repro_torch.serving.cache_utils import pad_cache  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatcher, Request,
)

torch.set_num_threads(1)

CELL = "minicpm3-4b"
TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, intermediate_size=96, vocab_size=256,
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
TOL = dict(atol=2e-4, rtol=2e-4)


def tiny(q_lora_rank=32, **more):
    c = registry.config(CELL)
    c.update(TINY, dtype="float32", q_lora_rank=q_lora_rank, **more)
    return c


def built(c, seed):
    ref = registry.reference(c["family"])
    w = weights.make(ref.leaves(c), seed, torch.float32, "cpu")
    return ref, w, Model(program.port_config(c), device="cpu") \
        .load_params(w)


@pytest.mark.parametrize("q_lora_rank", [32, 0])
@pytest.mark.parametrize("S", [37, 64])
def test_prefill_and_buffered_decode_match_the_reference(q_lora_rank, S):
    """The last logits of a prefill, then decode steps through the
    padded latent cache (the batcher's path), against the reference's
    one forward over the whole sequence."""
    c = tiny(q_lora_rank)
    ref, w, model = built(c, 5)
    toks = torch.randint(0, 250, (S + 6,),
                         generator=torch.Generator().manual_seed(S))
    want = ref.forward(c, w, toks, S - 1)                  # (7, V)
    logits, cache = model.prefill({"tokens": toks[None, :S]})
    torch.testing.assert_close(logits[0], want[0], **TOL)
    cache = pad_cache(model, cache, 8, 1, S)
    assert set(cache) == {"ckv"}
    for i in range(6):
        logits, cache = model.decode_step(
            cache, toks[None, S + i:S + i + 1], torch.tensor([S + i]))
        torch.testing.assert_close(logits[0], want[i + 1], **TOL)


@pytest.mark.parametrize("q_lora_rank", [32, 0])
def test_batcher_run_reads_no_gap(q_lora_rank):
    """Requests served by the continuous batcher (batch-1 prefills
    spliced into a shared latent cache, batched decode at per-slot
    positions), judged by the benchmark's comparison: every served token
    is the reference's best, or within float32 rounding of it."""
    c = tiny(q_lora_rank)
    ref, w, model = built(c, 9)
    batcher = ContinuousBatcher(model, slots=3, max_len=64, eos_id=None)
    g = torch.Generator().manual_seed(q_lora_rank)
    reqs = [Request(rid=i, tokens=torch.randint(
        0, 250, (int(n),), generator=g).numpy(), max_new_tokens=int(m))
        for i, (n, m) in enumerate([(9, 12), (30, 5), (17, 20), (5, 9),
                                    (40, 14)])]
    for r in reqs:
        batcher.submit(r)
    for _ in range(100):
        if all(r.done for r in reqs):
            break
        batcher.step()
    assert all(r.done and len(r.out) == r.max_new_tokens for r in reqs)
    rows = verify.gaps(ref, c, w, reqs, "cpu")
    got = verify.numbers(rows)
    assert sum(r["served"] for r in rows) == 60
    assert got["max_logit_gap"] <= 4e-4


@pytest.mark.parametrize("q_lora_rank", [32, 0])
def test_leaves_are_the_ports_template(q_lora_rank):
    from repro_torch.sharding.partitioning import flatten
    for c in (tiny(q_lora_rank), dict(registry.config(CELL),
                                      q_lora_rank=q_lora_rank)):
        model = Model(program.port_config(c), device="meta")
        want = {p: tuple(s.shape) for p, s in flatten(model.template())}
        got = registry.reference(c["family"]).leaves(c)
        assert {p: tuple(s) for p, (s, _) in got.items()} == want


def test_a_dense_config_without_mla_has_no_reference():
    c = tiny()
    del c["kv_lora_rank"], c["v_head_dim"]
    ref = registry.reference("dense")
    with pytest.raises(KeyError, match="kv_lora_rank.*v_head_dim"):
        ref.leaves(c)
    with pytest.raises(KeyError, match="kv_lora_rank"):
        ref.forward(c, {}, torch.zeros(3, dtype=torch.long), 0)


@pytest.mark.parametrize("seed", [1, 2])
def test_fp8_control_reads_worse_than_float32(seed):
    """The control (every weight product in fake float8, one step below
    the bf16 the configuration states) moves the logits far more than
    the port's float32 rounding does."""
    c = tiny(num_hidden_layers=4)
    ref, w, model = built(c, seed)
    toks = torch.randint(0, 250, (80,),
                         generator=torch.Generator().manual_seed(seed))
    hi = ref.forward(c, w, toks, 0)
    lo = ref.forward(c, w, toks, 0, "fp8")
    port = model.prefill({"tokens": toks[None]})[0][0]
    port_err = (port - hi[-1]).abs().max()
    assert (hi - lo).abs().max() > 1e-3 and \
        (hi - lo).abs().max() > 100 * port_err
    with pytest.raises(ValueError):
        ref.forward(c, w, toks, 0, "int3")


# ---------------------------------------------------------------------------
# The frozen yardstick at the cell's shapes
# ---------------------------------------------------------------------------

MLA_SHAPES = [(1, 40, S, S, 96, 64, True, "bfloat16")
              for S in (64, 346, 1024, 1537)] + \
    [(2, 4, 37, 37, 24, 16, True, "float32"),
     (1, 40, 1, 1537, 96, 64, True, "bfloat16"),
     (1, 40, 64, 64, 96, 64, False, "bfloat16")]


@pytest.mark.parametrize("shape", MLA_SHAPES)
def test_mla_attention_cost_is_the_ports(shape):
    assert yardstick_mla.mla_attention_cost(shape) == \
        costs.mla_attention_cost(shape)
    assert yardstick.bound(*yardstick_mla.mla_attention_cost(shape),
                           shape[-1]) == \
        costs.bound(*costs.mla_attention_cost(shape), shape[-1])


def test_mla_attention_cost_counts():
    B, H, S, dqk, dv = 2, 3, 5, 8, 4
    nbytes, flops = costs.mla_attention_cost((B, H, S, S, dqk, dv, True,
                                              "float32"))
    assert nbytes == 4 * (B * H * S * (dqk + dv) * 2)
    assert flops == 2 * (dqk + dv) * B * H * (S * (S + 1) // 2)
    q_nope = torch.zeros(B, S, H, 6, dtype=torch.bfloat16)
    q_rope = torch.zeros(B, S, H, 2, dtype=torch.bfloat16)
    v = torch.zeros(B, S, H, dv, dtype=torch.bfloat16)
    assert costs.mla_cost(q_nope, q_rope, v, causal=True) == \
        costs.mla_attention_cost((B, H, S, S, dqk, dv, True, "bfloat16"))


@pytest.mark.parametrize("q_lora_rank", [768, 0])
def test_param_and_flop_counts_are_the_ports(q_lora_rank):
    c = dict(registry.config(CELL), q_lora_rank=q_lora_rank)
    cfg = program.port_config(c)
    assert yardstick_mla.param_count(c) == cfg.param_count() == \
        cfg.active_param_count()
    assert yardstick_mla.matmul_params_per_token(c) == cfg.param_count()
    for S in (346, 1024, 1537):
        shape = InputShape("cell", S, 1, "prefill")
        assert 2.0 * yardstick_mla.param_count(c) * S == \
            analysis.model_flops_for(cfg, shape)
    assert yardstick_mla.model_flops(c, 10) == \
        20.0 * yardstick_mla.matmul_params_per_token(c)


def test_the_cells_counts():
    """minicpm3-4b at its published widths: 4.07 B parameters (8.1 GB in
    bf16), 288 latent values a token a layer."""
    c = registry.config(CELL)
    assert yardstick_mla.param_count(c) == 4_073_809_920
    cfg = program.port_config(c)
    t = Model(cfg, device="meta").cache_template(64, 1537)
    assert tuple(t["ckv"].shape) == (62, 64, 1537, 288)


# ---------------------------------------------------------------------------
# MLA's spans and roofline region
# ---------------------------------------------------------------------------

PREFILL = {"repro_torch.mla.q", "repro_torch.mla.kv",
           "repro_torch.attention", "repro_torch.mla.out"}
DECODE = {"repro_torch.mla.q", "repro_torch.mla.kv",
          "repro_torch.mla.absorbed"}


def _parents(prof):
    """{span name: names of the spans directly enclosing it}."""
    ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.name.startswith(spans.PREFIX)),
                key=lambda x: (x[1], -x[2]))
    out, stack = {}, []
    for name, s, e in ev:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.setdefault(name, set()).add(stack[-1][0] if stack else None)
        stack.append((name, s, e))
    return out


def test_mla_spans_nest_as_named_under_a_profiler():
    c = tiny()
    _, _, model = built(c, 3)
    toks = torch.randint(0, 250, (1, 20))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, cache = model.prefill({"tokens": toks})
        cache = pad_cache(model, cache, 4, 1, 20)
        model.decode_step(cache, toks[:, :1], torch.tensor([20]))
    parents = _parents(prof)
    for name in PREFILL - {"repro_torch.mla.q", "repro_torch.mla.kv"}:
        assert parents[name] == {"repro_torch.prefill"}, name
    assert parents["repro_torch.mla.q"] == parents["repro_torch.mla.kv"] \
        == {"repro_torch.prefill", "repro_torch.decode_attention"}
    assert parents["repro_torch.mla.absorbed"] == \
        {"repro_torch.decode_attention"}
    assert parents["repro_torch.decode_attention"] == \
        {"repro_torch.decode_step"}
    calls = {n: sum(e.name == n for e in prof.events())
             for n in PREFILL | DECODE}
    assert calls["repro_torch.mla.q"] == calls["repro_torch.mla.kv"] == \
        2 * c["num_hidden_layers"]
    assert calls["repro_torch.attention"] == c["num_hidden_layers"]


def test_mla_spans_open_nothing_without_a_profiler(monkeypatch):
    names = []

    def counted(name):
        names.append(name)
        return spans.nullcontext()
    monkeypatch.setattr(spans, "record_function", counted)
    _, _, model = built(tiny(), 3)
    toks = torch.randint(0, 250, (1, 12))
    _, cache = model.prefill({"tokens": toks})
    cache = pad_cache(model, cache, 4, 1, 12)
    model.decode_step(cache, toks[:, :1], torch.tensor([12]))
    assert names == []


def test_mla_prefill_traces_its_attention_region():
    """A traced MLA prefill counts each layer's attention once, as
    ``mla_attention_cost``, and every other matrix product exactly."""
    cfg = dataclasses.replace(program.port_config(tiny()), num_layers=3)
    model = Model(cfg, device="meta")
    B, S = 2, 48
    a = analyze_trace(model.prefill,
                      {"tokens": torch.zeros(B, S, dtype=torch.int32,
                                             device="meta")}, plain=True)
    m = cfg.mla
    att = costs.mla_attention_cost(
        (B, cfg.num_heads, S, S, m.qk_nope_head_dim + m.qk_rope_head_dim,
         m.v_head_dim, True, "float32"))
    assert a["regions"]["attention"] == {"bytes": 3.0 * att[0],
                                         "flops": 3.0 * att[1], "calls": 3}
    mats = sum(t.numel() for _, t in model.layers[0].named_parameters()
               if t.dim() >= 2)
    head = cfg.d_model * cfg.vocab_size
    assert a["flops"] == cfg.num_layers * (2 * mats * B * S + att[1]) + \
        2 * head * B
