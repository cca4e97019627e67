"""The port's vlm (llava-next-mistral-7b: a dense decoder after the
frontend's precomputed embeddings) and audio (whisper-medium: an encoder
over precomputed frame embeddings, a decoder with cross-attention)
families against the JAX package on the same weights and inputs,
reduced, in float32.

* Whole models: prefill logits and caches against JAX ``Model.prefill``
  with ``attention_impl`` "xla" and "pallas" (the Pallas flash kernel in
  interpret mode: the vlm's decoder, whisper's non-causal encoder and
  causal decoder), ``decode_step`` with scalar and per-sequence positions
  (the vlm's after its frontend positions), decode == prefill on the port
  alone (2e-3, the bar of ``tests/test_decode_equivalence.py``), greedy
  ``ServeEngine`` tokens, ``ContinuousBatcher`` refusing both families
  (text only, as in the reference), a reference checkpoint, templates,
  cache templates, ``pad_cache`` (whisper's cross-attention cache
  ``xk``/``xv`` stays as prefill left it) and ``cache_bytes``.
* Blocks: ``cross_attention`` and the encoder alone.

Tolerances: logits within 1e-5 relative to the largest |logit| (float32
both sides, other summation orders), caches and block outputs within
1e-5 (absolute, or of the largest |value|); greedy tokens exactly, each
argmax winning by more than 1e-4 (asserted); whisper's qkv biases are
drawn non-zero so that their path runs."""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint
from repro.checkpoint.checkpointer import _path_str
from repro.configs import get_config as j_config
from repro.models import blocks as jb
from repro.models import build_model as j_build
from repro.serving import ServeEngine as JEngine
from repro.serving import cache_bytes as j_cache_bytes
from repro.serving import pad_cache as j_pad
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.models import blocks as tb
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine, cache_bytes, pad_cache
from repro_torch.serving.scheduler import ContinuousBatcher
from repro_torch.sharding.partitioning import flatten

torch.set_num_threads(1)

REL_TOL = 1e-5
CACHE_ATOL = 1e-5
MARGIN = 1e-4
S = 48
ARCHS = ["llava-next-mistral-7b", "whisper-medium"]


def flat(params):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def unflat(like, arrays):
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[_path_str(p)]) for p, _ in paths])


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(JAX model, JAX params, port model) on the same weights; the zero
    QKV biases are replaced by random ones."""
    jm = j_build(j_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    arrays = flat(params)
    rng = np.random.default_rng(1)
    for key in arrays:
        if key.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            arrays[key] = rng.normal(0, 0.5, arrays[key].shape).astype(
                np.float32)
    tm = lm_from_reference(t_config(arch).reduced(), arrays, device="cpu")
    return jm, unflat(params, arrays), tm


def n_front(cfg):
    return cfg.frontend.num_tokens if cfg.family == "vlm" else 0


def inputs(cfg, batch=2, seq=S, seed=3):
    """{"tokens", and "frontend_embeds" or "encoder_embeds"} as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)
                                  ).astype(np.int32)}
    if cfg.family == "vlm":
        out["frontend_embeds"] = rng.normal(
            size=(batch, n_front(cfg), cfg.d_model)).astype(np.float32)
    else:
        out["encoder_embeds"] = rng.normal(
            size=(batch, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / (np.max(np.abs(want)) + 1e-9))


def margin(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return setup(request.param)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match(pair, impl):
    jm, params, tm = pair
    jm = j_build(dataclasses.replace(jm.cfg, attention_impl=impl))
    batch = inputs(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, to_jax(batch))
    lt, ct = tm.prefill(to_torch(batch))
    assert rel_err(lt.numpy(), lj) < REL_TOL
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_decode_step_matches(pair, per_sequence):
    jm, params, tm = pair
    batch = inputs(jm.cfg)
    T = S + n_front(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, to_jax(batch))
    _, ct = tm.prefill(to_torch(batch))
    cj = j_pad(jm, cj, 4, 2, T)
    ct = pad_cache(tm, ct, 4, 2, T)
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    pos = np.array([T, T - 5], np.int32) if per_sequence else T
    ld, cd = jax.jit(jm.decode_step)(params, cj, jnp.asarray(nxt),
                                     jnp.asarray(pos, jnp.int32))
    lt, ct = tm.decode_step(ct, torch.from_numpy(nxt), torch.as_tensor(pos))
    assert rel_err(lt.numpy(), ld) < REL_TOL
    for key in cd:
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cd[key]),
                                   rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill(arch):
    cfg = t_config(arch).reduced()
    m = build_model(cfg, device="cpu").init(seed=0)
    batch = to_torch(inputs(cfg, seed=4))
    toks = batch["tokens"]
    T = S + n_front(cfg)
    lg_full, _ = m.prefill(batch)
    _, cache = m.prefill(dict(batch, tokens=toks[:, :S - 1]))
    cache = pad_cache(m, cache, 1, 2, T - 1)
    lg_inc, _ = m.decode_step(cache, toks[:, S - 1:], T - 1)
    assert float((lg_full - lg_inc).abs().max()
                 / lg_full.abs().max()) < 2e-3


def test_generate_greedy_tokens_equal_reference(pair):
    jm, params, tm = pair
    batch = inputs(jm.cfg, seq=32, seed=6)
    want = np.asarray(JEngine(jm, params, max_new_tokens=6).generate(
        to_jax(batch)))
    got = ServeEngine(tm, max_new_tokens=6).generate(to_torch(batch))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same loop by hand: every argmax is clear of a tie
    T = 32 + n_front(jm.cfg)
    lg, cache = tm.prefill(to_torch(batch))
    cache = pad_cache(tm, cache, 6, 2, T)
    for i in range(6):
        assert margin(lg.numpy()) > MARGIN
        assert torch.equal(lg.argmax(-1), got[:, i])
        lg, cache = tm.decode_step(cache, got[:, i:i + 1], T + i)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batcher_is_text_only(arch):
    m = build_model(t_config(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="text-only scheduler"):
        ContinuousBatcher(m, slots=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_template_and_cache_template_match_the_reference(arch):
    jm = j_build(j_config(arch))
    tm = build_model(t_config(arch), device="meta")
    want = {_path_str(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.template(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {p: s.shape for p, s in flatten(tm.template())} == want
    for b, n in ((3, 100), (4, 2048 + 2880)):
        jc, tc = jm.cache_template(b, n), tm.cache_template(b, n)
        assert {k: (v.shape, v.axes) for k, v in tc.items()} == \
            {k: (v.shape, v.axes) for k, v in jc.items()}
        assert cache_bytes(tm, b, n) == j_cache_bytes(jm, b, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_shapes_equal_reference(arch):
    jm = j_build(j_config(arch).reduced())
    tm = build_model(t_config(arch).reduced(), device="cpu")
    for n in (20, 40):
        cj = {k: jnp.zeros(s.shape, jnp.float32) for k, s in
              jm.cache_template(2, n).items()}
        ct = {k: torch.ones(s.shape) for k, s in
              tm.cache_template(2, n).items()}
        pt = pad_cache(tm, ct, 7, 2, n)
        assert {k: tuple(v.shape) for k, v in pt.items()} == \
            {k: v.shape for k, v in j_pad(jm, cj, 7, 2, n).items()}
        for key in ("xk", "xv"):
            if key in pt:           # the encoder's keys: no zero slots
                assert pt[key] is ct[key]
                assert pt[key].shape[2] == jm.cfg.encoder_seq_len


def test_reference_checkpoint_loads_into_the_port():
    arch = "whisper-medium"
    jm, params, _ = setup(arch)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, step=3)
        assert os.path.exists(os.path.join(d, "arrays.npz"))
        arrays = load_checkpoint(d)
    want = flat(params)
    assert set(arrays) == set(want)
    assert any(k.startswith("enc_layers/") for k in want)
    tm = lm_from_reference(t_config(arch).reduced(), arrays, device="cpu")
    for key, a in want.items():
        t = tm._targets(key)
        got = torch.stack(t) if isinstance(t, list) else t
        np.testing.assert_array_equal(got.numpy(), a)
    batch = inputs(jm.cfg, seq=16)
    lj, _ = jax.jit(jm.prefill)(params, to_jax(batch))
    lt, _ = tm.prefill(to_torch(batch))
    assert rel_err(lt.numpy(), lj) < REL_TOL


def test_cross_attention_matches():
    cfg = j_config("whisper-medium").reduced()
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    rng = np.random.default_rng(9)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("wq", (D, H, hd)), ("wo", (H, hd, D)), ("bq", (H, hd)))}
    x = rng.normal(size=(2, 5, D)).astype(np.float32)
    k, v = (rng.normal(size=(2, 30, H, hd)).astype(np.float32)
            for _ in range(2))
    want = jb.cross_attention({n: jnp.asarray(a) for n, a in p.items()},
                              jnp.asarray(x), (jnp.asarray(k),
                                               jnp.asarray(v)), cfg)
    got = tb.cross_attention({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), (torch.from_numpy(k),
                                                   torch.from_numpy(v)),
                             t_config("whisper-medium").reduced())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_encoder_matches():
    jm, params, tm = setup("whisper-medium")
    enc = inputs(jm.cfg)["encoder_embeds"]
    want = jax.jit(jm._encode)(params, jnp.asarray(enc))
    got = tm._encode(torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
