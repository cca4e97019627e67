"""The port's MLA and MoE families against the JAX package on the same
weights and tokens: minicpm3-4b (dense, MLA), olmoe-1b-7b (MoE) and
deepseek-v3-671b (MLA, MoE, a dense-first layer, a shared expert and the
MTP group), reduced, in float32.

* Whole models: prefill logits and caches against JAX ``Model.prefill``
  (olmoe also with ``attention_impl`` "pallas": the Pallas flash kernel
  in interpret mode; MLA never reaches it), ``decode_step`` with scalar
  and per-sequence positions, decode == prefill on the port alone (the
  bars of ``tests/test_decode_equivalence.py``: MLA 5e-3, MoE at
  ``capacity_factor`` 8.0 2e-3), greedy ``generate`` and
  ``ContinuousBatcher`` tokens, a reference checkpoint (float32 and
  bfloat16, deepseek's nested ``mtp/block/...`` leaves included),
  templates, cache templates, ``pad_cache`` and ``cache_bytes``.
* Blocks: ``moe_ffn`` (y and aux) at capacity 1.25, with assignments
  dropped, and at 8.0, with deepseek's shared expert; routers with exact
  ties select what ``lax.top_k`` selects (the lower expert); the port's
  ``moe_ffn_shard_map`` is ``moe_ffn`` off-mesh, as the reference's is;
  ``mla_decode``; ``cross_attention`` is in ``test_torch_frontends.py``.

The reference's prefill caches MLA's shared rope key before RoPE while its
decode reads cached keys as rotated (ROADMAP Queue 3); the port caches the
rotated key. ``roped_reference()`` patches the reference's
``mla_attention`` (inside the tests only) to rotate its cache entry, so
that whole-model comparisons hold both packages to one semantics; one
test holds the unpatched reference's cache to the port's with the
rotation applied.

Tolerances: logits within 1e-5 relative to the largest |logit| (float32
both sides, other summation orders), caches within 1e-5 absolute, block
outputs within 1e-5 of their largest |value|; greedy tokens exactly, each
argmax winning by more than 1e-4 (asserted)."""
import dataclasses
import os
import tempfile
from unittest import mock

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
from repro.models import model as jmodel
from repro.serving import ServeEngine as JEngine
from repro.serving import cache_bytes as j_cache_bytes
from repro.serving import pad_cache as j_pad
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.models import blocks as tb
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine, cache_bytes, pad_cache
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.sharding.partitioning import flatten

torch.set_num_threads(1)

REL_TOL = 1e-5
CACHE_ATOL = 1e-5
MARGIN = 1e-4
S = 64
ARCHS = ["minicpm3-4b", "olmoe-1b-7b", "deepseek-v3-671b"]
_J_MLA = jmodel.mla_attention


def roped_mla(p, x, cfg, *, positions=None):
    """The reference's prefill MLA, its cache entry's rope key rotated as
    the reference's decode reads it (module doc)."""
    y, cache = _J_MLA(p, x, cfg, positions=positions)
    if positions is None:
        positions = jnp.arange(x.shape[1])[None, :]
    r = cfg.mla.kv_lora_rank
    kr = jb.apply_rope(cache[..., None, r:], positions, cfg.rope_theta)
    return y, jnp.concatenate([cache[..., :r], kr[:, :, 0]], axis=-1)


def roped_reference():
    return mock.patch.object(jmodel, "mla_attention", roped_mla)


def flat(params):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def setup(arch, factor=None):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    if factor:
        jc, tc = capacity(jc, factor), capacity(tc, factor)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, lm_from_reference(tc, flat(params), device="cpu")


def tokens(cfg, batch=2, seq=S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


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


PREFILL_CASES = [("minicpm3-4b", "xla"), ("olmoe-1b-7b", "xla"),
                 ("olmoe-1b-7b", "pallas"), ("deepseek-v3-671b", "xla")]


@pytest.mark.parametrize("arch,impl", PREFILL_CASES,
                         ids=[f"{a}-{i}" for a, i in PREFILL_CASES])
def test_prefill_logits_and_cache_match(arch, impl):
    jm, params, tm = setup(arch)
    jm = j_build(dataclasses.replace(jm.cfg, attention_impl=impl))
    toks = tokens(jm.cfg)
    with roped_reference():
        lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    assert rel_err(lt.numpy(), lj) < REL_TOL
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b"])
def test_reference_caches_the_rope_key_before_rope(arch):
    """The unpatched reference: the latents equal the port's, and its rope
    key rotated by RoPE equals the port's cached key (module doc)."""
    jm, params, tm = setup(arch)
    toks = tokens(jm.cfg)
    _, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    r = jm.cfg.mla.kv_lora_rank
    ref = np.asarray(cj["ckv"])
    got = ct["ckv"].numpy()
    np.testing.assert_allclose(got[..., :r], ref[..., :r], rtol=0,
                               atol=CACHE_ATOL)
    roped = jb.apply_rope(jnp.asarray(ref[..., None, r:]),
                          jnp.arange(S)[None, :], jm.cfg.rope_theta)
    np.testing.assert_allclose(got[..., r:], np.asarray(roped)[..., 0, :],
                               rtol=0, atol=CACHE_ATOL)
    assert np.abs(got[..., r:] - ref[..., r:]).max() > 1e-3


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_decode_step_matches(pair, per_sequence):
    jm, params, tm = pair
    toks = tokens(jm.cfg)
    with roped_reference():
        lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    cj = j_pad(jm, cj, 4, 2, S)
    ct = pad_cache(tm, ct, 4, 2, S)
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    pos = np.array([S, S - 5], np.int32) if per_sequence else S
    ld, cd = jax.jit(jm.decode_step)(params, cj, jnp.asarray(nxt),
                                     jnp.asarray(pos, jnp.int32))
    lt, ct = tm.decode_step(ct, torch.from_numpy(nxt), torch.as_tensor(pos))
    assert rel_err(lt.numpy(), ld) < REL_TOL
    for key in cd:
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cd[key]),
                                   rtol=0, atol=CACHE_ATOL)


def decode_err(cfg):
    """Relative logit error of one decode step against a full prefill, on
    the port alone (``tests/test_decode_equivalence.py``'s ``_err``)."""
    m = build_model(cfg, device="cpu").init(seed=0)
    toks = torch.from_numpy(tokens(cfg, seed=4))
    lg_full, _ = m.prefill({"tokens": toks})
    _, cache = m.prefill({"tokens": toks[:, :S - 1]})
    cache = pad_cache(m, cache, 1, 2, S - 1)
    lg_inc, _ = m.decode_step(cache, toks[:, S - 1:S], S - 1)
    return float((lg_full - lg_inc).abs().max() / lg_full.abs().max())


@pytest.mark.parametrize("arch,factor,bar", [
    ("minicpm3-4b", None, 5e-3), ("olmoe-1b-7b", 8.0, 2e-3),
    ("deepseek-v3-671b", 8.0, 5e-3)])
def test_decode_equals_prefill(arch, factor, bar):
    cfg = t_config(arch).reduced()
    assert decode_err(capacity(cfg, factor) if factor else cfg) < bar


def greedy(model, toks, n_new):
    """ServeEngine's greedy loop, returning (tokens, the smallest margin
    of any argmax it took)."""
    lg, cache = model.prefill({"tokens": toks})
    cache = pad_cache(model, cache, n_new, *toks.shape)
    out, worst = [], np.inf
    for i in range(n_new):
        worst = min(worst, margin(lg.numpy()))
        tok = lg.argmax(-1)
        out.append(tok)
        lg, cache = model.decode_step(cache, tok[:, None], toks.shape[1] + i)
    return torch.stack(out, dim=1), worst


def test_generate_greedy_tokens_equal_reference(pair):
    jm, params, tm = pair
    toks = tokens(jm.cfg, seq=32, seed=6)
    with roped_reference():
        want = np.asarray(JEngine(jm, params, max_new_tokens=6).generate(
            {"tokens": jnp.asarray(toks)}))
    got = ServeEngine(tm, max_new_tokens=6).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)
    again, worst = greedy(tm, torch.from_numpy(toks), 6)
    assert torch.equal(again, got) and worst > MARGIN


@pytest.mark.parametrize("arch", ["minicpm3-4b", "olmoe-1b-7b"])
def test_continuous_batcher_outputs_equal_reference(arch):
    jm, params, tm = setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int64)
               for n in (24, 16, 31, 9)]
    n_new = 5
    with roped_reference():
        jbat = JBatcher(jm, params, slots=2, max_len=64)
        jreqs = [JRequest(i, p, n_new) for i, p in enumerate(prompts)]
        for r in jreqs:
            jbat.submit(r)
        jbat.run()
    tbat = ContinuousBatcher(tm, slots=2, max_len=64)
    treqs = [Request(i, p, n_new) for i, p in enumerate(prompts)]
    for r in treqs:
        tbat.submit(r)
    tbat.run()
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_template_and_cache_template_match_the_reference(arch):
    jm = j_build(j_config(arch))
    tm = build_model(t_config(arch), device="meta")
    want = {_path_str(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.template(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {p: s.shape for p, s in flatten(tm.template())} == want
    for b, n in ((3, 100), (1, 2048)):
        jc, tc = jm.cache_template(b, n), tm.cache_template(b, n)
        assert {k: (v.shape, v.axes) for k, v in tc.items()} == \
            {k: (v.shape, v.axes) for k, v in jc.items()}
        assert cache_bytes(tm, b, n) == j_cache_bytes(jm, b, n)


def test_mla_cache_is_small():
    """tests/test_serving_checkpoint.py: the latent cache per token is
    under 1/8 of a GQA cache of the same dims."""
    cfg = t_config("minicpm3-4b")
    m = build_model(cfg, device="meta")
    per_tok = cache_bytes(m, 1, 1024) / 1024
    assert per_tok < cfg.num_layers * 2 * cfg.num_kv_heads * \
        cfg.head_dim * 2 / 8


@pytest.mark.parametrize("arch", ARCHS)
def test_pad_cache_shapes_equal_reference(arch):
    jm = j_build(j_config(arch).reduced())
    tm = build_model(t_config(arch).reduced(), device="cpu")
    for n in (20, 40):
        cj = {k: jnp.zeros(s.shape, jnp.float32) for k, s in
              jm.cache_template(2, n).items()}
        ct = {k: torch.zeros(s.shape) for k, s in
              tm.cache_template(2, n).items()}
        assert {k: tuple(v.shape) for k, v in
                pad_cache(tm, ct, 7, 2, n).items()} == \
            {k: v.shape for k, v in j_pad(jm, cj, 7, 2, n).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_into_the_port(dtype):
    """deepseek's tree (``layers_dense``, ``layers``, ``mtp/block/...``):
    every weight bit for bit; prefill logits as from the JAX params."""
    arch = "deepseek-v3-671b"
    jm = j_build(j_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(2), jnp.dtype(dtype))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, step=3)
        assert os.path.exists(os.path.join(d, "arrays.npz"))
        arrays = load_checkpoint(d)
    want = flat(params)
    assert set(arrays) == set(want)
    assert any(k.startswith("mtp/block/moe/") for k in want)
    tm = lm_from_reference(t_config(arch).reduced(), arrays, device="cpu",
                           dtype=dtype)
    for key, a in want.items():
        t = tm._targets(key)
        got = torch.stack(t) if isinstance(t, list) else t
        assert got.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), a)
    if dtype == "float32":
        toks = tokens(jm.cfg, seq=32)
        with roped_reference():
            lj, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
        lt, _ = tm.prefill({"tokens": torch.from_numpy(toks)})
        assert rel_err(lt.numpy(), lj) < REL_TOL


# --------------------------------------------------------------------------
# blocks: the MoE FFN and the MLA decode on the same float32 inputs
# --------------------------------------------------------------------------

def moe_params(arch, seed, router_scale=1.0):
    """The reduced config's MoE leaves (deepseek's with the shared
    expert), drawn with numpy; router columns scaled by ``router_scale``."""
    cfg = j_config(arch).reduced()
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=s.shape) * 0.2).astype(np.float32)
         for k, s in flatten(tb.moe_template(cfg))}
    p["router"] *= router_scale
    return cfg, p


def nested(p, to):
    out = {}
    for path, a in p.items():
        node = out
        *head, leaf = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[leaf] = to(a)
    return out


def run_moe(arch, p, x, factor, fn="moe_ffn"):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    jc, tc = capacity(jc, factor), capacity(tc, factor)
    yj, auxj = getattr(jb, fn)(nested(p, jnp.asarray), jnp.asarray(x), jc)
    yt, auxt = getattr(tb, fn)(nested(p, torch.from_numpy),
                               torch.from_numpy(x), tc)
    return (np.asarray(yj), float(auxj)), (yt.numpy(), float(auxt)), tc


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_moe_ffn_matches_reference(arch, factor):
    cfg, p = moe_params(arch, seed=1)
    rng = np.random.default_rng(2)
    # a shared component skews the router: some experts overflow at 1.25
    x = (rng.normal(size=(2, 96, cfg.d_model))
         + 2.0 * rng.normal(size=cfg.d_model)).astype(np.float32)
    (yj, auxj), (yt, auxt), tc = run_moe(arch, p, x, factor)
    np.testing.assert_allclose(yt, yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())
    assert abs(auxt - auxj) <= 1e-6 * abs(auxj)
    m = tc.moe
    logits = torch.from_numpy(x.reshape(-1, cfg.d_model)) @ \
        torch.from_numpy(p["router"])
    keep = tb.moe_dispatch(torch.softmax(logits, -1), m.top_k,
                           tb._capacity(x.shape[0] * x.shape[1], m))[3]
    assert bool(keep.all()) == (factor == 8.0)


def test_router_ties_select_like_lax_top_k():
    rng = np.random.default_rng(5)
    levels = np.array([0.1, 0.2, 0.3], np.float32)
    probs = levels[rng.integers(0, 3, (64, 8))]       # many exact ties
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 3)
    vt, it = tb.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # through the FFN: duplicated router columns tie exactly in every row
    cfg, p = moe_params("olmoe-1b-7b", seed=3)
    p["router"][:, 2] = p["router"][:, 0]
    p["router"][:, 3] = p["router"][:, 1]
    x = np.random.default_rng(4).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)
    (yj, _), (yt, _), _ = run_moe("olmoe-1b-7b", p, x, 8.0)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_moe_ffn_shard_map_is_moe_ffn_off_mesh():
    cfg, p = moe_params("deepseek-v3-671b", seed=6)
    x = np.random.default_rng(7).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)
    (yj, auxj), (yt, auxt), tc = run_moe("deepseek-v3-671b", p, x, 1.25,
                                         fn="moe_ffn_shard_map")
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    assert abs(auxt - auxj) <= 1e-6 * abs(auxj)
    y2, aux2 = tb.moe_ffn(nested(p, torch.from_numpy), torch.from_numpy(x),
                          tc)
    assert np.array_equal(y2.numpy(), yt) and float(aux2) == auxt


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b"])
def test_mla_decode_matches(arch):
    cfg = j_config(arch).reduced()
    m = cfg.mla
    rng = np.random.default_rng(8)
    p = {k: (rng.normal(size=s.shape) * 0.3).astype(np.float32)
         for k, s in flatten(tb.mla_template(cfg))}
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    cache = rng.normal(size=(2, 10, m.kv_lora_rank + m.qk_rope_head_dim)
                       ).astype(np.float32)
    yj, ej = jb.mla_decode(nested(p, jnp.asarray), jnp.asarray(x),
                           jnp.asarray(cache), cfg, t_cache=10)
    yt, et = tb.mla_decode(nested(p, torch.from_numpy), torch.from_numpy(x),
                           torch.from_numpy(cache), t_config(arch).reduced(),
                           t_cache=10)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-5 * float(np.abs(yj).max()))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0,
                               atol=1e-5)
