"""The port's dense LM (``repro_torch.models``) against the JAX package on
the same weights and tokens: prefill logits and caches against JAX
``Model.prefill`` with ``attention_impl`` "xla" and "pallas" (the Pallas
kernel in interpret mode), and ``decode_step`` with scalar and per-sequence
(B,) positions, for llama3.2-3b, granite-3-8b and qwen2-72b (``qkv_bias``,
with non-zero biases) reduced, and the sliding-window variant. Weights
come from JAX ``Model.init`` through ``lm_from_reference``, and once
through a checkpoint written by ``repro.checkpoint.save_checkpoint``.

Then the building blocks one by one on the same float32 inputs: RMSNorm,
RoPE, the gated MLP, ``chunked_attention`` (its chunk loop, a window, and
per-sequence decode positions), ``gqa_decode``; and ``init_params``
against its template.

Tolerance: float32 on both sides, max abs error below 1e-5 relative to
the largest |logit| (other summation orders; the measured gap is about
3e-7 on logits of magnitude 0.7-1.8), caches within 1e-5 absolute; the
blocks within 1e-6 to 2e-5 absolute on O(1) values (stated per test)."""
import dataclasses
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
from repro.serving import pad_cache as j_pad
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.models import blocks as tb
from repro_torch.models import build_model
from repro_torch.serving import pad_cache as t_pad
from repro_torch.sharding.partitioning import flatten, init_params

torch.set_num_threads(1)

REL_TOL = 1e-5
CACHE_ATOL = 1e-5
S = 64

CASES = [("llama3.2-3b", 0), ("granite-3-8b", 0), ("qwen2-72b", 0),
         ("llama3.2-3b", 32)]
IDS = ["llama3.2-3b", "granite-3-8b", "qwen2-72b", "llama3.2-3b-window32"]


def flat(params):
    """The reference's parameter leaves as {``/``-joined path: array}."""
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def unflat(like, arrays):
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[_path_str(p)]) for p, _ in paths])


def setup(arch, window):
    """(JAX model, JAX params, port model) on the same weights; qwen2's
    zero-initialised QKV biases are replaced by random ones so that the
    bias path is exercised."""
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    if window:
        jc = dataclasses.replace(jc, sliding_window=window)
        tc = dataclasses.replace(tc, sliding_window=window)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    arrays = flat(params)
    rng = np.random.default_rng(1)
    for key in arrays:
        if key.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
            arrays[key] = rng.normal(0, 0.5, arrays[key].shape).astype(
                np.float32)
    params = unflat(params, arrays)
    return jm, params, lm_from_reference(tc, arrays, device="cpu")


def tokens(cfg, batch=2, seq=S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / (np.max(np.abs(want)) + 1e-9))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def pair(request):
    return setup(*request.param)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match(pair, impl):
    jm, params, tm = pair
    jm = j_build(dataclasses.replace(jm.cfg, attention_impl=impl))
    toks = tokens(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    assert lt.shape == lj.shape
    assert rel_err(lt.numpy(), lj) < REL_TOL
    for key in ("k", "v"):
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_decode_step_matches(pair, per_sequence):
    jm, params, tm = pair
    toks = tokens(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    cj = j_pad(jm, cj, 4, 2, S)
    ct = t_pad(tm, ct, 4, 2, S)
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    pos = np.array([S, S - 5], np.int32) if per_sequence else S
    ld, cd = jax.jit(jm.decode_step)(params, cj, jnp.asarray(nxt),
                                     jnp.asarray(pos, jnp.int32))
    lt, ct = tm.decode_step(ct, torch.from_numpy(nxt), torch.as_tensor(pos))
    assert rel_err(lt.numpy(), ld) < REL_TOL
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cd[key]),
                                   rtol=0, atol=CACHE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_into_the_port(dtype):
    """save_checkpoint (JAX) -> load_checkpoint (numpy only) ->
    lm_from_reference: every weight bit for bit (bfloat16 through the
    int16 view), and prefill logits as from the JAX params."""
    cfg = j_config("qwen2-72b").reduced()
    jm = j_build(cfg)
    params = jm.init(jax.random.PRNGKey(2), jnp.dtype(dtype))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, step=3)
        assert os.path.exists(os.path.join(d, "arrays.npz"))
        arrays = load_checkpoint(d)
    want = flat(params)
    assert set(arrays) == set(want)
    tm = lm_from_reference(t_config("qwen2-72b").reduced(), arrays,
                           device="cpu", dtype=dtype)
    for key, a in want.items():
        got = torch.stack(tm._targets(key)) if key.startswith("layers/") \
            else tm._targets(key)
        assert got.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), a)
    if dtype == "float32":
        toks = tokens(cfg, seq=32)
        lj, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
        lt, _ = tm.prefill({"tokens": torch.from_numpy(toks)})
        assert rel_err(lt.numpy(), lj) < REL_TOL


def test_lm_from_reference_refuses_a_wrong_tree():
    cfg = j_config("llama3.2-3b").reduced()
    arrays = flat(j_build(cfg).init(jax.random.PRNGKey(0)))
    tcfg = t_config("llama3.2-3b").reduced()
    extra = dict(arrays, lm_head=np.zeros((128, 256), np.float32))
    with pytest.raises(ValueError, match="unexpected"):
        lm_from_reference(tcfg, extra, device="cpu")
    short = {k: v for k, v in arrays.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        lm_from_reference(tcfg, short, device="cpu")
    bad = dict(arrays, embed=arrays["embed"][:8])
    with pytest.raises(ValueError, match="shape"):
        lm_from_reference(tcfg, bad, device="cpu")


def test_template_and_cache_template_match_the_reference():
    for arch in ("llama3.2-3b", "granite-3-8b", "qwen2-72b"):
        jm = j_build(j_config(arch))
        tm = build_model(t_config(arch), device="meta")
        want = {_path_str(p): tuple(s.shape) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    jm.template(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
        assert {p: s.shape for p, s in flatten(tm.template())} == want
        jc = jm.cache_template(3, 100)
        tc = tm.cache_template(3, 100)
        assert {k: (v.shape, v.axes) for k, v in tc.items()} == \
            {k: (v.shape, v.axes) for k, v in jc.items()}


# --------------------------------------------------------------------------
# building blocks, one by one (same float32 inputs through both packages)
# --------------------------------------------------------------------------

def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_rmsnorm_rope_and_mlp_match():
    x, scale = _rng_arrays(0, (2, 9, 4, 32), (32,))
    np.testing.assert_allclose(
        tb.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jb.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[0, 3, 7, 100, 5, 6, 2047, 8, 9]] * 2, np.int32)
    np.testing.assert_allclose(
        tb.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                      500_000.0).numpy(),
        np.asarray(jb.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 500_000.0)), rtol=0, atol=1e-5)
    h, wi, wg, wo = _rng_arrays(1, (2, 5, 16), (16, 24), (16, 24), (24, 16))
    want = jb.mlp({"wi": jnp.asarray(wi), "wg": jnp.asarray(wg),
                   "wo": jnp.asarray(wo)}, jnp.asarray(h))
    got = tb.mlp({"wi": torch.from_numpy(wi), "wg": torch.from_numpy(wg),
                  "wo": torch.from_numpy(wo)}, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("S,T,q_offset,window,chunk", [
    (1024, 1024, 0, 0, 512),          # the chunk loop (S a multiple > chunk)
    (1024, 1024, 0, 100, 512),        # ... with a window
    (1, 40, [39, 20], 0, 512),        # per-sequence decode positions
    (3, 40, [30, 12], 16, 512),       # per-sequence, window, S > 1
])
def test_chunked_attention_matches(S, T, q_offset, window, chunk):
    q, k, v = _rng_arrays(2, (2, S, 4, 16), (2, T, 2, 16), (2, T, 2, 16))
    off = np.asarray(q_offset, np.int32)
    kw = dict(causal=True, window=window, chunk=chunk)
    want = jb.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=jnp.asarray(off),
                                **kw)
    got = tb.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=torch.from_numpy(off), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_gqa_decode_matches():
    cfg = j_config("qwen2-72b").reduced()
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x, ck, cv, wq, wk, wv, wo, bq, bk, bv = _rng_arrays(
        3, (2, 1, D), (2, 10, KV, hd), (2, 10, KV, hd), (D, H, hd),
        (D, KV, hd), (D, KV, hd), (H, hd, D), (H, hd), (KV, hd), (KV, hd))
    p = dict(wq=wq, wk=wk, wv=wv, wo=wo, bq=bq, bk=bk, bv=bv)
    want, (jk, jv) = jb.gqa_decode({k: jnp.asarray(a) for k, a in p.items()},
                                   jnp.asarray(x), jnp.asarray(ck),
                                   jnp.asarray(cv), cfg, t_cache=10)
    got, (tk, tv) = tb.gqa_decode(
        {k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x),
        torch.from_numpy(ck), torch.from_numpy(cv),
        t_config("qwen2-72b").reduced(), t_cache=10)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-4)


def test_init_params_follows_the_template():
    m = build_model(t_config("qwen2-72b").reduced(), device="meta")
    tmpl = m.template()
    kw = dict(default_dtype=torch.bfloat16, device="cpu")
    a = init_params(tmpl, seed=5, **kw)
    b = init_params(tmpl, seed=5, **kw)
    c = init_params(tmpl, seed=6, **kw)
    for path, spec in flatten(tmpl):
        assert a[path].shape == spec.shape
        assert a[path].dtype == torch.bfloat16
        assert torch.equal(a[path], b[path])
        if spec.init == "ones":
            assert bool((a[path] == 1).all())
        elif spec.init == "zeros":
            assert bool((a[path] == 0).all())
        else:
            assert not torch.equal(a[path], c[path])
            assert abs(float(a[path].float().std()) - 0.02) < 2e-3
