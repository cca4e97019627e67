"""The port's ``ssm`` (mamba2-1.3b) and ``hybrid`` (recurrentgemma-9b)
families against the JAX package on the same weights and tokens.

* The mixers one by one (``models/ssd.py``, ``models/rglru.py``): the
  depthwise causal conv, the block-diagonal gates, prefill forward and
  the one-token decode step, on the same float32 inputs.
* The whole models, reduced (recurrentgemma with 5 layers: one period of
  rglru, rglru, attention, then 2 tail layers, so that every kind of
  sublayer runs): prefill logits and caches against JAX ``Model.prefill``
  with ``attention_impl`` "xla" and "pallas" (the Pallas kernels in
  interpret mode), ``decode_step`` with scalar and per-sequence
  positions, decode == prefill on the port alone
  (``tests/test_decode_equivalence.py``), greedy ``generate`` and
  ``ContinuousBatcher`` tokens (hybrid prompts at least the reduced
  window, 32), reference checkpoints in float32 and bfloat16, templates,
  cache templates, ``pad_cache`` and ``cache_bytes``.
* The new initialisers (``ssm_a``, ``dt_bias``, ``conv``, ``fan_in``):
  their distributions, and that each seed is deterministic.

Tolerances: logits within 1e-5 relative to the largest |logit| (float32
both sides, other summation orders: the measured gap is below 1e-6);
caches and mixer outputs within 1e-5 of their largest |value| (at least
1e-5 absolute: ``close``); decode ==
prefill within 2e-3 (the reference test's bound). Greedy tokens are
compared exactly; every argmax wins by more than 1e-4 (asserted)."""
import dataclasses
import math
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
from repro.models import build_model as j_build
from repro.models import rglru as jr
from repro.models import ssd as jssd
from repro.serving import ServeEngine as JEngine
from repro.serving import cache_bytes as j_cache_bytes
from repro.serving import pad_cache as j_pad
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.models import build_model
from repro_torch.models import rglru as tr
from repro_torch.models import ssd as tssd
from repro_torch.serving import ServeEngine, cache_bytes, pad_cache
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.sharding.partitioning import flatten, init_params

torch.set_num_threads(1)

REL_TOL = 1e-5
ATOL = 1e-5
MARGIN = 1e-4
S = 64
ARCHS = [("mamba2-1.3b", None), ("recurrentgemma-9b", 5)]
IDS = ["mamba2-1.3b", "recurrentgemma-9b-5layers"]


def configs(arch, num_layers=None):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    if num_layers:
        jc = dataclasses.replace(jc, num_layers=num_layers)
        tc = dataclasses.replace(tc, num_layers=num_layers)
    return jc, tc


def flat(params):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def setup(arch, num_layers=None, seed=0):
    """(JAX model, JAX params, port model) on the same weights."""
    jc, tc = configs(arch, num_layers)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(seed))
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


def close(got, want, what=""):
    """|got - want| <= 1e-5 x max(1, max |want|), elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
        err_msg=what)


def assert_caches_close(ct, cj):
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        close(ct[key].numpy(), cj[key], key)


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def pair(request):
    return setup(*request.param)


# --------------------------------------------------------------------------
# the mixers, one by one
# --------------------------------------------------------------------------

def _params(template, seed):
    """Random float32 parameters for a mixer template, drawn with numpy
    (O(1) gates and decay parameters, 0.2-scaled weights)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, spec in flatten(template):
        scale = 0.5 if spec.init in ("ssm_a", "dt_bias", "ones", "zeros") \
            else 0.2
        out[path] = rng.normal(size=spec.shape).astype(np.float32) * scale
    return out


def _both(arrays):
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def test_causal_conv_and_block_diag_match():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    want = jssd._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b))
    got = tssd._causal_conv(*(torch.from_numpy(a) for a in (u, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    got_r = tr._causal_conv(*(torch.from_numpy(a) for a in (u, w, b)))
    np.testing.assert_allclose(
        got_r.numpy(), np.asarray(jr._causal_conv(
            jnp.asarray(u), jnp.asarray(w), jnp.asarray(b))), rtol=0,
        atol=1e-6)
    bd = rng.normal(size=(4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tr._block_diag(torch.from_numpy(u), torch.from_numpy(bd)).numpy(),
        np.asarray(jr._block_diag(jnp.asarray(u), jnp.asarray(bd))),
        rtol=0, atol=1e-6)


def test_ssd_mixer_forward_and_decode_match():
    jc, tc = configs("mamba2-1.3b")
    jp, tp = _both(_params(tssd.ssd_template(tc), seed=1))
    x = np.random.default_rng(2).normal(size=(2, 40, jc.d_model)).astype(
        np.float32)
    yj, (hj, cj) = jax.jit(jssd.ssd_forward, static_argnums=2)(
        jp, jnp.asarray(x), jc)
    yt, (ht, ct) = tssd.ssd_forward(tp, torch.from_numpy(x), tc)
    close(yt.numpy(), yj)
    close(ht.numpy(), hj)
    close(ct.numpy(), cj)
    x1 = np.random.default_rng(3).normal(size=(2, 1, jc.d_model)).astype(
        np.float32)
    ydj, (sj, vj) = jax.jit(jssd.ssd_decode, static_argnums=4)(
        jp, jnp.asarray(x1), hj, cj, jc)
    state, conv = ht.clone(), ct.clone()
    ydt, (st, vt) = tssd.ssd_decode(tp, torch.from_numpy(x1), state, conv, tc)
    assert st is state and vt is conv                  # written in place
    close(ydt.numpy(), ydj)
    close(st.numpy(), sj)
    close(vt.numpy(), vj)


def test_rglru_mixer_forward_and_decode_match():
    jc, tc = configs("recurrentgemma-9b")
    jp, tp = _both(_params(tr.rglru_template(tc), seed=4))
    x = np.random.default_rng(5).normal(size=(2, 33, jc.d_model)).astype(
        np.float32)
    yj, (hj, cj) = jax.jit(jr.rglru_forward, static_argnums=2)(
        jp, jnp.asarray(x), jc)
    yt, (ht, ct) = tr.rglru_forward(tp, torch.from_numpy(x), tc)
    close(yt.numpy(), yj)
    close(ht.numpy(), hj)
    close(ct.numpy(), cj)
    x1 = np.random.default_rng(6).normal(size=(2, 1, jc.d_model)).astype(
        np.float32)
    ydj, (sj, vj) = jax.jit(jr.rglru_decode, static_argnums=4)(
        jp, jnp.asarray(x1), hj, cj, jc)
    state, conv = ht.clone(), ct.clone()
    ydt, (st, vt) = tr.rglru_decode(tp, torch.from_numpy(x1), state, conv, tc)
    assert st is state and vt is conv                  # written in place
    close(ydt.numpy(), ydj)
    close(st.numpy(), sj)
    close(vt.numpy(), vj)


# --------------------------------------------------------------------------
# whole models against JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match(pair, impl):
    jm, params, tm = pair
    jm = j_build(dataclasses.replace(jm.cfg, attention_impl=impl))
    toks = tokens(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    lt, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    assert lt.shape == lj.shape
    assert rel_err(lt.numpy(), lj) < REL_TOL
    assert_caches_close(ct, cj)


@pytest.mark.parametrize("per_sequence", [False, True],
                         ids=["scalar_pos", "vector_pos"])
def test_decode_step_matches(pair, per_sequence):
    jm, params, tm = pair
    toks = tokens(jm.cfg)
    lj, cj = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, ct = tm.prefill({"tokens": torch.from_numpy(toks)})
    cj = j_pad(jm, cj, 4, 2, S)
    ct = pad_cache(tm, ct, 4, 2, S)
    nxt = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    pos = np.array([S, S - 5], np.int32) if per_sequence else S
    ld, cd = jax.jit(jm.decode_step)(params, cj, jnp.asarray(nxt),
                                     jnp.asarray(pos, jnp.int32))
    buffers = {k: v.data_ptr() for k, v in ct.items()}
    lt, ct = tm.decode_step(ct, torch.from_numpy(nxt), torch.as_tensor(pos))
    assert {k: v.data_ptr() for k, v in ct.items()} == buffers  # in place
    assert rel_err(lt.numpy(), ld) < REL_TOL
    assert_caches_close(ct, cd)


@pytest.mark.parametrize("arch,num_layers", [
    ("mamba2-1.3b", None), ("recurrentgemma-9b", None),
    ("recurrentgemma-9b", 5)],
    ids=["mamba2-1.3b", "recurrentgemma-9b", "recurrentgemma-9b-5layers"])
def test_decode_equals_prefill(arch, num_layers):
    """tests/test_decode_equivalence.py on the port alone (the reduced
    recurrentgemma of 2 layers has no period, so no attention)."""
    _, cfg = configs(arch, num_layers)
    m = build_model(cfg, device="cpu").init(seed=0)
    toks = torch.from_numpy(tokens(cfg, seed=3).astype(np.int64))
    lg_full, _ = m.prefill({"tokens": toks})
    _, cache = m.prefill({"tokens": toks[:, :S - 1]})
    cache = pad_cache(m, cache, 1, 2, S - 1)
    lg_inc, _ = m.decode_step(cache, toks[:, S - 1:S], S - 1)
    scale = float(lg_full.abs().max()) + 1e-9
    assert float((lg_full - lg_inc).abs().max()) / scale < 2e-3


@pytest.mark.parametrize("arch,num_layers", ARCHS, ids=IDS)
def test_generate_greedy_tokens_equal_reference(arch, num_layers):
    jm, params, tm = setup(arch, num_layers, seed=1)
    toks = tokens(jm.cfg, seq=40, seed=8)        # >= the hybrid window, 32
    want = np.asarray(JEngine(jm, params, max_new_tokens=6).generate(
        {"tokens": jnp.asarray(toks)}))
    got = ServeEngine(tm, max_new_tokens=6).generate(
        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), want)
    seq = torch.from_numpy(toks)
    for i in range(6):
        lg, _ = tm.prefill({"tokens": seq})
        assert margin(lg.numpy()) > MARGIN
        seq = torch.cat([seq, got[:, i:i + 1].to(seq.dtype)], dim=1)


@pytest.mark.parametrize("arch,num_layers,lengths", [
    ("mamba2-1.3b", None, (24, 16, 31, 9)),
    ("recurrentgemma-9b", 5, (32, 40, 35, 48))], ids=IDS)
def test_continuous_batcher_outputs_equal_reference(arch, num_layers,
                                                    lengths):
    """Hybrid prompts are at least the window: a shorter one gets a window
    cache of its own length, which cannot be spliced beside another
    (ROADMAP Queue 3, both packages)."""
    jm, params, tm = setup(arch, num_layers, seed=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int64)
               for n in lengths]
    n_new = 5
    jbat = JBatcher(jm, params, slots=2, max_len=64)
    jreqs = [JRequest(i, p, n_new) for i, p in enumerate(prompts)]
    tbat = ContinuousBatcher(tm, slots=2, max_len=64)
    treqs = [Request(i, p, n_new) for i, p in enumerate(prompts)]
    for jq, tq in zip(jreqs, treqs):
        jbat.submit(jq)
        tbat.submit(tq)
    jbat.run()
    done = tbat.run()
    assert all(r.done for r in treqs) and len(done) == len(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    eng = ServeEngine(tm, max_new_tokens=n_new)
    for r, p in zip(treqs, prompts):
        ref = eng.generate({"tokens": torch.from_numpy(p[None, :])})[0]
        assert r.out[:n_new] == ref.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,num_layers", ARCHS, ids=IDS)
def test_reference_checkpoint_loads_into_the_port(arch, num_layers, dtype):
    """save_checkpoint (JAX) -> load_checkpoint (numpy only) ->
    lm_from_reference: every weight bit for bit, and (float32) prefill
    logits as from the JAX params."""
    jc, tc = configs(arch, num_layers)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(2), jnp.dtype(dtype))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, params, step=3)
        assert os.path.exists(os.path.join(d, "arrays.npz"))
        arrays = load_checkpoint(d)
    want = flat(params)
    assert set(arrays) == set(want)
    tm = lm_from_reference(tc, arrays, device="cpu", dtype=dtype)
    for key, a in want.items():
        got = tm._targets(key)
        got = torch.stack(got) if isinstance(got, list) else got
        assert got.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), a)
    if dtype == "float32":
        toks = tokens(jc, seq=40)
        lj, _ = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
        lt, _ = tm.prefill({"tokens": torch.from_numpy(toks)})
        assert rel_err(lt.numpy(), lj) < REL_TOL


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_templates_and_caches_match_the_reference(arch):
    """Full-size templates and cache templates (shapes and axes), cache
    bytes, and pad_cache shapes equal the reference's."""
    jm = j_build(j_config(arch))
    tm = build_model(t_config(arch), device="meta")
    want = {_path_str(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jm.template(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {p: s.shape for p, s in flatten(tm.template())} == want
    for b, n in ((1, 1024), (4, 2048), (3, 3000)):
        jt, tt = jm.cache_template(b, n), tm.cache_template(b, n)
        assert {k: (v.shape, v.axes) for k, v in tt.items()} == \
            {k: (v.shape, v.axes) for k, v in jt.items()}
        assert cache_bytes(tm, b, n) == j_cache_bytes(jm, b, n)
    jm, tm = j_build(j_config(arch).reduced()), \
        build_model(t_config(arch).reduced(), device="cpu")
    for n in (20, 40):
        cj = {k: jnp.zeros(s.shape, jnp.float32) for k, s in
              jm.cache_template(2, n).items()}
        ct = {k: torch.zeros(s.shape) for k, s in
              tm.cache_template(2, n).items()}
        assert {k: tuple(v.shape) for k, v in
                pad_cache(tm, ct, 7, 2, n).items()} == \
            {k: v.shape for k, v in j_pad(jm, cj, 7, 2, n).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_embedding_scale_is_rounded_to_the_model_dtype(dtype):
    """h = embed[tokens] * sqrt(d_model) rounded to the model dtype
    (11.3137... at the reduced d_model of 128; 64 exactly at 4096)."""
    jc, tc = configs("recurrentgemma-9b", 5)
    jm = j_build(dataclasses.replace(jc, dtype=dtype))
    tm = build_model(dataclasses.replace(tc, dtype=dtype),
                     device="cpu").init(seed=0)
    toks = np.arange(10, dtype=np.int32)[None]
    params = {"embed": jnp.asarray(tm.top["embed"].float().numpy(),
                                   jnp.dtype(dtype))}
    want = jm._embed(params, jnp.asarray(toks))
    got = tm._embed(torch.from_numpy(toks))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert float(torch.tensor(math.sqrt(4096), dtype=getattr(torch, dtype))) \
        == 64.0


def test_new_initialisers_draw_their_distributions():
    """ssm_a = log U[1, 16), dt_bias = softplus^-1(U[1e-3, 1e-1)), conv
    N(0, 1/shape[0]), fan_in N(0, 1/shape[-2]) (of the stacked leaf, as
    the reference); each seed is deterministic and seeds differ."""
    tm = build_model(t_config("mamba2-1.3b").reduced(), device="meta")
    hy = build_model(configs("recurrentgemma-9b", 5)[1], device="meta")
    tmpl = {"ssm": tm.template(), "hybrid": hy.template()}
    a = init_params(tmpl, seed=5, device="cpu")
    b = init_params(tmpl, seed=5, device="cpu")
    c = init_params(tmpl, seed=6, device="cpu")
    seen = set()
    for path, spec in flatten(tmpl):
        assert torch.equal(a[path], b[path]), path
        v = a[path].double()
        if spec.init in ("zeros", "ones"):
            continue
        assert not torch.equal(a[path], c[path]), path
        seen.add(spec.init)
        if spec.init == "ssm_a":
            u = v.exp()
            assert 1.0 <= float(u.min()) and float(u.max()) < 16.0
        elif spec.init == "dt_bias":
            u = torch.nn.functional.softplus(v)
            assert 1e-3 - 1e-9 <= float(u.min()) and float(u.max()) < 0.1
        elif spec.init == "conv":
            assert abs(float(v.std()) - 1 / math.sqrt(spec.shape[0])) \
                < 0.1 / math.sqrt(spec.shape[0])
        elif spec.init == "fan_in":
            assert abs(float(v.std()) - 1 / math.sqrt(spec.shape[-2])) \
                < 0.1 / math.sqrt(spec.shape[-2])
    assert {"ssm_a", "dt_bias", "conv", "fan_in"} <= seen
    # the wide leaves: uniform draws fill their range
    lam = init_params({"w": tm.template()["layers"]["mixer"]["A_log"]},
                      seed=1, device="cpu")["w"].exp()
    assert lam.numel() == 2 * 16 and float(lam.max() - lam.min()) > 5.0
