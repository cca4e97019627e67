"""The port's serving path against the JAX package: ``ServeEngine``
greedy tokens and ``ContinuousBatcher`` outputs equal the reference's on
the same weights (the reference scheduler test's prompts of 24, 16, 31 and
9 tokens), ``pad_cache`` shapes and ``cache_bytes`` equal, and
``make_lm_batch`` / ``TokenStream`` tokens byte-equal. Then the
decode-vs-prefill checks of ``tests/test_decode_equivalence.py`` and
``tests/test_scheduler.py`` on the port alone, at their bounds (relative
logit error 2e-3; per-sequence positions within 2e-3 absolute).

Greedy tokens are compared exactly. That is meaningful because the port's
float32 logits are within 1e-5 (relative) of JAX's (tests/test_torch_lm.py)
while every argmax taken here wins by a margin of more than 1e-4 (asserted
in ``_margin``): no comparison sits on a near tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _path_str
from repro.configs import get_config as j_config
from repro.data.pipeline import TokenStream as JTokenStream
from repro.data.pipeline import make_lm_batch as j_batch
from repro.models import build_model as j_build
from repro.serving import ServeEngine as JEngine
from repro.serving import cache_bytes as j_cache_bytes
from repro.serving import pad_cache as j_pad
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.data.pipeline import TokenStream, make_lm_batch
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine, cache_bytes, pad_cache
from repro_torch.serving.scheduler import ContinuousBatcher, Request

torch.set_num_threads(1)

S = 64
MARGIN = 1e-4


def _flat(params):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def _pair(arch="llama3.2-3b", seed=0):
    jm = j_build(j_config(arch).reduced())
    params = jm.init(jax.random.PRNGKey(seed))
    tm = lm_from_reference(t_config(arch).reduced(), _flat(params),
                           device="cpu")
    return jm, params, tm


def _margin(logits):
    top2 = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


def test_generate_greedy_tokens_equal_reference():
    jm, params, tm = _pair()
    cfg = jm.cfg
    jb = j_batch(cfg.vocab_size, 2, 32, d_model=cfg.d_model)
    tb = make_lm_batch(cfg.vocab_size, 2, 32, d_model=cfg.d_model,
                       device="cpu")
    want = np.asarray(JEngine(jm, params, max_new_tokens=6).generate(
        {"tokens": jb["tokens"]}))
    got = ServeEngine(tm, max_new_tokens=6).generate(
        {"tokens": tb["tokens"]})
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    # every step's argmax is clear of a tie (module doc)
    seq = tb["tokens"]
    for i in range(6):
        lg, _ = tm.prefill({"tokens": seq})
        assert _margin(lg.numpy()) > MARGIN
        seq = torch.cat([seq, got[:, i:i + 1].to(seq.dtype)], dim=1)


def test_continuous_batcher_outputs_equal_reference():
    jm, params, tm = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jm.cfg.vocab_size, n).astype(np.int64)
               for n in (24, 16, 31, 9)]
    n_new = 5
    jbat = JBatcher(jm, params, slots=2, max_len=64)
    jreqs = [JRequest(i, p, n_new) for i, p in enumerate(prompts)]
    tbat = ContinuousBatcher(tm, slots=2, max_len=64)
    treqs = [Request(i, p, n_new) for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jbat.submit(jr)
        tbat.submit(tr)
    jbat.run()
    done = tbat.run()
    assert all(r.done for r in treqs) and len(done) == len(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    # and equal to one-at-a-time generation, as the reference test checks
    eng = ServeEngine(tm, max_new_tokens=n_new)
    for r, p in zip(treqs, prompts):
        ref = eng.generate({"tokens": torch.from_numpy(p[None, :])})[0]
        assert r.out[:n_new] == ref.tolist()


@pytest.mark.parametrize("arch,window", [("llama3.2-3b", 0),
                                         ("qwen2-72b", 0),
                                         ("llama3.2-3b", 32)])
def test_pad_cache_shapes_equal_reference(arch, window):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    if window:
        jc = dataclasses.replace(jc, sliding_window=window)
        tc = dataclasses.replace(tc, sliding_window=window)
    jm, tm = j_build(jc), build_model(tc, device="cpu")
    for n in (20, 40):
        cj = {k: jnp.zeros(s.shape, jnp.float32) for k, s in
              jm.cache_template(2, n).items()}
        ct = {k: torch.zeros(s.shape) for k, s in
              tm.cache_template(2, n).items()}
        pj = j_pad(jm, cj, 7, 2, n)
        pt = pad_cache(tm, ct, 7, 2, n)
        assert {k: tuple(v.shape) for k, v in pt.items()} == \
            {k: v.shape for k, v in pj.items()}


def test_cache_bytes_equal_reference():
    for arch in ("llama3.2-3b", "granite-3-8b", "qwen2-72b"):
        jm = j_build(j_config(arch))
        tm = build_model(t_config(arch), device="meta")
        for b, n in ((1, 1024), (4, 2048), (3, 777)):
            assert cache_bytes(tm, b, n) == j_cache_bytes(jm, b, n)
    # llama3.2-3b: 28 layers x 2 x 8 KV heads x 128 x 2 bytes per token
    tm = build_model(t_config("llama3.2-3b"), device="meta")
    assert cache_bytes(tm, 1, 1) == 28 * 2 * 8 * 128 * 2


def test_make_lm_batch_byte_equal():
    for kw in (dict(), dict(frontend_tokens=5, d_model=16),
               dict(encoder_len=6, d_model=16)):
        want = j_batch(1000, 3, 17, seed=4, **kw)
        got = make_lm_batch(1000, 3, 17, seed=4, device="cpu", **kw)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype in (torch.int32, torch.float32)
            assert got[key].numpy().tobytes() == \
                np.asarray(want[key]).tobytes()


def test_token_stream_byte_equal():
    want = next(JTokenStream(500, seed=2).batches(2, 9))
    got = next(TokenStream(500, seed=2).batches(2, 9, device="cpu"))
    for key in ("tokens", "targets"):
        assert got[key].numpy().tobytes() == np.asarray(want[key]).tobytes()


def test_sampling_uses_its_generator():
    tm = build_model(t_config("llama3.2-3b").reduced(), device="cpu").init(0)
    batch = make_lm_batch(256, 2, 16, device="cpu")
    eng = ServeEngine(tm, max_new_tokens=5)
    runs = [eng.generate(batch, temperature=1.0,
                         generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="generator"):
        eng.generate(batch, temperature=1.0)


# --------------------------------------------------------------------------
# decode == prefill on the port alone (tests/test_decode_equivalence.py)
# --------------------------------------------------------------------------

def _decode_err(arch, window=0):
    cfg = t_config(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    m = build_model(cfg, device="cpu").init(seed=0)
    toks = make_lm_batch(cfg.vocab_size, 2, S, seed=3, device="cpu")["tokens"]
    lg_full, _ = m.prefill({"tokens": toks})
    _, cache = m.prefill({"tokens": toks[:, :S - 1]})
    cache = pad_cache(m, cache, 1, 2, S - 1)
    lg_inc, _ = m.decode_step(cache, toks[:, S - 1:S], S - 1)
    scale = float(lg_full.abs().max()) + 1e-9
    return float((lg_full - lg_inc).abs().max()) / scale


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-3-8b", "qwen2-72b"])
def test_decode_equals_prefill(arch):
    assert _decode_err(arch) < 2e-3


def test_sliding_window_decode_equals_prefill():
    assert _decode_err("llama3.2-3b", window=32) < 2e-3


def test_multi_step_generation_consistency():
    """N decode steps == greedy continuation by repeated full prefill."""
    cfg = t_config("llama3.2-3b").reduced()
    m = build_model(cfg, device="cpu").init(seed=1)
    toks = make_lm_batch(cfg.vocab_size, 1, S, seed=5, device="cpu")["tokens"]
    n_new = 4
    lg, cache = m.prefill({"tokens": toks})
    cache = pad_cache(m, cache, n_new, 1, S)
    out, cur = [], lg.argmax(-1)[:, None]
    for i in range(n_new):
        out.append(int(cur[0, 0]))
        lg, cache = m.decode_step(cache, cur, S + i)
        cur = lg.argmax(-1)[:, None]
    seq, ref = toks, []
    for _ in range(n_new):
        lg_f, _ = m.prefill({"tokens": seq})
        nxt = lg_f.argmax(-1)[:, None]
        ref.append(int(nxt[0, 0]))
        seq = torch.cat([seq, nxt.to(seq.dtype)], dim=1)
    assert out == ref


def test_per_sequence_positions_decode():
    """Two sequences at different depths in one batched decode match their
    scalar-position decodes (tests/test_scheduler.py)."""
    cfg = t_config("llama3.2-3b").reduced()
    m = build_model(cfg, device="cpu").init(seed=1)
    toks = make_lm_batch(cfg.vocab_size, 2, 32, seed=7,
                         device="cpu")["tokens"]
    lens, refs, caches, firsts = [32, 20], [], [], []
    for i, n in enumerate(lens):
        lg, cache = m.prefill({"tokens": toks[i:i + 1, :n]})
        cache = pad_cache(m, cache, 40 - n, 1, n)
        caches.append({k: v.clone() for k, v in cache.items()})
        firsts.append(lg.argmax(-1))
        lg2, _ = m.decode_step(cache, lg.argmax(-1)[:, None], n)
        refs.append(lg2[0])
    batched = {k: torch.cat([caches[0][k], caches[1][k]], dim=1)
               for k in caches[0]}
    lgb, _ = m.decode_step(batched, torch.cat(firsts)[:, None],
                           torch.tensor(lens))
    for i in range(2):
        torch.testing.assert_close(lgb[i], refs[i], rtol=0, atol=2e-3)
