"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on the same inputs, and the reference's own optimizer tests
(``tests/test_optim.py``) run on the port.

* AdamW: k steps from the same parameters, gradients and state equal the
  reference's within 1e-6 relative (float32 on both sides; other
  rounding of ``pow`` and of the norm's sums), clipped and unclipped,
  with a stacked per-layer norm (``layers/ln1``, (layers, d)) that the
  reference decays, given to the port both stacked and split into its
  per-layer tensors (the model's ``param_tree`` layout), and a top-level
  vector (``final_norm``) that it does not decay; the same in bfloat16
  parameters with float32 moments (parameters within one bf16 ulp).
* The decay decision on every model's ``param_tree`` is the template's
  ``ndim >= 2``, stacked leaves counted whole.
* ``clip_by_global_norm``, ``cosine_warmup_schedule`` and ``sgd_update``
  within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # deterministic shim, tests/_hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import OptimizerConfig as JOpt
from repro.optim import adamw as ja
from repro.optim.schedule import cosine_warmup_schedule as j_sched
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import build_model
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, cosine_warmup_schedule,
                               global_norm, sgd_update)
from repro_torch.optim.adamw import AdamWState, _stacked_ndim
from repro_torch.sharding.partitioning import flatten

torch.set_num_threads(1)

RTOL = 1e-6
SHAPES = {"embed": (16, 8), "final_norm": (8,), "layers/ln1": (2, 8),
          "layers/w": (2, 8, 4)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(0, 1, s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _nest(flat):
    """{"a/b": x} -> {"a": {"b": x}} for the reference."""
    out = {}
    for k, v in flat.items():
        *heads, last = k.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return out


def _unnest(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_unnest(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _split(flat, dtype):
    """The port's layout: ``layers/...`` as lists of per-layer tensors."""
    return {k: [torch.tensor(r, dtype=dtype) for r in v]
            if k.startswith("layers/") else torch.tensor(v, dtype=dtype)
            for k, v in flat.items()}


def _stack(tree):
    return {k: (torch.stack(v) if isinstance(v, list) else v).float().numpy()
            for k, v in tree.items()}


def _close(got, want, rtol=RTOL):
    for k in want:
        w = np.asarray(want[k], np.float32)
        err = np.abs(np.asarray(got[k], np.float32) - w).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-30), (k, err)


CFG = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("layout", ["stacked", "split"])
def test_adamw_steps_match_reference(clip, layout):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=3.0) for _ in range(4)]
    jcfg, tcfg = JOpt(grad_clip=clip, **CFG), OptimizerConfig(grad_clip=clip,
                                                              **CFG)
    jp, jo = _nest(p0), ja.adamw_init(_nest(p0))
    as_port = (lambda f: _split(f, torch.float32)) if layout == "split" \
        else (lambda f: {k: torch.tensor(v) for k, v in f.items()})
    tp = as_port(p0)
    to = adamw_init(tp)
    for i, g in enumerate(grads):
        lr = j_sched(jcfg)(i + 3)
        jp, jo, jn = ja.adamw_update(_nest(g), jo, jp, lr, jcfg)
        tp, to, tn = adamw_update(as_port(g), to, tp,
                                  cosine_warmup_schedule(tcfg)(i + 3), tcfg)
        assert float(tn) == pytest.approx(float(jn), rel=RTOL)
    _close(_stack(tp), _unnest(jp))
    _close({k: v.numpy() for k, v in to.mu.items()}, _unnest(jo.mu))
    _close({k: v.numpy() for k, v in to.nu.items()}, _unnest(jo.nu))
    assert int(to.count) == int(jo.count) == len(grads)
    # the stacked per-layer norm decays, the top-level vector does not
    zero = {k: np.zeros_like(v) for k, v in p0.items()}
    tp, _, _ = adamw_update(as_port(zero), adamw_init(as_port(p0)),
                            as_port(p0), 0.1, tcfg)
    got = _stack(tp)
    assert np.array_equal(got["final_norm"], p0["final_norm"])
    assert not np.allclose(got["layers/ln1"], p0["layers/ln1"])


def test_adamw_bfloat16_params_match_reference():
    """bf16 parameters and gradients, float32 moments: the port's step
    rounds where the reference's does (params within one bf16 ulp)."""
    rng = np.random.default_rng(1)
    p0, g = _tree(rng), _tree(rng, scale=2.0)
    cfg = OptimizerConfig(grad_clip=1.0, **CFG)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _nest(p0))
    jg = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _nest(g))
    jp2, jo, _ = ja.adamw_update(jg, ja.adamw_init(jp), jp, 1e-2,
                                 JOpt(grad_clip=1.0, **CFG))
    tp = _split(p0, torch.bfloat16)
    tp, to, _ = adamw_update(_split(g, torch.bfloat16), adamw_init(tp), tp,
                             1e-2, cfg)
    assert all(t.dtype == torch.bfloat16 for v in tp.values()
               for t in (v if isinstance(v, list) else [v]))
    assert all(m.dtype == torch.float32 for m in to.mu.values())
    want = {k: np.asarray(v, np.float32) for k, v in _unnest(jp2).items()}
    for k, v in _stack(tp).items():
        ulp = np.abs(want[k]) * 2.0 ** -7
        assert (np.abs(v - want[k]) <= ulp + 1e-30).all(), k
    _close({k: v.numpy() for k, v in to.mu.items()}, _unnest(jo.mu))


@pytest.mark.parametrize("scale", [0.01, 0.3, 1.0, 50.0, 1e4])
def test_clip_by_global_norm_matches_reference(scale):
    rng = np.random.default_rng(2)
    g = _tree(rng, scale)
    jc, jn = ja.clip_by_global_norm(_nest(g), 1.0)
    tc, tn = clip_by_global_norm(_split(g, torch.float32), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=RTOL)
    assert float(global_norm(tc)) == pytest.approx(
        float(ja.global_norm(jc)), rel=RTOL)
    _close(_stack(tc), _unnest(jc))


@pytest.mark.parametrize("cfg", [dict(lr=1e-3, warmup_steps=20,
                                      total_steps=8),
                                 dict(lr=3e-3, warmup_steps=10,
                                      total_steps=300, min_lr_ratio=0.1),
                                 dict(lr=0.1, warmup_steps=0,
                                      total_steps=100, min_lr_ratio=1.0)])
def test_schedule_matches_reference(cfg):
    js, ts = j_sched(JOpt(**cfg)), cosine_warmup_schedule(
        OptimizerConfig(**cfg))
    for step in range(0, 320, 3):
        got, want = ts(step), js(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=RTOL, abs=1e-12)
    assert float(ts(torch.tensor(7, dtype=torch.int32))) == \
        pytest.approx(float(js(7)), rel=RTOL)


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(3)
    p, g = _tree(rng), _tree(rng)
    want = ja.sgd_update(_nest(g), _nest(p), 0.05)
    got = sgd_update(_split(g, torch.float32), _split(p, torch.float32),
                     0.05)
    _close(_stack(got), _unnest(want))


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_decay_rule_reads_the_stacked_template(arch):
    """On the model's split layers the decision is the template's: every
    stacked leaf (per-layer norms and biases too) decays, and so does
    every top-level matrix; top-level vectors do not."""
    model = build_model(get_config(arch).reduced(), device="meta")
    want = {p: len(s.shape) >= 2 for p, s in flatten(model.template())}
    got = {p: _stacked_ndim(leaf) >= 2
           for p, leaf in model.param_tree().items()}
    assert got == want
    assert got.get("layers/ln1", True) and not got["final_norm"]


# ------------------------------------------- tests/test_optim.py on the port
def test_adamw_minimizes_quadratic():
    cfg = OptimizerConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0,
                          warmup_steps=0, total_steps=100, min_lr_ratio=1.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(g, opt, params, 0.1, cfg)
    assert float(((params["w"] - target) ** 2).sum()) < 1e-3


@given(scale=st.floats(min_value=0.01, max_value=1e4))
@settings(max_examples=30, deadline=None)
def test_clip_bounds_norm(scale):
    g = {"a": torch.ones((4, 4)) * scale, "b": torch.ones(7) * scale}
    orig = {k: v.clone() for k, v in g.items()}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) <= 1.0 + 1e-4
    if float(norm) <= 1.0:       # no-op when already under the bound
        for k in orig:
            torch.testing.assert_close(clipped[k], orig[k], rtol=1e-5,
                                       atol=0)


def test_weight_decay_skips_vectors():
    cfg = OptimizerConfig(lr=0.1, weight_decay=1.0, grad_clip=0.0)
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones(2)}
    opt = adamw_init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = adamw_update(zero_g, opt, params, 0.1, cfg)
    assert float((new["vec"] - 1.0).abs().max()) < 1e-6   # no decay
    assert float(new["mat"].max()) < 1.0                   # decayed


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lr = cosine_warmup_schedule(cfg)
    assert float(lr(0)) == pytest.approx(0.0)
    assert float(lr(10)) == pytest.approx(1e-3, rel=0.02)
    assert float(lr(5)) == pytest.approx(5e-4, rel=0.02)
    assert float(lr(100)) == pytest.approx(1e-4, rel=0.05)
    vals = [float(lr(s)) for s in range(10, 101, 10)]
    assert all(a >= b - 1e-12 for a, b in zip(vals, vals[1:]))


def test_moments_are_float32():
    params = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt.mu["w"].dtype == torch.float32
    assert opt.nu["w"].dtype == torch.float32
    g = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    new, opt2, _ = adamw_update(g, opt, params, 1e-3, OptimizerConfig())
    assert new["w"].dtype == torch.bfloat16     # params keep their dtype
    assert opt2.mu["w"].dtype == torch.float32
    assert isinstance(opt2, AdamWState) and int(opt2.count) == 1
