"""The port's hypothesis-transfer trainer (``repro_torch.core.
htl_trainer``) against the JAX package's, and the reference's own tests
(``tests/test_htl_trainer.py``) run on the port.

Parity: both packages start from the reference's ``HTLTrainer.init``
state (carried over with ``htl_state_from_reference``), run the same
local phase (H AdamW steps per DC, the count shared) and one transfer
round, for A2A and Star, each with ``"gd"`` mixing (gradient descent
through the mixture) and ``"loss_softmax"``, and the sync baseline's
local phase. Bounds, float32: local losses within 1e-5 relative;
parameters within 1e-5 of each leaf's max |x| plus 1% of the learning
rates summed over the steps (Adam steps an element whose gradient is
rounding noise by up to lr: ``tests/test_torch_train.py``); moments
within 1e-4 of the leaf's max (the loss tests' gradient bound); count
and step exact. The Star election is compared exactly
(``_token_entropy`` within 1e-6; the same center)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _path_str
from repro.configs import get_config as j_config
from repro.configs.base import HTLConfig as JHTL
from repro.configs.base import OptimizerConfig as JOpt
from repro.core.htl_trainer import HTLTrainer as JTrainer
from repro.models import build_model as j_build
from repro_torch.configs import get_config
from repro_torch.configs.base import HTLConfig, OptimizerConfig
from repro_torch.core.convert import htl_state_from_reference
from repro_torch.core.htl_trainer import HTLTrainer
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import build_model
from repro_torch.sharding.partitioning import flatten

torch.set_num_threads(1)

SMALL = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
             head_dim=32, d_ff=128, vocab_size=256)
CFG = dataclasses.replace(get_config("llama3.2-3b").reduced(), **SMALL)
J_CFG = dataclasses.replace(j_config("llama3.2-3b").reduced(), **SMALL)
MODEL = build_model(CFG, device="cpu")
L, H, B, S = 4, 4, 4, 64
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=50)
LOSS_RTOL, PARAM_RTOL, MOMENT_RTOL = 1e-5, 1e-5, 1e-4


def flat(tree):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_state_close(got, want, lr_sum):
    w = flat(want)
    for k, v in got.params.items():
        ref = w[".params/" + k]
        bound = PARAM_RTOL * np.abs(ref).max() + 1e-2 * lr_sum
        assert np.abs(v.numpy() - ref).max() <= bound, k
    for name, tree in (("mu", got.opt.mu), ("nu", got.opt.nu)):
        for k, v in tree.items():
            ref = w[f".opt/.{name}/{k}"]
            assert np.abs(v.numpy() - ref).max() <= \
                MOMENT_RTOL * np.abs(ref).max() + 1e-30, (name, k)
    assert int(got.opt.count) == int(w[".opt/.count"])
    assert int(got.step) == int(w[".step"])


def tokens(rng, *lead):
    toks = rng.integers(0, CFG.vocab_size, lead + (B, 33)).astype(np.int32)
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


@pytest.mark.parametrize("mode,mixing", [("a2a", "gd"),
                                         ("a2a", "loss_softmax"),
                                         ("star", "gd"),
                                         ("star", "loss_softmax"),
                                         ("sync", "gd")])
def test_local_and_transfer_phases_match_reference(mode, mixing):
    n = 1 if mode == "sync" else L
    htl = dict(mode=mode, num_collectors=n, local_steps=3, mixing_steps=3,
               mixing_mode=mixing)
    jt = JTrainer(j_build(J_CFG), JOpt(**OPT), JHTL(**htl))
    tt = HTLTrainer(MODEL, OptimizerConfig(**OPT), HTLConfig(**htl))
    js = jt.init(jax.random.PRNGKey(0))
    ts = htl_state_from_reference(flat(js), device="cpu")
    rng = np.random.default_rng(0)
    local = tokens(rng, 3) if mode == "sync" else tokens(rng, 3, L)
    js, jl = jax.jit(jt.local_phase)(js, {k: jnp.asarray(v)
                                          for k, v in local.items()})
    ts, tl = tt.local_phase(ts, {k: torch.from_numpy(v)
                                 for k, v in local.items()})
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOSS_RTOL)
    lr_sum = sum(float(tt._sched(i)) for i in range(3))
    assert_state_close(ts, js, lr_sum)
    mix = tokens(rng, L)
    js = jax.jit(jt.transfer_phase)(js, {k: jnp.asarray(v)
                                         for k, v in mix.items()})
    ts = tt.transfer_phase(ts, {k: torch.from_numpy(v)
                                for k, v in mix.items()})
    assert_state_close(ts, js, lr_sum)
    if mode != "sync":
        for v in ts.params.values():
            assert torch.equal(v[0], v[-1])


def test_token_entropy_and_election_match_reference():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 5000, (L, B, 64)).astype(np.int32)
    toks[2] %= 7                        # a low-entropy DC
    toks[3] = toks[1]                   # a tie: the first max wins
    want = np.asarray(jax.vmap(JTrainer._token_entropy)(jnp.asarray(toks)))
    got = torch.stack([HTLTrainer._token_entropy(torch.from_numpy(t))
                       for t in toks]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert int(np.argmax(want)) == int(torch.argmax(torch.from_numpy(got)))


def test_local_phase_podwise_waits_for_the_mesh():
    """The pod-wise local phase runs on a mesh (it waited for ROADMAP
    Queue 1 item 10): on a one-pod world it is the local phase, bit for
    bit, with the losses (L, H) as the reference's out_specs give them;
    the reference's own podwise phase is held to its local phase the same
    way."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    tr = _trainer("a2a")
    stream = TokenStream(CFG.vocab_size, seed=5)
    batches = _batches(stream, 2)
    want_state, want = tr.local_phase(tr.init(0), batches)
    fake_world(1)
    try:
        mesh = make_production_mesh(multi_pod=True, shape=(1, 1, 1))
        got_state, got = tr.local_phase_podwise(tr.init(0), batches, mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert got.shape == (L, 2) and torch.equal(got, want.t())
    for k in want_state.params:
        assert torch.equal(got_state.params[k], want_state.params[k]), k
        assert torch.equal(got_state.opt.mu[k], want_state.opt.mu[k]), k
        assert torch.equal(got_state.opt.nu[k], want_state.opt.nu[k]), k
    assert int(got_state.opt.count) == int(want_state.opt.count) == 2
    assert int(got_state.step) == 2


# --------------------------------------- tests/test_htl_trainer.py on port
def _trainer(mode):
    return HTLTrainer(MODEL, OptimizerConfig(lr=3e-3, warmup_steps=10,
                                             total_steps=300),
                      HTLConfig(mode=mode, num_collectors=L, local_steps=H,
                                mixing_steps=4))


def _batches(stream, h):
    toks = np.stack([stream.tokens(L * B * (S + 1)).reshape(L, B, S + 1)
                     for _ in range(h)])
    return {"tokens": torch.from_numpy(toks[..., :-1].copy()),
            "targets": torch.from_numpy(toks[..., 1:].copy())}


@pytest.mark.parametrize("mode", ["a2a", "star"])
def test_htl_training_converges(mode):
    tr = _trainer(mode)
    state = tr.init(0)
    stream = TokenStream(CFG.vocab_size, seed=1)
    losses = []
    for _ in range(5):
        state, ls = tr.local_phase(state, _batches(stream, H))
        state = tr.transfer_phase(state, {k: v[0] for k, v in
                                          _batches(stream, 1).items()})
        losses.append(float(ls.mean()))
    assert losses[-1] < losses[0] - 0.3, losses
    # all DC hypotheses identical after a transfer round (avg / broadcast)
    p0 = next(iter(state.params.values()))
    assert torch.allclose(p0[0], p0[1])


def test_transfer_keeps_finite():
    tr = _trainer("a2a")
    state = tr.init(0)
    stream = TokenStream(CFG.vocab_size, seed=2)
    state, _ = tr.local_phase(state, _batches(stream, H))
    state = tr.transfer_phase(state, {k: v[0] for k, v in
                                      _batches(stream, 1).items()})
    assert all(bool(torch.isfinite(x).all())
               for x in state.params.values())


def test_traffic_ledger_scaling():
    """HTL round traffic is O(L^2) for A2A, O(L) for Star, and the ratio to
    the sync baseline falls as 1/local_steps; equal to the reference's."""
    r8 = _trainer("a2a").round_traffic_bytes()
    mb = r8["model_bytes"]
    assert r8["htl_round_bytes"] == mb * (L * (L - 1) + (L - 1))
    star = _trainer("star").round_traffic_bytes()
    assert star["htl_round_bytes"] < r8["htl_round_bytes"]
    long_h = HTLTrainer(MODEL, OptimizerConfig(),
                        HTLConfig(mode="a2a", num_collectors=L,
                                  local_steps=64))
    assert long_h.round_traffic_bytes()["traffic_ratio_vs_sync"] < \
        r8["traffic_ratio_vs_sync"]
    for mode in ("a2a", "star", "sync"):
        htl = JHTL(mode=mode, num_collectors=L, local_steps=H)
        want = JTrainer(j_build(J_CFG), JOpt(), htl).round_traffic_bytes()
        got = HTLTrainer(MODEL, OptimizerConfig(), HTLConfig(
            mode=mode, num_collectors=L, local_steps=H)).round_traffic_bytes()
        assert got == want


def test_sync_mode_is_plain_training():
    tr = HTLTrainer(MODEL, OptimizerConfig(lr=3e-3),
                    HTLConfig(mode="sync", num_collectors=1, local_steps=H))
    state = tr.init(0)
    # sync params are unstacked: the template's shapes
    assert {k: tuple(v.shape) for k, v in state.params.items()} == \
        {k: s.shape for k, s in flatten(MODEL.template())}
    assert tr.round_traffic_bytes()["htl_round_bytes"] == 0.0
