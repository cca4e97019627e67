"""The port's training driver (``repro_torch.launch.train``) and
checkpointer (``repro_torch.checkpoint``) against the JAX package's.

* ``make_train_step``: 3 steps (across the end of the warmup) from the
  reference's weights (``lm_from_reference``) and the same batches give
  the reference's jitted step's metrics (loss, ce, aux, mtp, gnorm, lr
  within 1e-5 relative), moments within 1e-4 of each leaf's max |x| (they
  average gradients: the loss tests' gradient bound), and parameters
  within 1e-5 of the leaf's max plus 1% of the learning rates summed
  over the steps, for llama3.2-3b and deepseek-v3-671b (MoE, MLA, MTP) reduced,
  float32. The second term is Adam's: it normalises each element's step
  to about lr, so an element whose gradient is float32 rounding noise
  (|g| ~4e-9 beside a leaf max of 0.24 in llama's ``embed``, 11% apart
  between the packages) steps by up to lr either way; measured worst
  8.6e-6, 0.3% of the summed rates.
* Checkpoints cross both ways: the reference's ``train_loop`` writes
  one at step 4 and the port resumes from it (the structured load is bit
  for bit; the resumed 4 steps, on the stream reseeded with ``seed +
  start`` in both packages, end within 1e-5 of the reference's own
  resume); the port writes one and the reference's ``load_checkpoint``
  restores it bit for bit, and its ``train_loop`` resumes from it.
* The index codec against the ``msgpack`` package, both ways, across
  every size class; bfloat16 checkpoints round-trip bit for bit.
* bfloat16: 4 steps of both packages keep loss and gnorm within 1e-3.
* ``tests/test_train_resume.py``'s case, run on the port; the CLI.
"""
import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint.checkpointer import _path_str
from repro.checkpoint.checkpointer import checkpoint_step as j_step
from repro.configs import get_config as j_config
from repro.configs.base import OptimizerConfig as JOpt
from repro.launch.train import make_train_step as j_make_step
from repro.launch.train import train_loop as j_train_loop
from repro.models import build_model as j_build
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import (checkpoint_step, load_checkpoint,
                                    load_train_state, save_checkpoint)
from repro_torch.checkpoint.checkpointer import pack, unpack
from repro_torch.configs import get_config as t_config
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.convert import lm_from_reference
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import adamw_init, cosine_warmup_schedule

torch.set_num_threads(1)

RTOL = 1e-5
MOMENT_RTOL = 1e-4


def flat(tree):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def stacked(model):
    return {k: (torch.stack(v) if isinstance(v, list) else v).detach()
            .numpy() for k, v in model.param_tree().items()}


def assert_tree_close(got, want, rtol=RTOL, lr_sum=0.0):
    """Each leaf within ``rtol`` of its max |x|, plus 1% of ``lr_sum``
    (the learning rates of the Adam steps taken: module doc)."""
    assert set(got) == set(want)
    for k, w in want.items():
        if not w.size:
            continue
        err = float(np.abs(np.asarray(got[k], np.float32) - w).max())
        bound = rtol * float(np.abs(w).max()) + 1e-2 * lr_sum
        assert err <= max(bound, 1e-30), (k, err, bound)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_train_step_matches_reference(arch):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    cfg = dict(lr=1e-3, warmup_steps=20, total_steps=30)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    model = lm_from_reference(tc, flat(params), device="cpu")
    j_step_fn = jax.jit(j_make_step(jm, JOpt(**cfg)))
    t_step_fn = train.make_train_step(model, OptimizerConfig(**cfg))
    jo, to = j_adamw_init(params), adamw_init(model.param_tree())
    it = TokenStream(jc.vocab_size, seed=5).batches(2, 32, device="cpu")
    lr_sum = 0.0
    for step in (18, 19, 20):
        b = next(it)
        params, jo, jmet = j_step_fn(params, jo, {k: jnp.asarray(v.numpy())
                                                  for k, v in b.items()},
                                     jnp.asarray(step, jnp.int32))
        to, tmet = t_step_fn(to, b, step)
        assert set(tmet) == set(jmet)
        for k in jmet:
            assert float(tmet[k]) == pytest.approx(float(jmet[k]),
                                                   rel=RTOL, abs=1e-9), k
        lr_sum += float(jmet["lr"])
    assert_tree_close(stacked(model), flat(params), lr_sum=lr_sum)
    assert_tree_close({k: v.numpy() for k, v in to.mu.items()},
                      flat(jo.mu), rtol=MOMENT_RTOL)
    assert_tree_close({k: v.numpy() for k, v in to.nu.items()},
                      flat(jo.nu), rtol=MOMENT_RTOL)
    assert int(to.count) == int(jo.count) == 3


def test_bfloat16_train_step_tracks_reference():
    """bf16 parameters and activations, float32 moments, per-layer remat:
    4 steps of both packages' steps from the same weights keep the loss
    and gnorm within 1e-3 relative (bf16 rounds activations at the same
    places in both, in other summation orders; measured below 1e-4 at
    d 512 over 8 steps)."""
    arch = "llama3.2-3b"
    kw = dict(dtype="bfloat16", remat="full")
    jc = dataclasses.replace(j_config(arch).reduced(), **kw)
    tc = dataclasses.replace(t_config(arch).reduced(), **kw)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    model = lm_from_reference(tc, flat(params), device="cpu")
    assert model.top["embed"].dtype == torch.bfloat16
    j_step_fn = jax.jit(j_make_step(jm, JOpt(**cfg)))
    t_step_fn = train.make_train_step(model, OptimizerConfig(**cfg))
    jo, to = j_adamw_init(params), adamw_init(model.param_tree())
    it = TokenStream(jc.vocab_size, seed=6).batches(2, 64, device="cpu")
    for step in range(4):
        b = next(it)
        params, jo, jmet = j_step_fn(params, jo, {k: jnp.asarray(v.numpy())
                                                  for k, v in b.items()},
                                     jnp.asarray(step, jnp.int32))
        to, tmet = t_step_fn(to, b, step)
        for k in ("loss", "gnorm"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]),
                                                   rel=1e-3), (step, k)
    assert all(m.dtype == torch.float32 for m in to.mu.values())


KW = dict(batch=2, seq_len=32, log_every=100)


def test_port_resumes_from_a_reference_checkpoint(capsys):
    with tempfile.TemporaryDirectory() as d:
        ref_dir, port_dir = os.path.join(d, "ref"), os.path.join(d, "port")
        j_train_loop("llama3.2-3b", steps=4, ckpt_dir=ref_dir,
                     ckpt_every=4, **KW)
        shutil.copytree(ref_dir, port_dir)
        # the structured load is bit for bit
        arrays = load_checkpoint(ref_dir)
        model = build_model(t_config("llama3.2-3b").reduced(), device="cpu")
        opt, step = load_train_state(ref_dir, model)
        assert step == 4 == checkpoint_step(ref_dir)
        for k, v in stacked(model).items():
            assert np.array_equal(v, arrays["params/" + k]), k
        assert int(opt.count) == 4 and opt.count.dtype == torch.int32
        for k in opt.mu:
            assert np.array_equal(opt.mu[k].numpy(), arrays["opt/.mu/" + k])
            assert np.array_equal(opt.nu[k].numpy(), arrays["opt/.nu/" + k])
        # both resume to step 8 on the reseeded stream: the same trajectory
        j_params, _ = j_train_loop("llama3.2-3b", steps=8, ckpt_dir=ref_dir,
                                   ckpt_every=100, **KW)
        capsys.readouterr()
        model, hist = train.train_loop("llama3.2-3b", steps=8,
                                       ckpt_dir=port_dir, ckpt_every=100,
                                       device="cpu", **KW)
        assert "resumed from step 4" in capsys.readouterr().out
        sched = cosine_warmup_schedule(OptimizerConfig(
            lr=1e-3, warmup_steps=20, total_steps=8))
        assert_tree_close(stacked(model), flat(j_params),
                          lr_sum=sum(float(sched(i)) for i in range(4, 8)))
        assert np.isfinite(hist).all()


def test_reference_restores_a_port_checkpoint(capsys):
    with tempfile.TemporaryDirectory() as d:
        model, _ = train.train_loop("llama3.2-3b", steps=4, ckpt_dir=d,
                                    ckpt_every=4, device="cpu", **KW)
        jm = j_build(j_config("llama3.2-3b").reduced())
        like = jm.init(jax.random.PRNGKey(1))
        state = j_load(d, {"params": like, "opt": j_adamw_init(like)})
        assert j_step(d) == 4
        for k, v in stacked(model).items():
            assert np.array_equal(flat(state["params"])[k], v), k
        assert int(state["opt"].count) == 4
        capsys.readouterr()
        j_params, _ = j_train_loop("llama3.2-3b", steps=6, ckpt_dir=d,
                                   ckpt_every=100, **KW)
        assert "resumed from step 4" in capsys.readouterr().out
        assert all(np.isfinite(x).all() for x in flat(j_params).values())


def test_bfloat16_checkpoint_round_trips_bit_for_bit():
    cfg = dataclasses.replace(t_config("deepseek-v3-671b").reduced(),
                              dtype="bfloat16")
    model = build_model(cfg, device="cpu").init(3)
    opt = adamw_init(model.param_tree())
    for m in opt.mu.values():
        m.normal_()
    opt = opt._replace(count=torch.tensor(7, dtype=torch.int32))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, {"params": model.param_tree(), "opt": opt},
                        step=7)
        with open(os.path.join(d, "index.msgpack"), "rb") as f:
            index = msgpack.unpackb(f.read())
        assert index["step"] == 7
        dtypes = {leaf["path"]: leaf["dtype"] for leaf in index["leaves"]}
        assert dtypes["params/embed"] == "bfloat16"
        assert dtypes["opt/.mu/embed"] == "float32"
        assert dtypes["opt/.count"] == "int32"
        fresh = build_model(cfg, device="cpu")
        opt2, step = load_train_state(d, fresh)
    assert step == 7 and int(opt2.count) == 7
    for (k, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), k
    for k in opt.mu:
        assert torch.equal(opt.mu[k], opt2.mu[k])


CODEC_CASES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, "", "a" * 31, "a" * 32, "é" * 200, "b" * 256,
    "c" * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {f"k{i}": i for i in range(70000)},
    {"step": 4, "leaves": [{"path": "params/layers/ln1", "shape": [2, 128],
                            "dtype": "float32", "pspec": ""}]},
]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=[f"case{i}" for i in range(len(CODEC_CASES))])
def test_index_codec_matches_msgpack(obj):
    ref = msgpack.packb(obj)
    assert pack(obj) == ref
    assert unpack(ref) == obj
    assert msgpack.unpackb(pack(obj), strict_map_key=False) == obj


def test_index_codec_refuses_what_it_does_not_speak():
    for obj in (1.5, None, True, b"x"):
        with pytest.raises(TypeError):
            pack(obj)
    with pytest.raises(ValueError, match="not supported"):
        unpack(msgpack.packb(1.5))
    with pytest.raises(ValueError, match="trailing"):
        unpack(msgpack.packb(1) + b"\x00")


def test_resume_matches_uninterrupted():
    """tests/test_train_resume.py on the port."""
    with tempfile.TemporaryDirectory() as d:
        p_full, _ = train.train_loop("llama3.2-3b", steps=8, device="cpu",
                                     **KW)
        train.train_loop("llama3.2-3b", steps=4, ckpt_dir=d, ckpt_every=4,
                         device="cpu", **KW)
        p_resumed, _ = train.train_loop("llama3.2-3b", steps=8, ckpt_dir=d,
                                        ckpt_every=100, device="cpu", **KW)
        full, resumed = stacked(p_full), stacked(p_resumed)
        assert all(np.isfinite(v).all() for v in resumed.values())
        diff = sum(float(np.abs(full[k] - resumed[k]).sum()) for k in full)
        assert diff > 0          # different stream seed after resume


def test_train_cli_on_the_cpu(capsys):
    model, hist = train.main(["--arch", "whisper-medium", "--steps", "2",
                              "--batch", "1", "--seq-len", "16",
                              "--device", "cpu"])
    assert model.device.type == "cpu" and len(hist) == 1
    assert np.isfinite(hist).all()
    assert "step     1 loss" in capsys.readouterr().out
