"""The port's training loss (``Model.loss_fn``) and its gradients against
``jax.value_and_grad(Model.loss_fn)`` of the JAX package, on the same
weights (JAX ``Model.init`` through ``lm_from_reference``) and the same
batch, for every family: dense (llama3.2-3b), MLA (minicpm3-4b), MoE with
its aux loss (olmoe-1b-7b), MoE + MLA + MTP (deepseek-v3-671b), ssm
(mamba2-1.3b), hybrid (recurrentgemma-9b at ``num_layers=5``, one period
with attention and two tail layers, as the serve tests), vlm
(llava-next-mistral-7b, frontend embeddings) and audio (whisper-medium,
encoder frames); reduced configs in float32. The port runs with
``remat`` "none" and "full" (per-layer ``torch.utils.checkpoint``); the
reference's reduced configs do not remat, and remat changes no value.

Tolerance: the loss and each metric within 1e-5 relative; each gradient
leaf within 1e-4 of the reference leaf's max |g| plus 1e-9 absolute. The
absolute floor is for leaves the loss does not depend on in exact
arithmetic (whisper's key biases: a bias added to every key shifts each
query's scores by one constant, which softmax ignores), whose gradients
are rounding noise of about 1e-10 in both packages; measured worst
relative gap elsewhere 3.1e-6 (mamba2's ``A_log``).

Then ``loss_fn`` under ``torch.func.functional_call`` with a stacked
{path: tensor} tree and remat on, the module's own parameters
overwritten with garbage: the loss and the gradients w.r.t. the stacked
tensors equal the module path's (the recompute in the backward pass
reads the tensors of the forward pass)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.checkpoint.checkpointer import _path_str
from repro.configs import get_config as j_config
from repro.models import build_model as j_build
from repro_torch.configs import get_config as t_config
from repro_torch.core.convert import lm_from_reference
from repro_torch.models.model import MTP_LOSS_COEF

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-9
B, S = 2, 64

FAMILIES = {"dense": ("llama3.2-3b", None), "mla": ("minicpm3-4b", None),
            "moe": ("olmoe-1b-7b", None),
            "moe_mla_mtp": ("deepseek-v3-671b", None),
            "ssm": ("mamba2-1.3b", None),
            "hybrid": ("recurrentgemma-9b", 5),
            "vlm": ("llava-next-mistral-7b", None),
            "audio": ("whisper-medium", None)}


def flat(tree):
    return {_path_str(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def configs(arch, num_layers):
    jc, tc = j_config(arch).reduced(), t_config(arch).reduced()
    if num_layers:
        jc = dataclasses.replace(jc, num_layers=num_layers)
        tc = dataclasses.replace(tc, num_layers=num_layers)
    return jc, tc


def make_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = rng.normal(
            0, 1, (B, cfg.frontend.num_tokens, cfg.d_model)).astype(
                np.float32)
    if cfg.family == "audio":
        batch["encoder_embeds"] = rng.normal(
            0, 1, (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference(family):
    """(weights, batch, loss, metrics, gradients) of the JAX package."""
    arch, nl = FAMILIES[family]
    jc, _ = configs(arch, nl)
    jm = j_build(jc)
    params = jm.init(jax.random.PRNGKey(0))
    batch = make_batch(jc)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(params, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    return (flat(params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, flat(grads))


def stacked_grads(model):
    return {path: (torch.stack([t.grad for t in leaf])
                   if isinstance(leaf, list) else leaf.grad)
            for path, leaf in model.param_tree().items()}


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        err = float(np.abs(g.detach().numpy() - w).max())
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert err <= bound, (path, err, bound)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradients_match_reference(family, remat):
    arrays, batch, j_loss, j_metrics, j_grads = reference(family)
    arch, nl = FAMILIES[family]
    _, tc = configs(arch, nl)
    model = lm_from_reference(dataclasses.replace(tc, remat=remat), arrays,
                              device="cpu")
    model.requires_grad_(True)
    total, metrics = model.loss_fn({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    total.backward()
    assert set(metrics) == set(j_metrics)
    assert float(total.detach()) == pytest.approx(j_loss, rel=LOSS_RTOL)
    for k, v in j_metrics.items():
        assert float(metrics[k]) == pytest.approx(v, rel=LOSS_RTOL,
                                                  abs=1e-9), k
        assert not metrics[k].requires_grad
    if family.startswith("moe"):
        assert j_metrics["aux"] > 0
    if family == "moe_mla_mtp":
        assert float(metrics["loss"]) == pytest.approx(
            float(metrics["ce"]) + MTP_LOSS_COEF * float(metrics["mtp"])
            + float(metrics["aux"]), rel=1e-6)
    assert_grads_close(stacked_grads(model), j_grads)


@pytest.mark.parametrize("family", ["dense", "moe_mla_mtp", "hybrid",
                                    "audio"])
def test_loss_under_functional_call_with_remat(family):
    arrays, batch, j_loss, _, j_grads = reference(family)
    arch, nl = FAMILIES[family]
    _, tc = configs(arch, nl)
    model = lm_from_reference(dataclasses.replace(tc, remat="full"), arrays,
                              device="cpu")
    tree = {k: torch.tensor(v, requires_grad=True)
            for k, v in arrays.items()}
    with torch.no_grad():                # the module's own: garbage
        for p in model.parameters():
            p.fill_(7.0)
    total, metrics = functional_call(model, model.named_from_tree(tree),
                                     ({k: torch.from_numpy(v)
                                       for k, v in batch.items()},))
    total.backward()
    assert float(total.detach()) == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert_grads_close({k: t.grad if t.grad is not None
                        else torch.zeros_like(t) for k, t in tree.items()},
                       j_grads)
