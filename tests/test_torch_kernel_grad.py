"""The port's kernels and gradients on the CPU: ``forbid_grad`` (the guard
every CUDA kernel wrapper calls before it launches) raises exactly when
grad mode is on and an input requires grad, and every wrapper's CPU branch
(plain torch) still differentiates. The card side, where each CUDA entry
point must raise, is in ``tests/test_torch_cuda.py``.

Tolerances: the RG-LRU gradient within 1e-5 (absolute, values of order 1)
of the sequential oracle's and of ``jax.grad`` through the reference's XLA
path (another order of composition, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (flash_inputs, kernel_inputs, rglru_inputs,
                        ssd_inputs, step_inputs)
from repro.models.rglru import rglru_scan_ref as j_ref_scan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import loo_trials as loo
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels._grad import forbid_grad

torch.set_num_threads(1)

GRAD_TOL = 1e-5


def leaves(tensors):
    """Fresh leaves that require grad (floating tensors only)."""
    return [t.detach().clone().requires_grad_(t.is_floating_point())
            for t in tensors]


def test_forbid_grad_raises_only_for_grad_inputs_under_grad_mode():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="^some_kernel: .*no backward"):
        forbid_grad("some_kernel", y, x)
    with torch.no_grad():
        forbid_grad("some_kernel", y, x)
    with torch.inference_mode():
        forbid_grad("some_kernel", torch.ones(3))
    forbid_grad("some_kernel", y, x.detach(), None, 3, "a")
    forbid_grad("some_kernel")


def test_rglru_cpu_gradient_matches_the_oracle_and_jax():
    """h.sum().backward() through the CPU branch fills a.grad and b.grad,
    equal to the sequential oracle's gradient and to ``jax.grad`` through
    the reference's XLA path, within 1e-5."""
    rng = np.random.default_rng(0)
    a_np = (1.0 / (1.0 + np.exp(-rng.normal(size=(2, 77, 24))))).astype(
        np.float32)
    b_np = (rng.normal(size=(2, 77, 24)) * 0.5).astype(np.float32)
    a, b = leaves([torch.from_numpy(a_np), torch.from_numpy(b_np)])
    rg.rglru_scan(a, b).sum().backward()
    ao, bo = leaves([torch.from_numpy(a_np), torch.from_numpy(b_np)])
    rg.rglru_reference(ao, bo).sum().backward()
    for got, want in ((a.grad, ao.grad), (b.grad, bo.grad)):
        assert got is not None and got.shape == (2, 77, 24)
        assert float((got - want).abs().max()) < GRAD_TOL
    ja, jb = jax.grad(lambda x, y: j_ref_scan(x, y).sum(), argnums=(0, 1))(
        jnp.asarray(a_np), jnp.asarray(b_np))
    assert float(np.abs(a.grad.numpy() - np.asarray(ja)).max()) < GRAD_TOL
    assert float(np.abs(b.grad.numpy() - np.asarray(jb)).max()) < GRAD_TOL


def _flash(*t):
    return fa.flash_attention(*(x.transpose(1, 2) for x in t))


def _cpu_cases():
    """(name, call, inputs) of each kernel wrapper's CPU branch."""
    flash = flash_inputs((1, 4, 2, 40, 40, 32, True, 0, 0, "float32"), 0,
                         "cpu")
    ssd = ssd_inputs((1, 96, 2, 16, 8, 32, "float32"), 0, "cpu")
    tc = ssd_inputs((1, 64, 1, 64, 64, 64, "float32"), 1, "cpu")
    return {
        "flash_attention": (_flash, flash),
        "flash_attention_bshd": (fa.flash_attention_bshd, flash),
        "ssd_scan": (lambda *t: ss.ssd_scan(*t, chunk=32), ssd),
        # the chunk states do not read C: it is passed as a constant
        "chunk_states": (lambda x, dt, A, Bm: ss.chunk_states(
            x, dt, A, Bm, tc[4], chunk=64), tc[:4]),
        "rglru_scan": (rg.rglru_scan, rglru_inputs((2, 50, 16), 0, "cpu")),
        "loo_trials": (loo.loo_trials,
                       kernel_inputs(2, 40, 23, 16, 0, "cpu")),
        "loo_trials_step": (loo.loo_trials_step,
                            step_inputs(2, 40, 23, 16, 0, "cpu"))}


CPU_ENTRY_POINTS = ["flash_attention", "flash_attention_bshd", "ssd_scan",
                    "chunk_states", "rglru_scan", "loo_trials",
                    "loo_trials_step"]


@pytest.mark.parametrize("entry", CPU_ENTRY_POINTS)
def test_every_cpu_branch_differentiates(entry):
    """The plain branch of each wrapper gives every floating input that
    requires grad a finite gradient (``loss_fn`` will train through them),
    and counts no launch."""
    call, args = _cpu_cases()[entry]
    args = leaves(args)
    launches = (fa.launches, ss.launches, rg.launches, loo.launches)
    out = call(*args)
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.float().sum() for o in outs).backward()
    assert (fa.launches, ss.launches, rg.launches, loo.launches) == launches
    for t in args:
        if t.requires_grad:
            assert t.grad is not None, entry
            assert bool(torch.isfinite(t.grad).all()), entry
