"""The port's RG-LRU scan (``repro_torch.kernels.rglru_scan``) against the
JAX package on the same numpy inputs: the plain version ``rglru_scan_ref``
against JAX ``rglru_scan_ref`` (the reference's XLA path) and against the
Pallas kernel in interpret mode at the JAX sweep's shapes
(``tests/test_kernels.py:83-87``); the port's sequential oracle against
``ref.rglru_reference``; lengths that are not powers of two; and the
wrapper's choice by device.

Tolerances (absolute, on values of order 1): the JAX sweep's 1e-4
(float32) and 5e-2 (bfloat16) where the two sides combine in another
order (log-depth vs sequential, or the Pallas kernel's chunked combine);
2e-6 (float32) where both run the same algorithm."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_reference as j_reference
from repro.kernels.rglru_scan import rglru_scan as j_pallas
from repro.models.rglru import rglru_scan_ref as j_ref_scan
from repro_torch.kernels import rglru_scan as rg

torch.set_num_threads(1)

SWEEP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SAME_ALGO_TOL = 2e-6
SWEEP_SHAPES = [(2, 256, 256, 64, 128), (1, 128, 128, 128, 128),
                (3, 512, 384, 128, 128), (1, 64, 512, 32, 256)]


def inputs(B, S, W, dtype="float32", seed=0):
    """The sweep's distributions: a = sigmoid(normal), b = normal / 2,
    rounded to ``dtype`` (as numpy float32 holding the rounded values)."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, W))))).astype(
        np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        a, b = (np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                for v in (a, b))
    return a, b


def diff(got, want):
    return float(np.abs(np.asarray(got.float()) - np.asarray(
        jnp.asarray(want, jnp.float32))).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES,
                         ids=[str(s) for s in SWEEP_SHAPES])
def test_plain_matches_the_pallas_kernel_and_the_oracle(shape, dtype):
    B, S, W, chunk, bw = shape
    a, b = inputs(B, S, W, dtype, seed=S + W)
    ja, jb = (jnp.asarray(v, jnp.dtype(dtype)) for v in (a, b))
    ta, tb = (torch.from_numpy(v).to(getattr(torch, dtype)) for v in (a, b))
    hk = j_pallas(ja, jb, chunk=chunk, block_w=bw, interpret=True)
    h = rg.rglru_scan_ref(ta, tb)
    assert h.dtype == ta.dtype and h.shape == ta.shape
    assert diff(h, hk) < SWEEP_TOL[dtype]
    ho = rg.rglru_reference(ta, tb)
    assert ho.dtype == torch.float32
    assert diff(h, np.asarray(ho)) < SWEEP_TOL[dtype]
    assert diff(ho, j_reference(ja, jb)) < SAME_ALGO_TOL


@pytest.mark.parametrize("S", [1, 2, 77, 300])
def test_plain_matches_the_reference_xla_path(S):
    a, b = inputs(2, S, 40, seed=S)
    want = j_ref_scan(jnp.asarray(a), jnp.asarray(b))
    got = rg.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert diff(got, want) < SAME_ALGO_TOL * 5
    assert diff(got, j_reference(jnp.asarray(a), jnp.asarray(b))) \
        < SWEEP_TOL["float32"]


def test_oracle_takes_an_initial_state():
    a, b = inputs(2, 30, 16, seed=4)
    h0 = np.random.default_rng(0).normal(size=(2, 16)).astype(np.float32)
    want = j_reference(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = rg.rglru_reference(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(h0))
    assert diff(got, want) < SAME_ALGO_TOL


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    a, b = (torch.from_numpy(v) for v in inputs(2, 50, 24, seed=2))
    before = rg.launches
    assert torch.equal(rg.rglru_scan(a, b), rg.rglru_scan_ref(a, b))
    assert rg.launches == before            # only a kernel launch counts
    with pytest.raises(ValueError, match="no implementation"):
        rg.rglru_scan(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        rg.rglru_scan(a, b[:, :3])
    with pytest.raises(ValueError, match="dtype"):
        rg.rglru_scan(a, b.double())
    with pytest.raises(ValueError, match="float32"):
        rg.rglru_scan(a.bfloat16(), b.bfloat16())   # the gates give float32


def test_strided_inputs_read_in_place():
    """A (B,S,W) view with a batch and time stride of its own (a slice of
    a wider time axis) gives what its contiguous copy gives."""
    a, b = (torch.from_numpy(v) for v in inputs(2, 60, 8, seed=3))
    av, bv = a[:, 10:50], b[:, 10:50]
    assert torch.equal(rg.rglru_scan(av, bv),
                       rg.rglru_scan(av.contiguous(), bv.contiguous()))
