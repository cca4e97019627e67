"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
package on the same numpy inputs: the plain version ``ssd_chunked``
against JAX ``ssd_chunked`` (the reference's XLA path) and against the
Pallas kernel in interpret mode at the JAX sweep's shapes
(``tests/test_kernels.py:56-60``); the port's sequential oracle against
``ref.ssd_reference``; ragged lengths (the chunk does not divide S)
against the oracle; and the wrapper's choice by device.

Tolerances, relative to the largest |value| of y and of the state: the
JAX sweep's 3e-5 (float32) and 5e-2 (bfloat16) where the two sides run
different algorithms (chunked vs sequential, or the Pallas kernel's
float32 intermediates vs ``ssd_chunked``'s rounded ones); 1e-5 (float32)
where both run the same algorithm in another summation order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_reference as j_reference
from repro.kernels.ssd_scan import ssd_scan as j_pallas
from repro.models.ssd import ssd_chunked as j_chunked
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(1)

SWEEP_TOL = {"float32": 3e-5, "bfloat16": 5e-2}
SAME_ALGO_TOL = 1e-5
SWEEP_SHAPES = [(2, 256, 4, 64, 32, 64), (1, 128, 2, 32, 64, 128),
                (2, 512, 8, 64, 128, 128), (1, 256, 1, 128, 16, 32)]


def inputs(B, S, H, P, N, dtype="float32", seed=0):
    """The sweep's distributions (x normal, dt = softplus(normal),
    A = -exp(normal / 2), B and C normal / 2), drawn with numpy; x, B, C
    rounded to ``dtype`` (as numpy float32 holding the rounded values)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=H) * 0.5)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        x, Bm, Cm = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (x, Bm, Cm))
    return x, dt, A, Bm, Cm


def as_jax(arrays, dtype):
    x, dt, A, Bm, Cm = arrays
    d = jnp.dtype(dtype)
    return (jnp.asarray(x, d), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, d), jnp.asarray(Cm, d))


def as_torch(arrays, dtype):
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrays)
    d = getattr(torch, dtype)
    return x.to(d), dt, A, Bm.to(d), Cm.to(d)


def rel(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want.float() if torch.is_tensor(want) else
                      jnp.asarray(want, jnp.float32), np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP_SHAPES,
                         ids=[str(s) for s in SWEEP_SHAPES])
def test_plain_matches_the_pallas_kernel_and_the_oracle(shape, dtype):
    B, S, H, P, N, chunk = shape
    arrays = inputs(B, S, H, P, N, dtype, seed=S + H)
    yk, sk = j_pallas(*as_jax(arrays, dtype), chunk=chunk, interpret=True)
    y, st = ss.ssd_chunked(*as_torch(arrays, dtype), chunk)
    assert y.dtype == st.dtype == getattr(torch, dtype)
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, P, N)
    assert rel(y, yk) < SWEEP_TOL[dtype]
    assert rel(st, sk) < SWEEP_TOL[dtype]
    yo, so = ss.ssd_reference(*as_torch(arrays, dtype))
    assert rel(y, yo) < SWEEP_TOL[dtype]
    assert rel(st, so) < SWEEP_TOL[dtype]


@pytest.mark.parametrize("S,chunk", [(64, 32), (100, 32), (37, 256)],
                         ids=["divides", "ragged", "shorter"])
def test_plain_matches_the_reference_xla_path(S, chunk):
    """Same algorithm both sides (a chunk that does not divide S becomes
    one chunk of S steps in both), float32."""
    arrays = inputs(2, S, 3, 16, 8, seed=S)
    yj, sj = j_chunked(*as_jax(arrays, "float32"), chunk)
    y, st = ss.ssd_chunked(*as_torch(arrays, "float32"), chunk)
    assert rel(y, yj) < SAME_ALGO_TOL
    assert rel(st, sj) < SAME_ALGO_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_the_reference_oracle(dtype):
    arrays = inputs(2, 50, 3, 8, 16, dtype, seed=7)
    yj, sj = j_reference(*as_jax(arrays, dtype))
    y, st = ss.ssd_reference(*as_torch(arrays, dtype))
    tol = SAME_ALGO_TOL if dtype == "float32" else 1e-2   # one bf16 ulp
    assert rel(y, yj) < tol
    assert rel(st, sj) < tol


@pytest.mark.parametrize("S", [1, 63, 100, 257])
def test_ragged_lengths_match_the_oracle(S):
    """The model's batcher gives lengths the chunk does not divide."""
    arrays = inputs(1, S, 2, 16, 16, seed=S)
    y, st = ss.ssd_scan(*as_torch(arrays, "float32"), chunk=64)
    yo, so = ss.ssd_reference(*as_torch(arrays, "float32"))
    assert rel(y, yo) < SWEEP_TOL["float32"]
    assert rel(st, so) < SWEEP_TOL["float32"]


def test_masked_decay_never_makes_nan():
    """Large steps (dt A down to about -50 per step) make exp(cs_i - cs_j)
    overflow above the diagonal; the plain version selects before it
    multiplies, so y stays finite and equal to the oracle."""
    x, dt, A, Bm, Cm = inputs(1, 64, 2, 8, 8, seed=3)
    dt = dt * 20.0
    args = as_torch((x, dt, A, Bm, Cm), "float32")
    y, st = ss.ssd_chunked(*args, 64)
    yo, so = ss.ssd_reference(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert rel(y, yo) < SWEEP_TOL["float32"]


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    arrays = inputs(2, 96, 3, 16, 8, seed=1)
    args = as_torch(arrays, "float32")
    before = ss.launches
    y, st = ss.ssd_scan(*args, chunk=32)
    yp, sp = ss.ssd_chunked(*args, 32)
    assert torch.equal(y, yp) and torch.equal(st, sp)
    assert ss.launches == before            # only a kernel launch counts
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no implementation"):
        ss.ssd_scan(*meta, chunk=32)
    with pytest.raises(ValueError, match="disagree"):
        ss.ssd_scan(args[0], args[1][:, :5], *args[2:], chunk=32)
    with pytest.raises(TypeError, match="dtype"):
        ss.ssd_scan(args[0], args[1], args[2], args[3].double(), args[4],
                    chunk=32)


def test_strided_views_read_in_place():
    """The model hands x, B and C over as views of one activation tensor
    (the conv output); the result equals that of contiguous copies."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 40, 2, 8, 4
    xbc = torch.from_numpy(rng.normal(size=(B, S, H * P + 2 * N))
                           .astype(np.float32))
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(B, S, H)).astype(np.float32)))
    A = -torch.ones(H)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    y, st = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    yc, sc = ss.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                         Cm.contiguous(), chunk=16)
    assert torch.equal(y, yc) and torch.equal(st, sc)
