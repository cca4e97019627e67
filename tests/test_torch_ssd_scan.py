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
where both run the same algorithm in another summation order. The
staged version's hi + lo emulation is held to the bfloat16 bound."""
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


@pytest.mark.parametrize("shape", SWEEP_SHAPES,
                         ids=[str(s) for s in SWEEP_SHAPES])
def test_staged_matches_the_pallas_kernel_and_the_oracle(shape):
    """float32: the three plain stages in a row against the Pallas kernel
    (interpret mode) and the oracle; bf16 inputs with the hi + lo
    emulation against the oracle."""
    B, S, H, P, N, chunk = shape
    arrays = inputs(B, S, H, P, N, "float32", seed=S + H + 1)
    yk, sk = j_pallas(*as_jax(arrays, "float32"), chunk=chunk,
                      interpret=True)
    args = as_torch(arrays, "float32")
    y, st = ss.ssd_staged(*args, chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(st.shape) == (B, H, P, N)
    yo, so = ss.ssd_reference(*args)
    for want_y, want_st in ((yk, sk), (yo, so)):
        assert rel(y, want_y) < SWEEP_TOL["float32"]
        assert rel(st, want_st) < SWEEP_TOL["float32"]
    bf = as_torch(inputs(B, S, H, P, N, "bfloat16", seed=S + H + 1),
                  "bfloat16")
    y, st = ss.ssd_staged(*bf, chunk, split=True)
    assert y.dtype == st.dtype == torch.bfloat16
    yo, so = ss.ssd_reference(*bf)
    assert rel(y, yo) < SWEEP_TOL["bfloat16"]
    assert rel(st, so) < SWEEP_TOL["bfloat16"]


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 100, 257])
def test_staged_pads_a_ragged_last_chunk(S, chunk):
    """Any S: the last chunk is padded with x = B = C = 0 and dt = 0 and no
    row past S comes back. float32 against the oracle, and the hi + lo
    emulation (bf16 inputs) within the bfloat16 bound."""
    arrays = inputs(2, S, 3, 64, 64, seed=S + chunk)
    args = as_torch(arrays, "float32")
    y, st = ss.ssd_staged(*args, chunk)
    yo, so = ss.ssd_reference(*args)
    assert tuple(y.shape) == (2, S, 3, 64)
    assert rel(y, yo) < SWEEP_TOL["float32"]
    assert rel(st, so) < SWEEP_TOL["float32"]
    bf = as_torch(inputs(2, S, 3, 64, 64, "bfloat16", seed=S + chunk),
                  "bfloat16")
    y, st = ss.ssd_staged(*bf, chunk, split=True)
    yo, so = ss.ssd_reference(*bf)
    assert rel(y, yo) < SWEEP_TOL["bfloat16"]
    assert rel(st, so) < SWEEP_TOL["bfloat16"]


def test_stages_hand_on_what_the_kernels_hand_on():
    """Kernel 1's plain stage gives the chunks' cumulative log decay
    (B,nc,H,Q), constant over the padding, and their own states; kernel
    2's gives 0 entering the first chunk and the final state; on the CPU
    ``chunk_states`` is the plain stage with the hi + lo split."""
    B, S, H, P, N, Q = 2, 150, 3, 64, 64, 64
    x, dt, A, Bm, Cm = as_torch(inputs(B, S, H, P, N, "bfloat16", seed=9),
                                "bfloat16")
    cs, states = ss.chunk_states_ref(x, dt, A, Bm, Q)
    assert tuple(cs.shape) == (B, 3, H, Q)
    assert tuple(states.shape) == (B, 3, H, P, N)
    ragged = cs[:, -1, :, S - 2 * Q - 1:]                  # rows 21.. of 64
    assert torch.equal(ragged, ragged[..., :1].expand_as(ragged))
    assert bool((cs[..., 1:] <= cs[..., :-1]).all())     # dt A <= 0
    h_prev, h = ss.state_pass_ref(cs, states)
    assert not h_prev[:, 0].any()
    assert torch.allclose(h_prev[:, 1], states[:, 0])
    _, so = ss.ssd_reference(x, dt, A, Bm, Cm)
    assert rel(h, so) < SWEEP_TOL["bfloat16"]
    before = ss.launches
    cs_s, states_s = ss.chunk_states(x, dt, A, Bm, Cm, chunk=Q)
    cs_r, states_r = ss.chunk_states_ref(x, dt, A, Bm, Q, split=True)
    assert torch.equal(cs_s, cs_r) and torch.equal(states_s, states_r)
    assert ss.launches == before


def _views(B, S, H, N, extra=0, dtype=torch.bfloat16):
    """x (B,S,H,64), B and C (B,S,N) as views of one conv output of width
    64 H + 2 N + extra, the model's layout."""
    xbc = torch.zeros((B, S, 64 * H + 2 * N + extra), dtype=dtype)
    return (xbc[..., :64 * H].unflatten(-1, (H, 64)),
            xbc[..., 64 * H:64 * H + N], xbc[..., 64 * H + N:64 * H + 2 * N])


def test_tensor_core_route_choices():
    """mamba2-1.3b's prefill (P 64, N 128, chunk 256, views of the conv
    output with row stride 4352) and contiguous bf16 take the tensor
    cores; float32, P 32 or 128, N 16 or 32, a chunk of 32 or past 256,
    misaligned rows and a stride of 0 take the CUDA cores."""
    route = ss.tensor_core_route
    x, Bm, Cm = _views(2, 300, 64, 128)
    assert x.stride(1) == 4352 and route(x, Bm, Cm, 256)
    for chunk in (64, 128, 192):
        assert route(x, Bm, Cm, chunk)
    for chunk in (32, 100, 320, 512):
        assert not route(x, Bm, Cm, chunk)
    xc, Bc, Cc = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    assert route(xc, Bc, Cc, 256)
    assert route(*_views(1, 5, 2, 64), 64)
    assert not route(*_views(2, 300, 4, 128, dtype=torch.float32), 256)
    bf = torch.bfloat16
    for P in (32, 128):
        assert not route(torch.zeros((1, 8, 2, P), dtype=bf), Bc[:1, :8],
                         Cc[:1, :8], 256)
    for N in (16, 32):
        assert not route(*_views(1, 8, 2, N), 256)
    # row stride 64 H + 2 N + 4: not a multiple of 8 elements
    assert not route(*_views(1, 8, 2, 128, extra=4), 256)
    # every row starts one element (2 bytes) past a 16-byte boundary
    wide = torch.zeros((1, 8, 2, 72), dtype=bf)
    assert not route(wide[..., 1:65], Bc[:1, :8], Cc[:1, :8], 256)
    # one head's x broadcast to 4 heads: head stride 0
    one = torch.zeros((1, 8, 1, 64), dtype=bf).expand(1, 8, 4, 64)
    assert one.stride(2) == 0 and not route(one, Bc[:1, :8], Cc[:1, :8], 64)
    assert route(one.contiguous(), Bc[:1, :8], Cc[:1, :8], 64)
