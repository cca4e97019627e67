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


# Layouts of the kernel's decomposition (chunks per window, segments per
# chunk, steps per chunk): launch_plan's at the main path (8 x 256 steps,
# 8 segments), channel groups of 64 (4 segments), one-block clusters, and
# short chunks that make the sweep's S take several windows.
CHUNKED_LAYOUTS = [dict(chunks=8, segs=8, chunk=256),
                   dict(chunks=8, segs=4, chunk=64),
                   dict(chunks=3, segs=8, chunk=32),
                   dict(chunks=1, segs=8, chunk=8),
                   dict(chunks=5, segs=4, chunk=136)]
CHUNKED_TOL = 1e-5


@pytest.mark.parametrize("layout", CHUNKED_LAYOUTS,
                         ids=[str(tuple(d.values())) for d in CHUNKED_LAYOUTS])
@pytest.mark.parametrize("shape", SWEEP_SHAPES,
                         ids=[str(s) for s in SWEEP_SHAPES])
def test_chunked_decomposition_matches_the_pallas_kernel_and_the_oracle(
        shape, layout):
    """``rglru_chunked_ref`` (the kernel's order of composition) against
    the Pallas kernel in interpret mode and both oracles, at the sweep's
    shapes, within 1e-5: every order of composition gives the recurrence
    to roundoff."""
    B, S, W, chunk, bw = shape
    a, b = inputs(B, S, W, seed=S + W)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    h = rg.rglru_chunked_ref(torch.from_numpy(a), torch.from_numpy(b),
                             **layout)
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    assert diff(h, j_pallas(ja, jb, chunk=chunk, block_w=bw,
                            interpret=True)) < CHUNKED_TOL
    assert diff(h, j_reference(ja, jb)) < CHUNKED_TOL
    assert diff(h, np.asarray(rg.rglru_reference(
        torch.from_numpy(a), torch.from_numpy(b)))) < CHUNKED_TOL


@pytest.mark.parametrize("S", [1, 7, 77, 300, 1000, 2100])
def test_chunked_decomposition_takes_ragged_and_multi_window_lengths(S):
    """S of one step, shorter than a segment, not a multiple of the chunk,
    and longer than a window (launch_plan's layout for S and a short one
    that takes many windows), against the JAX oracle and XLA path."""
    a, b = inputs(2, S, 24, seed=S)
    want = j_reference(jnp.asarray(a), jnp.asarray(b))
    plan = rg.launch_plan(2, S, 24)
    for layout in (plan.chunked_ref_args(),
                   dict(chunks=3, segs=8, chunk=16)):
        span = layout["chunks"] * layout["chunk"]
        got = rg.rglru_chunked_ref(torch.from_numpy(a), torch.from_numpy(b),
                                   **layout)
        assert diff(got, want) < CHUNKED_TOL, (layout, -(-S // span))
        assert diff(got, j_ref_scan(jnp.asarray(a), jnp.asarray(b))) \
            < CHUNKED_TOL
    with pytest.raises(ValueError, match="multiple"):
        rg.rglru_chunked_ref(torch.from_numpy(a), torch.from_numpy(b),
                             chunks=2, segs=8, chunk=12)


MAIN_PATH = [(4, 2048, 4096)] + [(1, n, 4096) for n in
                                 (2048, 2100, 2300, 2500, 2650, 2800, 2900,
                                  3000)]


@pytest.mark.parametrize("S", [1, 2, 9, 33, 64, 77, 256, 300, 2048, 2100,
                               3000, 20000])
def test_launch_plan_covers_any_length_within_the_kernels_limits(S):
    plan = rg.launch_plan(1, S, 4096)
    assert plan.group in rg.GROUPS
    assert 1 <= plan.cluster <= rg.MAX_CLUSTER
    assert plan.chunk % rg.CHUNK_STEP == 0
    assert rg.CHUNK_STEP <= plan.chunk <= rg.MAX_CHUNK
    assert plan.chunk * plan.group <= rg.MAX_TILE
    n = plan.windows(S)
    span = plan.cluster * plan.chunk
    assert (n - 1) * span < S <= n * span
    # every block of the first window holds a step of S
    assert (plan.cluster - 1) * plan.chunk < S
    args = plan.chunked_ref_args()
    assert args["chunk"] % args["segs"] == 0
    assert args["segs"] * plan.group == rg.THREADS


def test_launch_plan_at_the_main_path():
    """The layouts timed best on the card (PERF.md): recurrentgemma-9b's
    prefill (the headline) in one-block clusters of 64 channels walking 32
    windows of 64 steps; its batcher's B-1 prompts in two-block clusters of
    32 channels and chunks of at most 128 steps; every launch about two
    blocks per SM (256), each cluster walking its windows."""
    assert rg.launch_plan(4, 2048, 4096) == rg.LaunchPlan(64, 1, 64)
    for B, S, W in MAIN_PATH[1:]:
        plan = rg.launch_plan(B, S, W)
        assert plan.group == 32 and plan.cluster == 2
        assert plan.chunk <= 128 and plan.windows(S) >= 8
    for B, S, W in MAIN_PATH:
        plan = rg.launch_plan(B, S, W)
        assert plan.cluster * (-(-W // plan.group)) * B == rg.BLOCKS
        assert plan.chunk * plan.group <= rg.TILE


def test_tma_route_takes_aligned_nested_strides_only():
    a = torch.zeros(2, 50, 64)
    h = torch.empty_like(a)
    assert rg.tma_route(a, a, h)
    assert rg.tma_route(a[:, 3:], a[:, 3:], h[:, 3:])      # time offset
    assert rg.tma_route(a[:1, :1], a[:1, :1], h[:1, :1])   # extent-1 axes
    assert not rg.tma_route(a[..., 1:61], a[..., 1:61], h[..., 1:61])
    w77 = torch.zeros(2, 50, 77)
    assert not rg.tma_route(w77, w77, w77)                 # W % 4
    assert not rg.tma_route(a, a.transpose(0, 1).contiguous().transpose(
        0, 1), h)                                           # batch inside
    wide = torch.zeros(1, 50, 64).expand(2, 50, 64)
    assert not rg.tma_route(wide, a, h)                     # batch stride 0
