"""The port's flash attention (plain PyTorch version, on the CPU) against
the JAX package's Pallas kernel in interpret mode and its
``mha_reference`` oracle, over the cases of the reference's own sweep
(``tests/test_kernels.py``: GQA, MHA with a longer KV, MQA with a sliding
window, bidirectional with ragged blocks, a small head_dim, and the
``q_offset`` decode case), in both layouts, and the wrappers' contracts.
The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (card only) and by chip_smoke.py.

Tolerances: the reference sweep's own, 2e-5 (max abs) in float32 and
2e-2 in bfloat16. Inputs are drawn with numpy and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import flash_attention as t_fa

# The tier-1 run puts 6 pytest workers on the CPU: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, H, KV, Sq, Skv, d, causal, window, q_offset)
SWEEP = [
    (2, 4, 2, 256, 256, 64, True, 0, 0),      # GQA causal
    (1, 8, 8, 128, 384, 64, True, 0, 0),      # MHA, kv longer (decode-ish)
    (2, 4, 1, 256, 256, 128, True, 64, 0),    # MQA + sliding window
    (1, 2, 2, 192, 192, 64, False, 0, 0),     # bidirectional, ragged blocks
    (1, 4, 4, 64, 64, 32, True, 0, 0),        # small head dim
    (2, 4, 4, 1, 128, 64, True, 0, 127),      # decode: q at position T-1
]


def _inputs(B, H, KV, Sq, Skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, d)).astype(np.float32),
            rng.normal(size=(B, KV, Skv, d)).astype(np.float32),
            rng.normal(size=(B, KV, Skv, d)).astype(np.float32))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", SWEEP, ids=[str(c) for c in SWEEP])
def test_plain_version_matches_pallas_and_oracle(case):
    B, H, KV, Sq, Skv, d, causal, window, q_offset = case
    q, k, v = _inputs(B, H, KV, Sq, Skv, d, seed=sum(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     interpret=True, **kw)
    oracle = j_ref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = t_fa.flash_attention_ref(tq, tk, tv, **kw)
    out = t_fa.flash_attention(tq, tk, tv, **kw)
    for got in (ref, out):
        assert got.shape == (B, H, Sq, d) and got.dtype == torch.float32
        assert _err(got, pallas) < TOL["float32"]
        assert _err(got, oracle) < TOL["float32"]


@pytest.mark.parametrize("case", SWEEP[:4], ids=[str(c) for c in SWEEP[:4]])
def test_bshd_layout_matches_ops_wrapper(case):
    """(B,S,H,d) layout against the reference's ``ops`` wrapper (which
    transposes around the Pallas kernel, in interpret mode on the CPU)."""
    from repro.kernels.ops import flash_attention_bshd as j_bshd

    B, H, KV, Sq, Skv, d, causal, window, q_offset = case
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
               for a in _inputs(B, H, KV, Sq, Skv, d, seed=7 + sum(case)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = j_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = t_fa.flash_attention_bshd(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **kw)
    assert got.shape == (B, Sq, H, d)
    assert _err(got, want) < TOL["float32"]


@pytest.mark.parametrize("case", SWEEP[:3], ids=[str(c) for c in SWEEP[:3]])
def test_plain_version_bfloat16_matches_oracle(case):
    """bfloat16 in and out; both sides compute in float32 and round once."""
    B, H, KV, Sq, Skv, d, causal, window, q_offset = case
    q, k, v = _inputs(B, H, KV, Sq, Skv, d, seed=3)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    oracle = j_ref.mha_reference(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), **kw)
    got = t_fa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    assert _err(got.float(), oracle.astype(jnp.float32)) < TOL["bfloat16"]


def test_cpu_path_never_counts_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 16, 16, 32, 0))
    before = t_fa.launches
    t_fa.flash_attention(q, k, v)
    t_fa.flash_attention_bshd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    assert t_fa.launches == before


def test_wrappers_refuse_what_they_cannot_run():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 8, 8, 32, 0))
    with pytest.raises(ValueError, match="do not divide"):
        t_fa.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 8, 32, 0))
    with pytest.raises(TypeError, match="one dtype"):
        t_fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="do not fit"):
        t_fa.flash_attention(q, k, v[:, :, :4])
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no implementation"):
        t_fa.flash_attention(*meta)


def test_row_without_a_valid_key_is_the_documented_corner():
    """A window that leaves the last query rows no key: the plain version
    gives the mean of v there (softmax over all -1e30), as the oracle does;
    every other row is exact attention."""
    q, k, v = _inputs(1, 2, 2, 40, 8, 32, seed=5)
    kw = dict(causal=True, window=4)
    got = t_fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                   **kw).numpy()
    oracle = np.asarray(j_ref.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), **kw))
    assert _err(got, oracle) < TOL["float32"]
    # rows 11.. have no key in (q - 4, q] inside the 8 keys
    np.testing.assert_allclose(got[0, :, 11:], np.broadcast_to(
        v.mean(axis=2)[0, :, None], got[0, :, 11:].shape), atol=1e-6)


def test_tensor_core_route_choices():
    """The wrapper's choice of the bf16 wgmma kernel (TMA): bf16 with
    16-byte aligned rows in either layout, and q/k/v as views of one fused
    projection, take it; float32, misaligned rows and an ``expand``ed K/V
    (stride 0 over KV heads) take the CUDA-core kernel."""
    route = t_fa.tensor_core_route
    bf = torch.bfloat16
    q, k, v = (torch.zeros(s, dtype=bf) for s in ((2, 64, 8, 128),
                                                   (2, 64, 4, 128),
                                                   (2, 64, 4, 128)))
    assert route(q, k, v, torch.empty_like(q))
    assert route(*(t.transpose(1, 2) for t in (q, k, v, q)))   # (B,H,S,d)
    fused = torch.zeros((2, 64, 16, 128), dtype=bf)
    assert route(fused[:, :, :8], fused[:, :, 8:12], fused[:, :, 12:], q)
    assert not route(*(t.float() for t in (q, k, v, q)))
    wide = torch.zeros((2, 64, 4, 136), dtype=bf)
    assert not route(q, wide[..., 1:129], v, q)
    k1 = torch.zeros((2, 64, 1, 128), dtype=bf)
    ke, ve = k1.expand(2, 64, 4, 128), k1.expand(2, 64, 4, 128)
    assert ke.stride(2) == 0 and not route(q, ke, ve, q)
    # a stride of 0 on an extent-1 dimension is harmless
    k0 = k1[:1].as_strided((1, 64, 1, 128), (64 * 128, 128, 0, 1))
    assert k0.stride(2) == 0 and route(q[:1], k0, k1[:1], q[:1])
