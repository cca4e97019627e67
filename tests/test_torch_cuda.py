"""Card-only tests of the port: the hand-written CUDA kernels against
their plain PyTorch versions, and the port on the card against the port
on the CPU (the HTL scenarios, and the reduced llama3.2-3b, mamba2-1.3b
and recurrentgemma-9b in float32). Every test here is marked ``cuda`` and
skips (with its reason) where CUDA is absent; this file imports neither
JAX nor ``repro``, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``loo_trials`` and the fused ``loo_trials_step`` (objs, dinv,
zj) within rtol 1e-5 and an atol floor of 1e-5 of the plain version
(float32, other summation order), bitwise equal across launches; whole scenarios with ledgers exactly equal and F1 within the
port's bound of 5e-3 (PERF.md); ``flash_attention`` within the JAX sweep's
max abs 2e-5 (float32) and 2e-2 (bfloat16) of its plain version, bitwise
equal across launches and across the (B,S,H,d) and (B,H,S,d) layouts
(including edge cases of the wgmma kernel's TMA path at every head dim,
expanded K/V views, which take the CUDA-core kernel, and overlapping K/V
views, within 2e-2 of contiguous copies); ``ssd_scan``
within the sweep's relative 3e-5 (float32) / 5e-2 (bfloat16) of its plain
version, and on its bf16 tensor-core route also of the sequential oracle
and of the plain stages (the chunk states within 1e-3: float32 both
sides, the same bf16 hi + lo operands, another summation order and
cumsum); ``rglru_scan`` (float32 only) within its absolute 1e-4; both
scans bitwise equal across launches; the reduced LMs' logits within 1e-5
relative; the scan engine's graph replays bitwise equal to its body run
eagerly on the card, the scan engine against the fleet engine and a small
city on the card against the CPU (ledgers exactly, F1 within 1e-4, the
reference's fleet-vs-loop bar), same-shape scan and city scenarios run
from four threads at once against each run alone (the same bars), the
city's peak device memory within 1.15x from 2 to 6 windows, and the small
city over a 2-rank ``gloo`` world on the card against one shard (centers
equal, F1 within 1e-4); the sweep
backends (devices, processes, inline hosts) on the card byte-equal to
the sequential card run; the MoE dispatch on the card selecting what it
selects on the CPU (bfloat16 ties included), the MoE FFN bitwise
deterministic on the card and within 1e-5 of the CPU in float32, and the
reduced MLA, MoE, vlm and audio models on the card against the CPU.
The decode step's CUDA graph (``models/decode_graph.py``): for every
family that decodes, in float32 and bfloat16, with per-slot and shared
positions, ten steps through ``Model.decode_step`` bitwise equal (logits,
tokens, caches) to the eager body on a clone of the caches, with one
warm-up, one capture and nine replays; a continuous batcher with the
graph serving the tokens and leaving the cache of one without it.

Training: ``loss_fn`` on a card model launches no kernel (the plain route)
and gives every parameter a finite gradient, while ``prefill`` on the same
model launches flash, ``ssd_scan`` and ``rglru_scan`` as the serve path
counts them; the loss and its gradients on the card within 1e-5 relative
and 1e-4 of each leaf's max |g| (+1e-9) of the CPU's (float32 reduction
order) for every reduced family; an AdamW step on the card within 1e-6
relative of the CPU's; the HTL trainer's local and transfer phases on
the card against the CPU within the CPU parity tests' bounds."""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (CITY_MEMORY_RATIO, CITY_SMALL, CITY_WINDOWS,
                        FLASH_EXTRA, FLASH_MAIN, FLASH_TOL, KERNEL_SHAPES,
                        REDUCED,
                        REDUCED_LOGIT_RTOL, RGLRU_EXTRA, RGLRU_SHAPES,
                        RGLRU_TOL,
                        SCAN_F1_ATOL, SSD_SHAPES, SSD_TOL, TRAIN_GRAD_RTOL,
                        TRAIN_LOSS_RTOL, flash_inputs, flash_kwargs,
                        kernel_inputs, lm_batch, reduced_card_vs_cpu,
                        rel_err, rglru_inputs, small_city_card_vs_cpu,
                        ssd_inputs, step_inputs, train_card_vs_cpu)
from repro_torch.core import scenario
from repro_torch.data.synthetic_covtype import make_covtype_like
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import loo_trials as loo
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


def test_kernel_matches_plain_version(cuda):
    for i, (L, R, D, M) in enumerate(KERNEL_SHAPES):
        args = kernel_inputs(L, R, D, M, seed=100 + i, device=cuda)
        before = loo.launches
        out = loo.loo_trials(*args)
        again = loo.loo_trials(*args)
        assert loo.launches == before + 2
        torch.testing.assert_close(out, loo.loo_trials_ref(*args),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(out, again)


# Edge shapes of the cluster kernel, (L, R, D, M): R = 1, R that the 64-row
# tile does not divide, several candidate tiles (M 17, 64, 128), the
# largest D bucket, L = 64 (cluster of 2), and long rows (cluster of 8 with
# many tiles each); every multi-DC row ends in a padding DC, and every
# fifth candidate is masked (``kernel_inputs``).
LOO_EDGE_SHAPES = [(1, 1, 23, 16), (4, 1, 11, 16), (3, 100, 23, 16),
                   (2, 1000, 11, 17), (5, 300, 23, 64), (2, 129, 23, 128),
                   (3, 200, 128, 16), (2, 70, 128, 128), (64, 112, 23, 16),
                   (64, 1120, 23, 16), (1, 5000, 40, 16), (9, 65, 23, 33)]


@pytest.mark.parametrize("shape", LOO_EDGE_SHAPES,
                         ids=[str(s) for s in LOO_EDGE_SHAPES])
def test_kernel_edge_shapes_match_plain_version(cuda, shape):
    L, R, D, M = shape
    args = kernel_inputs(L, R, D, M, seed=sum(shape), device=cuda)
    out = loo.loo_trials(*args)
    again = loo.loo_trials(*args)
    torch.testing.assert_close(out, loo.loo_trials_ref(*args), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(out, again)
    if L > 1:
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))


@pytest.mark.parametrize("shape", KERNEL_SHAPES + LOO_EDGE_SHAPES,
                         ids=[str(s) for s in KERNEL_SHAPES + LOO_EDGE_SHAPES])
def test_step_kernel_matches_plain_version(cuda, shape):
    """The fused step (prologue + scorer) against its plain version: objs,
    dinv and zj within rtol 1e-5 / atol 1e-5, bitwise equal across two
    launches, one launch counted per call."""
    L, R, D, M = shape
    args = step_inputs(L, R, D, M, seed=7 + sum(shape), device=cuda)
    before, before_step = loo.launches, loo.step_launches
    out = loo.loo_trials_step(*args)
    again = loo.loo_trials_step(*args)
    assert loo.launches == before + 2
    assert loo.step_launches == before_step + 2
    for got, twice, want in zip(out, again, loo.loo_trials_step_ref(*args)):
        assert got.shape == (L, M)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, twice)


def test_kernel_wrapper_refuses_what_it_cannot_run(cuda):
    args = kernel_inputs(2, 64, 23, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        loo.loo_trials(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                       *args[1:])
    wide = kernel_inputs(1, 8, 130, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        loo.loo_trials(*wide)


@pytest.mark.parametrize("algo,tech", [("star", "4g"), ("a2a", "wifi")])
def test_scenario_on_the_card_matches_the_cpu(cuda, algo, tech):
    data = make_covtype_like(n_total=3000, seed=0)
    cfg = scenario.ScenarioConfig(windows=3, eval_every=1, algo=algo,
                                  tech=tech, p_edge=0.15)
    loo.reset_launches()
    on_card = scenario.run_scenario(cfg, data, device=cuda)
    assert loo.launches > 0
    on_cpu = scenario.run_scenario(dataclasses.replace(cfg), data,
                                   device="cpu")
    assert on_card.ledger.events == on_cpu.ledger.events
    np.testing.assert_allclose(on_card.f1_curve, on_cpu.f1_curve, rtol=0,
                               atol=5e-3)


# llava's prefill (4 x 4928 positions) and whisper's encoder (4 x 1500
# frames, non-causal, d 64) and decoder: the last three main-path rows
FLASH_SHAPES = [(1, 24, 8, 777, 777, 128, True, 0, 0, "bfloat16")] + \
    FLASH_EXTRA + FLASH_MAIN[-3:]


def _wgmma_edge_shapes():
    """bfloat16 cases aimed at the wgmma kernel's TMA path, at every head
    dim: Sq and Skv in {1, 63, 65, 129, 2049} (ragged against the 128-row
    query tile and the 64/128-key tiles), G = H / KV in {1, 3, 16}, window
    edges that fall inside a tile, and q_offset with Sq = 1."""
    out = []
    for d in (32, 64, 128, 256):
        out += [(2, 3, 1, 63, 63, d, True, 0, 0),          # G 3
                (1, 16, 1, 65, 129, d, False, 0, 0),       # G 16 (MQA)
                (2, 4, 4, 129, 65, d, False, 0, 0),        # G 1
                (1, 6, 2, 2049, 2049, d, True, 0, 0),
                (2, 3, 3, 1, 1, d, True, 0, 0),
                (2, 16, 1, 1, 2049, d, True, 0, 2048),     # q_offset, Sq 1
                (1, 6, 2, 1000, 1000, d, True, 100, 0),    # window edges
                (1, 3, 1, 129, 2049, d, False, 700, 1900)]  # window, offset
    return [s + ("bfloat16",) for s in out]


FLASH_SHAPES += _wgmma_edge_shapes()


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=[str(s) for s in FLASH_SHAPES])
def test_flash_kernel_matches_plain_version(cuda, shape):
    q, k, v = flash_inputs(shape, seed=200, device=cuda)
    kw = flash_kwargs(shape)
    before = fa.launches
    out = fa.flash_attention_bshd(q, k, v, **kw)
    again = fa.flash_attention_bshd(q, k, v, **kw)
    assert fa.launches == before + 2
    ref = fa.flash_attention_bshd_ref(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= \
        FLASH_TOL[shape[9]]
    assert torch.equal(out, again)
    # the (B,H,S,d) layout reads the same tensors through other strides
    bhsd = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), **kw)
    assert torch.equal(bhsd.transpose(1, 2), out)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_wgmma_reads_each_layout_through_its_own_tensor_map(cuda, d):
    """A contiguous (B,H,S,d) tensor (seq stride d, head stride S d) and
    q/k/v as strided views of one fused (B,S,H+2KV,d) projection give the
    (B,S,H,d) result bit for bit: the tensor maps follow the strides."""
    shape = (2, 6, 2, 300, 300, d, True, 0, 0, "bfloat16")
    q, k, v = flash_inputs(shape, seed=7, device=cuda)
    out = fa.flash_attention_bshd(q, k, v)
    bhsd = fa.flash_attention(*(t.transpose(1, 2).contiguous()
                                for t in (q, k, v)))
    assert bhsd.is_contiguous()
    assert torch.equal(bhsd.transpose(1, 2), out)
    fused = torch.cat([q, k, v], dim=2)
    views = fused[:, :, :6], fused[:, :, 6:8], fused[:, :, 8:]
    assert views[0].stride(1) == 10 * d
    assert torch.equal(fa.flash_attention_bshd(*views), out)


def test_flash_wrapper_refuses_what_it_cannot_run(cuda):
    q, k, v = flash_inputs((1, 4, 2, 16, 16, 48, True, 0, 0, "float32"),
                           seed=0, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bshd(q, k, v)
    q, k, v = flash_inputs((1, 4, 2, 16, 16, 32, True, 0, 0, "float32"),
                           seed=0, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bshd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match=">= 0"):
        fa.flash_attention_bshd(q, k, v, q_offset=-1)


def test_reduced_lm_on_the_card_matches_the_cpu(cuda):
    assert max(reduced_card_vs_cpu("llama3.2-3b", seed=4)) <= \
        REDUCED_LOGIT_RTOL


@pytest.mark.parametrize("arch,num_layers", REDUCED[1:3],
                         ids=[a for a, _ in REDUCED[1:3]])
def test_reduced_ssm_and_hybrid_on_the_card_match_the_cpu(cuda, arch,
                                                          num_layers):
    assert max(reduced_card_vs_cpu(arch, seed=4, num_layers=num_layers)) \
        <= REDUCED_LOGIT_RTOL


@pytest.mark.parametrize("arch", [a for a, _ in REDUCED[3:]])
def test_reduced_mla_moe_vlm_audio_on_the_card_match_the_cpu(cuda, arch):
    assert max(reduced_card_vs_cpu(arch, seed=4)) <= REDUCED_LOGIT_RTOL


def _router_probs(T, E, seed):
    """Router logits in bfloat16 (a bfloat16 matmul's output, as the
    models give it), skewed towards the higher experts so that some
    overflow at capacity 1.25, with the last expert duplicating the one
    before it, and the third-last the fourth-last: exact ties in every
    row among often-chosen experts, and more among the rest."""
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn((T, E), generator=g) * 2
              + torch.linspace(0, 3, E)).bfloat16().float()
    logits[:, E - 1] = logits[:, E - 2]
    logits[:, E - 3] = logits[:, E - 4]
    return logits


@pytest.mark.parametrize("T,E,K,factor", [(8192, 64, 8, 1.25),
                                          (8192, 256, 8, 1.25),
                                          (4096, 64, 8, 8.0), (4, 64, 8, 8.0)])
def test_moe_dispatch_on_the_card_matches_the_cpu(cuda, T, E, K, factor):
    """The dispatch (top-k by a stable sort, the stable sort by expert,
    capacity drops) selects the same assignments on the card as on the
    CPU, ties included (the lower expert wins, as lax.top_k)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import blocks

    logits = _router_probs(T, E, seed=T + E)
    C = blocks._capacity(T, MoEConfig(num_experts=E, top_k=K,
                                      capacity_factor=factor))
    cpu = blocks.moe_dispatch(torch.softmax(logits, -1), K, C)
    card = blocks.moe_dispatch(torch.softmax(logits.to(cuda), -1), K, C)
    for name, a, b in zip(("gate", "flat_e", "order", "keep", "dest"),
                          cpu, card):
        if name == "gate":
            torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(b.cpu(), a), name
    flat_e = cpu[1].reshape(T, K)
    # the last expert is taken only after its twin, the lower index
    lo, hi = (flat_e == E - 2), (flat_e == E - 1)
    first = lo.int().argmax(-1) < hi.int().argmax(-1)
    assert bool((~hi.any(-1) | (lo.any(-1) & first)).all())
    assert bool(hi.any())
    assert bool((~cpu[3]).any()) == (factor < 8.0)  # drops at 1.25


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_ffn_on_the_card(cuda, arch):
    """The MoE FFN on the card: float32 within 1e-5 (relative to the
    largest |y|) of the CPU on the same weights, and bitwise equal across
    two runs in float32 and bfloat16 (a fixed-order combine, no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.sharding.partitioning import init_params

    cfg = get_config(arch).reduced()
    p = init_params(blocks.moe_template(cfg), seed=1, device="cpu")
    x = torch.randn((2, 512, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))

    def run(dev, dtype):
        tree = {}
        for path, t in p.items():
            node = tree
            *head, leaf = path.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[leaf] = t.to(dev, dtype)
        return blocks.moe_ffn(tree, x.to(dev, dtype), cfg)[0]

    want = run("cpu", torch.float32)
    got = run(cuda, torch.float32)
    assert float((got.cpu() - want).abs().max()) <= \
        1e-5 * float(want.abs().max())
    assert torch.equal(got, run(cuda, torch.float32))
    assert torch.equal(run(cuda, torch.bfloat16), run(cuda, torch.bfloat16))


# the batcher's shapes (B 1) and the sweep's, in both dtypes
SSD_CARD_SHAPES = SSD_SHAPES[1:]


@pytest.mark.parametrize("shape", SSD_CARD_SHAPES,
                         ids=[str(s) for s in SSD_CARD_SHAPES])
def test_ssd_kernel_matches_plain_version(cuda, shape):
    args = ssd_inputs(shape, seed=500, device=cuda)
    chunk = shape[5]
    before = ss.launches
    y, st = ss.ssd_scan(*args, chunk=chunk)
    y2, st2 = ss.ssd_scan(*args, chunk=chunk)
    assert ss.launches == before + 2
    yp, stp = ss.ssd_chunked(*args, chunk)
    assert y.dtype == args[0].dtype and st.shape == stp.shape
    tol = SSD_TOL[shape[6]]
    assert rel_err(y, yp) <= tol and rel_err(st, stp) <= tol
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_ssd_kernel_reads_views_and_refuses_what_it_cannot_run(cuda):
    """x, B and C as views of one conv output (the model's layout) give
    what contiguous copies give; P > 128 and a chunk > 1024 raise."""
    B, S, H, P, N = 2, 300, 4, 64, 32
    g = torch.Generator(device=cuda).manual_seed(0)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=cuda)
    x = xbc[..., :H * P].unflatten(-1, (H, P))
    Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                  device=cuda))
    A = -torch.ones(H, device=cuda)
    y, st = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    yc, sc = ss.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(),
                         Cm.contiguous(), chunk=128)
    assert torch.equal(y, yc) and torch.equal(st, sc)
    wide = torch.zeros((1, 8, 1, 192), device=cuda)
    with pytest.raises(ValueError, match="P, N <= 128"):
        ss.ssd_scan(wide, dt[:1, :8, :1], A[:1], Bm[:1, :8], Cm[:1, :8])
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(x, dt, A, Bm, Cm, chunk=2048)


# The tensor-core route (bf16, P 64): every S and chunk below, with N, B, H
# and the layout (views of one conv output, or contiguous) cycling so that
# each of their 16 combinations occurs.
SSD_TC_CASES = []
for _i, (_S, _chunk) in enumerate((S, c) for S in (1, 63, 65, 255, 257, 777,
                                                    2048)
                                  for c in (64, 128, 256)):
    SSD_TC_CASES.append((1 + 2 * (_i >> 1 & 1), _S, 1 + 4 * (_i >> 2 & 1),
                         (64, 128)[_i & 1], _chunk, bool(_i >> 3 & 1)))
# chunk states, tensor-core kernel against the plain stage (module doc)
SSD_STATES_TOL = 1e-3


def ssd_tc_inputs(B, S, H, N, views, seed, device):
    """bf16 x (B,S,H,64), B and C (B,S,N) as in ``ssd_inputs``; with
    ``views`` all three are strided views of one (B,S,64 H + 2 N) tensor,
    as the model's conv output gives them."""
    g = torch.Generator(device=device).manual_seed(seed)
    P = 64
    if views:
        xbc = torch.randn((B, S, H * P + 2 * N), generator=g, device=device)
        xbc[..., H * P:] *= 0.5
        xbc = xbc.bfloat16()
        x = xbc[..., :H * P].unflatten(-1, (H, P))
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = torch.randn((B, S, H, P), generator=g, device=device).bfloat16()
        Bm, Cm = ((torch.randn((B, S, N), generator=g, device=device) * 0.5)
                  .bfloat16() for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=device))
    A = -torch.exp(torch.randn(H, generator=g, device=device) * 0.5)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("case", SSD_TC_CASES,
                         ids=[str(c) for c in SSD_TC_CASES])
def test_ssd_tensor_core_route(cuda, case):
    """y and the final state against ``ssd_chunked``, the oracle and the
    plain stages; the chunk states of kernel 1 against their plain stage;
    two launches bitwise equal; one launch counted per call."""
    B, S, H, N, chunk, views = case
    args = ssd_tc_inputs(B, S, H, N, views, seed=S + chunk, device=cuda)
    x, dt, A, Bm, Cm = args
    assert x.is_contiguous() != views
    assert ss.tensor_core_route(x, Bm, Cm, chunk)
    before = ss.launches
    y, st = ss.ssd_scan(*args, chunk=chunk)
    y2, st2 = ss.ssd_scan(*args, chunk=chunk)
    assert ss.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert y.dtype == st.dtype == torch.bfloat16
    assert tuple(st.shape) == (B, H, 64, N)
    tol = SSD_TOL["bfloat16"]
    for want_y, want_st in (ss.ssd_chunked(*args, chunk),
                            ss.ssd_reference(*args)):
        assert rel_err(y, want_y) <= tol and rel_err(st, want_st) <= tol
    cs, states = ss.chunk_states(*args, chunk=chunk)
    assert ss.launches == before + 3
    cs_p, states_p = ss.chunk_states_ref(x, dt, A, Bm, chunk, split=True)
    assert rel_err(states, states_p) <= SSD_STATES_TOL
    assert rel_err(cs, cs_p) <= SSD_STATES_TOL
    h_prev, h = ss.state_pass_ref(cs_p, states_p)
    assert rel_err(st, h) <= tol
    assert rel_err(y, ss.chunk_scan_ref(x, dt, Bm, Cm, cs_p, h_prev,
                                        split=True)) <= tol


def test_flash_kernel_reads_expanded_kv(cuda):
    """bf16 K/V as ``expand``ed views (one KV head broadcast to 4, stride
    0) take the CUDA-core kernel and give what contiguous copies give
    (the wgmma kernel), within the bf16 bound."""
    q, k1, v1 = flash_inputs((2, 8, 1, 300, 300, 128, True, 0, 0,
                              "bfloat16"), seed=11, device=cuda)
    k, v = (t.expand(2, 300, 4, 128) for t in (k1, v1))
    assert k.stride(2) == 0
    assert not fa.tensor_core_route(q, k, v, q)
    assert fa.tensor_core_route(q, k.contiguous(), v.contiguous(), q)
    out = fa.flash_attention_bshd(q, k, v)
    want = fa.flash_attention_bshd(q, k.contiguous(), v.contiguous())
    assert float((out.float() - want.float()).abs().max()) <= \
        FLASH_TOL["bfloat16"]


def test_flash_kernel_reads_overlapping_kv(cuda):
    """bf16 K/V as ``as_strided`` views whose rows overlap (sequence stride
    d, head stride 2 d, so the sequence stride is smaller than the head
    stride times KV and k[:, s, h] is k[:, s + 2, h - 1]) give what
    ``.contiguous()`` copies give, within the bf16 bound."""
    B, H, KV, S, d = 2, 8, 4, 300, 128
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((B, S, H, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((B, S + 2 * KV, d), generator=g, device=cuda)
            .bfloat16().as_strided((B, S, KV, d), ((S + 2 * KV) * d, d,
                                                   2 * d, 1))
            for _ in range(2))
    assert k.stride(1) < k.stride(2) * KV and not k.is_contiguous()
    assert torch.equal(k[:, 2, 0], k[:, 0, 1])
    out = fa.flash_attention_bshd(q, k, v)
    want = fa.flash_attention_bshd(q, k.contiguous(), v.contiguous())
    assert float((out.float() - want.float()).abs().max()) <= \
        FLASH_TOL["bfloat16"]
    assert float((out.float() - fa.flash_attention_bshd_ref(q, k, v).float())
                 .abs().max()) <= FLASH_TOL["bfloat16"]


@pytest.mark.parametrize("shape", RGLRU_SHAPES,
                         ids=[str(s) for s in RGLRU_SHAPES])
def test_rglru_kernel_matches_plain_version(cuda, shape):
    a, b = rglru_inputs(shape, seed=600, device=cuda)
    before = rg.launches
    h = rg.rglru_scan(a, b)
    h2 = rg.rglru_scan(a, b)
    assert rg.launches == before + 2
    assert h.dtype == torch.float32 and h.shape == a.shape
    err = float((h - rg.rglru_scan_ref(a, b)).abs().max())
    assert err <= RGLRU_TOL
    assert torch.equal(h, h2)
    # a (B,S,W) view with other batch and time strides reads in place
    hv = rg.rglru_scan(a[:, 1:], b[:, 1:])
    assert torch.equal(hv, rg.rglru_scan(a[:, 1:].contiguous(),
                                         b[:, 1:].contiguous()))
    with pytest.raises(ValueError, match="float32"):
        rg.rglru_scan(a.bfloat16(), b.bfloat16())


# (B, S, W, offset): chip_smoke's extra rows (a time axis of many cluster
# windows, widths off the 16-byte grain, offset views) and a few edges: one
# step, one short block, a window plus one step, an odd width in a view.
RGLRU_CARD_EXTRA = RGLRU_EXTRA + [(1, 1, 64, 0), (3, 77, 40, 0),
                                  (2, 2049, 4096, 0), (1, 300, 384, 3)]


@pytest.mark.parametrize("row", RGLRU_CARD_EXTRA,
                         ids=[str(r) for r in RGLRU_CARD_EXTRA])
def test_rglru_kernel_long_unaligned_and_offset_inputs(cuda, row):
    """Within 1e-4 of the plain version and of the sequential oracle,
    bitwise equal across launches, on the route ``tma_route`` names, and
    bitwise equal to its contiguous copy (which may take the other
    route: both compose in the same order)."""
    B, S, W, offset = row
    a, b = rglru_inputs((B, S, W), seed=610, device=cuda, offset=offset)
    h = rg.rglru_scan(a, b)
    assert torch.equal(h, rg.rglru_scan(a, b))
    assert float((h - rg.rglru_scan_ref(a, b)).abs().max()) <= RGLRU_TOL
    assert float((h - rg.rglru_reference(a, b)).abs().max()) <= RGLRU_TOL
    assert rg.tma_route(a, b, h) == (W % 4 == 0 and offset % 4 == 0)
    assert torch.equal(h, rg.rglru_scan(a.contiguous(), b.contiguous()))


# Kernel layouts (channel group, cluster, chunk): one block, odd clusters,
# groups of 64, the longest chunks, and chunks that make S take many
# (double-buffered) windows.
RGLRU_PLANS = [(32, 1, 8), (32, 3, 32), (64, 8, 64), (32, 8, 256),
               (64, 2, 128), (32, 5, 136), (64, 1, 32)]
# The kernel against rglru_chunked_ref under the same layout: the same
# composition and roundings, except that the plain version's float64 FMA
# rounds twice (rarely one float32 ulp apart).
RGLRU_CHUNKED_TOL = 1e-6


@pytest.mark.parametrize("plan", RGLRU_PLANS, ids=[str(p) for p in RGLRU_PLANS])
def test_rglru_kernel_composes_as_its_plain_decomposition(cuda, plan):
    """Under every layout, on both routes: within 1e-6 of
    ``rglru_chunked_ref`` with that layout and bitwise equal across the
    routes and across launches."""
    plan = rg.LaunchPlan(*plan)
    for i, (B, S, W) in enumerate([(2, 300, 76), (1, 1000, 256),
                                   (3, 64, 128), (1, 2500, 40)]):
        a, b = rglru_inputs((B, S, W), seed=620 + i, device=cuda)
        want = rg.rglru_chunked_ref(a, b, **plan.chunked_ref_args())
        h = rg._launch(a, b, plan, tma=True)
        assert float((h - want).abs().max()) <= RGLRU_CHUNKED_TOL
        assert torch.equal(h, rg._launch(a, b, plan, tma=False))
        assert torch.equal(h, rg._launch(a, b, plan, tma=True))


def _grad_case(entry, device):
    """(kernel name, call, inputs) of a CUDA entry point at a small shape
    of its main path."""
    flash = flash_inputs((1, 4, 2, 64, 64, 64, True, 0, 0, "bfloat16"), 0,
                         device)
    tc = ssd_tc_inputs(1, 128, 1, 64, False, 0, device)
    return {
        "flash_attention": ("flash_attention", lambda *t: fa.flash_attention(
            *(x.transpose(1, 2) for x in t)), flash),
        "flash_attention_bshd": ("flash_attention", fa.flash_attention_bshd,
                                 flash),
        "ssd_scan": ("ssd_scan", lambda *t: ss.ssd_scan(*t, chunk=64), tc),
        "chunk_states": ("chunk_states",
                         lambda *t: ss.chunk_states(*t, chunk=64), tc),
        "rglru_scan": ("rglru_scan", rg.rglru_scan,
                       rglru_inputs((2, 64, 128), 0, device)),
        "loo_trials": ("loo_trials", loo.loo_trials,
                       kernel_inputs(2, 64, 23, 16, 0, device)),
        "loo_trials_step": ("loo_trials_step", loo.loo_trials_step,
                            step_inputs(2, 64, 23, 16, 0, device))}[entry]


GRAD_ENTRY_POINTS = ["flash_attention", "flash_attention_bshd", "ssd_scan",
                     "chunk_states", "rglru_scan", "loo_trials",
                     "loo_trials_step"]


@pytest.mark.parametrize("entry", GRAD_ENTRY_POINTS)
def test_cuda_entry_points_refuse_inputs_that_require_grad(cuda, entry):
    """With grad enabled and inputs that require grad, the entry point
    raises naming its kernel and launches nothing (the kernel has no
    backward, and its output would silently carry no gradient); under
    ``torch.no_grad()`` the same inputs give the bits plain inputs give."""
    name, call, args = _grad_case(entry, cuda)
    want = call(*args)
    grads = [t.detach().clone().requires_grad_(t.is_floating_point())
             for t in args]
    counts = (fa.launches, ss.launches, rg.launches, loo.launches)
    with pytest.raises(RuntimeError, match=f"^{name}: .*no backward"):
        call(*grads)
    assert (fa.launches, ss.launches, rg.launches, loo.launches) == counts
    with torch.no_grad():
        got = call(*grads)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert not g.requires_grad
        assert torch.equal(g, w)


def test_flash_kernel_unaligned_bfloat16_takes_the_cuda_core_kernel(cuda):
    """bfloat16 rows that are not 16-byte aligned (here every row starts one
    element, 2 bytes, into a wider buffer) run the CUDA-core kernel: still
    within the bfloat16 bound of the plain version."""
    shape = (2, 8, 4, 300, 300, 64, True, 0, 0, "bfloat16")
    wide = flash_inputs((2, 8, 4, 300, 300, 65, True, 0, 0, "bfloat16"),
                        seed=3, device=cuda)
    q, k, v = (t[..., 1:] for t in wide)
    assert q.data_ptr() % 16 != 0
    out = fa.flash_attention_bshd(q, k, v)
    ref = fa.flash_attention_bshd_ref(q, k, v)
    assert float((out.float() - ref.float()).abs().max()) <= \
        FLASH_TOL[shape[9]]


# ---------------------------------------------------------------------------
# the scan and city engines: each window one replay of a captured graph
# ---------------------------------------------------------------------------

SCAN_CASES = {"a2a": dict(algo="a2a", tech="wifi", seed=1),
              "star": dict(algo="star", tech="mesh:hops=2", seed=2,
                           aggregate=True),
              "a2a_trim": dict(algo="a2a", tech="ble", seed=4,
                               byz_frac=0.3, robust_agg="trim:frac=0.2")}


def _scan_cfg(name):
    return scenario.ScenarioConfig(windows=4, eval_every=1, engine="scan",
                                   **SCAN_CASES[name])


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_window_replay_is_bitwise_the_eager_body(cuda, name):
    """Every window replayed from the captured graph gives the carry and
    the confusion counts that the same body run eagerly on the card gives,
    bit for bit."""
    from repro_torch.core import cityscan

    cfg = _scan_cfg(name)
    data = make_covtype_like(n_total=3000, seed=0)
    plan = cityscan._pack_plan(cfg, cityscan._plan_scenario(cfg, data)[0])
    x_test, y_oh = cityscan._eval_arrays(data, cuda)
    prog = cityscan._scan_program(
        cfg.algo, 7, cfg.train_iters,
        scenario.resolve_robust(cfg.robust_agg), plan, x_test.shape[0],
        cuda)
    cityscan._dispatch_scan(prog, plan, cfg.global_update_rate, x_test,
                            y_oh)                # uploads, captures, runs
    assert prog.graph is not None and prog.step_launches > 0
    s = prog.state
    eager, replayed = [], []
    for step, out in ((lambda: prog.body(s), eager),
                      (prog.graph.replay, replayed)):
        cityscan._reset_carry(s)
        for _ in range(cfg.windows):
            step()
            out.append((s["w"].clone(), s["cms"].clone()))
    for (we, ce), (wr, cr) in zip(eager, replayed):
        assert torch.equal(we, wr) and torch.equal(ce, cr)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_engine_matches_the_fleet_engine_on_the_card(cuda, name):
    from repro_torch.core import cityscan
    from repro_torch.core.dispatch import dispatch_scope

    cfg = _scan_cfg(name)
    data = make_covtype_like(n_total=3000, seed=0)
    fleet = scenario.run_scenario(dataclasses.replace(cfg, engine="fleet"),
                                  data, device=cuda)
    cityscan.reset_graph_stats()
    with dispatch_scope() as counts:
        got = scenario.run_scenario(cfg, data)       # the card by default
    assert counts.get("scan_windows") == 1
    assert cityscan.graph_stats()["replays"] == cfg.windows
    assert got.ledger.events == fleet.ledger.events
    np.testing.assert_allclose(got.f1_curve, fleet.f1_curve, rtol=0,
                               atol=SCAN_F1_ATOL)


def test_small_city_on_the_card_matches_the_cpu(cuda):
    """The 40-DC city with the same injected draw indices: centers equal,
    F1 within the fleet-vs-loop bar."""
    err, same_centers, _ = small_city_card_vs_cpu(
        make_covtype_like(seed=0), seed=5)
    assert same_centers
    assert err <= SCAN_F1_ATOL


def test_sharded_city_on_the_card_matches_one_shard(cuda):
    """The 40-DC city with injected draws over a 2-rank ``gloo`` world,
    both ranks on ``cuda:0`` (chip_smoke phase 8g's ranks, spawned): every
    rank's centers equal the one-shard card run's, its F1 within the
    fleet-vs-loop bar."""
    from chip_smoke import run_city_world

    _, _, one = small_city_card_vs_cpu(make_covtype_like(seed=0), seed=0)
    f1, centers = one["cuda"]
    ranks = run_city_world(2)
    assert len(ranks) == 2
    for r in ranks:
        assert r["small"]["centers"] == centers.tolist()
        assert max(abs(a - b) for a, b in zip(r["small"]["f1_curve"],
                                              f1)) <= SCAN_F1_ATOL


def test_city_device_memory_is_flat_in_windows(cuda):
    """Per-window buffers live in the graph's pool: peak device memory at 6
    windows within 1.15x of the peak at 2 (the reference's city_smoke bar)."""
    import gc

    from repro_torch.core import cityscan

    data = make_covtype_like(n_total=3000, seed=0)
    peaks = []
    for W in CITY_WINDOWS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(scenario.ScenarioConfig(**CITY_SMALL),
                                  windows=W, fleet_size=4000)
        r = cityscan.run_city(cfg, data, device=cuda)
        assert len(r.f1_curve) == W
        peaks.append(torch.cuda.max_memory_allocated())
    assert peaks[1] <= CITY_MEMORY_RATIO * peaks[0]


def test_programs_on_the_card_take_turns_across_threads(cuda):
    """Same-shape scan and city scenarios (two update rates, two seeds)
    from four threads at once, the cache emptied first so captures overlap
    other threads' runs: each gives what it gives alone."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import cityscan

    data = make_covtype_like(n_total=3000, seed=0)
    cfgs = ([dataclasses.replace(_scan_cfg("a2a"), global_update_rate=r)
             for r in (0.3, 0.9)]
            + [dataclasses.replace(scenario.ScenarioConfig(**CITY_SMALL),
                                   seed=s) for s in (0, 1)])

    def run(cfg):
        return scenario.run_scenario(cfg, data, device=cuda)

    alone = [run(c) for c in cfgs]
    assert alone[0].f1_curve != alone[1].f1_curve
    cityscan._PROGRAMS.clear()
    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(ex.map(run, cfgs * 2))
    for g, a in zip(got, alone * 2):
        assert g.ledger.events == a.ledger.events
        np.testing.assert_allclose(g.f1_curve, a.f1_curve, rtol=0,
                                   atol=SCAN_F1_ATOL)


@pytest.mark.parametrize("parallel", ["devices:n=2", "processes:n=2",
                                      "hosts:channel=inline,n=2"])
def test_sweep_backends_on_the_card_are_byte_equal(cuda, parallel):
    """Every backend on the card gives the sequential card run's JSON
    byte for byte (shards on ``cuda:{k % count}``; worker processes
    open their own CUDA contexts)."""
    from repro_torch.core.experiment import get_preset

    data = make_covtype_like(n_total=2500, seed=1)
    spec = get_preset("smoke", windows=2, n_seeds=2)
    want = spec.run(data, device="cuda").to_json()
    assert spec.run(data, parallel=parallel,
                    device="cuda").to_json() == want


def test_host_only_guard_refuses_card_tensors(cuda):
    from repro_torch.core.parallel import assert_host_only

    with pytest.raises(TypeError, match="cuda"):
        assert_host_only({"x": [torch.zeros(2, device=cuda)]})


# ------------------------------------------------------------- training
# (arch, num_layers, launches of each kernel per prefill of the reduced
# config): attention layers (the audio encoder's too), SSD layers, RG-LRU
# sublayers
TRAIN_KERNEL_CASES = [
    ("llama3.2-3b", None, {"flash_attention": 2}),
    ("mamba2-1.3b", None, {"ssd_scan": 2}),
    ("recurrentgemma-9b", 5, {"rglru_scan": 4, "flash_attention": 1}),
    ("whisper-medium", None, {"flash_attention": 4})]
KERNEL_MODS = {"flash_attention": fa, "ssd_scan": ss, "rglru_scan": rg}


@pytest.mark.parametrize("arch,num_layers,per_prefill", TRAIN_KERNEL_CASES,
                         ids=[c[0] for c in TRAIN_KERNEL_CASES])
def test_loss_on_the_card_takes_the_plain_route(cuda, arch, num_layers,
                                                per_prefill):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg, device=cuda).init(0).requires_grad_(True)
    batch = lm_batch(cfg, 2, 64, seed=1, device=cuda)
    for mod in KERNEL_MODS.values():
        mod.reset_launches()
    total, _ = model.loss_fn(batch)
    total.backward()
    assert all(mod.launches == 0 for mod in KERNEL_MODS.values())
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    model.prefill(batch)
    assert {n: KERNEL_MODS[n].launches for n in per_prefill} == per_prefill


@pytest.mark.parametrize("arch,num_layers", REDUCED,
                         ids=[a for a, _ in REDUCED])
def test_loss_and_gradients_on_the_card_match_the_cpu(cuda, arch,
                                                      num_layers):
    loss_err, grad_err, leaf = train_card_vs_cpu(arch,
                                                 num_layers=num_layers)
    assert loss_err <= TRAIN_LOSS_RTOL
    assert grad_err <= TRAIN_GRAD_RTOL, leaf


def test_adamw_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import adamw_init, adamw_update

    g = torch.Generator().manual_seed(0)
    shapes = {"embed": (512, 64), "final_norm": (64,),
              "layers/ln1": (3, 64), "layers/w": (3, 64, 96)}

    def tree(dev, scale=1.0):
        out = {}
        for k, shape in shapes.items():
            x = (scale * torch.randn(shape, generator=g)).to(dev)
            out[k] = list(x.unbind(0)) if k.startswith("layers/") else x
        return out

    cfg = OptimizerConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)

    def run(dev):
        g.manual_seed(0)
        p = tree(dev)
        o = adamw_init(p)
        norms = []
        for _ in range(3):
            p, o, n = adamw_update(tree(dev, 3.0), o, p, 1e-2, cfg)
            norms.append(float(n))
        return p, o, norms
    (pc, oc, nc), (pg, og, ng) = run("cpu"), run(cuda)
    np.testing.assert_allclose(ng, nc, rtol=1e-6)
    for k in shapes:
        for a, b in zip(pg[k] if isinstance(pg[k], list) else [pg[k]],
                        pc[k] if isinstance(pc[k], list) else [pc[k]]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
        torch.testing.assert_close(og.mu[k].cpu(), oc.mu[k], rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(og.nu[k].cpu(), oc.nu[k], rtol=1e-6,
                                   atol=0)
    assert int(og.count) == int(oc.count) == 3


@pytest.mark.parametrize("mode", ["a2a", "star"])
def test_htl_trainer_on_the_card_matches_the_cpu(cuda, mode):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import HTLConfig, OptimizerConfig
    from repro_torch.core.htl_trainer import HTLState, HTLTrainer
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWState

    cfg = dataclasses.replace(
        get_config("llama3.2-3b").reduced(), num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256)
    L, H = 4, 3
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    htl = HTLConfig(mode=mode, num_collectors=L, local_steps=H,
                    mixing_steps=3)

    def copy_to(st, dev):
        tree = lambda t: {k: v.to(dev, copy=True) for k, v in t.items()}
        return HTLState(tree(st.params), AdamWState(
            st.opt.count.to(dev, copy=True), tree(st.opt.mu),
            tree(st.opt.nu)), st.step.to(dev, copy=True))

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (H + 1, L, 4, 33)))
    tr = HTLTrainer(build_model(cfg, device="cpu"), opt_cfg, htl)
    first = tr.init(0)

    def run(dev):
        tr = HTLTrainer(build_model(cfg, device=dev), opt_cfg, htl)
        t = toks.to(dev)
        st, losses = tr.local_phase(copy_to(first, dev),
                                    {"tokens": t[:H, ..., :-1],
                                     "targets": t[:H, ..., 1:]})
        st = tr.transfer_phase(st, {"tokens": t[H, ..., :-1],
                                    "targets": t[H, ..., 1:]})
        return copy_to(st, "cpu"), losses.cpu()
    lr_sum = sum(float(tr._sched(i)) for i in range(H))
    (sc, lc), (sg, lg) = run("cpu"), run(cuda)
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    for k, v in sc.params.items():
        bound = 1e-5 * float(v.abs().max()) + 1e-2 * lr_sum
        assert float((sg.params[k] - v).abs().max()) <= bound, k
    for k, v in sc.opt.nu.items():
        assert float((sg.opt.nu[k] - v).abs().max()) <= \
            1e-4 * float(v.abs().max()) + 1e-30, k


# ---------------------------------------------------------------------------
# The mesh, the dry-run and the roofline on the card's torch
# ---------------------------------------------------------------------------

def test_hint_under_the_host_mesh_leaves_served_logits_bit_for_bit(cuda):
    """Under the 1x1 host mesh of the card the hints change nothing: the
    served prefill and decode logits are bit for bit those without a
    mesh, with plain tensors and with the parameters and tokens laid out
    as (replicated) DTensors on that mesh (attention runs on the local
    tensors: the flash kernel launches)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding.partitioning import use_compute_mesh

    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg).init(seed=0)
    batch = lm_batch(cfg, 2, 64, seed=0)
    want, cache = model.prefill(batch)
    mesh = make_host_mesh()
    try:
        with use_compute_mesh(mesh):
            got, _ = model.prefill(batch)
            assert torch.equal(got, want)
            rep = [Replicate(), Replicate()]
            for mod in model.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    setattr(mod, name, torch.nn.Parameter(
                        DTensor.from_local(p.detach(), mesh, rep),
                        requires_grad=False))
            before = fa.launches
            with implicit_replication():      # positions, masks
                got_dt, _ = model.prefill({"tokens": DTensor.from_local(
                    batch["tokens"], mesh, rep)})
            assert fa.launches == before + cfg.num_layers
        assert torch.equal(got_dt.full_tensor(), want)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,num_layers", [("llama3.2-3b", None),
                                             ("mamba2-1.3b", None),
                                             ("recurrentgemma-9b", 5)])
def test_kernel_and_plain_routes_trace_the_same_flops(cuda, arch,
                                                      num_layers):
    """A card model's prefill launches the kernels, which no dispatch mode
    sees; the mixer regions count their work, so the traced FLOPs equal
    the plain route's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.roofline.trace import analyze_trace

    cfg = get_config(arch).reduced()
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = build_model(cfg).init(seed=0)
    batch = lm_batch(cfg, 2, 64, seed=0)
    kernel = analyze_trace(model.prefill, batch)
    plain = analyze_trace(model.prefill, batch, plain=True)
    assert kernel["flops"] == plain["flops"] > 0
    assert kernel["regions"] == plain["regions"] and kernel["regions"]


def test_fake_world_and_dtensor_on_the_cards_torch():
    """The fake backend (torch's internal testing store) and DTensor under
    it, on the card machine's torch: a 256-rank mesh, a sharded matmul and
    a redistribution seen by the trace, in a fresh process."""
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    code = "\n".join([
        "import torch",
        "from torch.distributed.tensor import Shard, Replicate",
        "from repro_torch.launch.mesh import fake_world, "
        "make_production_mesh",
        "from repro_torch.roofline.trace import analyze_trace",
        "from repro_torch.sharding.partitioning import P, distribute",
        "fake_world(256)",
        "mesh = make_production_mesh()",
        "x = distribute(torch.empty(64, 512, device='meta'), mesh, "
        "P('data'))",
        "w = distribute(torch.empty(512, 256, device='meta'), mesh, "
        "P('data', 'model'))",
        "a = analyze_trace(lambda: (x @ w).redistribute(mesh, "
        "[Shard(0), Replicate()]))",
        "assert a['flops'] > 0 and a['collectives']['n_ops'] > 0, a",
        "print('OK', a['flops'], a['collectives']['by_op'])"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env=dict(os.environ, PYTHONPATH=os.path.join(
                              root, "src")), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


# ---------------------------------------------------------------------------
# The decode step as one CUDA graph (models/decode_graph.py)
# ---------------------------------------------------------------------------

# Every family that decodes: (arch, config changes); the window case rolls
# llama's cache, recurrentgemma's 5 layers hold a period with attention.
DECODE_GRAPH_CASES = {
    "dense": ("llama3.2-3b", {}),
    "dense-window": ("llama3.2-3b", {"sliding_window": 16}),
    "moe": ("olmoe-1b-7b", {}),
    "mla": ("minicpm3-4b", {}),
    "moe-mla": ("deepseek-v3-671b", {}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("recurrentgemma-9b", {"num_layers": 5}),
    "audio": ("whisper-medium", {}),
    "vlm": ("llava-next-mistral-7b", {}),
}
DECODE_STEPS = 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_kind", ["per_slot", "shared"])
@pytest.mark.parametrize("case", list(DECODE_GRAPH_CASES))
def test_decode_graph_replays_are_bitwise_the_eager_step(cuda, case,
                                                         pos_kind, dtype):
    """Ten steps through ``Model.decode_step`` (one eager warm-up, one
    capture that replays once, eight replays) give the logits and greedy
    tokens of the eager body run on a clone of the same caches, bit for
    bit, and the same caches after; logits returned earlier are not
    overwritten by later replays; the graph dies with the cache."""
    from chip_smoke import cache_len
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import decode_graph as dg
    from repro_torch.serving import pad_cache

    arch, changes = DECODE_GRAPH_CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg, dtype=dtype).init(seed=0)
    batch = lm_batch(cfg, 2, 24, seed=3)
    T = cache_len(batch)
    logits, cache = model.prefill(batch)
    cache = pad_cache(model, cache, DECODE_STEPS, 2, T)
    ref_cache = {k: v.clone() for k, v in cache.items()}
    tok = ref_tok = logits.argmax(-1)
    dg.reset_decode_graph_stats()
    kept = []
    for i in range(DECODE_STEPS):
        pos = torch.full((2,) if pos_kind == "per_slot" else (), T + i,
                         dtype=torch.long, device=cuda)
        logits, out = model.decode_step(cache, tok[:, None], pos)
        ref, ref_cache = model._decode_body(ref_cache, ref_tok[:, None],
                                            pos.clone())
        assert out is cache
        assert torch.equal(logits, ref), i
        kept.append((logits, ref.clone()))
        tok, ref_tok = logits.argmax(-1), ref.argmax(-1)
        assert torch.equal(tok, ref_tok), i
    for k in cache:
        assert torch.equal(cache[k], ref_cache[k]), k
    for got, want in kept:
        assert torch.equal(got, want)
    stats = dg.decode_graph_stats()
    assert (stats["eager"], stats["captures"], stats["replays"]) == \
        (1, 1, DECODE_STEPS - 1), stats
    del cache, out                   # the graph dies with its cache
    assert model._decode_graph is None


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b"])
def test_batcher_with_the_decode_graph_matches_the_eager_batcher(cuda,
                                                                 arch):
    """A continuous batcher in bfloat16, refills spliced between replays,
    serves the tokens it serves with the graph bypassed (``decode_step``
    bound to the eager body), and leaves the same cache: a recurrent
    state advanced once per step. One capture, at the batcher's second
    step; the graph goes when the batcher's cache does."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import decode_graph as dg
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    cfg = get_config(arch).reduced()
    model = build_model(cfg, dtype="bfloat16").init(seed=0)
    rng = np.random.default_rng(0)
    lens = [(int(rng.integers(4, 30)), int(rng.integers(3, 12)))
            for _ in range(9)]

    def serve(eager):
        inner = model._decode_body if eager else model.decode_step
        steps = []

        def step(cache, tokens, pos):
            steps.append(1)
            return inner(cache, tokens, pos)
        model.decode_step = step
        try:
            b = ContinuousBatcher(model, slots=3, max_len=48)
            reqs = [Request(i, rng_tokens(i, n), m)
                    for i, (n, m) in enumerate(lens)]
            for r in reqs:
                b.submit(r)
            b.run()
        finally:
            del model.decode_step
        return [r.out for r in reqs], b.cache, len(steps)

    def rng_tokens(i, n):
        return np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, n)

    dg.reset_decode_graph_stats()
    out_g, cache_g, n_steps = serve(eager=False)
    stats = dg.decode_graph_stats()
    out_e, cache_e, n_eager = serve(eager=True)
    assert out_g == out_e and n_steps == n_eager
    assert all(len(o) >= 3 for o in out_g)
    for k in cache_g:
        assert torch.equal(cache_g[k], cache_e[k]), k
    assert (stats["eager"], stats["captures"], stats["replays"]) == \
        (1, 1, n_steps - 1), stats
    del cache_g                      # the batcher's cache takes the graph
    assert model._decode_graph is None
