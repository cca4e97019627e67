"""Decode attention over a fixed-size KV buffer
(``repro_torch/kernels/decode_attention.py``).

CPU: the plain version ``decode_attention_ref`` against
``chunked_attention(q, ck, cv, causal=True, window=w, q_offset=pos)``, the
path the buffered GQA decode took before the kernel, over query heads per
KV head G 1, 3, 4, head dims 32, 64, 128, a shared (0-d) and a per-slot
position at depths 0, S - 1 and mixed, with and without a window (float32
within 1e-6; bfloat16 within 2e-2, since ``chunked_attention`` rounds the
probabilities to bf16 before p·v and the plain version does not); the
wrapper on the CPU takes the plain version bit for bit and counts no
launch; the kernel's checks refuse a dtype, head dim, group, window, shape
or alignment it does not take; ``chip_smoke.DECODE_ATTN_TOL`` takes one
bf16 rounding of the output and refuses the plain version with a split of
keys left out; ``chip_smoke.buffered_decode_layers`` is the number of
``decode_attention`` calls in a decode step of every family.

Card (marked ``cuda``, skipped without CUDA; ``chip_smoke``'s shapes): the
kernel against the plain version within ``DECODE_ATTN_TOL`` (2e-5 in
float32, one bf16 rounding in bfloat16) at olmoe-1b-7b chat's buffer (B
64, S 1,537, 16 KV heads of 128), long-prompt's (B 16, S 3,043), G > 1,
d 64 and reduced float32 shapes, random depths with 0 and S - 1 among
them; two launches bitwise equal; the kernel captured in a CUDA graph and
replayed with new positions equal to its eager call; decode graph replays
count one launch a layer; the wrapper raising on a CUDA tensor the kernel
does not take.
"""
import dataclasses

import pytest
import torch

from chip_smoke import (DECODE_ATTN_SHAPES, DECODE_ATTN_SPLIT,
                        buffered_decode_layers, cache_len,
                        decode_attention_inputs, decode_attention_tol_use,
                        lm_batch, split_left_out)
from repro_torch.kernels import decode_attention as da
from repro_torch.models.blocks import chunked_attention

torch.set_num_threads(1)

B, S, KV = 3, 40, 2
DEPTHS = {"shared-0": 0, "shared-last": S - 1, "per-slot-0": [0, 0, 0],
          "per-slot-last": [S - 1] * B, "per-slot-mixed": [0, 17, S - 1]}


def _inputs(G, hd, depth, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, 1, KV * G, hd, generator=g).to(dtype)
    ck, cv = (torch.randn(B, S, KV, hd, generator=g).to(dtype)
              for _ in range(2))
    return q, ck, cv, torch.tensor(depth, dtype=torch.long)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("depth", list(DEPTHS))
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4])
def test_plain_version_matches_chunked_attention(G, hd, depth, window):
    q, ck, cv, pos = _inputs(G, hd, DEPTHS[depth])
    got = da.decode_attention_ref(q, ck, cv, pos, window=window)
    want = chunked_attention(q, ck, cv, causal=True, window=window,
                             q_offset=pos)
    assert got.shape == want.shape == q.shape and got.dtype == q.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("depth", ["shared-last", "per-slot-mixed"])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_version_matches_chunked_attention_bf16(G, depth):
    q, ck, cv, pos = _inputs(G, 128, DEPTHS[depth], torch.bfloat16)
    got = da.decode_attention_ref(q, ck, cv, pos)
    want = chunked_attention(q, ck, cv, causal=True, q_offset=pos)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= 2e-2
    # against float32 attention over the same bf16 values: one rounding
    exact = da.decode_attention_ref(q.float(), ck.float(), cv.float(), pos)
    torch.testing.assert_close(got.float(), exact, rtol=2 ** -8, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    q, ck, cv, pos = _inputs(3, 64, DEPTHS["per-slot-mixed"])
    before = da.launches
    got = da.decode_attention(q, ck, cv, pos, window=7)
    assert torch.equal(got, da.decode_attention_ref(q, ck, cv, pos,
                                                    window=7))
    assert da.launches == before


def _refused(case):
    q, ck, cv, _ = _inputs(2, 64, 0)
    if case == "float16":
        return q.half(), ck.half(), cv.half()
    if case == "mixed-dtypes":
        return q, ck.bfloat16(), cv.bfloat16()
    if case == "head-dim-48":
        return q[..., :48], ck[..., :48], cv[..., :48]
    if case == "head-dim-256":
        return (torch.cat([x] * 4, -1) for x in (q, ck, cv))
    if case == "group-16":
        return q.repeat(1, 1, 8, 1), ck, cv
    if case == "two-queries":
        return torch.cat([q, q], 1), ck, cv
    if case == "unaligned-rows":
        # rows 4 floats apart from a 16-byte boundary by a 1-element offset
        wide = torch.zeros(B, S, KV, 65)
        return q, wide[..., 1:], cv
    raise ValueError(case)


@pytest.mark.parametrize("case", ["float16", "mixed-dtypes", "head-dim-48",
                                  "head-dim-256", "group-16", "two-queries",
                                  "unaligned-rows"])
def test_kernel_refuses_what_it_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        da.kernel_dims(*_refused(case))


def test_kernel_refuses_a_window():
    q, ck, cv, _ = _inputs(2, 64, 0, torch.bfloat16)
    assert da.kernel_dims(q, ck, cv, window=0) == (B, 2 * KV, KV, S, 64)
    with pytest.raises(ValueError, match="window"):
        da.kernel_dims(q, ck, cv, window=5)


def test_kernel_takes_the_decode_shapes():
    for G in (1, 2, 3, 4, 8):
        for hd in da.HEAD_DIMS:
            q, ck, cv, _ = _inputs(G, hd, 0, torch.bfloat16)
            assert da.kernel_dims(q, ck, cv) == (B, KV * G, KV, S, hd)


def test_tolerance_takes_one_rounding_and_refuses_a_split_left_out():
    """At olmoe's heads and a chat-deep buffer: float32 attention with
    float32-sized noise, rounded to bf16, is within the limit of the same
    attention rounded once; the plain version without its first split of
    keys is not."""
    shape = (4, 3 * DECODE_ATTN_SPLIT, 16, 16, 128, "bfloat16")
    q, ck, cv, pos = decode_attention_inputs(shape, seed=5, device="cpu",
                                             depths=[0, 300, 500, 767])
    exact = da.decode_attention_ref(q.float(), ck.float(), cv.float(), pos)
    ref = exact.bfloat16()
    g = torch.Generator().manual_seed(0)
    noisy = (exact + 1e-6 * torch.randn(exact.shape, generator=g)).bfloat16()
    assert decode_attention_tol_use(noisy, ref, "bfloat16") <= 1
    assert decode_attention_tol_use(ref, ref, "bfloat16") == 0
    fault = split_left_out(q, ck, cv, pos)
    assert torch.equal(fault[:1], ref[:1])      # shallower than a split
    assert decode_attention_tol_use(fault, ref, "bfloat16") > 1


FAMILIES = [("llama3.2-3b", {}), ("llama3.2-3b", {"sliding_window": 8}),
            ("olmoe-1b-7b", {}), ("minicpm3-4b", {}), ("mamba2-1.3b", {}),
            ("recurrentgemma-9b", {"num_layers": 5}), ("whisper-medium", {}),
            ("llava-next-mistral-7b", {})]


@pytest.mark.parametrize("arch,changes", FAMILIES,
                         ids=[f"{a}{'-window' if c.get('sliding_window') else ''}"
                              for a, c in FAMILIES])
def test_buffered_decode_layers_counts_the_calls_of_a_decode_step(
        arch, changes, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as model_mod
    from repro_torch.serving import pad_cache

    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg, device="cpu").init(seed=0)
    batch = lm_batch(cfg, 2, 8, seed=1, device="cpu")
    logits, cache = model.prefill(batch)
    T = cache_len(batch)
    cache = pad_cache(model, cache, 2, 2, T)
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return da.decode_attention(*args, **kwargs)
    monkeypatch.setattr(model_mod, "decode_attention", counted)
    model.decode_step(cache, logits.argmax(-1)[:, None], T)
    assert len(calls) == buffered_decode_layers(cfg)


# ----------------------------------------------------------------- card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_ATTN_SHAPES,
                         ids=[f"B{s[0]}-S{s[1]}-H{s[2]}-KV{s[3]}-d{s[4]}-"
                              f"{s[5]}" for s in DECODE_ATTN_SHAPES])
def test_kernel_matches_plain_version(cuda, shape):
    dtype = shape[-1]
    q, ck, cv, pos = decode_attention_inputs(shape, seed=7, device=cuda)
    before = da.launches
    out = da.decode_attention(q, ck, cv, pos)
    again = da.decode_attention(q, ck, cv, pos)
    assert da.launches == before + 2
    ref = da.decode_attention_ref(q, ck, cv, pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.equal(out, again)
    assert decode_attention_tol_use(out, ref, dtype) <= 1
    if int(pos.max()) >= DECODE_ATTN_SPLIT:
        assert decode_attention_tol_use(split_left_out(q, ck, cv, pos), ref,
                                        dtype) > 1
    # a shared position: every slot at one depth
    shared = pos[len(pos) // 2].clone()
    assert decode_attention_tol_use(
        da.decode_attention(q, ck, cv, shared),
        da.decode_attention_ref(q, ck, cv, shared), dtype) <= 1


@pytest.mark.cuda
def test_graph_replay_with_new_positions_equals_the_eager_call(cuda):
    shape = DECODE_ATTN_SHAPES[0]
    q, ck, cv, pos = decode_attention_inputs(shape, seed=3, device=cuda)
    static = pos.clone()
    da.decode_attention(q, ck, cv, static)          # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, ck, cv, static)
    S = shape[1]
    for seed in range(3):
        g = torch.Generator(device=cuda).manual_seed(seed)
        new = torch.randint(0, S, pos.shape, device=cuda, generator=g)
        new[seed] = S - 1
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, da.decode_attention(q, ck, cv, new))


@pytest.mark.cuda
def test_decode_graph_replays_count_one_launch_a_layer(cuda):
    """Four decode steps of a reduced olmoe through ``decode_step``: the
    wrapper counts the eager warm-up and the capture, the decode graph's
    stats each replay's launches, one a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import decode_graph as dg
    from repro_torch.serving import pad_cache

    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg, dtype="bfloat16").init(seed=0)
    batch = lm_batch(cfg, 2, 24, seed=3)
    T = cache_len(batch)
    logits, cache = model.prefill(batch)
    cache = pad_cache(model, cache, 4, 2, T)
    tok = logits.argmax(-1)
    dg.reset_decode_graph_stats()
    da.reset_launches()
    for i in range(4):
        logits, cache = model.decode_step(cache, tok[:, None], T + i)
        tok = logits.argmax(-1)
    stats = dg.decode_graph_stats()
    assert (stats["eager"], stats["captures"], stats["replays"]) == (1, 1, 3)
    assert da.launches == 2 * cfg.num_layers
    assert stats["launches"] == {"decode_attention": 3 * cfg.num_layers}


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda):
    q, ck, cv, pos = decode_attention_inputs((2, 64, 4, 2, 64, "bfloat16"),
                                             0, cuda)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), ck.half(), cv.half(), pos)
    with pytest.raises(ValueError):
        da.decode_attention(q[..., :48], ck[..., :48], cv[..., :48], pos)
    with pytest.raises(ValueError):
        da.decode_attention(q, ck, cv, pos, window=16)
