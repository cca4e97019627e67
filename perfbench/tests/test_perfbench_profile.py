"""The traced span's arithmetic on a synthetic trace: busy time as the
union of device intervals, idle gaps by the host span open when they
began, and the kernel rooflines from the frozen costs."""
import pytest

from perfbench import registry, yardstick
from perfbench.cell import Run
from perfbench.profiling import Profile
from perfbench.timeline import WindowStats


def synthetic():
    # span 0..1000 us; a prefill 100..500 with two overlapping kernels and
    # a flash launch; a decode step 600..900 with two kernels
    kernels = [("gemm", 120, 300), ("flash_attention_wgmma_kernel", 250, 400),
               ("gemm", 650, 700), ("ssd_chunk_scan_kernel<128>", 800, 850)]
    host = [("client_loop", 0, 1000), ("step", 50, 950),
            ("refill", 90, 520), ("prefill", 100, 500),
            ("decode_step", 600, 900)]
    return Profile((0.0, 1000.0), kernels, host, prefill_lens=[2048])


def test_busy_and_idle():
    p = synthetic()
    assert p.merged() == [[120, 400], [650, 700], [800, 850]]
    assert p.busy_s() == pytest.approx(380e-6)
    assert p.span_s == pytest.approx(1e-3)
    gaps = dict(p.idle_gaps())
    # 0-120: prefill open from 100, so the gap began under "client_loop"
    # (0) ; 400-650 began inside prefill; 700-800 inside decode_step;
    # 850-1000 inside decode_step
    assert gaps == pytest.approx({"client_loop": 120e-6,
                                  "prefill": 250e-6,
                                  "decode_step": 250e-6})
    assert sum(gaps.values()) + p.busy_s() == pytest.approx(p.span_s)
    assert p.top_ops()[0] == ["gemm", pytest.approx(230e-6)]


def test_kernel_rooflines_and_idle_reader():
    p = synthetic()
    stats = WindowStats(1.0, 1, 2048, 1, 1, [0.1], [])
    for name, dev in (("olmoe-1b-7b", 150e-6), ("mamba2-1.3b", 50e-6)):
        c = registry.config(name)
        run = Run({}, c, {}, 1.0, stats, profile=p)
        L = c["num_hidden_layers"]
        if name == "olmoe-1b-7b":
            us = yardstick.bound(*yardstick.flash_cost(
                (1, 16, 16, 2048, 2048, 128, True, 0, 0, "bfloat16")),
                "bfloat16")[0] * L
            got = registry.metric("flash_attention_roofline").read(run)
            assert registry.metric("ssd_scan_roofline").read(run) is None
        else:
            us = yardstick.bound(*yardstick.ssd_cost(
                (1, 2048, 64, 64, 128, 256, "bfloat16")), "bfloat16")[0] * L
            got = registry.metric("ssd_scan_roofline").read(run)
            assert registry.metric("flash_attention_roofline").read(run) \
                is None
        assert got == pytest.approx(100 * us / 1e6 / dev)
        idle = registry.metric("device_idle.chat").read(run)
        assert idle == pytest.approx(100 * (1 - 0.38))


def test_nothing_to_read_gives_nothing():
    p = Profile((0.0, 10.0), [], [], [])
    run = Run({}, registry.config("olmoe-1b-7b"), {}, 1.0,
              WindowStats(1.0, 0, 0, 0, 0, [], []), profile=p)
    for n in ("device_idle.long-prompt", "flash_attention_roofline",
              "ssd_scan_roofline", "prompt_tokens_per_s", "mfu.chat"):
        assert registry.metric(n).read(run) is None
