"""Rates and tails are taken over every request in the window, on a
synthetic timeline that holds a stall."""
import numpy as np
import pytest

from perfbench.cell import Run
from perfbench import registry
from perfbench.timeline import Timeline, p95, window_stats


def stalled_timeline():
    """40 requests of 100 prompt tokens, each sent at 0.25 s steps with a
    first token 0.05 s later and 4 more tokens 0.02 s apart, except that
    a 2 s stall holds back the 4 requests sent just before t = 5 s."""
    tl = Timeline()
    for rid in range(40):
        t = 0.25 * rid
        tl.sent(rid, t, 100)
        first = t + 0.05
        if 4.0 <= t < 5.0:
            first = 7.0 + 0.01 * rid
        tl.tokens[rid] = [first + 0.02 * k for k in range(5)]
        tl.done[rid] = tl.tokens[rid][-1]
    return tl


def test_window_counts_everything_inside():
    tl = stalled_timeline()
    s = window_stats(tl, 2.0, 9.0)
    firsts = [rid for rid in range(40) if 2.0 <= tl.tokens[rid][0] <= 9.0]
    assert s.prefills == len(firsts)
    assert s.prompt_tokens == 100 * len(firsts)
    assert s.output_tokens == sum(2.0 <= t <= 9.0 for ts in tl.tokens.values()
                                  for t in ts)
    assert s.completed == sum(2.0 <= t <= 9.0 for t in tl.done.values())
    assert s.seconds == 7.0
    assert s.rate(s.prompt_tokens) == 100 * len(firsts) / 7.0


def test_tail_sees_the_stall():
    tl = stalled_timeline()
    s = window_stats(tl, 0.0, 12.0)
    ttft = np.asarray(s.ttft_s)
    assert len(ttft) == 40
    assert p95(s.ttft_s) > 2.0               # the 4 stalled of 40 are 10%
    # a median of per-second chunks would hide it
    chunks = [np.median([x for rid, x in enumerate(ttft)
                         if k <= 0.25 * rid < k + 1]) for k in range(10)]
    assert np.median(chunks) < 0.1
    assert p95(s.itl_s) < 0.03 and len(s.itl_s) == 40 * 4


def test_readers_on_the_stalled_timeline():
    tl = stalled_timeline()
    s = window_stats(tl, 0.0, 12.0)
    c = registry.config("olmoe-1b-7b")
    run = Run({}, c, {}, 3.5, s)
    read = {n: registry.metric(n).read(run) for n in (
        "ttft_p95_ms", "itl_p95_ms", "prompt_tokens_per_s",
        "output_tokens_per_s", "setup_s", "mfu.long-prompt")}
    assert read["ttft_p95_ms"] == 1e3 * p95(s.ttft_s)
    assert read["prompt_tokens_per_s"] == 4000 / 12.0
    assert read["output_tokens_per_s"] == 200 / 12.0
    assert read["setup_s"] == 3.5
    assert read["mfu.long-prompt"] == pytest.approx(
        100 * 2 * 1178927104 * 4200 / (12.0 * 989e12))
    # traced readers find nothing in an untraced run
    for n in ("decode_step_ms.chat", "prefill_ms_per_ktok.long-prompt",
              "device_idle.chat", "flash_attention_roofline",
              "ssd_scan_roofline"):
        assert registry.metric(n).read(run) is None
    assert p95([]) is None
