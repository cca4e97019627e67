"""What happened to each request, on the host's clock, and the window's
rates and tails taken from it.

A :class:`Timeline` holds, per request id: when its client sent it, its
prompt length, the time each of its tokens reached the host (the first
from its prefill, the rest from decode steps), and when it completed.
:func:`window_stats` reduces it over one window [open, close]: every rate
is the work of the whole window over the window's length, and every tail
is a percentile over every sample in the window, never a statistic of
chunks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Timeline:
    send: Dict[int, float] = field(default_factory=dict)
    prompt_len: Dict[int, int] = field(default_factory=dict)
    tokens: Dict[int, List[float]] = field(default_factory=dict)
    done: Dict[int, float] = field(default_factory=dict)

    def sent(self, rid: int, t: float, prompt_len: int) -> None:
        self.send[rid] = t
        self.prompt_len[rid] = prompt_len
        self.tokens[rid] = []


def p95(values) -> Optional[float]:
    """The 95th percentile (linear interpolation), None without samples."""
    return float(np.percentile(values, 95)) if len(values) else None


@dataclass
class WindowStats:
    seconds: float
    prefills: int              # first tokens that reached the host
    prompt_tokens: int         # prompt tokens of those prefills
    output_tokens: int         # tokens that reached the host
    completed: int             # requests completed
    ttft_s: List[float]        # send -> first token, per prefill
    itl_s: List[float]         # gaps between consecutive tokens

    def rate(self, n) -> float:
        return n / self.seconds


def window_stats(tl: Timeline, t_open: float, t_close: float
                 ) -> WindowStats:
    """Everything in [t_open, t_close] (module doc). A request's first
    token counts where it lands in the window, whenever it was sent; a
    gap counts where its later token lands."""
    def inside(t):
        return t_open <= t <= t_close

    prefills, prompt, out = 0, 0, 0
    ttft, itl = [], []
    for rid, times in tl.tokens.items():
        if times and inside(times[0]):
            prefills += 1
            prompt += tl.prompt_len[rid]
            ttft.append(times[0] - tl.send[rid])
        for a, b in zip([None] + times[:-1], times):
            if not inside(b):
                continue
            out += 1
            if a is not None:
                itl.append(b - a)
    completed = sum(1 for t in tl.done.values() if inside(t))
    return WindowStats(t_close - t_open, prefills, prompt, out, completed,
                       ttft, itl)
