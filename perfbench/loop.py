"""The closed loop around the program's continuous batcher.

As many clients as slots. A client sends its next request as soon as its
previous one completes (at the end of the step that completed it), so a
slow system receives less load. Each client's first request starts
part-way through its budget (:meth:`Traffic.head_start`), so the slots
finish at staggered steps and the loop is in steady state after a few
steps.

The loop drives only the batcher's public calls (``submit``, ``step``).
To see when a first token reaches the host it wraps the batcher
instance's ``_prefill_one`` (which returns after the token is on the
host); later tokens reach the host at the end of the step that made them.
"""
from __future__ import annotations

import time

from perfbench.timeline import Timeline


class ClosedLoop:
    def __init__(self, batcher, request_cls, traffic, clients: int,
                 clock=time.perf_counter):
        self.batcher = batcher
        self.request_cls = request_cls
        self.traffic = traffic
        self.clients = clients
        self.clock = clock
        self.timeline = Timeline()
        self.requests = {}
        self.inflight = set()
        self.next_index = 0
        self._wrap_prefill()

    def _wrap_prefill(self):
        inner = self.batcher._prefill_one
        tokens = self.timeline.tokens

        def prefill_one(req):
            out = inner(req)
            tokens[req.rid].append(self.clock())
            return out
        self.batcher._prefill_one = prefill_one

    def send(self, now: float, max_new_tokens=None):
        i = self.next_index
        self.next_index += 1
        prompt, budget = self.traffic.spec(i)
        req = self.request_cls(rid=i, tokens=self.traffic.tokens(i),
                               max_new_tokens=max_new_tokens or budget)
        self.timeline.sent(i, now, prompt)
        self.requests[i] = req
        self.inflight.add(i)
        self.batcher.submit(req)

    def start(self):
        """Every client sends its first request, part-way through its
        budget."""
        now = self.clock()
        for frac in self.traffic.head_start(self.clients):
            _, budget = self.traffic.spec(self.next_index)
            self.send(now, max(1, budget - int(frac * budget)))

    def step(self) -> float:
        """One batcher step; record the tokens it brought to the host and
        let each client whose request completed send the next. Returns
        the time the step ended."""
        self.batcher.step()
        now = self.clock()
        tl = self.timeline
        for rid in sorted(self.inflight):
            req, times = self.requests[rid], tl.tokens[rid]
            times.extend([now] * (len(req.out) - len(times)))
            if req.done:
                tl.done[rid] = now
                self.inflight.discard(rid)
                self.send(now)
        return now

    def finished(self):
        """The requests that completed, in the order they were sent."""
        return [self.requests[rid] for rid in sorted(self.timeline.done)]
