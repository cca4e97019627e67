"""Continuous-batching serving scheduler (port of
``repro.serving.scheduler``).

Requests arrive with different prompt lengths and token budgets; the
scheduler keeps a fixed number of decode slots busy: when a sequence
finishes (EOS or budget), its slot is refilled by prefilling the next queued
request (batch 1, any length) and splicing its cache into the batch cache
at the free slot (axis 1 of every leaf, ('layers', 'batch', ...)). All busy
slots then decode in one batch with per-slot positions; idle slots decode
garbage that is ignored and overwritten by the next splice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.cache_utils import pad_cache


@dataclass
class Request:
    rid: int
    tokens: np.ndarray              # (prompt_len,)
    max_new_tokens: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching over a shared decode cache."""

    def __init__(self, model: Model, *, slots: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None):
        resolve_device(model.device)
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = None
        self.pos = np.zeros(slots, np.int64)      # per-slot write position
        self.last_tok = np.zeros(slots, np.int64)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _prefill_one(self, req: Request):
        """Prefill a single request and return (next_token, slot_cache)."""
        toks = torch.as_tensor(np.asarray(req.tokens)[None, :],
                               dtype=torch.int32).to(self.model.device)
        logits, cache = self.model.prefill({"tokens": toks})
        cache = pad_cache(self.model, cache, self.max_len - len(req.tokens),
                          1, len(req.tokens))
        return int(torch.argmax(logits, dim=-1)[0]), cache

    def _splice(self, slot: int, slot_cache):
        """Write a 1-batch cache into the batched cache at ``slot``."""
        if self.cache is None:
            self.cache = {k: x.new_zeros((x.shape[0], self.slots)
                                         + x.shape[2:])
                          for k, x in slot_cache.items()}
        for k, one in slot_cache.items():
            self.cache[k][:, slot] = one[:, 0]

    def _refill_slots(self):
        for s in range(self.slots):
            if self.active[s] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            tok, slot_cache = self._prefill_one(req)
            self._splice(s, slot_cache)
            self.active[s] = req
            self.pos[s] = len(req.tokens)
            self.last_tok[s] = tok
            req.out.append(tok)

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One decode step across all busy slots. Returns False when idle."""
        self._refill_slots()
        busy = [s for s in range(self.slots) if self.active[s] is not None]
        if not busy:
            return False
        dev = self.model.device
        toks = torch.as_tensor(self.last_tok[:, None]).to(dev)
        logits, self.cache = self.model.decode_step(
            self.cache, toks, torch.as_tensor(self.pos).to(dev))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in busy:
            req = self.active[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.last_tok[s] = tok
            self.pos[s] += 1
            if (len(req.out) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                self.active[s] = None
        return True

    def run(self, max_steps: int = 10_000) -> List[Request]:
        all_reqs = list(self.queue)
        for _ in range(max_steps):
            if not self.step():
                break
        return [r for r in all_reqs if r.done] or all_reqs
