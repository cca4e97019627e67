"""Minimal batched serving engine: prefill once, decode greedily or
sampled (port of ``repro.serving.engine``).

The model holds its own parameters, so the engine takes only the model.
Sampling draws from an explicit ``torch.Generator`` on the model's device
(``torch.multinomial`` over the tempered softmax); it is a different
random stream from the reference's ``jax.random.categorical``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.cache_utils import pad_cache


class ServeEngine:
    def __init__(self, model: Model, max_new_tokens: int = 32):
        resolve_device(model.device)
        self.model = model
        self.max_new = max_new_tokens

    def generate(self, batch: dict, *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        """batch: {"tokens": (B, S) on the model's device}.

        Returns (B, max_new) generated token ids (greedy if temperature=0).
        """
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a generator")
        tokens = batch["tokens"]
        B, S = tokens.shape
        logits, cache = self.model.prefill(batch)
        cache = pad_cache(self.model, cache, self.max_new, B, S)

        out = []
        for i in range(self.max_new):
            if temperature > 0.0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            pos = torch.full((), S + i, dtype=torch.long, device=tok.device)
            logits, cache = self.model.decode_step(cache, tok[:, None], pos)
        return torch.stack(out, dim=1)
