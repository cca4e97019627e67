"""Deterministic synthetic token pipeline for LM serving (port of
``repro.data.pipeline``).

Tokens are drawn with numpy exactly as the reference draws them, so they
are byte-equal to its tokens for the same arguments; only the containers
differ (torch tensors on the asked device instead of JAX arrays).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


class TokenStream:
    """Infinite reproducible token stream with learnable structure."""

    def __init__(self, vocab_size: int, seed: int = 0, order: int = 1,
                 zipf_a: float = 1.2, effective_vocab: int = 2048):
        self.vocab_size = vocab_size
        self.eff = min(effective_vocab, vocab_size)
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, self.eff + 1, dtype=np.float64)
        self.unigram = ranks ** (-zipf_a)
        self.unigram /= self.unigram.sum()
        # sparse bigram structure: each token has a few preferred successors
        self.succ = self.rng.integers(0, self.eff, size=(self.eff, 4))

    def tokens(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int32)
        prev = int(self.rng.choice(self.eff, p=self.unigram))
        for i in range(n):
            if self.rng.random() < 0.5:
                prev = int(self.succ[prev, self.rng.integers(0, 4)])
            else:
                prev = int(self.rng.choice(self.eff, p=self.unigram))
            out[i] = prev
        return out

    def batches(self, batch: int, seq_len: int,
                device="cuda") -> Iterator[dict]:
        dev = resolve_device(device)
        while True:
            toks = self.tokens(batch * (seq_len + 1)).reshape(batch,
                                                              seq_len + 1)
            yield {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                   "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def make_lm_batch(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                  frontend_tokens: int = 0, d_model: int = 0,
                  encoder_len: int = 0, device="cuda") -> dict:
    """One concrete batch: int32 ``tokens``/``targets`` (B, seq_len) and,
    when asked, float32 frontend or encoder embeddings."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(batch, seq_len + 1),
                        dtype=np.int32)
    out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
           "targets": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    if frontend_tokens and encoder_len == 0:
        out["frontend_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (batch, frontend_tokens, d_model))
            .astype(np.float32)).to(dev)
    if encoder_len:
        out["encoder_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (batch, encoder_len, d_model))
            .astype(np.float32)).to(dev)
    return out
