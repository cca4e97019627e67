"""The one traffic generator: a stream of requests drawn from a mix file's
parameters (``mixes/<name>.json``) and the run's seed.

Lengths are stratified: each cycle of ``pool`` requests holds the same
``pool`` prompt lengths and the same ``pool`` output budgets, at the
quantiles (i + 0.5) / pool of the mix's distributions, in an order the
seed permutes (prompt lengths and budgets apart). Every seed therefore
offers the same work in another order, and runs with different seeds
differ about as much as two runs of one seed. Token ids are uniform below
``token_ids_below``, drawn per request from (seed, request index), so the
i-th request of a stream is the same whichever client sends it.

Distributions: ``loguniform`` (lo..hi, rounded to an integer) and
``uniform`` (the integers lo..hi, each equally often).
"""
from __future__ import annotations

import numpy as np

SEED_MOD = 2 ** 64


def seed_words(seed: int, *more: int):
    """A numpy seed sequence entropy from any whole number (negative and
    beyond 64 bits included) and further words."""
    return [int(seed) % SEED_MOD, *more]


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n integer lengths at the quantiles (i + 0.5) / n of ``dist``."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "loguniform":
        v = np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    if dist["dist"] == "uniform":
        return (lo + np.floor(q * (hi - lo + 1))).astype(np.int64)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


class Traffic:
    """The request stream of one mix under one seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed
        self.pool = int(mix["pool"])
        self.prompts = quantiles(mix["prompt_tokens"], self.pool)
        self.budgets = quantiles(mix["output_tokens"], self.pool)
        self._cycles: dict = {}

    def _cycle(self, k: int):
        if k not in self._cycles:
            rng = np.random.default_rng(seed_words(self.seed, 0, k))
            self._cycles[k] = (self.prompts[rng.permutation(self.pool)],
                               self.budgets[rng.permutation(self.pool)])
        return self._cycles[k]

    def spec(self, i: int):
        """(prompt length, output budget) of the i-th request."""
        prompts, budgets = self._cycle(i // self.pool)
        return int(prompts[i % self.pool]), int(budgets[i % self.pool])

    def tokens(self, i: int) -> np.ndarray:
        """The prompt token ids of the i-th request."""
        n, _ = self.spec(i)
        rng = np.random.default_rng(seed_words(self.seed, 1, i))
        return rng.integers(0, self.mix["token_ids_below"], n,
                            dtype=np.int64)

    def head_start(self, slots: int) -> np.ndarray:
        """Fractions in (0, 1), one per slot, of its first request's budget
        already served when the run opens (stratified, permuted by the
        seed): the slots start staggered, as in steady state."""
        rng = np.random.default_rng(seed_words(self.seed, 2))
        return (rng.permutation(slots) + 0.5) / slots
