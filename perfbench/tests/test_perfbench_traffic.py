"""The mixes are deterministic from the seed, and every seed offers the same
work in another order."""
import numpy as np
import pytest

from perfbench import registry
from perfbench.traffic import Traffic, quantiles

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -12)


@pytest.mark.parametrize("mix", ["long-prompt", "chat"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(mix, seed):
    m = registry.mix(mix)
    a, b = Traffic(m, seed), Traffic(m, seed)
    for i in (0, 1, 17, m["pool"] - 1, m["pool"], 3 * m["pool"] + 5):
        assert a.spec(i) == b.spec(i)
        assert np.array_equal(a.tokens(i), b.tokens(i))
    assert np.array_equal(a.head_start(m["slots"]), b.head_start(m["slots"]))


@pytest.mark.parametrize("mix", ["long-prompt", "chat"])
def test_every_seed_offers_the_same_lengths(mix):
    m = registry.mix(mix)
    cycles = []
    for seed in SEEDS:
        t = Traffic(m, seed)
        specs = [t.spec(i) for i in range(m["pool"])]
        cycles.append((sorted(p for p, _ in specs), sorted(b for _, b in specs),
                       specs))
    assert all(c[0] == cycles[0][0] and c[1] == cycles[0][1] for c in cycles)
    assert len({tuple(c[2]) for c in cycles}) == len(SEEDS)


@pytest.mark.parametrize("mix", ["long-prompt", "chat"])
def test_lengths_within_the_mix(mix):
    m = registry.mix(mix)
    t = Traffic(m, 99)
    for i in range(2 * m["pool"]):
        prompt, budget = t.spec(i)
        assert m["prompt_tokens"]["lo"] <= prompt <= m["prompt_tokens"]["hi"]
        assert m["output_tokens"]["lo"] <= budget <= m["output_tokens"]["hi"]
        # the batcher never cuts a request short
        assert prompt + budget <= m["max_len"] - 1
        toks = t.tokens(i)
        assert len(toks) == prompt and toks.max() < m["token_ids_below"]


def test_quantiles():
    u = quantiles({"dist": "uniform", "lo": 2, "hi": 8}, 700)
    assert sorted(set(u)) == list(range(2, 9))
    assert max(np.bincount(u)[2:]) - min(np.bincount(u)[2:]) <= 1
    lg = quantiles({"dist": "loguniform", "lo": 64, "hi": 1024}, 256)
    assert lg.min() >= 64 and lg.max() <= 1024
    assert abs(np.median(lg) - 256) < 8          # geometric midpoint
    with pytest.raises(ValueError):
        quantiles({"dist": "zipf", "lo": 1, "hi": 2}, 4)
