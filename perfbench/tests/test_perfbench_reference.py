"""Each family's plain reference matches the port on the CPU at a tiny
size: the last logits of a prefill, and the logits of decode steps through
the port's cache, in float32 on both sides."""
import json

import pytest
import torch

from perfbench import program, registry, weights
from perfbench.tests.conftest import TINY


def tiny(name, **more):
    c = registry.config(name)
    c.update(TINY[name], dtype="float32", **more)
    return c


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-1.3b"])
@pytest.mark.parametrize("S", [37, 64])
def test_reference_matches_the_port(name, S):
    c = tiny(name)
    ref = registry.reference_of(c)
    w = weights.make(ref.leaves(c), 5, torch.float32, "cpu")
    from repro_torch.models.model import Model
    from repro_torch.serving.cache_utils import pad_cache
    model = Model(program.port_config(c), device="cpu").load_params(w)
    g = torch.Generator().manual_seed(S)
    toks = torch.randint(0, 250, (S + 6,), generator=g)
    want = ref.forward(c, w, toks, S - 1)                 # (7, V)
    logits, cache = model.prefill({"tokens": toks[None, :S]})
    torch.testing.assert_close(logits[0], want[0], atol=2e-4, rtol=2e-4)
    cache = pad_cache(model, cache, 8, 1, S)
    for i in range(6):
        logits, cache = model.decode_step(
            cache, toks[None, S + i:S + i + 1], torch.tensor(S + i))
        torch.testing.assert_close(logits[0], want[i + 1], atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("S", [37, 64])
def test_reference_cache_entries_are_the_ports(S):
    """The keys and values the attention reference gives at decode
    positions are what the port's decode steps write into its cache."""
    c = tiny("olmoe-1b-7b")
    ref = registry.reference_of(c)
    w = weights.make(ref.leaves(c), 7, torch.float32, "cpu")
    from repro_torch.models.model import Model
    from repro_torch.serving.cache_utils import pad_cache
    model = Model(program.port_config(c), device="cpu").load_params(w)
    toks = torch.randint(0, 250, (S + 5,), generator=torch.Generator()
                         .manual_seed(S))
    _, cache = model.prefill({"tokens": toks[None, :S]})
    cache = pad_cache(model, cache, 8, 1, S)
    for i in range(5):
        _, cache = model.decode_step(cache, toks[None, S + i:S + i + 1],
                                     torch.tensor([S + i]))
    at = torch.arange(S - 2, S + 5)
    _, kv = ref.forward(c, w, toks, S - 1, kv_at=at)   # (7, L, 2 KV hd)
    got = torch.cat([cache["k"][:, 0, at].flatten(2),
                     cache["v"][:, 0, at].flatten(2)], -1).transpose(0, 1)
    torch.testing.assert_close(got, kv, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-1.3b"])
def test_control_reads_lower_precision(name):
    c = tiny(name)
    ref = registry.reference_of(c)
    w = weights.make(ref.leaves(c), 6, torch.float32, "cpu")
    toks = torch.randint(0, 250, (80,), generator=torch.Generator()
                         .manual_seed(1))
    hi = ref.forward(c, w, toks, 0)
    lo = ref.forward(c, w, toks, 0, "fp8")
    err = (hi - lo).abs().max()
    assert 1e-3 < err < 10 * hi.std()
    with pytest.raises(ValueError):
        ref.forward(c, w, toks, 0, "int3")


def test_ssd_chunking_is_exact():
    from perfbench.reference import ssm
    g = torch.Generator().manual_seed(0)
    S, H, P, N = 150, 3, 4, 5
    x = torch.randn(S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(S, H, generator=g, dtype=torch.float64) * 0.2
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    B = torch.randn(S, N, generator=g, dtype=torch.float64)
    C = torch.randn(S, N, generator=g, dtype=torch.float64)
    s = torch.zeros(H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):       # the recurrence, one step at a time
        s = s * torch.exp(dt[t] * A)[:, None, None] + \
            (dt[t][:, None] * x[t])[..., None] * B[t]
        want.append(s @ C[t])
    for Q in (16, 64, 150):
        torch.testing.assert_close(ssm.ssd(x, dt, A, B, C, Q),
                                   torch.stack(want), atol=1e-10, rtol=1e-10)


def test_leaves_are_the_ports_template():
    from repro_torch.models.model import Model
    from repro_torch.sharding.partitioning import flatten
    for name in TINY:
        c = tiny(name)
        ref = registry.reference_of(c)
        model = Model(program.port_config(c), device="meta")
        want = {p: tuple(s.shape) for p, s in flatten(model.template())}
        assert {p: tuple(s) for p, (s, _) in ref.leaves(c).items()} == want
    json.dumps(ref.leaves(c))
