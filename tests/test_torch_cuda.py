"""Card-only tests of the port: the hand-written CUDA kernel against its
plain PyTorch version, and the port on the card against the port on the
CPU. Every test here is marked ``cuda`` and skips (with its reason) where
CUDA is absent; this file imports neither JAX nor ``repro``, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernel within rtol 1e-5 and an atol floor of 1e-5 of the
plain version (float32, other summation order), bitwise equal across
launches; whole scenarios with ledgers exactly equal and F1 within the
port's bound of 5e-3 (PERF.md)."""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import KERNEL_SHAPES, kernel_inputs
from repro_torch.core import scenario
from repro_torch.data.synthetic_covtype import make_covtype_like
from repro_torch.kernels import loo_trials as loo

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    return torch.device("cuda")


def test_kernel_matches_plain_version(cuda):
    for i, (L, R, D, M) in enumerate(KERNEL_SHAPES):
        args = kernel_inputs(L, R, D, M, seed=100 + i, device=cuda)
        before = loo.launches
        out = loo.loo_trials(*args)
        again = loo.loo_trials(*args)
        assert loo.launches == before + 2
        torch.testing.assert_close(out, loo.loo_trials_ref(*args),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(out, again)


def test_kernel_wrapper_refuses_what_it_cannot_run(cuda):
    args = kernel_inputs(2, 64, 23, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        loo.loo_trials(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                       *args[1:])
    wide = kernel_inputs(1, 8, 130, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="D <= 128"):
        loo.loo_trials(*wide)


@pytest.mark.parametrize("algo,tech", [("star", "4g"), ("a2a", "wifi")])
def test_scenario_on_the_card_matches_the_cpu(cuda, algo, tech):
    data = make_covtype_like(n_total=3000, seed=0)
    cfg = scenario.ScenarioConfig(windows=3, eval_every=1, algo=algo,
                                  tech=tech, p_edge=0.15)
    loo.reset_launches()
    on_card = scenario.run_scenario(cfg, data, device=cuda)
    assert loo.launches > 0
    on_cpu = scenario.run_scenario(dataclasses.replace(cfg), data,
                                   device="cpu")
    assert on_card.ledger.events == on_cpu.ledger.events
    np.testing.assert_allclose(on_card.f1_curve, on_cpu.f1_curve, rtol=0,
                               atol=5e-3)
