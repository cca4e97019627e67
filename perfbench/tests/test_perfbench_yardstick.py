"""The frozen yardstick equals the port's arithmetic today, at the cells'
shapes."""
import pytest

from perfbench import program, registry, yardstick
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.roofline import analysis, costs

FLASH = [(1, 16, 16, S, S, 128, True, 0, 0, "bfloat16")
         for S in (64, 750, 1024, 1537, 1623, 3000)]
SSD = [(1, S, 64, 64, 128, 256, "bfloat16") for S in (64, 750, 1024, 1623,
                                                      3000)]


@pytest.mark.parametrize("shape", FLASH)
def test_flash_cost(shape):
    assert yardstick.flash_pairs(shape) == costs.flash_pairs(shape)
    assert yardstick.flash_cost(shape) == costs.flash_cost(shape)
    assert yardstick.bound(*yardstick.flash_cost(shape), "bfloat16") == \
        costs.bound(*costs.flash_cost(shape), "bfloat16")


@pytest.mark.parametrize("shape", SSD)
def test_ssd_cost(shape):
    assert yardstick.ssd_cost(shape) == costs.ssd_cost(shape)
    assert yardstick.bound(*yardstick.ssd_cost(shape), "bfloat16") == \
        costs.bound(*costs.ssd_cost(shape), "bfloat16")


def test_peaks():
    assert yardstick.HBM_BYTES_PER_S == costs.HBM_BYTES_PER_S
    assert yardstick.PEAK_FLOPS_PER_S == costs.PEAK_FLOPS_PER_S
    assert yardstick.PEAK_FLOPS_PER_S["bfloat16"] == analysis.HW.peak_flops


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mamba2-1.3b"])
def test_model_flops(name):
    c = registry.config(name)
    cfg = program.port_config(c)
    assert yardstick.param_count(c) == cfg.param_count()
    assert yardstick.active_param_count(c) == cfg.active_param_count()
    for S in (1623, 3000):
        shape = InputShape("cell", S, 1, "prefill")
        assert 2.0 * yardstick.active_param_count(c) * S == \
            analysis.model_flops_for(cfg, shape)
    assert analysis.model_flops_for(cfg, INPUT_SHAPES["decode_32k"]) == \
        2.0 * yardstick.active_param_count(c) * 128
    lookup = 0 if c["tie_word_embeddings"] else \
        c["vocab_size"] * c["hidden_size"]
    assert yardstick.matmul_params_per_token(c) == \
        cfg.active_param_count() - lookup
    assert yardstick.model_flops(c, 10) == \
        20.0 * yardstick.matmul_params_per_token(c)
