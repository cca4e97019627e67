"""The frozen yardstick equals the port's arithmetic today, at the cells'
shapes; its counts of the benchmark's configurations are frozen to the
integer; it counts DeepSeek-V3's widths (MLA, shared experts, leading
dense layers) as the port does, and a card's share of the experts by
hand."""
import dataclasses

import pytest

from perfbench import program, registry, yardstick
from repro_torch.configs import get_config
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


# param_count, matmul_params_per_token and model_flops(c, 1000) of each
# configuration, as the benchmark has measured them since it has had them
FROZEN = {"olmoe-1b-7b": (6_919_094_272, 1_178_927_104, 2_357_854_208_000.0),
          "mamba2-1.3b": (1_343_444_992, 1_343_444_992, 2_686_889_984_000.0),
          "minicpm3-4b": (4_073_809_920, 4_073_809_920, 8_147_619_840_000.0)}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_counts_are_frozen(name):
    c = registry.config(name)
    got = (yardstick.param_count(c), yardstick.matmul_params_per_token(c),
           yardstick.model_flops(c, 1000))
    assert got == FROZEN[name]
    assert all(type(g) is type(f) for g, f in zip(got, FROZEN[name]))


def test_mla_model_is_the_ports():
    c = registry.config("minicpm3-4b")
    cfg = program.port_config(c)
    assert yardstick.param_count(c) == cfg.param_count() == \
        yardstick.active_param_count(c) == cfg.active_param_count()
    for S in (346, 1537):
        assert yardstick.model_flops(c, S) == analysis.model_flops_for(
            cfg, InputShape("cell", S, 1, "prefill"))


@pytest.mark.parametrize("shape", [(1, 40, S, S, 96, 64, True, "bfloat16")
                                   for S in (64, 1537)])
def test_mla_attention_cost(shape):
    assert yardstick.mla_attention_cost(shape) == \
        costs.mla_attention_cost(shape)


# DeepSeek-V3 at its published widths, under the published config's keys
# (https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json),
# with ``num_experts`` the experts held here
DEEPSEEK = dict(
    name="deepseek-v3-671b", hidden_size=7168, num_hidden_layers=61,
    num_attention_heads=128, num_key_value_heads=128, q_lora_rank=1536,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, intermediate_size=18432, moe_intermediate_size=2048,
    num_experts=256, num_experts_per_tok=8, n_shared_experts=1,
    first_k_dense_replace=3, vocab_size=129280, tie_word_embeddings=False)


def test_deepseek_v3_is_the_ports():
    """Without the multi-token-prediction module (which the yardstick does
    not count): 671 B parameters, 37 B active."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              num_mtp_modules=0)
    assert yardstick.param_count(DEEPSEEK) == cfg.param_count()
    assert yardstick.active_param_count(DEEPSEEK) == cfg.active_param_count()
    assert 671e9 < yardstick.param_count(DEEPSEEK) < 672e9
    assert 37e9 < yardstick.active_param_count(DEEPSEEK) < 38e9
    assert yardstick.matmul_params_per_token(DEEPSEEK) == \
        cfg.active_param_count() - 129280 * 7168


def test_a_cards_share_of_the_experts():
    """8 of 256 experts held here, the router at its published 256: a
    token's top 8 of 256 lands on 8 * 8 / 256 = 1/4 of an expert here on
    average, beside the shared one."""
    c = dict(DEEPSEEK, num_experts=8, router_experts=256)
    d, de, v = 7168, 2048, 129280
    mla = (d * 1536 + 1536 * 128 * 192 + d * (512 + 64)
           + 512 * 128 * (128 + 128) + 128 * 128 * d)
    dense = mla + 3 * d * 18432 + 2 * d
    moe = mla + d * 256 + 3 * d * de * (8 + 1) + 2 * d
    total = 2 * v * d + 3 * dense + 58 * moe
    assert yardstick.param_count(c) == total
    idle = 3 * d * de * 8 - 3 * d * de // 4       # 8 held, 1/4 used
    assert yardstick.active_param_count(c) == total - 58 * idle
    assert yardstick.matmul_params_per_token(c) == \
        total - 58 * idle - v * d
    # every expert held here: the router's width and the top 8 as published
    whole = dict(c, num_experts=256)
    assert yardstick.active_param_count(whole) == \
        yardstick.active_param_count(dict(DEEPSEEK))


@pytest.mark.parametrize("name,drop", [
    ("olmoe-1b-7b", "head_dim"), ("olmoe-1b-7b", "moe_intermediate_size"),
    ("minicpm3-4b", "intermediate_size"), ("minicpm3-4b", "v_head_dim"),
    ("mamba2-1.3b", "conv_kernel")])
def test_widths_it_cannot_count_raise(name, drop):
    c = registry.config(name)
    del c[drop]
    with pytest.raises(ValueError):
        yardstick.param_count(c)


def test_an_ssd_layer_beside_attention_raises():
    c = dict(registry.config("mamba2-1.3b"), num_attention_heads=32)
    with pytest.raises(ValueError):
        yardstick.param_count(c)
