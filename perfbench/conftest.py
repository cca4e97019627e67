"""The tiny sizes of configurations that entered the benchmark after
``perfbench/tests/conftest.py`` was written, laid into its ``tiny_root`` (a
session fixture; autouse here), so that the tests that run every cell on
the CPU run these at a tiny size too, never at the published one.

minicpm3-4b: every width cut, q through a latent as published. Its
``chat`` limit is set as the committed one is, between the sound
program's largest and the control's smallest reading over 8 seeds at
this size: ``mean_logit_gap`` 0.0000094-0.00055 against 0.0127-0.031
(``max_logit_gap`` 0.0016-0.047 against 0.43-0.84). Each fault of
:mod:`perfbench.faults` reads a ``mean_logit_gap`` of at least 0.33.
"""
import json

import pytest

TINY = {
    "minicpm3-4b": dict(num_hidden_layers=2, hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=4,
                        intermediate_size=96, vocab_size=256,
                        q_lora_rank=32, kv_lora_rank=32,
                        qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16),
}
TINY_LIMITS = {"minicpm3-4b.chat": {"mean_logit_gap": 0.003}}


@pytest.fixture(scope="session", autouse=True)
def tiny_later_configs(tiny_root):
    from perfbench import registry
    for name, widths in TINY.items():
        c = registry.config(name)
        c.update(widths)
        (tiny_root / "configs" / f"{name}.json").write_text(json.dumps(c))
    for cell, limits in TINY_LIMITS.items():
        assert set(limits) == set(registry.limits(cell))
        (tiny_root / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    return tiny_root
