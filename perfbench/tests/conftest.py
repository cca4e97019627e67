"""Shared fixtures of the benchmark's CPU tests:

    PYTHONPATH=src python -m pytest -q perfbench/tests

``tiny_root`` is a copy of the benchmark's folder whose configurations and
mixes are cut to a size the CPU runs in seconds (the widths below, the
dtype as stated: bfloat16). Its limits hold the numbers the committed
limits name, set as the committed ones are, between the sound program's
largest and the control's smallest reading over 6 seeds at the tiny size:
olmoe long-prompt ``mean_logit_gap`` 0.00003-0.0022 against 0.0095-0.0199
and ``mean_kv_error`` 0.0035-0.0051 against 0.044-0.048; olmoe chat
0.00015-0.0033 against 0.0118-0.0288; mamba2 ``max_logit_gap``
0.011-0.034 against 0.30-0.64 (long-prompt) and 0.003-0.031 against
0.29-0.45 (chat). Each fault of :mod:`perfbench.faults` reads above one
of a cell's limits: olmoe at least 0.034 (chat; long-prompt's cache left
unwritten reads a ``mean_kv_error`` of 1.0), mamba2 at least 4.2.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

torch.set_num_threads(2)

TINY = {
    "olmoe-1b-7b": dict(num_hidden_layers=2, hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=4,
                        head_dim=16, vocab_size=256, num_experts=8,
                        num_experts_per_tok=2, moe_intermediate_size=32,
                        capacity_factor=4.0),
    "mamba2-1.3b": dict(num_hidden_layers=2, hidden_size=64, head_dim=16,
                        state_size=16, chunk_size=32, vocab_size=256),
}
TINY_MIX = {
    "long-prompt": dict(clients=4, slots=4, max_len=145, token_ids_below=250,
                        check_tokens=40,
                        prompt_tokens={"dist": "loguniform", "lo": 32,
                                       "hi": 128},
                        output_tokens={"dist": "loguniform", "lo": 4,
                                       "hi": 16}),
    "chat": dict(clients=4, slots=4, max_len=97, token_ids_below=250,
                 check_tokens=40,
                 prompt_tokens={"dist": "loguniform", "lo": 8, "hi": 64},
                 output_tokens={"dist": "loguniform", "lo": 4, "hi": 32}),
}

TINY_LIMITS = {"olmoe-1b-7b.long-prompt": {"mean_logit_gap": 0.01,
                                           "mean_kv_error": 0.015},
               "olmoe-1b-7b.chat": {"mean_logit_gap": 0.007},
               "mamba2-1.3b.long-prompt": {"max_logit_gap": 0.12},
               "mamba2-1.3b.chat": {"max_logit_gap": 0.12}}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from perfbench import registry
    root = tmp_path_factory.mktemp("perfbench")
    shutil.copytree(registry.ROOT, root, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, widths in TINY.items():
        c = registry.config(name)
        c.update(widths)
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, params in TINY_MIX.items():
        m = registry.mix(name)
        m.update(params)
        (root / "mixes" / f"{name}.json").write_text(json.dumps(m))
    for cell, limits in TINY_LIMITS.items():
        assert set(limits) == set(registry.limits(cell))
        (root / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    return root
