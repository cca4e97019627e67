"""The MLA names of the one frozen yardstick, :mod:`perfbench.yardstick`,
which counts an MLA model from its widths like any other. Kept only for
``tests/test_torch_mla_reference.py`` at the repository's root, which
imports this module; nothing in the benchmark does."""
from perfbench.yardstick import (  # noqa: F401
    matmul_params_per_token, mla_attention_cost, model_flops, param_count,
)
