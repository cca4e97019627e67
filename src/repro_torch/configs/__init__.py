"""Architecture configs of the port. Importing this package registers the
ported architectures: the three ``dense`` ones, which share one code path
(qwen2 adds ``qkv_bias``). The reference's other architectures raise in
:func:`get_config`, naming their ROADMAP item.

``--arch`` ids use dashes (e.g. ``llama3.2-3b``); module names use
underscores.
"""
from repro_torch.configs import granite_3_8b, llama3_2_3b, qwen2_72b  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    NOT_PORTED,
    HTLConfig,
    InputShape,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
    get_config,
    list_configs,
)

ALL_ARCHS = ["qwen2-72b", "llama3.2-3b", "granite-3-8b"]
