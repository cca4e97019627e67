"""Architecture configs of the port. Importing this package registers the
ported architectures: the three ``dense`` ones, which share one code path
(qwen2 adds ``qkv_bias``), the ``ssm`` mamba2-1.3b and the ``hybrid``
recurrentgemma-9b. The reference's other architectures raise in
:func:`get_config`, naming their ROADMAP item.

``--arch`` ids use dashes (e.g. ``llama3.2-3b``); module names use
underscores.
"""
from repro_torch.configs import (  # noqa: F401
    granite_3_8b,
    llama3_2_3b,
    mamba2_1_3b,
    qwen2_72b,
    recurrentgemma_9b,
)
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

ALL_ARCHS = ["mamba2-1.3b", "qwen2-72b", "recurrentgemma-9b", "llama3.2-3b",
             "granite-3-8b"]
