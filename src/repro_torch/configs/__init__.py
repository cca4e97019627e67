"""Architecture configs of the port. Importing this package registers
every architecture of the reference: the ``dense`` ones (llama3.2-3b,
granite-3-8b, qwen2-72b with ``qkv_bias``, minicpm3-4b with MLA), the
``moe`` ones (olmoe-1b-7b; deepseek-v3-671b with MLA, dense-first layers
and a shared expert), the ``ssm`` mamba2-1.3b, the ``hybrid``
recurrentgemma-9b, the ``vlm`` llava-next-mistral-7b and the ``audio``
whisper-medium.

``--arch`` ids use dashes (e.g. ``llama3.2-3b``); module names use
underscores.
"""
from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    granite_3_8b,
    llama3_2_3b,
    llava_next_mistral_7b,
    mamba2_1_3b,
    minicpm3_4b,
    olmoe_1b_7b,
    qwen2_72b,
    recurrentgemma_9b,
    whisper_medium,
)
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    HTLConfig,
    InputShape,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
    get_config,
    list_configs,
)

ALL_ARCHS = [
    "whisper-medium",
    "llava-next-mistral-7b",
    "mamba2-1.3b",
    "qwen2-72b",
    "recurrentgemma-9b",
    "minicpm3-4b",
    "llama3.2-3b",
    "olmoe-1b-7b",
    "granite-3-8b",
    "deepseek-v3-671b",
]
