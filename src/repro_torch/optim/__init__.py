"""Optimizer of the port (``repro.optim``): AdamW with float32 moments,
global-norm clipping, SGD, and the cosine warmup schedule."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    sgd_update,
)
from repro_torch.optim.schedule import cosine_warmup_schedule  # noqa: F401
