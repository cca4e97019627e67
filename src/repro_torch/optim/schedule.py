"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step counter, computed in float32 as the reference computes them."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def cosine_warmup_schedule(cfg: OptimizerConfig):
    """``lr(step)``: linear warmup to ``cfg.lr`` over ``warmup_steps``,
    then a cosine decay to ``min_lr_ratio * lr`` at ``total_steps``. The
    step is an int or a tensor; the result is a 0-d float32 tensor on the
    step's device (the CPU for an int)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.lr * step / max(1.0, cfg.warmup_steps)
        denom = max(1.0, cfg.total_steps - cfg.warmup_steps)
        frac = torch.clamp((step - cfg.warmup_steps) / denom, 0.0, 1.0)
        cos = cfg.min_lr_ratio * cfg.lr + 0.5 * (1 - cfg.min_lr_ratio) * \
            cfg.lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr
