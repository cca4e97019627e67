"""The weights of a run, made from its seed on its device.

One ``torch.Generator`` on the device, seeded from the run's seed, fills
each leaf of the family's layout (``reference/<family>.leaves``) in one
call, in the dtype the model is served in. Layers are stacked in a leaf
(the port's layout), so a model is a dozen or so calls, not one per
layer. Initialisers:

* ("normal", fan_in): N(0, 1 / fan_in), so every product keeps its
  input's scale and the logits have a spread of about one;
* "ones", "zeros": norm scales, skip weights and biases;
* "dt_bias": softplus^-1 of U[1e-3, 1e-1); "a_log": log U[1, 16), the
  Mamba-2 initialisers.

The same seed gives the same weights on every run, which the program
(through ``Model.load_params``) and the reference both receive.
"""
from __future__ import annotations

import math

import torch

from perfbench.traffic import seed_words

SEED_MOD = 2 ** 63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_words(seed)[0] % SEED_MOD)
    return g


@torch.no_grad()
def make(leaves: dict, seed: int, dtype, device) -> dict:
    """{path: tensor} for ``leaves`` ({path: (shape, init)})."""
    g = generator(seed, device)
    out = {}
    for path in sorted(leaves):
        shape, init = leaves[path]
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif init in ("dt_bias", "a_log"):
            lo, hi = (1e-3, 1e-1) if init == "dt_bias" else (1.0, 16.0)
            u = torch.rand(shape, generator=g, dtype=torch.float32,
                           device=device) * (hi - lo) + lo
            v = torch.log(torch.expm1(u)) if init == "dt_bias" \
                else torch.log(u)
            out[path] = v.to(dtype)
        else:
            kind, fan_in = init
            if kind != "normal":
                raise ValueError(f"{path}: unknown initialiser {init!r}")
            t = torch.randn(shape, generator=g, dtype=dtype, device=device)
            out[path] = t.mul_(1.0 / math.sqrt(fan_in))
    return out


def nbytes(weights: dict) -> int:
    return sum(t.numel() * t.element_size() for t in weights.values())
