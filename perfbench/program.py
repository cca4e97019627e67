"""The system under test: the port's model and its continuous batcher,
built from a configuration file.

The configuration file names the port's registered architecture
(``arch``) and maps each of its widths onto a field of the port's
``ModelConfig`` (``port_fields``: config key -> field, ``moe.top_k`` for
a field of a sub-config). The harness sets every mapped field from the
file, so the program runs the widths the file states, whatever the
port's registered config holds. Nothing here imports the port until a
run builds it.
"""
from __future__ import annotations

import dataclasses


def port_config(c: dict):
    """The port's ``ModelConfig`` of configuration file ``c``."""
    from repro_torch.configs import get_config

    cfg = get_config(c["arch"])
    top, sub = {}, {}
    for key, field in c["port_fields"].items():
        group, _, name = field.rpartition(".")
        (sub.setdefault(group, {}) if group else top)[name] = c[key]
    for group, values in sub.items():
        top[group] = dataclasses.replace(getattr(cfg, group), **values)
    cfg = dataclasses.replace(cfg, **top)
    if cfg.family != c["family"]:
        raise ValueError(f"{c['name']}: the port's {c['arch']} is family "
                         f"{cfg.family!r}, the file says {c['family']!r}")
    return cfg


def build(c: dict, weights: dict, mix: dict, device):
    """(model, batcher, request class): the port's ``Model`` with
    ``weights`` loaded, behind a ``ContinuousBatcher`` of the mix's slots
    and ``max_len``, with no end-of-sequence token (every request runs
    its whole budget)."""
    from repro_torch.models.model import Model
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    model = Model(port_config(c), device=device).load_params(weights)
    batcher = ContinuousBatcher(model, slots=mix["slots"],
                                max_len=mix["max_len"], eos_id=None)
    return model, batcher, Request
