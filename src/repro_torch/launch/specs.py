"""Input specs for every (architecture x input-shape) combo (port of
``repro.launch.specs``).

``input_specs`` returns a :class:`TensorSpec` (shape, dtype, partition
spec) per input of the function the shape's kind runs, never an
allocation:

* train_4k     -> ``train_step(params, opt_state, batch, step)``
* prefill_32k  -> ``prefill(params, batch)``
* decode_32k / long_500k -> ``decode_step(params, cache, tokens, pos)``

The reference's 0-dim int32 scalars (``pos``, ``step``, the optimizer's
``count``) stay 0-dim. VLM note: seq_len is the *total* context; the
anyres image prefix (2880 frontend tokens) is carved out of it. Whisper
note: seq_len is the decoder length; the encoder is fixed at 1500
stub-frontend frames.

A mesh is a ``DeviceMesh`` or any object whose ``.shape`` maps axis name
to size (:func:`repro_torch.sharding.partitioning.mesh_axes`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES, MULTIPOD_RULES, P, PartitionSpec, logical_to_pspec,
    mesh_axes, param_pspecs, spec_axes, torch_dtype,
)

LLAMA_LONG_WINDOW = 8192   # documented sliding-window variant for long_500k


class TensorSpec(NamedTuple):
    """A tensor's shape, dtype and :class:`PartitionSpec`: the port's
    ``jax.ShapeDtypeStruct`` with a sharding."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: PartitionSpec = P()

    def meta(self) -> torch.Tensor:
        """A meta tensor of this shape and dtype (no storage)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def rules_for(mesh) -> dict:
    return MULTIPOD_RULES if "pod" in mesh_axes(mesh) else DEFAULT_RULES


def param_rules_for(mesh, shape: Optional[InputShape] = None,
                    cfg: Optional[ModelConfig] = None,
                    weight_stationary_decode: bool = True) -> dict:
    """Weight sharding rules, specialised per workload: a decode step keeps
    its weights stationary (TP over 'model' only, no FSDP all-gather of
    every weight per token), with MoE experts sharded over both axes."""
    rules = dict(rules_for(mesh))
    if (weight_stationary_decode and shape is not None
            and shape.kind == "decode"):
        rules["embed"] = None
        rules["experts"] = rules["experts_both"]
    return rules


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The documented per-shape variants: llama's sliding window at 500k;
    MoE decode uses expert parallelism over both mesh axes."""
    if shape.name == "long_500k" and cfg.name == "llama3.2-3b":
        cfg = dataclasses.replace(cfg, sliding_window=LLAMA_LONG_WINDOW)
    if shape.kind == "decode" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, expert_parallel="both")
    return cfg


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is in scope; the reason when it is skipped."""
    if shape.name == "long_500k":
        cfg = arch_for_shape(cfg, shape)
        if not (cfg.supports_long_context or cfg.sliding_window):
            return False, ("full attention is quadratic at 524k ctx; no "
                           "sub-quadratic variant implemented for this arch")
    return True, ""


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    rules = rules_for(mesh)
    B = shape.global_batch
    dt = torch_dtype(cfg.dtype)

    def ts(dims, dtype, axes):
        return TensorSpec(tuple(dims), dtype,
                          logical_to_pspec(axes, dims, mesh, rules))

    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        n_front = cfg.frontend.num_tokens if cfg.family == "vlm" else 0
        S_text = S - n_front
        out = {"tokens": ts((B, S_text), torch.int32, ("batch", "seq"))}
        if shape.kind == "train":
            out["targets"] = ts((B, S_text), torch.int32, ("batch", "seq"))
        if cfg.family == "vlm":
            out["frontend_embeds"] = ts((B, n_front, cfg.d_model), dt,
                                        ("batch", "seq", None))
        if cfg.family == "audio":
            out["encoder_embeds"] = ts((B, cfg.encoder_seq_len, cfg.d_model),
                                       dt, ("batch", "seq", None))
        return out

    # decode kinds
    return {"tokens": ts((B, 1), torch.int32, ("batch", None)),
            "pos": TensorSpec((), torch.int32)}


def _template_specs(template, mesh, rules, dtype):
    pspecs = param_pspecs(template, mesh, rules)

    def walk(t, p):
        if isinstance(p, PartitionSpec):
            return TensorSpec(t.shape, torch_dtype(t.dtype or dtype), p)
        return {k: walk(t[k], p[k]) for k in t}
    return walk(template, pspecs)


def param_specs(model: Model, mesh, rules: dict = None) -> dict:
    return _template_specs(model.template(), mesh, rules or rules_for(mesh),
                           model.dtype)


def _densify_spec(spec, shape, mesh) -> PartitionSpec:
    """ZeRO-1: extend a spec by sharding replicated dims over unused mesh
    axes (largest dims first). Optimizer moments are only updated
    element-wise and reduce-scattered, so sharding them maximally is free
    memory."""
    sizes = mesh_axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries for a in spec_axes(e)}
    free = [a for a in sizes if a not in used]
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is not None or not free:
            continue
        for a in list(free):
            if shape[i] % sizes[a] == 0:
                entries[i] = a
                free.remove(a)
                break
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _map_specs(fn, tree):
    if isinstance(tree, TensorSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def opt_state_specs(param_ts, mesh, zero1: bool = False) -> AdamWState:
    """AdamW moments (float32) laid out as the parameters; with ``zero1``
    sharded over every mesh axis their dims allow (off by default, as in
    the reference: a pure propagation pass reshards through the mismatched
    layouts)."""
    def mom(s):
        spec = _densify_spec(s.spec, s.shape, mesh) if zero1 else s.spec
        return TensorSpec(s.shape, torch.float32, spec)
    m = _map_specs(mom, param_ts)
    return AdamWState(count=TensorSpec((), torch.int32), mu=m,
                      nu=_map_specs(lambda x: x, m))


def cache_specs(model: Model, shape: InputShape, mesh) -> dict:
    t = model.cache_template(shape.global_batch, shape.seq_len)
    return _template_specs(t, mesh, rules_for(mesh), model.dtype)


def input_specs(cfg: ModelConfig, shape: InputShape, mesh,
                model: Optional[Model] = None,
                weight_stationary_decode: bool = True) -> dict:
    """Every :class:`TensorSpec` needed to run the step of this combo (the
    model is built on the meta device unless one is given)."""
    cfg = arch_for_shape(cfg, shape)
    model = model or build_model(cfg, device="meta")
    ps = param_specs(model, mesh,
                     param_rules_for(mesh, shape, cfg,
                                     weight_stationary_decode))
    out: dict[str, Any] = {"params": ps,
                           "batch": batch_specs(cfg, shape, mesh)}
    if shape.kind == "train":
        out["opt_state"] = opt_state_specs(ps, mesh)
        out["step"] = TensorSpec((), torch.int32)
    if shape.kind == "decode":
        out["cache"] = cache_specs(model, shape, mesh)
    return out
