"""Three-term roofline of a dry-run record on the H100 (port of
``repro.roofline.analysis``):

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = (total - internode) / nvlink_bw + internode / ib_bw

per device (the trace's numbers are one device's). ``MODEL_FLOPS = 6 N D``
(N = active parameters for MoE) per training step, ``2 N D`` for inference
steps. ``dcn_bytes`` (the bytes crossing between pods, HTL's quantity) is
reported as the reference defines it; on a cluster of H100 nodes the slow
link is InfiniBand between 8-GPU NVLink nodes, so the collective term
splits at the node.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sharding.partitioning import torch_dtype


@dataclass(frozen=True)
class Hardware:
    """Per-device peaks; the defaults are the H100 SXM's data sheet."""
    peak_flops: float = 989e12        # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12           # HBM3 bytes/s
    nvlink_bw: float = 450e9          # NVLink 4 bytes/s, one direction
    ib_bw: float = 50e9               # InfiniBand NDR 400 Gb/s per GPU


HW = Hardware()


def roofline_from_record(rec: dict, hw: Hardware = HW) -> dict:
    """rec: one dry-run JSON record (see launch/dryrun.py). A record
    without ``internode_bytes`` (the reference's) puts its ``dcn_bytes``
    on the slow link."""
    chips = rec["num_devices"]
    flops = rec.get("flops", 0.0) or 0.0
    bytes_acc = rec.get("bytes_accessed", 0.0) or 0.0
    t_compute = flops / hw.peak_flops
    t_memory_hlo = bytes_acc / hw.hbm_bw
    t_memory = rec.get("analytic_bytes", bytes_acc) / hw.hbm_bw
    coll = rec.get("collectives", {})
    slow_b = coll.get("internode_bytes", coll.get("dcn_bytes", 0.0))
    fast_b = coll.get("total_bytes", 0.0) - slow_b
    t_coll = fast_b / hw.nvlink_bw + slow_b / hw.ib_bw

    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)

    out = dict(terms)
    out["memory_hlo_s"] = t_memory_hlo
    out["dominant"] = dominant.replace("_s", "")
    model_flops = rec.get("model_flops")
    if model_flops:
        total_flops = flops * chips
        out["model_flops"] = model_flops
        out["useful_fraction"] = (model_flops / total_flops
                                  if total_flops else None)
    step_time = max(terms.values())
    out["roofline_step_s"] = step_time
    if model_flops and step_time > 0:
        out["mfu_bound"] = model_flops / (chips * hw.peak_flops * step_time)
    return out


def analytic_memory_bytes(cfg, shape, num_devices: int) -> float:
    """Analytic per-device HBM traffic per step (ops fused as a compiler
    would).

    train:   params 3x (fwd + bwd + remat fwd) + grads w + adam m,v r/w (f32)
             + layer-boundary activation saves (w+r) + logits r/w (f32)
    prefill: params 1x + KV-cache write + boundary activations
    decode:  params 1x + KV-cache read + write of one entry
    """
    itm = torch_dtype(cfg.dtype).itemsize
    p_bytes = cfg.param_count() * itm
    active_bytes = cfg.active_param_count() * itm
    d = cfg.d_model
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    tok_dev = tokens / num_devices

    if shape.kind == "train":
        remat_factor = 3.0 if cfg.remat != "none" else 2.0
        traffic = p_bytes * remat_factor          # weight reads
        traffic += p_bytes                        # grad write
        traffic += cfg.param_count() * 4 * 4      # adam m,v read+write f32
        layer_acts = cfg.num_layers * tokens * d * itm
        traffic += 2 * layer_acts / num_devices * num_devices  # global
        traffic += 2 * tokens * cfg.vocab_size * 4 / 16        # logits (TP)
        # weights are sharded across all devices; activations per device
        return (traffic / num_devices
                + 2 * cfg.num_layers * tok_dev * d * itm)
    if shape.kind == "prefill":
        kv = _cache_bytes_per_token(cfg) * tokens
        return (active_bytes / num_devices
                + (kv + 2 * cfg.num_layers * tokens * d * itm)
                / num_devices)
    # decode: read whole cache + weights once per token step
    kv_total = _cache_bytes_per_token(cfg) * shape.seq_len * shape.global_batch
    return (active_bytes + kv_total) / num_devices


def _cache_bytes_per_token(cfg) -> float:
    itm = torch_dtype(cfg.dtype).itemsize
    if cfg.mla is not None:
        return cfg.num_layers * (cfg.mla.kv_lora_rank
                                 + cfg.mla.qk_rope_head_dim) * itm
    if cfg.family == "ssm":
        return 0.0        # O(1) state, not per token
    if cfg.family == "hybrid":
        # only local-attn layers cache, bounded by the window: amortised ~0
        n_att = cfg.num_layers // len(cfg.rglru.pattern)
        return n_att * 2 * cfg.num_kv_heads * cfg.head_dim * itm * \
            min(1.0, cfg.rglru.window / 32768)
    return cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * itm


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train) / 2·N_active·B (decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence
