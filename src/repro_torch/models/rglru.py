"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427],
port of ``repro.models.rglru``.

Temporal mixing = gated linear recurrence:
    i_t = sigmoid(W_i u_t)          (input gate, block-diagonal)
    r_t = sigmoid(W_r u_t)          (recurrence gate, block-diagonal)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill evaluates the recurrence through
:func:`~repro_torch.kernels.rglru_scan.rglru_scan`: on the card the
hand-written kernel, on the CPU its plain version
:func:`rglru_scan_ref` (the reference's log-depth scan). The training
loss passes ``plain=True`` and runs :func:`rglru_scan_ref` on any device,
since the kernel has no backward: the one place where the device does
not pick the kernel (ROADMAP Queue 1 item 9d). The scan runs in a
roofline region (cost :func:`repro_torch.roofline.costs.rglru_scan_cost`)
on either route. Decode is the O(1) step
in torch ops and writes the state and conv caches in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.models.ssd import _causal_conv  # the same depthwise conv
from repro_torch.roofline.costs import rglru_scan_cost
from repro_torch.roofline.trace import region
from repro_torch.sharding.partitioning import ParamSpec

C_FACTOR = 8.0
N_GATE_BLOCKS = 16


def rglru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_template(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    W = rglru_width(cfg)
    r = cfg.rglru
    nb = N_GATE_BLOCKS
    bs = W // nb
    return {
        "w_y": ParamSpec((D, W), ("embed", "lru")),
        "w_x": ParamSpec((D, W), ("embed", "lru")),
        "conv_w": ParamSpec((r.conv_width, W), ("conv", "lru"), "conv"),
        "conv_b": ParamSpec((W,), ("lru",), "zeros"),
        "gate_i": ParamSpec((nb, bs, bs), (None, None, None), "fan_in"),
        "gate_r": ParamSpec((nb, bs, bs), (None, None, None), "fan_in"),
        "lam": ParamSpec((W,), ("lru",), "dt_bias"),
        "w_out": ParamSpec((W, D), ("lru", "embed"), "scaled_normal"),
    }


def _block_diag(u, w):
    """u: (...,W), w: (nb,bs,bs) -> (...,W) block-diagonal matmul."""
    nb, bs, _ = w.shape
    out = torch.einsum("...nb,nbc->...nc", u.unflatten(-1, (nb, bs)), w)
    return out.reshape(u.shape)


def _gates(u, p):
    i = torch.sigmoid(_block_diag(u, p["gate_i"]).float())
    r = torch.sigmoid(_block_diag(u, p["gate_r"]).float())
    log_a = -C_FACTOR * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * \
        u.float()
    return a, gated_in


def rglru_forward(p, x, cfg: ModelConfig, *, plain=False):
    """x: (B,S,D) -> (y, (h_final, conv_tail)); ``plain`` takes
    :func:`rglru_scan_ref` (module doc)."""
    B, S, D = x.shape
    y_branch = F.gelu(x @ p["w_y"], approximate="tanh")   # jax.nn.gelu
    u_pre = x @ p["w_x"]
    u = _causal_conv(u_pre, p["conv_w"], p["conv_b"])
    a, gated_in = _gates(u, p)
    scan = rglru_scan_ref if plain else rglru_scan
    with region("rglru_scan", lambda: rglru_scan_cost(a)):
        h = scan(a, gated_in)                           # (B,S,W) f32
    h = h.to(x.dtype)
    out = (h * y_branch) @ p["w_out"]
    # the reference recomputes x @ w_x here; the pre-conv u is the same
    conv_tail = u_pre[:, S - (cfg.rglru.conv_width - 1):, :]
    return out, (h[:, -1, :], conv_tail)


def rglru_decode(p, x, h_state, conv_state, cfg: ModelConfig):
    """One-token step; writes ``h_state`` and ``conv_state`` in place and
    returns them. x: (B,1,D); h_state: (B,W); conv_state: (B,cw-1,W)."""
    y_branch = F.gelu(x @ p["w_y"], approximate="tanh")  # (B,1,W)
    u_new = x @ p["w_x"]                                 # (B,1,W)
    window = torch.cat([conv_state, u_new], dim=1)
    u = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    a, gated_in = _gates(u[:, None, :], p)               # (B,1,W)
    h = a[:, 0] * h_state.float() + gated_in[:, 0]
    h = h.to(x.dtype)
    out = (h[:, None, :] * y_branch) @ p["w_out"]
    h_state.copy_(h)
    conv_state.copy_(window[:, 1:, :])
    return out, (h_state, conv_state)
