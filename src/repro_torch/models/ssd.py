"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060], port of
``repro.models.ssd``.

Prefill runs the chunked scan through
:func:`~repro_torch.kernels.ssd_scan.ssd_scan`: on the card that is the
hand-written kernel, on the CPU its plain version :func:`ssd_chunked`
(the reference's XLA path). There is no ``attention_impl`` switch; the
training loss passes ``plain=True`` and runs :func:`ssd_chunked` on any
device, since the kernel has no backward: the one place where the device
does not pick the kernel (ROADMAP Queue 1 item 9d). The scan runs in a
roofline region (:func:`repro_torch.roofline.trace.region`, cost
:func:`repro_torch.roofline.costs.ssd_scan_cost`) on either route.
Decode is the O(1) recurrent step in torch ops, as in the reference,
whose decode never reaches the Pallas kernel; it writes the state and
conv caches it is given in place. Spans (:mod:`repro_torch.spans`):
prefill's ``repro_torch.ssd.in_proj``, ``.ssd.conv``,
``repro_torch.ssd_scan`` (the region) and ``.ssd.out``; decode's
``repro_torch.ssd.decode``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.roofline.costs import ssd_scan_cost
from repro_torch.roofline.trace import region
from repro_torch.sharding.partitioning import ParamSpec, current_mesh, hint
from repro_torch.spans import span


def ssd_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim


def ssd_template(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    d_in, nh, P, N = ssd_dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "w_z": ParamSpec((D, d_in), ("embed", "mlp")),
        "w_xbc": ParamSpec((D, conv_ch), ("embed", "mlp")),
        "w_dt": ParamSpec((D, nh), ("embed", None)),
        "dt_bias": ParamSpec((nh,), (None,), "dt_bias"),
        "A_log": ParamSpec((nh,), (None,), "ssm_a"),
        "D_skip": ParamSpec((nh,), (None,), "ones"),
        "conv_w": ParamSpec((s.conv_width, conv_ch), ("conv", "mlp"), "conv"),
        "conv_b": ParamSpec((conv_ch,), ("mlp",), "zeros"),
        "gate_norm": ParamSpec((d_in,), ("mlp",), "ones"),
        "w_out": ParamSpec((d_in, D), ("mlp", "embed"), "scaled_normal"),
    }


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B,S,C), w: (cw,C): a grouped
    ``conv1d`` (weight (C,1,cw)) over ``cw - 1`` zeros of left padding.
    The result is contiguous (B,S,C): the scan kernels read C in place.
    Under a mesh it is a manual region: each rank convolves its own batch
    rows over every channel (DTensor's convolution keeps the global group
    count on a channel-sharded shard, and takes no batch split over two
    mesh axes)."""
    from torch.distributed.tensor import DTensor
    if isinstance(u, DTensor) and current_mesh() is not None:
        u = hint(u, ("batch", None, None))
        out = _causal_conv(u.to_local(), w.full_tensor(), b.full_tensor())
        return DTensor.from_local(out, u.device_mesh, u.placements,
                                  run_check=False)
    cw, C = w.shape
    out = F.conv1d(F.pad(u.transpose(1, 2), (cw - 1, 0)),
                   w.t().unsqueeze(1), groups=C)
    return out.transpose(1, 2).contiguous() + b


def _gated_rmsnorm(y, z, scale, eps):
    y = y * F.silu(z)
    y32 = y.float()
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_xbc(xbc, d_in, N):
    """(x, B, C) views of the post-conv activations."""
    return xbc[..., :d_in], xbc[..., d_in:d_in + N], xbc[..., d_in + N:]


def ssd_forward(p, x, cfg: ModelConfig, *, plain=False, length=None):
    """Full-sequence SSD mixer. x: (B,S,D) -> (y, (ssm_state, conv_tail)).
    x, B and C reach the scan as views of the conv output (the kernel
    reads them through strides); ``plain`` takes :func:`ssd_chunked`
    (module doc).

    ``length`` (a 0-d long tensor on x's device, or None) marks the
    positions from ``length`` on as padding, as the prefill graph runs a
    prompt padded to its bucket (:mod:`repro_torch.models.prefill_graph`):
    dt is 0 there after the softplus, so each pad step decays the state
    by exp(0) = 1 and adds nothing, and ``ssm_state`` is the state at
    ``length``; the conv tail is read at ``length - (cw - 1) ... length -
    1`` by a device index, its rows before position 0 the conv's zero
    padding. Causal, the real positions' y never sees a pad. None is the
    unpadded path, op for op."""
    B, S, D = x.shape
    s = cfg.ssm
    d_in, nh, P, N = ssd_dims(cfg)

    with span("repro_torch.ssd.in_proj"):
        z = x @ p["w_z"]                               # (B,S,d_in)
        u = x @ p["w_xbc"]                             # (B,S,conv_ch)
        dt = x @ p["w_dt"]                             # (B,S,nh)
    with span("repro_torch.ssd.conv"):
        xbc = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
        xs, Bm, Cm = _split_xbc(xbc, d_in, N)
        xs = xs.unflatten(-1, (nh, P))
        dt = F.softplus(dt.float() + p["dt_bias"])
        if length is not None:
            pad = torch.arange(S, device=dt.device)[:, None] >= length
            dt = dt.masked_fill(pad, 0.0)
        A = -torch.exp(p["A_log"].float())

    with region("ssd_scan", lambda: ssd_scan_cost(xs, Bm, s.chunk_size)):
        if plain:
            y, h_final = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk_size)
        else:
            y, h_final = ssd_scan(xs, dt, A, Bm, Cm, chunk=s.chunk_size)
    with span("repro_torch.ssd.out"):
        y = y + xs * p["D_skip"].to(x.dtype)[None, None, :, None]
        y = y.reshape(B, S, d_in)
        y = _gated_rmsnorm(y, z, p["gate_norm"], cfg.norm_eps)
        y = y @ p["w_out"]
    # the reference recomputes x @ w_xbc here; the pre-conv u is the same
    if length is None:
        conv_tail = u[:, S - (s.conv_width - 1):, :]
    else:
        at = length + torch.arange(1 - s.conv_width, 0, device=u.device)
        conv_tail = torch.where((at >= 0)[None, :, None],
                                u.index_select(1, at.clamp(min=0)), 0.0)
    return y, (h_final, conv_tail)


def ssd_decode(p, x, ssm_state, conv_state, cfg: ModelConfig):
    """One-token recurrent step; writes ``ssm_state`` and ``conv_state``
    in place and returns them. The span ``repro_torch.ssd.decode``.

    x: (B,1,D); ssm_state: (B,H,P,N); conv_state: (B,cw-1,conv_ch).
    """
    with span("repro_torch.ssd.decode"):
        B = x.shape[0]
        d_in, nh, P, N = ssd_dims(cfg)

        z = x @ p["w_z"]                                   # (B,1,d_in)
        u = x @ p["w_xbc"]                                 # (B,1,conv_ch)
        window = torch.cat([conv_state, u], dim=1)         # (B,cw,conv_ch)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + \
            p["conv_b"]
        xbc = F.silu(conv_out)[:, None, :]                 # (B,1,conv_ch)

        xs, Bm, Cm = _split_xbc(xbc, d_in, N)
        xs = xs.reshape(B, nh, P)
        Bm, Cm = Bm[:, 0], Cm[:, 0]                        # (B,N)
        dt = F.softplus((x @ p["w_dt"]).float()[:, 0] + p["dt_bias"])
        A = -torch.exp(p["A_log"].float())                 # (H,)

        decay = torch.exp(dt * A).to(x.dtype)              # (B,H)
        dx = dt.to(x.dtype)[..., None] * xs                # (B,H,P)
        new_state = ssm_state * decay[:, :, None, None] + \
            torch.einsum("bhp,bn->bhpn", dx, Bm.to(x.dtype))
        y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(x.dtype))
        y = y + xs * p["D_skip"].to(x.dtype)[None, :, None]
        y = y.reshape(B, 1, d_in)
        y = _gated_rmsnorm(y, z, p["gate_norm"], cfg.norm_eps)
        ssm_state.copy_(new_state)
        conv_state.copy_(window[:, 1:, :])
        return y @ p["w_out"], (ssm_state, conv_state)
