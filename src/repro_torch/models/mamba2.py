"""Mamba-2 (SSD, state-space duality) block: chunked scan and decode step.

A port of the reference model's ``models/mamba2.py``.  Prefill and the
train forward run the chunked scan through
:func:`repro_torch.kernels.ssd_scan.ops.ssd` (the kernel on the card, with
its backward kernel when a gradient is needed; the plain version on the
CPU); the single-token decode step is the direct recurrence in plain
torch, as in the reference, which runs it outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ops as ssd_ops
from . import layers as L


def init_mamba(cfg):
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return {
        "in_proj": L.Leaf((d, 2 * di + 2 * g * n + h), d ** -0.5),
        "conv_w": L.Leaf((cfg.ssm_conv, conv_dim), 0.1),
        "conv_b": L.Leaf((conv_dim,), fill=0.0),
        "a_log": L.Leaf((h,), fill=np.log(np.linspace(1.0, 16.0, h)),
                        keep_f32=True),
        "dt_bias": L.Leaf((h,), fill=0.0, keep_f32=True),
        "d_skip": L.Leaf((h,), fill=1.0, keep_f32=True),
        "norm_scale": L.Leaf((di,), fill=1.0, keep_f32=True),
        "out_proj": L.Leaf((di, d), di ** -0.5),
    }


def _split_proj(cfg, proj):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * g * n]
    dt = proj[..., -h:]
    return z, xbc, dt


def _causal_conv(cfg, xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv (kernel K) as a sum over taps (no cuDNN, whose
    f32 convolutions run in TF32).  conv_state [B,K-1,C] for decode."""
    k = cfg.ssm_conv
    if conv_state is None:
        pad = xbc.new_zeros(xbc.shape[0], k - 1, xbc.shape[2])
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                    # [B, S+K-1, C]
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i][None, None] for i in range(k))
    # a copy: a view would keep all of xp [B, S+K-1, C] alive in the cache
    # (1.1 GB a layer at 4 × 32,768 tokens of mamba2-1.3b)
    new_state = xp[:, -(k - 1):].clone() if k > 1 else pad[:, :0]
    return F.silu(out + conv_b[None, None]), new_state


def mamba_block(cfg, p, x, state=None):
    """Full Mamba-2 mixer.  x [B,S,d].  state = (conv_state, ssm_state) for
    decode (S may be 1); returns (y, new_state)."""
    di, h, g, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    pdim = cfg.ssm_head_dim
    b, s = x.shape[:2]
    proj = x @ p.in_proj
    z, xbc, dt_raw = _split_proj(cfg, proj)
    conv_state = state[0] if state is not None else None
    xbc, new_conv = _causal_conv(cfg, xbc, p.conv_w, p.conv_b, conv_state)
    xs = xbc[..., :di]
    b_in = xbc[..., di:di + g * n].reshape(b, s, g, n)
    c_in = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None])
    a = -torch.exp(p.a_log)
    xh = xs.reshape(b, s, h, pdim)

    if state is not None and s == 1:
        # single-token decode: direct recurrence
        ssm = state[1]                                   # [B,H,P,N]
        dt1 = dt[:, 0]                                   # [B,H]
        decay = torch.exp(dt1 * a[None, :])
        bh = b_in[:, 0].repeat_interleave(h // g, dim=1)  # [B,H,N]
        ch = c_in[:, 0].repeat_interleave(h // g, dim=1)
        upd = torch.einsum("bhp,bhn,bh->bhpn", xh[:, 0].float(), bh.float(),
                           dt1)
        new_ssm = decay[:, :, None, None] * ssm + upd
        y = torch.einsum("bhpn,bhn->bhp", new_ssm, ch.float())[:, None]
        y = y.to(x.dtype)
    else:
        init = state[1] if state is not None else None
        y, new_ssm = ssd_ops.ssd(
            xh.contiguous(), dt.contiguous(), a.contiguous(),
            b_in.contiguous(), c_in.contiguous(),
            chunk=min(128, max(16, s)), init_state=init)

    y = y + xh * p.d_skip[None, None, :, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = y * F.silu(z)
    # gated RMSNorm (Mamba-2)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * p.norm_scale).to(x.dtype)
    return y @ p.out_proj, (new_conv, new_ssm)
