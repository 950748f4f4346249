"""Core model layers in torch: norms, rotary embeddings, attention, MLP.

A port of the reference model's ``models/layers.py``.  Each layer is a plain
function on tensors; its parameters come from a module (``p.scale``,
``p.w_gate``, …) named as the reference's parameter keys.

Attention has one path.  The reference chooses between a direct, a
KV-chunked and a banded form, which are XLA memory strategies for one
function; here every shape goes through
:func:`repro_torch.kernels.flash_attention.ops.gqa_attention` (the kernel
on the card, its plain version on the CPU).

MoE and M-RoPE wait for the configs that need them (mixtral, dbrx, jamba;
qwen2-vl) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import gqa_attention

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "rms":
        return rms_norm(x, p.scale)
    return layer_norm(x, p.scale, p.bias)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x [B,S,H,D]; positions [B,S] int.  Rotates the interleaved pairs
    ``(x[..., 2i], x[..., 2i+1])``, as the reference does."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., None].float() * freqs                 # [B,S,D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL's multimodal RoPE: waits for the qwen2-vl config."""
    raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")


def position_embed(cfg, q, k, positions):
    if cfg.pos == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta),
                apply_mrope(k, positions, cfg.rope_theta))
    return q, k   # 'none' / 'learned' (added at embedding)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, q_pos, k_pos, causal=True, window=None):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], positions int32 [S]/[T] (absolute;
    −1 in ``k_pos`` marks an empty cache slot)."""
    return gqa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         q_pos=q_pos, k_pos=k_pos, causal=causal,
                         window=window)


# ---------------------------------------------------------------------------
# MLP and MoE
# ---------------------------------------------------------------------------

def mlp(cfg, p, x):
    if cfg.mlp == "swiglu":
        g = F.silu(x @ p.w_gate)
        return (g * (x @ p.w_up)) @ p.w_down
    return F.gelu(x @ p.w_up, approximate="tanh") @ p.w_down


def init_moe(cfg, *args, **kwargs):
    """Mixture-of-experts parameters: wait for the MoE configs."""
    raise NotImplementedError(
        f"{cfg.name}: mixture of experts is not ported yet")


def moe(cfg, p, x):
    """Sort-based MoE dispatch: waits for the MoE configs."""
    raise NotImplementedError(
        f"{cfg.name}: mixture of experts is not ported yet")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class ParamBlock(torch.nn.Module):
    """The parameters of one block (a norm, an attention, an MLP, a Mamba
    mixer), each named as the reference's key (``wq``, ``w_gate``,
    ``in_proj``, …).  Trainable: ``forward_train`` keeps its graph, while
    ``prefill`` and ``decode_step`` run under ``torch.no_grad()``."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, torch.nn.Parameter(t))


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One f32 parameter at the reference's init: ``N(0, std²)`` when
    ``std`` is set, else ``fill`` (a number, or an array broadcast to
    ``shape``).  The ``init_*`` functions return the reference's blocks as
    ``{key: Leaf}``; ``transformer.init_model`` draws them with torch and
    ``convert.reference_params_numpy`` with numpy, so the scales live here
    once."""
    shape: tuple
    std: float | None = None
    fill: object = 0.0


def map_leaves(fn, tree: dict) -> dict:
    """``fn`` on every ``Leaf`` of a nested dict, in insertion order."""
    return {k: map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def draw(gen: torch.Generator, leaf: Leaf) -> torch.Tensor:
    """``leaf`` as an f32 tensor on the generator's device."""
    if leaf.std is not None:
        return torch.randn(leaf.shape, generator=gen,
                           device=gen.device) * leaf.std
    return torch.from_numpy(np.broadcast_to(
        np.asarray(leaf.fill, np.float32), leaf.shape).copy()).to(gen.device)


def init_norm(cfg, d):
    p = {"scale": Leaf((d,), fill=1.0)}
    if cfg.norm != "rms":
        p["bias"] = Leaf((d,), fill=0.0)
    return p


def init_mlp(cfg, d, ff):
    p = {"w_up": Leaf((d, ff), d ** -0.5),
         "w_down": Leaf((ff, d), ff ** -0.5)}
    if cfg.mlp == "swiglu":
        p["w_gate"] = Leaf((d, ff), d ** -0.5)
    return p
