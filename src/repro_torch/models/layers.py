"""Core model layers in torch: norms, rotary embeddings (RoPE and M-RoPE),
attention, MLP and mixture of experts.

A port of the reference model's ``models/layers.py``.  Each layer is a plain
function on tensors; its parameters come from a module (``p.scale``,
``p.w_gate``, …) named as the reference's parameter keys.

Attention has one path.  The reference chooses between a direct, a
KV-chunked and a banded form, which are XLA memory strategies for one
function; here every shape goes through
:func:`repro_torch.kernels.flash_attention.ops.gqa_attention` (the kernel
on the card, its plain version on the CPU).

MoE keeps the reference's sort-based dispatch with capacity truncation
(:func:`moe`): every expert runs on its ``[capacity, d]`` block, so a decode
step reads every expert's weights, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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


def _rotate(x, ang):
    """Rotates the interleaved pairs ``(x[..., 2i], x[..., 2i+1])`` of
    x [B,S,H,D] by ``ang`` [B,S,D/2], as the reference does."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


def _freqs(d, theta, device):
    return torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x, positions, theta: float):
    """x [B,S,H,D]; positions [B,S] int."""
    freqs = _freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope_sections(n: int, sections=(2, 3, 3)) -> np.ndarray:
    """Which of (temporal, height, width) rotates each of the ``n``
    frequency bands: the bands split in proportion to ``sections``, with
    the reference's rounding (``np.round`` of each share, ``cumsum``, the
    last bound set to ``n``)."""
    sec = np.array(sections, dtype=np.float64)
    bounds = np.cumsum(np.round(sec / sec.sum() * n).astype(int))
    bounds[-1] = n
    sel = np.zeros(n, dtype=np.int64)
    sel[bounds[0]:bounds[1]] = 1
    sel[bounds[1]:] = 2
    return sel


def apply_mrope(x, positions3, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL's multimodal RoPE: x [B,S,H,D]; positions3 [B,S,3] int,
    the (temporal, height, width) ids, which coincide for text tokens.
    Each frequency band rotates by the id of its section
    (:func:`mrope_sections`)."""
    d = x.shape[-1]
    sel = torch.from_numpy(mrope_sections(d // 2, sections)).to(x.device)
    pos = positions3.float()[..., sel]                         # [B,S,D/2]
    return _rotate(x, pos * _freqs(d, theta, x.device))


def position_embed(cfg, q, k, positions):
    if cfg.pos == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    if cfg.pos == "mrope":
        pos3 = positions[..., None].expand(*positions.shape, 3)
        return (apply_mrope(q, pos3, cfg.rope_theta),
                apply_mrope(k, pos3, cfg.rope_theta))
    return q, k   # 'none' / 'learned' (added at embedding)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, q_pos, k_pos, causal=True, window=None,
              sorted_keys=False):
    """q [B,S,Hq,D], k/v [B,T,Hkv,D], positions int32 [S]/[T] (absolute;
    −1 in ``k_pos`` marks an empty cache slot); ``sorted_keys``: ``k_pos``
    is non-decreasing (K3 then walks only the key tiles that can be
    live)."""
    return gqa_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         q_pos=q_pos, k_pos=k_pos, causal=causal,
                         window=window, sorted_keys=sorted_keys)


# ---------------------------------------------------------------------------
# MLP and mixture of experts
# ---------------------------------------------------------------------------

def mlp(cfg, p, x):
    if cfg.mlp == "swiglu":
        g = F.silu(x @ p.w_gate)
        return (g * (x @ p.w_up)) @ p.w_down
    return F.gelu(x @ p.w_up, approximate="tanh") @ p.w_down


def moe_capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's
    ``ceil(tokens·k/E·capacity_factor)`` in its float order, on the host,
    padded up to a multiple of 8 and at least 8."""
    cap = int(np.ceil(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


class Routing(NamedTuple):
    """One MoE layer's routing of T tokens: the router's ``probs`` [T,E];
    each token's top-k experts ``gate_idx`` [T,k] with their renormalised
    ``gate_vals``; ``order``, the stable sort by expert of the T·k
    assignments (token-major, flat) and ``counts`` [E] of each expert's;
    per assignment (token-major, [T,k]) whether it fits its expert's
    capacity (``keep``) and its row of the ``[E·cap, d]`` dispatch
    (``slot``; a dropped one points at its expert's first row, as the
    reference's does)."""
    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    order: torch.Tensor
    counts: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def moe_route(cfg, p, xf) -> Routing:
    """The reference's routing of xf [T,d]: router logits in f32, softmax,
    top-k, gates renormalised; assignments sorted stably by expert (the
    order within an expert decides which overflow the capacity)."""
    e, k = cfg.n_experts, cfg.top_k
    n, cap = xf.shape[0] * k, moe_capacity(cfg, xf.shape[0])
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = gate_idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    experts = torch.arange(e, device=xf.device)
    # not bincount, which reads the largest id back to the host on the card
    counts = (e_flat[:, None] == experts).sum(0)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=xf.device)
    pos_in_e = rank - (torch.cumsum(counts, 0) - counts)[e_flat]
    keep = pos_in_e < cap
    slot = e_flat * cap + torch.where(keep, pos_in_e, 0)
    return Routing(probs, gate_vals, gate_idx, order, counts,
                   keep.reshape(-1, k), slot.reshape(-1, k))


def moe(cfg, p, x):
    """x [B,S,d] → (y [B,S,d], aux): the reference's sort-based dispatch
    with capacity truncation, and its Switch load-balancing aux loss
    ``E·Σ density·mean_prob`` (density from each token's first choice).
    Deterministic on the card: the dispatch gathers each slot's token
    (no scatter), and each token adds its k contributions in ascending
    expert order, the order of the reference's sorted scatter, without
    atomics."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    xf = x.reshape(tokens, d)
    r = moe_route(cfg, p, xf)
    density = (r.gate_idx[:, :1] == torch.arange(e, device=x.device)
               ).float().mean(0)
    aux = e * (density * r.probs.mean(0)).sum()

    # row c of expert j holds sorted assignment starts[j] + c, if any
    cap = moe_capacity(cfg, tokens)
    rows = torch.arange(cap, device=x.device)
    starts = torch.cumsum(r.counts, 0) - r.counts
    src = (starts[:, None] + rows).clamp(max=tokens * k - 1)    # [E,cap]
    xe = torch.where((rows < r.counts[:, None])[..., None],
                     xf[r.order[src] // k], 0.0)                # [E,cap,d]

    g = F.silu(torch.bmm(xe, p.w_gate))
    u = torch.bmm(xe, p.w_up)
    ye = torch.bmm(g * u, p.w_down).reshape(e * cap, d)

    w = (r.gate_vals * r.keep).to(x.dtype)
    contrib = ye[r.slot] * w[..., None]                         # [T,k,d]
    by_expert = torch.argsort(r.gate_idx, dim=-1)
    contrib = contrib.gather(1, by_expert[..., None].expand(tokens, k, d))
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d), aux


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
    """One parameter at the reference's init: ``N(0, std²)`` when ``std``
    is set, else ``fill`` (a number, or an array broadcast to ``shape``),
    drawn in f32.  It is stored in the model's working type, unless
    ``keep_f32``: the reference keeps norm scales and biases, the MoE
    router and Mamba's ``a_log``, ``dt_bias``, ``d_skip`` and
    ``norm_scale`` in f32 whatever its ``dtype``.  The ``init_*`` functions
    return the reference's blocks as ``{key: Leaf}``;
    ``transformer.init_model`` draws them with torch and
    ``convert.reference_params_numpy`` with numpy, so the scales and types
    live here once."""
    shape: tuple
    std: float | None = None
    fill: object = 0.0
    keep_f32: bool = False


def map_leaves(fn, tree: dict) -> dict:
    """``fn`` on every ``Leaf`` of a nested dict, in insertion order."""
    return {k: map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def leaf_dtype(leaf: Leaf, dtype: torch.dtype) -> torch.dtype:
    """The type ``leaf`` is stored in when the model's working type is
    ``dtype``."""
    return torch.float32 if leaf.keep_f32 else dtype


def draw(gen: torch.Generator, leaf: Leaf,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``leaf`` on the generator's device, drawn in f32 and rounded to
    :func:`leaf_dtype` (to nearest, ties to even, as ``astype`` rounds)."""
    if leaf.std is not None:
        t = torch.randn(leaf.shape, generator=gen,
                        device=gen.device) * leaf.std
    else:
        t = torch.from_numpy(np.broadcast_to(
            np.asarray(leaf.fill, np.float32), leaf.shape).copy()
        ).to(gen.device)
    return t.to(leaf_dtype(leaf, dtype))


def init_norm(cfg, d):
    p = {"scale": Leaf((d,), fill=1.0, keep_f32=True)}
    if cfg.norm != "rms":
        p["bias"] = Leaf((d,), fill=0.0, keep_f32=True)
    return p


def init_mlp(cfg, d, ff):
    p = {"w_up": Leaf((d, ff), d ** -0.5),
         "w_down": Leaf((ff, d), ff ** -0.5)}
    if cfg.mlp == "swiglu":
        p["w_gate"] = Leaf((d, ff), d ** -0.5)
    return p


def init_moe(cfg):
    """The router [d,E] (f32 whatever the working type) and E SwiGLU
    experts ``w_gate``/``w_up`` [E,d,ff],
    ``w_down`` [E,ff,d]."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": Leaf((d, e), d ** -0.5, keep_f32=True),
            "w_gate": Leaf((e, d, ff), d ** -0.5),
            "w_up": Leaf((e, d, ff), d ** -0.5),
            "w_down": Leaf((e, ff, d), ff ** -0.5)}
