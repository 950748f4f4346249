"""Model assembly: init, forward, prefill and decode with a KV/SSM cache.

A port of the reference model's ``models/transformer.py`` for every
registered configuration: dense, sliding-window, SSM, mixture of experts
(mixtral, dbrx), M-RoPE (qwen2-vl), the attention + Mamba + MoE hybrid
(jamba) and the encoder-decoder (whisper).  The reference stacks layers
into periods and scans over them; here the layers are a ``ModuleList``
walked by a Python loop, layer ``li`` being slot ``li % period_len`` of
period ``li // period_len``.  Parameter names mirror the reference's keys
(``layers.3.attn.wq`` is the reference's ``periods/slot0/attn/wq[3]``,
``encoder.3.attn.wq`` its ``encoder/attn/wq[3]``).

Whisper (``cfg.enc_dec``) runs its encoder (:func:`run_encoder`) over
frame embeddings ``[B, n_frames, d]`` that stand in for the audio
frontend, as the reference's do, and every decoder layer adds
cross-attention over the encoder's output (the memory) after its
self-attention.  The cross K/V are projected from the memory at every
call, decode steps included, as the reference does: there is no
cross-attention cache.

Three entry points:
  * ``forward_train`` — full-sequence causal forward (no cache) → logits
                        and the MoE aux loss, with its autograd graph (the
                        train step's forward); with ``remat``, as the
                        reference's default, one checkpoint per period
  * ``prefill``       — fills a KV/SSM cache, returns last-token logits,
                        the cache and the memory (None without an encoder)
  * ``decode_step``   — one token with the cache (rolling buffer for SWA)
                        and the memory
``prefill`` and ``decode_step`` run under ``torch.no_grad()``, so serving
launches exactly what it launched before the parameters were trainable.

The cache is updated in place (the reference returns a new one).

Types follow the reference: ``init_model(dtype=)`` and
``init_cache(dtype=)`` default to bf16, as the reference's do, and every
caller that means f32 says so.  Norms, RoPE, the router and Mamba's decay
and gated norm compute in f32 and cast back to the working type where the
reference does; logits come out in the working type.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.utils.checkpoint

from ..device import resolve_device
from . import layers as L
from . import mamba2 as M

# ---------------------------------------------------------------------------
# period structure
# ---------------------------------------------------------------------------


def period_len(cfg) -> int:
    a = cfg.attn_period if cfg.attn_period else 1
    m = cfg.moe_period if cfg.n_experts else 1
    return math.lcm(a, m)


def period_slots(cfg) -> list[tuple[str, bool]]:
    """[(kind, is_moe)] for one period."""
    return [(cfg.layer_kind(i), cfg.is_moe_layer(i))
            for i in range(period_len(cfg))]


def n_periods(cfg) -> int:
    pl = period_len(cfg)
    if cfg.n_layers % pl:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                         f"whole number of periods of {pl}")
    return cfg.n_layers // pl


# ---------------------------------------------------------------------------
# the model and its init
# ---------------------------------------------------------------------------

class Model(torch.nn.Module):
    """Embedding, the layers (each a ``ModuleDict`` of ``norm1``,
    ``attn`` or ``mamba``, ``xnorm`` / ``xattn`` for an encoder-decoder,
    and ``norm2`` / ``mlp`` or ``moe`` where ``d_ff > 0``), the final norm
    and, for untied embeddings, ``lm_head``.  An encoder-decoder config
    also has ``encoder``, its layers (``norm1``, ``attn``, ``norm2``,
    ``mlp``), and ``enc_final_norm``."""

    def __init__(self, cfg, embed, final_norm, layers, lm_head=None,
                 encoder=None, enc_final_norm=None):
        super().__init__()
        self.cfg = cfg
        self.embed = torch.nn.Parameter(embed)
        self.final_norm = final_norm
        self.register_parameter(
            "lm_head", None if lm_head is None
            else torch.nn.Parameter(lm_head))
        self.layers = torch.nn.ModuleList(layers)
        if encoder is not None:
            self.encoder = torch.nn.ModuleList(encoder)
            self.enc_final_norm = enc_final_norm


def _init_attn(cfg):
    d = cfg.d_model
    hq = cfg.n_heads * cfg.head_dim
    hk = cfg.n_kv_heads * cfg.head_dim
    return {"wq": L.Leaf((d, hq), d ** -0.5), "wk": L.Leaf((d, hk), d ** -0.5),
            "wv": L.Leaf((d, hk), d ** -0.5), "wo": L.Leaf((hq, d), hq ** -0.5)}


def _init_slot(cfg, kind, is_moe):
    p = {"norm1": L.init_norm(cfg, cfg.d_model)}
    if kind == "attn":
        p["attn"] = _init_attn(cfg)
        if cfg.enc_dec:
            p["xnorm"] = L.init_norm(cfg, cfg.d_model)
            p["xattn"] = _init_attn(cfg)
    else:
        p["mamba"] = M.init_mamba(cfg)
    if cfg.d_ff > 0:
        p["norm2"] = L.init_norm(cfg, cfg.d_model)
        if is_moe:
            p["moe"] = L.init_moe(cfg)
        else:
            p["mlp"] = L.init_mlp(cfg, cfg.d_model, cfg.d_ff)
    return p


def _init_enc_layer(cfg):
    return {"norm1": L.init_norm(cfg, cfg.d_model), "attn": _init_attn(cfg),
            "norm2": L.init_norm(cfg, cfg.d_model),
            "mlp": L.init_mlp(cfg, cfg.d_model, cfg.d_ff)}


def param_spec(cfg) -> dict:
    """The reference's parameter tree (``transformer.py:61-128``) with a
    :class:`~.layers.Leaf` per parameter and no leading period or layer
    axis: ``embed``, ``final_norm``, ``lm_head`` for untied embeddings,
    ``periods/slot{i}/<block>/<key>`` and, for an encoder-decoder,
    ``encoder/<block>/<key>`` (one encoder layer; the reference's has a
    leading ``n_enc_layers`` axis) and ``enc_final_norm``."""
    spec = {"embed": L.Leaf((cfg.vocab, cfg.d_model), 0.02),
            "final_norm": L.init_norm(cfg, cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["lm_head"] = L.Leaf((cfg.d_model, cfg.vocab), 0.02)
    spec["periods"] = {f"slot{i}": _init_slot(cfg, kind, is_moe)
                       for i, (kind, is_moe) in enumerate(period_slots(cfg))}
    if cfg.enc_dec:
        spec["encoder"] = _init_enc_layer(cfg)
        spec["enc_final_norm"] = L.init_norm(cfg, cfg.d_model)
    return spec


def _layer_block(blocks: dict, make) -> torch.nn.ModuleDict:
    """A layer's ``ModuleDict`` of :class:`~.layers.ParamBlock`s, each
    leaf made by ``make``."""
    return torch.nn.ModuleDict(
        {name: L.ParamBlock(L.map_leaves(make, leaves))
         for name, leaves in blocks.items()})


def init_model(cfg, generator: torch.Generator,
               dtype: torch.dtype = torch.bfloat16) -> Model:
    """Random weights at the reference's init scales (:func:`param_spec`),
    drawn in f32 from ``generator`` on its device
    (``torch.Generator(device).manual_seed``) one leaf at a time and stored
    in ``dtype``, the reference's default bf16, except the leaves it keeps
    in f32 (``Leaf.keep_f32``).  The draws differ from the reference's
    ``jax.random`` ones; to give both packages the same weights use
    ``convert.reference_params_numpy``."""
    spec = param_spec(cfg)
    slots = list(spec.pop("periods").values())
    enc = spec.pop("encoder", None)

    def draw(leaf):
        return L.draw(generator, leaf, dtype)
    top = L.map_leaves(draw, spec)
    layers = [_layer_block(slots[li % len(slots)], draw)
              for li in range(n_periods(cfg) * len(slots))]
    if enc is None:
        return Model(cfg, top["embed"], L.ParamBlock(top["final_norm"]),
                     layers, top.get("lm_head"))
    return Model(cfg, top["embed"], L.ParamBlock(top["final_norm"]), layers,
                 top.get("lm_head"),
                 [_layer_block(enc, draw) for _ in range(cfg.n_enc_layers)],
                 L.ParamBlock(top["enc_final_norm"]))


def param_dtypes(model: Model, dtype: torch.dtype) -> list[torch.dtype]:
    """The type of each parameter of ``model``, in ``named_parameters``
    order, when its working type is ``dtype``: ``layers.leaf_dtype`` of the
    parameter's leaf in :func:`param_spec` (bf16, say, with the leaves the
    reference keeps in f32)."""
    spec = param_spec(model.cfg)
    slots = list(spec["periods"].values())
    out = []
    for name, _ in model.named_parameters():
        keys = name.split(".")
        if keys[0] == "layers":
            node, keys = slots[int(keys[1]) % len(slots)], keys[2:]
        elif keys[0] == "encoder":
            node, keys = spec["encoder"], keys[2:]
        else:
            node = spec
        for key in keys:
            node = node[key]
        out.append(L.leaf_dtype(node, dtype))
    return out


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def _sinusoid(positions, d):
    """Sinusoidal position embedding (whisper-style, table-free)."""
    half = d // 2
    freq = torch.exp(-torch.arange(half, device=positions.device)
                     * (np.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_sublayer(cfg, p, x, q_pos, k_pos, *, kv=None, cache=None,
                   causal=True):
    """Self-attention; with ``cache`` the new K/V go into it first.  With
    ``kv``, the memory [B,F,d], cross-attention: K/V projected from it, no
    position embedding, every key live (non-causal, no window) at
    ``k_pos`` = arange(F), no cache."""
    b, s, _ = x.shape
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    if kv is not None:
        f = kv.shape[1]
        k = (kv @ p.wk).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
        v = (kv @ p.wv).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
        k_pos = torch.arange(f, dtype=torch.int32, device=x.device)
        out = L.attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=False,
                          sorted_keys=True)
        return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo
    k = (x @ p.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q, k = L.position_embed(cfg, q, k, q_pos[None].expand(b, s))
    # a prefill's and a forward's keys are their own queries' positions, an
    # arange; a decode's are the ring cache's table
    sorted_keys = True
    if cache is not None:
        kc, vc, pc = cache.update(k, v, q_pos)
        if s == 1:
            # decode: attend over the cache contents
            k, v, k_pos = kc, vc, pc
            sorted_keys = False
        else:
            # prefill: attend over the full in-flight K/V (the rolling
            # buffer only receives the tail); k_pos = q_pos
            k_pos = q_pos
    out = L.attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                      window=cfg.window, sorted_keys=sorted_keys)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo


@dataclasses.dataclass
class _KVView:
    """Rolling KV cache of one attention layer, written in place."""
    k: torch.Tensor          # [B, T, Hkv, Dh]
    v: torch.Tensor
    pos_tab: torch.Tensor    # [T] absolute positions (-1 = empty), int32
    pos: int                 # tokens seen so far

    def update(self, k_new, v_new, q_pos):
        t_max = self.k.shape[1]
        s = k_new.shape[1]
        if s >= t_max:
            # prefill larger than the buffer: keep the last t_max tokens,
            # laid out at their rolling slots (idx = pos % t_max) so later
            # decode writes overwrite the *oldest* entry
            tail_pos = q_pos[-t_max:]
            idx = (tail_pos % t_max).long()
            self.k[:, idx] = k_new[:, -t_max:].to(self.k.dtype)
            self.v[:, idx] = v_new[:, -t_max:].to(self.v.dtype)
            self.pos_tab[idx] = tail_pos
        else:
            idx = (self.pos + torch.arange(s, device=self.k.device)) % t_max
            self.k[:, idx] = k_new.to(self.k.dtype)
            self.v[:, idx] = v_new.to(self.v.dtype)
            self.pos_tab[idx] = q_pos
        return self.k, self.v, self.pos_tab


def _apply_slot(cfg, p, kind, is_moe, x, q_pos, *, memory=None,
                slot_cache=None):
    """One layer: mixer + cross-attention over ``memory`` (an
    encoder-decoder's) + MLP or MoE with residuals.  Returns (x, the MoE
    aux loss or None); a ``slot_cache`` is updated in place."""
    h = L.apply_norm(cfg, x, p.norm1)
    s = h.shape[1]
    if kind == "attn":
        if slot_cache is not None:
            view = _KVView(slot_cache["k"], slot_cache["v"],
                           slot_cache["pos_tab"], slot_cache["pos"])
            out = _attn_sublayer(cfg, p.attn, h, q_pos, None, cache=view)
        else:
            out = _attn_sublayer(cfg, p.attn, h, q_pos, q_pos)
    else:
        state = None
        if slot_cache is not None:
            state = (slot_cache["conv"], slot_cache["ssm"])
        out, new_state = M.mamba_block(cfg, p.mamba, h, state)
        if slot_cache is not None:
            slot_cache["conv"] = new_state[0]
            slot_cache["ssm"] = new_state[1].to(slot_cache["ssm"].dtype)
    # h and the mixer's output go once added, not at the layer's end: at a
    # long prefill each is [B, S, d] (4 GB at danube's 524,288 tokens)
    del h
    x = x + out
    del out
    if kind == "attn" and memory is not None:
        hx = L.apply_norm(cfg, x, p.xnorm)
        x = x + _attn_sublayer(cfg, p.xattn, hx, q_pos, None, kv=memory)
    if slot_cache is not None:
        slot_cache["pos"] += s
    aux = None
    if cfg.d_ff > 0:
        h2 = L.apply_norm(cfg, x, p.norm2)
        if is_moe:
            out2, aux = L.moe(cfg, p.moe, h2)
        else:
            out2 = L.mlp(cfg, p.mlp, h2)
        x = x + out2
    return x, aux


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def run_encoder(cfg, model, frames):
    """frames [B,F,d], the frontend stub's frame embeddings → the memory
    [B,F,d]: sinusoidal positions added, then each encoder layer's
    non-causal self-attention and MLP with their residuals, then
    ``enc_final_norm``."""
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    x = frames + _sinusoid(pos, cfg.d_model)[None].to(frames.dtype)
    for p in model.encoder:
        layer = functools.partial(_encoder_layer, cfg, p, pos)
        # checkpointed whenever a gradient is taken, with remat or
        # without it, as the reference's scan of ``jax.checkpoint(body)``
        x = _checkpoint(layer, x) if torch.is_grad_enabled() else layer(x)
    return L.apply_norm(cfg, x, model.enc_final_norm)


def _encoder_layer(cfg, p, pos, x):
    """One encoder layer: non-causal self-attention and MLP, each after
    its norm, with their residuals."""
    a = L.apply_norm(cfg, x, p.norm1)
    x = x + _attn_sublayer(cfg, p.attn, a, pos, pos, causal=False)
    return x + L.mlp(cfg, p.mlp, L.apply_norm(cfg, x, p.norm2))


def _checkpoint(fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward, which runs
    it again (the reference's ``jax.checkpoint``).  Non-reentrant: the
    recompute runs with grad mode on, so K3's and K4's autograd Functions
    launch the same kernels both times, and their ``save_for_backward``
    tensors are freed after the forward."""
    # the forward draws no random numbers: no RNG state to restore
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _memory(cfg, model, enc_frames):
    """The encoder's output for an encoder-decoder config (which needs
    ``enc_frames``), else None."""
    if not cfg.enc_dec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                         "enc_frames [B, n_frames, d_model]")
    return run_encoder(cfg, model, enc_frames)


# ---------------------------------------------------------------------------
# main forward paths
# ---------------------------------------------------------------------------

def _embed(cfg, model, tokens, positions):
    x = model.embed[tokens.long()]
    if cfg.pos == "learned":
        x = x + _sinusoid(positions, cfg.d_model)[None].to(x.dtype)
    return x


def _logits(cfg, model, x):
    x = L.apply_norm(cfg, x, model.final_norm)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return x @ model.lm_head


def _run_layers(cfg, model, x, q_pos, memory=None, caches=None,
                remat=False):
    """The layers in order, a period (``period_len`` layers, the
    reference's scan step) at a time → (x, the sum of the MoE layers' aux
    losses in layer order, as the reference's scan carries it; None
    without MoE).  With ``remat`` and grad mode on, each period is one
    checkpoint."""
    slots = period_slots(cfg)
    wrap = remat and torch.is_grad_enabled()
    total = None
    for first in range(0, len(model.layers), len(slots)):
        period = functools.partial(
            _run_period, cfg, model.layers[first:first + len(slots)],
            slots, q_pos, None if caches is None
            else caches[first:first + len(slots)])
        x, total = _checkpoint(period, x, total, memory) if wrap \
            else period(x, total, memory)
    return x, total


def _run_period(cfg, layers, slots, q_pos, caches, x, total, memory):
    """One period's layers in order, ``total`` carrying the aux sum."""
    for i, p in enumerate(layers):
        kind, is_moe = slots[i]
        x, aux = _apply_slot(cfg, p, kind, is_moe, x, q_pos, memory=memory,
                             slot_cache=None if caches is None
                             else caches[i])
        if aux is not None:
            total = aux if total is None else total + aux
    return x, total


def forward_train(cfg, model, tokens, enc_frames=None, remat=True):
    """tokens [B,S] (and, for an encoder-decoder, enc_frames [B,F,d]) →
    (logits [B,S,V], aux loss), keeping the autograd graph (the parameters
    are trainable).  The aux loss is the sum of the MoE layers'
    load-balancing terms, 0 without experts.  ``remat`` (the reference's
    default) checkpoints each period of layers: the backward keeps only
    each period's input and runs its forward again.  An encoder's layers
    are checkpointed either way."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = _embed(cfg, model, tokens, positions)
    memory = _memory(cfg, model, enc_frames)
    x, aux = _run_layers(cfg, model, x, positions, memory, remat=remat)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return _logits(cfg, model, x), aux


# -- cache construction -------------------------------------------------------

def init_cache(cfg, batch, cache_len, device=None, dtype=torch.bfloat16):
    """One dict per layer: ``k``/``v`` [B,T,Hkv,Dh] in ``dtype``,
    ``pos_tab`` [T] int32 (−1 = empty) and ``pos`` for attention (T =
    ``cache_len``, or the window); ``conv`` [B,K−1,C] in ``dtype``,
    ``ssm`` [B,H,P,N] in f32 whatever ``dtype`` is, and ``pos`` for
    Mamba.  ``dtype`` defaults to the reference's bf16."""
    dev = resolve_device(device)
    t_max = cache_len if cfg.window is None else min(cache_len, cfg.window)
    slots = period_slots(cfg)
    caches = []
    for li in range(cfg.n_layers):
        if slots[li % len(slots)][0] == "attn":
            caches.append({
                "k": torch.zeros(batch, t_max, cfg.n_kv_heads, cfg.head_dim,
                                 dtype=dtype, device=dev),
                "v": torch.zeros(batch, t_max, cfg.n_kv_heads, cfg.head_dim,
                                 dtype=dtype, device=dev),
                "pos_tab": torch.full((t_max,), -1, dtype=torch.int32,
                                      device=dev),
                "pos": 0,
            })
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            caches.append({
                "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim,
                                    dtype=dtype, device=dev),
                "ssm": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state, dtype=torch.float32,
                                   device=dev),
                "pos": 0,
            })
    return caches


@torch.no_grad()
def prefill(cfg, model, tokens, cache, enc_frames=None):
    """Run S prompt tokens, filling ``cache`` (in place).  Returns
    (last_logits [B,1,V], cache, memory): the memory is the encoder's
    output for an encoder-decoder (which needs ``enc_frames``), else
    None, as the reference returns it."""
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = _embed(cfg, model, tokens, positions)
    memory = _memory(cfg, model, enc_frames)
    x, _ = _run_layers(cfg, model, x, positions, memory, caches=cache)
    return _logits(cfg, model, x[:, -1:]), cache, memory


@torch.no_grad()
def decode_step(cfg, model, tokens, cache, pos: int, memory=None):
    """One decode step.  tokens [B,1]; pos: the absolute position; memory:
    the encoder's output from :func:`prefill` for an encoder-decoder."""
    if cfg.enc_dec and memory is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: decode_step "
                         "needs the memory prefill returned")
    positions = torch.full((1,), pos, dtype=torch.int32,
                           device=tokens.device)
    x = _embed(cfg, model, tokens, positions)
    x, _ = _run_layers(cfg, model, x, positions, memory, caches=cache)
    return _logits(cfg, model, x), cache
