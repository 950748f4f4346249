"""Step builders for every (arch × shape) cell that fits one card.

A port of the single-device part of the reference's ``launch/steps.py``:
``SHAPES`` (the reference's grid: ``train_4k``, ``prefill_32k``,
``decode_32k``, ``long_500k``), ``skip_reason``, ``default_plan``,
``CellPlan`` (the fields that mean something on one card), ``loss_fn``
(the reference's next-token cross entropy plus 0.01 × the aux loss),
``make_train_step``, ``make_prefill_step``, ``make_decode_step`` and
``input_specs`` (each input's shape and type, the cache's built on the
``meta`` device).  What stays bound to a mesh has no counterpart here:
``build_cell``, ``params_shape``, the parameter, token and cache
shardings (``models/sharding.py``) and the ``fsdp``,
``expert_parallel`` and layout fields of the reference's plan, as do
``launch/mesh.py``, ``launch/dryrun.py`` and ``launch/hlo_analysis.py``.

Gradients come from autograd; on the card, attention's backward is K3's
backward kernel (``kernels/flash_attention/ops.FlashAttention``) and the
Mamba-2 SSD scan's is K4's (``kernels/ssd_scan/ops.SSDScan``), each in
the parameters' type: the reference's plan trains bf16 parameters (with
the leaves it keeps in f32) and f32 AdamW moments.  The serving steps run
under ``torch.no_grad`` (``transformer.prefill`` / ``decode_step``) and
update the cache in place.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import transformer as T
from ..optim import adamw

#: The reference's cells (``launch/steps.py:30-35``): the kind of step,
#: the sequence (for a decode, the cache's length) and the global batch.
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """``grad_accum`` micro-batches a step, their gradients added in
    order; ``remat``, the reference's rematerialisation: each period of
    layers keeps only its input for the backward and runs its forward
    again there (``forward_train(remat=)``); the parameters' working
    type, the reference's default bf16 (the train step checks each
    parameter against it, by the rule of ``init_model``:
    ``layers.leaf_dtype``); the AdamW moments' type."""
    grad_accum: int = 1
    remat: bool = True
    param_dtype: torch.dtype = torch.bfloat16
    opt_state_dtype: torch.dtype = torch.float32


def default_plan(cfg, shape: str) -> CellPlan:
    """The reference's baseline plan: gradient accumulation of 8 micro-
    batches for a train cell of a model over 20 G parameters, else 4, 1
    for a serving cell; bf16 AdamW moments over 100 G parameters, else
    f32.  Its ``fsdp`` (over 20 G) has no field on one card."""
    big = cfg.param_count() > 20e9
    huge = cfg.param_count() > 100e9
    accum = 1
    if SHAPES[shape]["kind"] == "train":
        accum = 8 if big else 4
    return CellPlan(grad_accum=accum, opt_state_dtype=torch.bfloat16
                    if huge else torch.float32)


def skip_reason(cfg, shape: str) -> str | None:
    """Why the reference leaves a cell out, else None: ``long_500k`` only
    for an arch whose attention is bounded by a window or an SSM state
    (``cfg.sub_quadratic``)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k dense decode is the "
                "quadratic case the assignment excludes")
    return None


def loss_fn(cfg, model, tokens, enc_frames=None, remat=True):
    """tokens [B,S] (and an encoder-decoder's enc_frames [B,F,d]) →
    (loss, ce): the mean next-token cross entropy over positions 0..S−2 in
    f32, plus 0.01 × the aux loss; ``remat`` as ``forward_train``'s."""
    logits, aux = T.forward_train(cfg, model, tokens, enc_frames,
                                  remat=remat)
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (logz - gold).mean()
    return ce + 0.01 * aux, ce


def make_train_step(cfg, plan: CellPlan, opt_cfg=None):
    """``train_step(model, opt_state, tokens, enc_frames=None) →
    (opt_state, loss, grad_norm)``: the loss (mean over micro-batches) and
    the raw global gradient norm are device scalars; the model's
    parameters and the state's moments are updated in place.  An
    encoder-decoder's ``enc_frames`` [B,F,d] split over the micro-batches
    as the tokens do."""
    opt_cfg = opt_cfg or adamw.AdamWConfig(state_dtype=plan.opt_state_dtype)

    def train_step(model, opt_state, tokens, enc_frames=None):
        params = list(model.parameters())
        for (name, p), dtype in zip(model.named_parameters(),
                                    T.param_dtypes(model, plan.param_dtype)):
            if p.dtype != dtype:
                raise ValueError(f"parameter {name} of {p.dtype}, the plan "
                                 f"says {dtype}")
            p.grad = None
        a = plan.grad_accum
        if tokens.shape[0] % a:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{a} micro-batches")
        loss, acc = None, None
        toks = tokens.reshape(a, -1, tokens.shape[1])
        frames = [None] * a if enc_frames is None else \
            enc_frames.reshape(a, -1, *enc_frames.shape[1:])
        for tb, fb in zip(toks, frames):
            micro, _ = loss_fn(cfg, model, tb, fb, remat=plan.remat)
            micro.backward()
            micro = micro.detach()
            loss = micro if loss is None else loss + micro
            if a > 1:
                # the micro-batches' gradients added into f32 in order, as
                # the reference's scan adds them into f32 zeros
                with torch.no_grad():
                    if acc is None:
                        acc = [torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device) if p.grad is None
                               else p.grad.float() for p in params]
                    else:
                        for g, p in zip(acc, params):
                            if p.grad is not None:
                                g.add_(p.grad)
                for p in params:
                    p.grad = None
        if a > 1:
            grads = acc
            torch._foreach_div_(grads, a)
        else:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
        opt_state, stats = adamw.apply(params, grads, opt_state, opt_cfg)
        for p in params:
            p.grad = None
        return opt_state, loss / a, stats["grad_norm"]

    return train_step


def make_prefill_step(cfg, plan: CellPlan, seq: int, batch: int):
    """``prefill_step(model, tokens, enc_frames=None) → (last, cache)``,
    plus the memory for an encoder-decoder: a cache of ``seq`` slots (the
    window's, for a windowed arch) for ``batch`` rows in
    ``plan.param_dtype`` on the model's device, filled by the prompt
    ``tokens`` [batch, S] (S ≤ ``seq``, or any S with a window); ``last``
    [batch, 1, V] the last position's logits.  The cache starts empty, as
    the reference's does: a prompt is prefilled in one call."""
    def prefill_step(model, tokens, enc_frames=None):
        cache = T.init_cache(cfg, batch, seq, device=model.embed.device,
                             dtype=plan.param_dtype)
        last, cache, memory = T.prefill(cfg, model, tokens, cache,
                                        enc_frames)
        return (last, cache) + ((memory,) if cfg.enc_dec else ())
    return prefill_step


def make_decode_step(cfg, plan: CellPlan):
    """``serve_step(model, tokens, cache, pos, memory=None) → (next_tok,
    logits, cache)``: one token a row at absolute position ``pos`` (an
    int), the cache updated in place; ``next_tok`` [B, 1] int32 the
    greedy choice, the first of equal largest logits as ``jnp.argmax``
    takes it.  ``plan`` is taken for the reference's signature; a decode
    step reads none of it."""
    def serve_step(model, tokens, cache, pos, memory=None):
        logits, cache = T.decode_step(cfg, model, tokens, cache, pos, memory)
        next_tok = logits[:, -1].argmax(dim=-1)[:, None]
        return next_tok.to(torch.int32), logits, cache
    return serve_step


def input_specs(cfg, shape: str, plan: CellPlan,
                batch: int | None = None) -> dict:
    """Each model input of the cell as ``(shape, torch.dtype)``, the
    reference's ``input_specs``: ``tokens`` (and an encoder-decoder's
    ``enc_frames``) for a train or prefill cell; for a decode cell one
    token a row, the ``cache`` (a list with a dict a layer, as
    ``init_cache`` builds it, here on the ``meta`` device; its ``pos``
    the reference's int32 scalar), ``pos`` and an encoder-decoder's
    ``memory``.  ``batch`` replaces the global batch, with the rows one
    card takes."""
    sh = SHAPES[shape]
    b = sh["batch"] if batch is None else batch
    s, dt = sh["seq"], plan.param_dtype
    frames = ((b, cfg.n_frames, cfg.d_model), dt)
    if sh["kind"] in ("train", "prefill"):
        specs = {"tokens": ((b, s), torch.int32)}
        if cfg.enc_dec:
            specs["enc_frames"] = frames
        return specs
    cache = T.init_cache(cfg, b, s, device="meta", dtype=dt)
    specs = {"tokens": ((b, 1), torch.int32),
             "cache": [{k: ((), torch.int32) if k == "pos"
                        else (tuple(v.shape), v.dtype)
                        for k, v in layer.items()} for layer in cache],
             "pos": ((), torch.int32)}
    if cfg.enc_dec:
        specs["memory"] = frames
    return specs
