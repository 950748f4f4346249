"""The train step: loss, gradients (with accumulation) and an AdamW update.

A port of the single-device part of the reference's ``launch/steps.py``:
``CellPlan`` keeps the fields that mean something on one card,
``loss_fn`` is the reference's next-token cross entropy plus 0.01 × the
aux loss, and ``make_train_step`` builds one step.  The reference's
``SHAPES``, ``default_plan``, ``build_cell``, ``input_specs`` and the
prefill/decode step builders serve XLA lowering and sharding across a
mesh; on one card they have no counterpart (serving is
``serving/engine.py``).

Gradients come from autograd; on the card, attention's backward is K3's
backward kernel (``kernels/flash_attention/ops.FlashAttention``) and the
Mamba-2 SSD scan's is K4's (``kernels/ssd_scan/ops.SSDScan``), each in
the parameters' type: the reference's plan trains bf16 parameters (with
the leaves it keeps in f32) and f32 AdamW moments.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import transformer as T
from ..optim import adamw


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
