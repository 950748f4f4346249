"""The port's bf16 train step against the reference's, on the CPU.

Mirrors ``test_substrate.py:126`` (the train step) in the reference's
working type: ``make_train_step`` with both packages' default plans (bf16
parameters with the leaves the reference keeps in f32, AdamW moments in
f32) on ``reference_params_numpy`` weights rounded by the same rule and
the same ``TokenPipeline`` batches, against the reference's jitted step:

* three steps (lr 3e-3, two warm-up steps) on the smollm-135m,
  mamba2-1.3b, h2o-danube-3-4b and stablelm-1.6b smoke configs at batch
  2 × 32 (mixtral-8x7b, qwen2-vl-2b and whisper-large-v3 over seeded
  frames in ``test_torch_train_bf16_steps_more.py``): the loss within rel
  ``LOSS_REL``, the grad norm within rel ``GNORM_REL_FIRST`` at step 1 and
  ``GNORM_REL`` over the three (measured: losses within 5.2e-4, grad norms
  within 1.4e-3 at step 1 and 1.26e-2 over three steps, mixtral's; the two
  frameworks round P, dP and the products' sums in other places, and the
  updated bf16 weights carry those differences into the next steps);
* ``grad_accum=4``: the micro-batches' gradients added into f32 in order
  and divided by 4, as the reference's scan does.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import steps as JS
from repro.optim import adamw as JA
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.optim import adamw
from test_torch_train_bf16 import both_bf16, frames_bf16

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

LOSS_REL = 1e-3
GNORM_REL_FIRST = 5e-3
GNORM_REL = 2e-2

#: The configs of the three-step tests here and in
#: ``test_torch_train_bf16_steps_more.py``.
STEP_ARCHS = ["smollm-135m", "mamba2-1.3b", "h2o-danube-3-4b",
              "stablelm-1.6b"]
MORE_STEP_ARCHS = ["mixtral-8x7b", "qwen2-vl-2b", "whisper-large-v3"]


def _steps(arch, n_steps, batch, seq, accum):
    """``n_steps`` of both packages' bf16 steps: ``[(loss, gnorm)]`` each,
    the port's and the reference's."""
    cfg, jcfg, model, jparams = both_bf16(arch)
    jframes, frames = frames_bf16(cfg, batch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    opt_cfg, jopt_cfg = adamw.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JS.CellPlan(grad_accum=accum, remat=False), jopt_cfg))
    step = S.make_train_step(cfg, S.CellPlan(grad_accum=accum, remat=False),
                             opt_cfg)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    jstate = JA.init_state(jparams, jopt_cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq))
    ours, theirs = [], []
    for i in range(n_steps):
        toks = pipe.batch_at(i)
        jparams, jstate, jloss, jgnorm = jstep(
            jparams, jstate, jnp.asarray(toks),
            *(() if jframes is None else (jframes,)))
        state, loss, gnorm = step(model, state, torch.from_numpy(toks),
                                  frames)
        ours.append((float(loss), float(gnorm)))
        theirs.append((float(jloss), float(jgnorm)))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16,
                                                      torch.float32}
    return ours, theirs


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_bf16_train_steps_match_reference(arch):
    check_three_steps(arch)


def check_three_steps(arch):
    """Three bf16 steps at batch 2 × 32 against the reference's."""
    ours, theirs = _steps(arch, 3, 2, 32, 1)
    for i, ((loss, gnorm), (jloss, jgnorm)) in enumerate(zip(ours, theirs)):
        assert loss == pytest.approx(jloss, rel=LOSS_REL), i
        rel = GNORM_REL_FIRST if i == 0 else GNORM_REL
        assert gnorm == pytest.approx(jgnorm, rel=rel), i


def test_bf16_train_step_accumulates_micro_batches_in_f32():
    """``grad_accum=4`` in bf16: one step over four micro-batches of one
    sequence, against the reference's accumulated step."""
    ((loss, gnorm),), ((jloss, jgnorm),) = _steps("smollm-135m", 1, 4, 16,
                                                  4)
    assert loss == pytest.approx(jloss, rel=LOSS_REL)
    assert gnorm == pytest.approx(jgnorm, rel=GNORM_REL_FIRST)


def test_bf16_micro_batch_gradients_add_in_f32_in_order(monkeypatch):
    """The step's accumulated gradient is the f32 sum of the micro-batches'
    bf16 gradients in order, divided by the count in f32: AdamW sees
    exactly that sum (not a bf16 ``.grad`` that autograd adds into)."""
    cfg, _, model, _ = both_bf16("smollm-135m")
    toks = torch.from_numpy(TokenPipeline(DataConfig(
        vocab=cfg.vocab, batch=4, seq=16)).batch_at(0))
    want = None
    for mb in toks.reshape(4, 1, -1):
        S.loss_fn(cfg, model, mb)[0].backward()
        g = [p.grad.float() for p in model.parameters()]
        want = g if want is None else [a + b for a, b in zip(want, g)]
        for p in model.parameters():
            p.grad = None
    want = [w / 4 for w in want]
    seen = {}
    real = adamw.apply

    def spy(params, grads, state, cfg_):
        seen["grads"] = [g.clone() for g in grads]
        return real(params, grads, state, cfg_)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    monkeypatch.setattr(adamw, "apply", spy)
    S.make_train_step(cfg, S.CellPlan(grad_accum=4), opt_cfg)(
        model, adamw.init_state(list(model.parameters()), opt_cfg), toks)
    assert all(g.dtype == torch.float32 for g in seen["grads"])
    assert all(torch.equal(a, b) for a, b in zip(seen["grads"], want))
