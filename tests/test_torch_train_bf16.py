"""bf16 training in the port against the JAX reference's, on the CPU.

The reference trains in its working type through ``make_train_step`` with
its default plan (``CellPlan.param_dtype`` bf16, AdamW moments f32,
``launch/steps.py:45-46``): bf16 weights with the leaves it keeps in f32,
gradients added into f32 across micro-batches, each update in f32 rounded
back by ``astype``.  The port takes the same plan.  Here, with the same
``reference_params_numpy`` weights rounded to bf16 by the same rule and the
same ``TokenPipeline`` batches (mirrors ``test_models.py:57``, the
gradient of the loss, and ``test_substrate.py:126``, the train step):

* first-step gradients of ``loss_fn`` in bf16 on the smollm-135m,
  mamba2-1.3b (seq 160: two chunks and a ragged tail), h2o-danube-3-4b,
  stablelm-1.6b, mixtral-8x7b and whisper-large-v3 smoke configs, within
  ``GRAD_ULPS`` bf16 ulps of each leaf's largest |entry|; where the
  reference's bf16 gradient is itself further than that from its f32
  gradient on the same bf16 weights (mamba2's ``d_skip`` at seq 160, a
  sum over 2 × 160 × 64 products that XLA reduces in bf16: 15.1 ulps
  off, the port 2.6), the port is held to the f32 gradient instead;
* the plan's leaf-aware type check, AdamW's bf16 update against the
  reference's ``apply``, and ``global_norm`` by groups (``GROUP_ELEMS``).

The other configs' gradients are in ``test_torch_train_bf16_grads.py``,
K3's and K4's backward mirrors in bf16 against ``jax.grad`` in
``test_torch_train_bf16_mirrors.py``, the train steps in
``test_torch_train_bf16_steps*.py``.

Tolerances are in bf16 ulps (``ulp(x) = 2^(floor(log2|x|) - 7)``) of a
leaf's or a gradient's largest |entry|, not of each row's: the two
frameworks round P, dP and the products' sums in other places, and the
rows of dq and dk are differences that cancel (D = rowsum(dO∘O)), so a
row's own largest entry can be far below its rounding error.  Measured:
first-step gradients within 6.0 ulps (smollm's ``attn.wv``), the mirrors
within 1.0.

Run as a script, this file prints the reference's ``BF16_TRAIN_PINS`` that
``chip_smoke.py`` holds the card to, one JSON line each (3 steps of its
jitted bf16 step at batch 2 × 128 on ``reference_params_numpy(cfg, 0)``,
lr 3e-4 with one warm-up step: smollm-135m whole, mamba2-1.3b with 4 of
its 48 layers, h2o-danube-3-4b and stablelm-1.6b with 2 of 24, and
whisper-large-v3 with 4 + 4 over seeded frames; then two pins under other
plans: qwen2-vl-2b with 2 of 28 layers under its ``train_4k`` default
plan, 4 micro-batches at 4 × 128, and smollm-135m whole under
dbrx-132b's, 8 micro-batches and bf16 moments at 8 × 128; a few minutes
and about 10 GB); an architecture's name prints its pins alone:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_bf16.py [ARCH]
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as JS
from repro.optim import adamw as JA
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_params_numpy)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from test_torch_serve import _to_jax

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BF16 = torch.bfloat16
GRAD_ULPS = 8

#: The configs of the first-step gradient tests here and in
#: ``test_torch_train_bf16_grads.py``, each with its sequence length.
GRAD_ARCHS = [("smollm-135m", 32), ("mamba2-1.3b", 160)]
MORE_GRAD_ARCHS = [("h2o-danube-3-4b", 32), ("stablelm-1.6b", 32),
                   ("mixtral-8x7b", 32), ("whisper-large-v3", 32)]

#: The pin runs of ``chip_smoke.py``'s ``BF16_TRAIN_PINS``: (arch, layers
#: kept or None for all, steps, batch, seq, plan), the plan's micro-batches
#: and moments' type where they are not ``CellPlan()``'s: qwen2-vl-2b's
#: ``train_4k`` default plan, and dbrx-132b's (8 micro-batches, bf16
#: moments) on smollm-135m.  mixtral-8x7b has none: its reference step at
#: full width, even with one layer, holds about 25 GB of parameters,
#: gradients and moments on the host.
PIN_RUNS = (("smollm-135m", None, 3, 2, 128, {}),
            ("mamba2-1.3b", 4, 3, 2, 128, {}),
            ("h2o-danube-3-4b", 2, 3, 2, 128, {}),
            ("stablelm-1.6b", 2, 3, 2, 128, {}),
            ("whisper-large-v3", 4, 3, 2, 128, {}),
            ("qwen2-vl-2b", 2, 3, 4, 128, {"grad_accum": 4}),
            ("smollm-135m", None, 3, 8, 128,
             {"grad_accum": 8, "opt_state_dtype": "bfloat16"}))


def ulp(x):
    """One bf16 ulp of |x| (f32 numpy), elementwise."""
    top = np.maximum(np.abs(np.asarray(x, np.float32)), 2.0 ** -100)
    return np.exp2(np.floor(np.log2(top)) - 7)


def ulps_of_largest(got, want) -> float:
    """max |got − want| in bf16 ulps of want's largest |entry|."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / ulp(np.abs(w).max()))


def both_bf16(arch, seed=0):
    """The smoke config in both packages and its weights in bf16 (the
    leaves the reference keeps in f32 stay f32): ``(cfg, jcfg, model,
    jparams)``."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, seed)
    model = params_from_numpy(cfg, tree, device="cpu", dtype=BF16)
    return cfg, jcfg, model, _to_jax(tree, T.param_spec(cfg))


def frames_bf16(cfg, batch, seed=5):
    """An encoder-decoder's seeded frames in bf16 as ``(jax, torch)``, else
    ``(None, None)``."""
    if not cfg.enc_dec:
        return None, None
    rng = np.random.default_rng(seed)
    j = jnp.asarray((rng.standard_normal((batch, cfg.n_frames, cfg.d_model))
                     * 0.02).astype(np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# first-step gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq", GRAD_ARCHS)
def test_bf16_first_step_gradients_match_reference(arch, seq):
    check_first_step_gradients(arch, seq)


def check_first_step_gradients(arch, seq):
    """First-step gradients of ``loss_fn`` in bf16 at batch 2 × ``seq``
    against the reference's, leaf for leaf."""
    cfg, jcfg, model, jparams = both_bf16(arch)
    tokens = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=2,
                                      seq=seq)).batch_at(0)
    jframes, frames = frames_bf16(cfg, 2)
    jgrads = jax.jit(jax.grad(lambda p: JS.loss_fn(
        jcfg, p, jnp.asarray(tokens), jframes, remat=False)[0]))(jparams)
    S.loss_fn(cfg, model, torch.from_numpy(tokens), frames,
              remat=False)[0].backward()
    named = dict(model.named_parameters())
    assert all(named[n].grad.dtype == named[n].dtype for n in named)
    grads = params_to_numpy(cfg, model, {n: p.grad for n, p in
                                         named.items()})
    exp, got = _leaves(jgrads), _leaves(grads)
    assert got.keys() == exp.keys()
    f32 = None
    for key, want in exp.items():
        if ulps_of_largest(got[key], want) <= GRAD_ULPS:
            continue
        # the reference's own bf16 reduction strays here: hold the port to
        # the reference's f32 gradient on the same bf16 weights instead
        if f32 is None:
            j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
            f32 = _leaves(jax.jit(jax.grad(lambda p: JS.loss_fn(
                jcfg, p, jnp.asarray(tokens), None if jframes is None
                else jframes.astype(jnp.float32), remat=False)[0]))(j32))
        assert ulps_of_largest(want, f32[key]) > GRAD_ULPS, key
        assert ulps_of_largest(got[key], f32[key]) <= GRAD_ULPS, key


# ---------------------------------------------------------------------------
# the plan's type check, AdamW in bf16, the global norm by groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_dtypes_follow_the_leaf_rule(arch):
    """``param_dtypes`` gives each parameter of ``init_model(dtype=)`` its
    type, for every smoke config, in bf16 and in f32."""
    cfg = get_config(arch, smoke=True)
    for dtype in (BF16, torch.float32):
        model = T.init_model(cfg, torch.Generator().manual_seed(0),
                             dtype=dtype)
        assert T.param_dtypes(model, dtype) == [p.dtype for p in
                                                model.parameters()]


def test_bf16_plan_checks_each_leaf_type():
    """The default plan is the reference's (bf16 parameters, f32 moments);
    the step takes a bf16 model with its f32 leaves and raises, naming the
    parameter, on an f32 model or on a leaf of the other type."""
    assert S.CellPlan().param_dtype == BF16
    assert S.CellPlan().opt_state_dtype == torch.float32
    cfg = get_config("smollm-135m", smoke=True)
    tokens = torch.from_numpy(TokenPipeline(DataConfig(
        vocab=cfg.vocab, batch=2, seq=16)).batch_at(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step = S.make_train_step(cfg, S.CellPlan(), opt_cfg)

    def run(model):
        return step(model, adamw.init_state(list(model.parameters()),
                                            opt_cfg), tokens)
    model = T.init_model(cfg, torch.Generator().manual_seed(0), dtype=BF16)
    _, loss, gnorm = run(model)
    assert np.isfinite(float(loss)) and float(gnorm) > 0
    assert {p.dtype for p in model.parameters()} == {BF16, torch.float32}
    with pytest.raises(ValueError, match="parameter embed of torch.float32"):
        run(T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32))
    model.final_norm.scale.data = model.final_norm.scale.data.to(BF16)
    with pytest.raises(ValueError, match="final_norm.scale of torch.bfloat16"
                                         ", the plan says torch.float32"):
        run(model)


def test_adamw_bf16_update_rounds_as_the_reference():
    """Three updates of bf16 parameters (and an f32 one) from the same
    gradients: the bf16 leaves equal the reference's ``apply`` bit for bit
    (the f32 update rounded to nearest even, as ``astype`` rounds), the
    f32 leaf and the moments within rel 1e-5, the grad norm within rel
    1e-6."""
    rng = np.random.default_rng(12)
    shapes = [(33, 7), (300,), (4, 5)]
    kinds = [BF16, BF16, torch.float32]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=0.5)
    cfg, jcfg = adamw.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    jdt = {BF16: jnp.bfloat16, torch.float32: jnp.float32}
    theirs = {str(i): jnp.asarray(p).astype(jdt[kd])
              for i, (p, kd) in enumerate(zip(params, kinds))}
    ours = [torch.from_numpy(np.array(theirs[str(i)].astype(jnp.float32)))
            .to(kd) for i, kd in enumerate(kinds)]
    state, jstate = adamw.init_state(ours, cfg), JA.init_state(theirs, jcfg)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jg = {str(i): jnp.asarray(g).astype(jdt[kd])
              for i, (g, kd) in enumerate(zip(grads, kinds))}
        state, stats = adamw.apply(
            ours, [torch.from_numpy(np.array(jg[str(i)].astype(jnp.float32)))
                   .to(kd) for i, kd in enumerate(kinds)], state, cfg)
        theirs, jstate, jstats = JA.apply(theirs, jg, jstate, jcfg)
        assert float(stats["grad_norm"]) == pytest.approx(
            float(jstats["grad_norm"]), rel=1e-6)
    for i, (p, kd) in enumerate(zip(ours, kinds)):
        want = np.asarray(theirs[str(i)].astype(jnp.float32))
        assert p.dtype == kd
        if kd == BF16:
            assert np.array_equal(p.float().numpy(), want), i
        else:
            np.testing.assert_allclose(p.numpy(), want, rtol=1e-5,
                                       atol=1e-6)
        for key in ("m", "v"):
            assert state[key][i].dtype == torch.float32
            np.testing.assert_allclose(state[key][i].numpy(),
                                       np.asarray(jstate[key][str(i)]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("elems", [1 << 28, 300, 1])
def test_global_norm_groups_hold_one_group_of_f32_copies(elems,
                                                         monkeypatch):
    """The card's global norm (``adamw._group_norms``) takes each leaf's
    f32 norm a group of ``apply``'s at a time: each multi-tensor call gets
    one group (at most ``GROUP_ELEMS`` elements, or one larger leaf), so at
    most one group's f32 copy of bf16 leaves is alive; on f32 leaves it
    gives the bits of one call over every leaf, and on bf16 leaves each
    leaf's f32 norm."""
    monkeypatch.setattr(adamw, "GROUP_ELEMS", elems)
    rng = np.random.default_rng(9)
    shapes = [(5, 7), (300,), (2, 3, 4), (1,), (64, 8)]
    f32 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in shapes]
    calls = []
    real = torch._foreach_norm

    def spy(tensors, *args, **kwargs):
        calls.append([t.numel() for t in tensors])
        assert all(t.dtype == torch.float32 for t in tensors)
        return real(tensors, *args, **kwargs)
    monkeypatch.setattr(torch, "_foreach_norm", spy)
    got = adamw._group_norms(f32)
    assert len(calls) == len(adamw._groups(f32))
    assert all(sum(c) <= elems or len(c) == 1 for c in calls)
    want = real(f32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bf16 = [x.to(BF16) for x in f32]
    got = adamw._group_norms(bf16)
    assert all(torch.equal(a, real([x.float()])[0])
               for a, x in zip(got, bf16))


# ---------------------------------------------------------------------------
# steps under a plan's micro-batches and moments
# ---------------------------------------------------------------------------

def plan_steps(arch, plan, jplan, n_steps, seq=32):
    """``n_steps`` bf16 steps of the port's ``make_train_step`` under
    ``plan`` and of the reference's jitted one under ``jplan`` on the
    arch's smoke config, a micro-batch of one sequence of ``seq`` (lr
    3e-3, two warm-up steps, the moments in each plan's type):
    ``[(loss, gnorm)]`` each, the port's and the reference's."""
    cfg, jcfg, model, jparams = both_bf16(arch)
    batch = plan.grad_accum
    jframes, frames = frames_bf16(cfg, batch)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    opt_cfg = adamw.AdamWConfig(**kw, state_dtype=plan.opt_state_dtype)
    jopt_cfg = JA.AdamWConfig(**kw, state_dtype=jplan.opt_state_dtype)
    jstep = jax.jit(JS.make_train_step(jcfg, jplan, jopt_cfg))
    step = S.make_train_step(cfg, plan, opt_cfg)
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
    assert all(m.dtype == plan.opt_state_dtype for m in state["m"])
    assert {str(v.dtype) for v in jax.tree.leaves(jstate["m"])} \
        == {str(jnp.dtype(jplan.opt_state_dtype))}
    return ours, theirs


def pin_plans(fields):
    """A pin run's plan fields as both packages' plans: the default plan
    with the run's micro-batches and moments' type."""
    accum = fields.get("grad_accum", 1)
    name = fields.get("opt_state_dtype", "float32")
    return (S.CellPlan(grad_accum=accum, opt_state_dtype=getattr(torch,
                                                                 name)),
            JS.CellPlan(grad_accum=accum, opt_state_dtype=getattr(jnp,
                                                                  name)))


@pytest.mark.parametrize("arch,fields", [
    (run[0], run[5]) for run in PIN_RUNS if run[5]])
def test_bf16_pin_plans_at_smoke_width_match_reference(arch, fields):
    """The plans of the pins that are not ``CellPlan()``'s (qwen2-vl-2b's
    ``train_4k`` plan, 4 micro-batches; dbrx-132b's on smollm-135m, 8
    micro-batches and bf16 moments), three bf16 steps on the smoke config
    against the reference's jitted step under the same plan: the bf16
    rule of ``test_torch_train_bf16_steps.py``."""
    from test_torch_train_bf16_steps import (GNORM_REL, GNORM_REL_FIRST,
                                             LOSS_REL)
    ours, theirs = plan_steps(arch, *pin_plans(fields), 3)
    for i, ((loss, gnorm), (jloss, jgnorm)) in enumerate(zip(ours, theirs)):
        assert loss == pytest.approx(jloss, rel=LOSS_REL), i
        rel = GNORM_REL_FIRST if i == 0 else GNORM_REL
        assert gnorm == pytest.approx(jgnorm, rel=rel), i


def test_bf16_train_pins_hold_every_pin_run():
    """``chip_smoke.py``'s ``BF16_TRAIN_PINS`` hold one pin of each
    ``PIN_RUNS`` run, its plan fields with it; qwen2-vl-2b's plan is its
    full config's ``train_4k`` default plan and smollm-135m's second pin
    runs dbrx-132b's, in both packages."""
    import importlib
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)
    assert len(cs.BF16_TRAIN_PINS) == len(PIN_RUNS)
    for pin, (arch, n_layers, steps, batch, seq, fields) in zip(
            cs.BF16_TRAIN_PINS, PIN_RUNS):
        assert (pin["arch"], pin["n_layers"], pin["steps"], pin["batch"],
                pin["seq"]) == (arch, n_layers, steps, batch, seq)
        assert {k: pin[k] for k in ("grad_accum", "opt_state_dtype")
                if k in pin} == fields
        assert cs.bf16_pin_plan(pin) == pin_plans(fields)[0]
        assert batch % pin_plans(fields)[0].grad_accum == 0
    for arch, full_arch in (("qwen2-vl-2b", "qwen2-vl-2b"),
                            ("smollm-135m", "dbrx-132b")):
        fields = [r[5] for r in PIN_RUNS if r[0] == arch][-1]
        ours, theirs = pin_plans(fields)
        want = S.default_plan(get_config(full_arch), "train_4k")
        jwant = JS.default_plan(j_get_config(full_arch), "train_4k")
        assert (ours.grad_accum, ours.opt_state_dtype) \
            == (want.grad_accum, want.opt_state_dtype)
        assert (theirs.grad_accum, theirs.opt_state_dtype) \
            == (jwant.grad_accum, jwant.opt_state_dtype)


# ---------------------------------------------------------------------------
# the pins of chip_smoke.py
# ---------------------------------------------------------------------------

def reference_bf16_train_pin(arch, n_layers, steps, batch, seq,
                             plan) -> dict:
    """The reference's losses and grad norms on one bf16 pin run: its
    jitted ``make_train_step`` with its default plan (bf16 parameters, f32
    moments) and the run's ``plan`` fields on
    ``reference_params_numpy(cfg, 0)`` rounded by the leaf rule."""
    from test_torch_serve import pin_config, pin_frames
    cfg = pin_config(arch, n_layers)
    jcfg = pin_config(arch, n_layers, j_get_config)
    params = _to_jax(reference_params_numpy(cfg, 0), T.param_spec(cfg))
    frames = (jnp.asarray(pin_frames(cfg, batch)).astype(jnp.bfloat16),) \
        if cfg.enc_dec else ()
    state_dtype = getattr(jnp, plan.get("opt_state_dtype", "float32"))
    opt_cfg = JA.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps,
                             state_dtype=state_dtype)
    step = jax.jit(JS.make_train_step(jcfg, JS.CellPlan(
        grad_accum=plan.get("grad_accum", 1), remat=False,
        opt_state_dtype=state_dtype), opt_cfg))
    opt = JA.init_state(params, opt_cfg)
    pipe = JTokenPipeline(JDataConfig(vocab=jcfg.vocab, batch=batch,
                                      seq=seq, seed=0))
    losses, gnorms = [], []
    for _ in range(steps):
        params, opt, loss, gnorm = step(params, opt, jnp.asarray(next(pipe)),
                                        *frames)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return {"arch": arch, "n_layers": n_layers,
            **({"n_enc_layers": cfg.n_enc_layers} if cfg.enc_dec else {}),
            "steps": steps, "batch": batch, "seq": seq, **plan,
            "losses": losses, "grad_norms": gnorms}


if __name__ == "__main__":
    # ``python tests/test_torch_train_bf16.py ARCH`` prints ARCH's pin alone
    for run in PIN_RUNS:
        if sys.argv[1:] in ([], [run[0]]):
            print(json.dumps(reference_bf16_train_pin(*run)), flush=True)
    sys.exit(0)
