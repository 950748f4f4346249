"""The port's train path against the JAX reference, on the CPU.

Mirrors ``test_substrate.py`` (data pipeline, checkpointing, AdamW) and
``test_system.py`` (training convergence, crash-resume):

* ``TokenPipeline`` batches bit-identical to the reference's; shards
  partition the batch; a restored stream continues where it stopped;
* checkpoints round-trip (bf16 leaves too), ``keep`` collects old steps, a
  stale temporary directory is ignored, and ``restore(..., device=)``
  places the leaves (the reference's re-shard onto a new mesh);
* AdamW descends, clips, keeps bf16 moments, and three ``apply`` calls
  equal the reference's on the same tensors (grad norm and lr within rel
  1e-6, parameters within rel 1e-5, f32 moments within rel 1e-6, bf16
  moments within 1e-2);
* the train step against the reference's jitted ``make_train_step`` on the
  same weights (``reference_params_numpy``) and ``TokenPipeline`` batches,
  for the smollm-135m (GQA, tied embeddings), mamba2-1.3b (the SSD scan's
  plain version under autograd) and h2o-danube-3-4b (sliding window)
  smoke configs: first-step gradients per leaf within 1e-4 of the leaf's
  largest entry, losses and grad norms over 4 steps within rel 1e-5 (f32,
  sums in another order);
* K3's backward mirror ``attention_bwd_ref`` against ``jax.grad`` of the
  reference's ``layers.attention`` (within 1e-5 of each gradient's
  largest entry), and ``attention_lse_ref`` against a logsumexp;
* a fixed batch is learnt well below the uniform floor, and training 20
  steps straight equals 10 steps, a checkpoint and a resumed 10.

Run as a script, this file prints the reference's ``TRAIN_PINS``,
``MAMBA2_TRAIN_PINS`` and ``WHISPER_TRAIN_PINS`` that ``chip_smoke.py``
holds the card to, one JSON line each (smollm-135m at full size, 3 steps
at batch 2 × seq 128, about a minute and 4 GB; mamba2-1.3b at full width
with 4 of its 48 layers, 3 steps at batch 2 × seq 320, three chunks of
128 with a ragged tail, a few minutes and about 6 GB; whisper-large-v3 at
full width with 4 + 4 layers, 3 steps at batch 2 × seq 128 over seeded
frames); an architecture's name prints its pin alone:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py [ARCH]
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JST
from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.optim import adamw as JA
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_params_numpy)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.optim import adamw

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCHS = ["smollm-135m", "mamba2-1.3b", "h2o-danube-3-4b"]

#: The pin runs of ``chip_smoke.py``, (arch, layers kept or None for all,
#: steps, batch, seq): full-size smollm-135m, mamba2-1.3b at full width
#: with 4 layers (the depth cut of the serve pins) and whisper-large-v3 at
#: full width with 4 encoder and 4 decoder layers over the serve pins'
#: frames (``test_torch_serve.pin_frames``), each on
#: ``reference_params_numpy(cfg, 0)`` and ``TokenPipeline`` batches of
#: seed 0, the launcher's AdamW (lr 3e-4, warmup 10).
PIN_RUNS = (("smollm-135m", None, 3, 2, 128), ("mamba2-1.3b", 4, 3, 2, 320),
            ("whisper-large-v3", 4, 3, 2, 128))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (1000, 50)])
def test_pipeline_deterministic(seed, step):
    cfg = DataConfig(vocab=1000, batch=8, seq=16, seed=seed)
    a = TokenPipeline(cfg).batch_at(step)
    assert np.array_equal(a, TokenPipeline(cfg).batch_at(step))
    assert a.min() >= 0 and a.max() < 1000
    ref = JTokenPipeline(JDataConfig(vocab=1000, batch=8, seq=16,
                                     seed=seed)).batch_at(step)
    assert a.dtype == ref.dtype and np.array_equal(a, ref)


def test_pipeline_shards_partition():
    cfg = DataConfig(vocab=100, batch=8, seq=4, seed=1)
    full = TokenPipeline(cfg).batch_at(3)
    parts = [TokenPipeline(cfg, shard=i, n_shards=4).shard_at(3)
             for i in range(4)]
    assert np.array_equal(np.concatenate(parts), full)
    with pytest.raises(ValueError):
        TokenPipeline(cfg, n_shards=3)


def test_pipeline_resume():
    cfg = DataConfig(vocab=100, batch=4, seq=8, seed=0)
    p = TokenPipeline(cfg)
    for _ in range(5):
        next(p)
    expected = next(TokenPipeline.restore(cfg, p.state()))
    q = TokenPipeline(cfg)
    for _ in range(5):
        next(q)
    assert np.array_equal(next(q), expected)
    with pytest.raises(ValueError, match="seed"):
        TokenPipeline.restore(DataConfig(vocab=100, batch=4, seq=8, seed=1),
                              p.state())


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4),
            "nested/b": torch.ones(5, dtype=torch.int32),
            "m": torch.linspace(-2, 2, 7).to(torch.bfloat16),
            "step": torch.tensor(7)}
    store.save(str(tmp_path), 7, tree, extra={"data": {"step": 7,
                                                       "seed": 0}})
    assert store.latest_step(str(tmp_path)) == 7
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored, extra = store.restore(str(tmp_path), 7, like)
    assert extra["data"]["step"] == 7
    assert list(restored) == list(tree)
    for k in tree:
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k]), k
    with pytest.raises(ValueError, match="structure"):
        store.restore(str(tmp_path), 7, {"w": like["w"]})


def test_checkpoint_layout_is_the_reference_layout(tmp_path):
    """The same files as the reference's store: ``step_<N>/manifest.json``
    and ``arrays.npz`` with ``leaf_<i>``; the reference reads ours back."""
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    path = store.save(str(tmp_path), 3, tree)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    got, _ = JST.restore(str(tmp_path), 3, [jnp.zeros((2, 3)),
                                             jnp.zeros(4)])
    assert np.array_equal(np.asarray(got[0]), tree["a"].numpy())
    assert np.array_equal(np.asarray(got[1]), tree["b"].numpy())


def test_checkpoint_gc_keeps_latest(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        store.save(str(tmp_path), s, tree, keep=2)
    assert sorted(store.all_steps(str(tmp_path))) == [4, 5]


def test_checkpoint_atomicity(tmp_path):
    store.save(str(tmp_path), 1, {"x": torch.ones(4)})
    # a stale tmp dir from a crashed writer must not break anything
    os.makedirs(tmp_path / ".tmp_step_2", exist_ok=True)
    assert store.latest_step(str(tmp_path)) == 1


def test_checkpoint_restore_onto_a_device(tmp_path):
    """``device=`` places every leaf, as the reference's ``shardings``
    re-shard does onto a new mesh."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    store.save(str(tmp_path), 3, tree)
    like = {"w": torch.zeros(4, 4, dtype=torch.float64)}
    restored, _ = store.restore(str(tmp_path), 3, like, device="cpu")
    assert restored["w"].device == torch.device("cpu")
    assert restored["w"].dtype == torch.float64
    assert torch.equal(restored["w"], tree["w"].double())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=2000,
                            weight_decay=0.0, clip_norm=1e9,
                            min_lr_frac=1.0)
    x = torch.tensor([5.0, -3.0])
    state = adamw.init_state([x], cfg)
    norms = []
    for _ in range(150):
        state, _ = adamw.apply([x], [2 * x], state, cfg)
        norms.append(float(x.abs().max()))
    assert norms[-1] < 0.5
    assert norms[-1] < norms[0]          # monotone progress overall


def test_global_norm_of_large_leaves_on_the_cpu():
    """The global norm of leaves of 2²² entries, a few large ones first,
    within rel 1e-6 of the f64 norm and of the reference's
    ``global_norm``: torch's f32 norm on the CPU drifts by 1e-3 there
    (whisper-large-v3 at full width with 4 + 4 layers gave a step-1 grad
    norm 7.5e-4 below the reference's)."""
    rng = np.random.default_rng(6)
    leaves = []
    for _ in range(2):
        x = (rng.standard_normal(1 << 22) * 1e-3).astype(np.float32)
        x[:1000] += 1.0
        leaves.append(x)
    want = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in leaves))
    got = float(adamw.global_norm([torch.from_numpy(x) for x in leaves]))
    ref = float(JA.global_norm([jnp.asarray(x) for x in leaves]))
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(ref, rel=1e-6)


def test_adamw_clips_gradients():
    cfg = adamw.AdamWConfig(clip_norm=1.0)
    x = torch.zeros(3)
    state = adamw.init_state([x], cfg)
    _, stats = adamw.apply([x], [torch.full((3,), 1e6)], state, cfg)
    assert float(stats["grad_norm"]) > 1.0   # raw norm reported
    # clipped to norm 1: the first update is lr · ĝ/(|ĝ| + eps) per entry
    assert float(x.abs().max()) <= cfg.lr * 1.001


def test_adamw_bf16_state():
    cfg = adamw.AdamWConfig(state_dtype=torch.bfloat16)
    x = torch.ones(4)
    state = adamw.init_state([x], cfg)
    assert state["m"][0].dtype == torch.bfloat16
    state, _ = adamw.apply([x], [torch.ones(4)], state, cfg)
    assert state["v"][0].dtype == torch.bfloat16
    assert x.dtype == torch.float32 and state["step"] == 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_leaf_groups_give_the_same_bits(state_dtype, monkeypatch):
    """``apply`` updates the leaves a group of at most ``GROUP_ELEMS``
    elements at a time (a larger leaf in pieces of its flattened entries:
    the (64, 8) leaf in two at 300, every leaf entry by entry at 1; the
    global norm takes a larger leaf alone): the groups bound its
    temporaries, and every entry's update is the same bits whatever the
    grouping."""
    rng = np.random.default_rng(8)
    shapes = [(5, 7), (300,), (2, 3, 4), (1,), (64, 8)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes] for _ in range(3)]
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                            clip_norm=0.5,
                            state_dtype=getattr(torch, state_dtype))
    runs = []
    for elems, n_groups, n_pieces in ((1 << 28, 1, 1), (300, 4, 5),
                                      (1, 5, 872)):
        monkeypatch.setattr(adamw, "GROUP_ELEMS", elems)
        ours = [torch.from_numpy(p.copy()) for p in params]
        assert len(adamw._groups(ours)) == n_groups
        assert len(adamw._pieces(ours)) == n_pieces
        state = adamw.init_state(ours, cfg)
        for g in grads:
            state, stats = adamw.apply(ours, g, state, cfg)
        runs.append([*ours, *state["m"], *state["v"], stats["grad_norm"]])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_apply_matches_reference(state_dtype):
    """Three updates of the same tensors from the same gradients: the
    parameters, moments, grad norm and lr of both packages agree."""
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=0.5)
    cfg = adamw.AdamWConfig(**kw, state_dtype=getattr(torch, state_dtype))
    jcfg = JA.AdamWConfig(**kw, state_dtype=getattr(jnp, state_dtype))
    ours = [torch.from_numpy(p.copy()) for p in params]
    theirs = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    state, jstate = adamw.init_state(ours, cfg), JA.init_state(theirs, jcfg)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        state, stats = adamw.apply(ours, [torch.from_numpy(g)
                                          for g in grads], state, cfg)
        theirs, jstate, jstats = JA.apply(
            theirs, {str(i): jnp.asarray(g) for i, g in enumerate(grads)},
            jstate, jcfg)
        assert float(stats["grad_norm"]) == pytest.approx(
            float(jstats["grad_norm"]), rel=1e-6)
        assert stats["lr"] == pytest.approx(float(jstats["lr"]), rel=1e-6)
    assert state["step"] == int(jstate["step"]) == 3
    tol = 1e-6 if state_dtype == "float32" else 1e-2
    for i, p in enumerate(ours):
        np.testing.assert_allclose(p.numpy(), np.asarray(theirs[str(i)]),
                                   rtol=1e-5, atol=1e-6)
        for key in ("m", "v"):
            np.testing.assert_allclose(
                state[key][i].float().numpy(),
                np.asarray(jstate[key][str(i)], np.float32), rtol=tol,
                atol=1e-7)


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    _check_train_step(arch, 32)


def test_mamba2_train_step_over_chunks_matches_reference():
    """At seq 160 the model's chunk is 128: two chunks and a ragged tail of
    32, so the gradient crosses a chunk boundary (at seq 32 the chunk is
    the whole sequence)."""
    _check_train_step("mamba2-1.3b", 160)


def test_mamba2_launcher_trains_over_chunks():
    losses = train.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "3",
                         "--batch", "2", "--seq", "160", "--log-every",
                         "100", "--device", "cpu"])
    assert len(losses) == 3 and all(np.isfinite(losses))


def _check_train_step(arch, seq):
    """First-step gradients (within 1e-4 of each leaf's largest entry) and
    4 steps' losses and grad norms against the reference's jitted step on
    the smoke config, batch 2 × ``seq``."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(cfg, tree, device="cpu")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=2, seq=seq))

    tokens = pipe.batch_at(0)
    jgrads = jax.grad(lambda p: JS.loss_fn(jcfg, p, jnp.asarray(tokens),
                                           remat=False)[0])(jparams)
    S.loss_fn(cfg, model, torch.from_numpy(tokens), remat=False)[0].backward()
    grads = params_to_numpy(cfg, model, {n: p.grad for n, p
                                         in model.named_parameters()})
    exp, got = _leaves(jgrads), _leaves(grads)
    assert got.keys() == exp.keys()
    for key, want in exp.items():
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got[key] - want).max()) <= 1e-4 * scale, key

    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    opt_cfg, jopt_cfg = adamw.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JS.CellPlan(grad_accum=1, remat=False,
                          param_dtype=jnp.float32), jopt_cfg))
    step = S.make_train_step(cfg, S.CellPlan(remat=False,
                                             param_dtype=torch.float32),
                             opt_cfg)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    jstate = JA.init_state(jparams, jopt_cfg)
    for i in range(4):
        toks = pipe.batch_at(i)
        jparams, jstate, jloss, jgnorm = jstep(jparams, jstate,
                                               jnp.asarray(toks))
        state, loss, gnorm = step(model, state, torch.from_numpy(toks))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5), i
        assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-5), i
    # the model trained on copies: the caller's arrays are as drawn
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(reference_params_numpy(cfg, 0))):
        assert np.array_equal(a, b)


def test_train_step_accumulates_micro_batches():
    """``grad_accum=2`` gives the reference's accumulated step: the mean
    of the two micro-batches' losses and gradients."""
    arch = "smollm-135m"
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, 1)
    model = params_from_numpy(cfg, tree, device="cpu")
    toks = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=4,
                                    seq=16)).batch_at(0)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JS.CellPlan(grad_accum=2, remat=False,
                          param_dtype=jnp.float32), JA.AdamWConfig(**kw)))
    jparams = jax.tree.map(jnp.asarray, tree)
    *_, jloss, jgnorm = jstep(jparams, JA.init_state(
        jparams, JA.AdamWConfig(**kw)), jnp.asarray(toks))
    opt_cfg = adamw.AdamWConfig(**kw)
    _, loss, gnorm = S.make_train_step(
        cfg, S.CellPlan(grad_accum=2, remat=False,
                        param_dtype=torch.float32), opt_cfg)(
        model, adamw.init_state(list(model.parameters()), opt_cfg),
        torch.from_numpy(toks))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(gnorm) == pytest.approx(float(jgnorm), rel=1e-5)
    with pytest.raises(ValueError, match="micro-batches"):
        S.make_train_step(cfg, S.CellPlan(grad_accum=3,
                                          param_dtype=torch.float32),
                          opt_cfg)(
            model, adamw.init_state(list(model.parameters()), opt_cfg),
            torch.from_numpy(toks))


@pytest.mark.parametrize("s,t,hq,hk,d,causal,window", [
    (24, 24, 4, 2, 16, True, None), (20, 32, 6, 2, 32, True, 9),
    (16, 16, 2, 2, 16, False, None)])
def test_attention_bwd_ref_matches_jax_grad(s, t, hq, hk, d, causal,
                                            window):
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((2, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, hk, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((2, s, hq, d)).astype(np.float32)
    q_pos = np.arange(t - s, t, dtype=np.int32)
    k_pos = np.arange(t, dtype=np.int32)

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, q_pos=jnp.asarray(q_pos),
                           k_pos=jnp.asarray(k_pos), causal=causal,
                           window=window)
        return jnp.sum(out * dout)
    exp = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    pos = dict(q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
               causal=causal, window=window)
    out = attention_ref(tq, tk, tv, **pos)
    lse = attention_lse_ref(tq, tk, **pos)
    scores = torch.einsum("bshgd,bthd->bhgst",
                          tq.reshape(2, s, hk, hq // hk, d), tk) / d ** 0.5
    live = torch.ones(s, t, dtype=torch.bool)
    if causal:
        live &= pos["k_pos"][None] <= pos["q_pos"][:, None]
    if window is not None:
        live &= pos["k_pos"][None] > pos["q_pos"][:, None] - window
    want_lse = torch.logsumexp(scores.masked_fill(~live, -torch.inf), -1)
    torch.testing.assert_close(lse, want_lse.reshape(2, hq, s))
    got = attention_bwd_ref(tq, tk, tv, out, tdo, lse, **pos)
    for g, e in zip(got, exp):
        e = np.asarray(e)
        assert g.shape == e.shape
        assert float(np.abs(g.numpy() - e).max()) \
            <= 1e-5 * float(np.abs(e).max())


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_training_loss_decreases():
    """Memorisation check (``test_system.py``): a fixed batch must be
    learnt well below the uniform-entropy floor."""
    cfg = get_config("smollm-135m", smoke=True)
    model = params_from_numpy(cfg, reference_params_numpy(cfg, 0), "cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=2000,
                                min_lr_frac=1.0)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    step = S.make_train_step(cfg, S.CellPlan(param_dtype=torch.float32),
                             opt_cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 64)).astype(np.int32))
    losses = []
    for _ in range(40):
        state, loss, _ = step(model, state, tokens)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_crash_resume_continuity(tmp_path):
    """Training 20 steps straight equals 10 steps, a checkpoint and a
    resumed 10 (same data stream, same final loss)."""
    base = ["--arch", "smollm-135m", "--smoke", "--batch", "2", "--seq",
            "32", "--log-every", "100", "--device", "cpu"]
    ck1, ck2 = str(tmp_path / "a"), str(tmp_path / "b")
    full = train.main([*base, "--steps", "20", "--ckpt-dir", ck1,
                       "--ckpt-every", "10"])
    train.main([*base, "--steps", "10", "--ckpt-dir", ck2,
                "--ckpt-every", "10"])
    resumed = train.main([*base, "--steps", "20", "--ckpt-dir", ck2,
                          "--resume"])
    assert len(resumed) == 10
    assert resumed[-1] == pytest.approx(full[-1], rel=1e-4)


# ---------------------------------------------------------------------------
# the pins of chip_smoke.py
# ---------------------------------------------------------------------------

def reference_train_pin(arch, n_layers, steps, batch, seq) -> dict:
    """The reference's losses and grad norms on one pin run."""
    from test_torch_serve import pin_config, pin_frames
    cfg = pin_config(arch, n_layers)
    jcfg = pin_config(arch, n_layers, j_get_config)
    params = jax.tree.map(jnp.asarray, reference_params_numpy(cfg, 0))
    frames = (jnp.asarray(pin_frames(cfg, batch)),) if cfg.enc_dec else ()
    opt_cfg = JA.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)
    step = jax.jit(JS.make_train_step(jcfg, JS.CellPlan(
        grad_accum=1, remat=False, param_dtype=jnp.float32), opt_cfg))
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
            "steps": steps,
            "batch": batch, "seq": seq, "losses": losses,
            "grad_norms": gnorms}


if __name__ == "__main__":
    # ``python tests/test_torch_train.py ARCH`` prints ARCH's pin alone
    for run in PIN_RUNS:
        if sys.argv[1:] in ([], [run[0]]):
            print(json.dumps(reference_train_pin(*run)), flush=True)
    sys.exit(0)
