"""The port's encoder-decoder (whisper-large-v3) against the JAX reference,
on the CPU.

Both packages get one set of weights (``reference_params_numpy``, the
``encoder`` leaves with a leading layer axis) and the same frame
embeddings: seeded numpy × 0.02, as ``test_models.py:19-25`` makes them
(zero frames alone would hide an encoder that ignores its input).  The
smoke config has 2 encoder and 2 decoder layers, d 64, 32 frames.

* ``init_model``'s and ``reference_params_numpy``'s parameter tree is the
  reference's (``jax.eval_shape``), at its init scales; ``convert``
  round-trips it leaf for leaf (``test_models.py``'s
  ``test_smoke_forward`` builds the same tree);
* ``forward_train`` logits, the memory ``prefill`` returns, its
  last-position logits and 4 ``decode_step``s within 2e-4
  (``test_models.py:71-92``, ``test_prefill_decode_equivalence``);
* ``ServeEngine`` greedy tokens equal the reference's
  ``ServeEngine.run(enc_frames=...)``, every argmax with a top-1 margin
  above 1e-3 (as ``test_torch_serve.py``);
* the train step against the reference's jitted ``make_train_step`` with
  ``enc_frames`` (``test_models.py:46-70``, ``test_smoke_train_step``):
  first-step gradients within 1e-4 of each leaf's largest entry, encoder
  leaves included; losses and grad norms of steps 1 and 3 within rel 1e-5,
  also at ``grad_accum = 2``, which splits the frames;
* ``launch.serve.main`` and ``launch.train.main`` with ``--device cpu``
  over the reference's zero frames, and crash-resume (``test_system.py``'s
  continuity check) on whisper's smoke config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_params_numpy)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import serve, train
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving import engine as E

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ARCH = "whisper-large-v3"


def _cfgs():
    return get_config(ARCH, smoke=True), j_get_config(ARCH, smoke=True)


def _frames(cfg, b, seed=0):
    rng = np.random.default_rng([seed, b])
    return (rng.standard_normal((b, cfg.n_frames, cfg.d_model))
            * 0.02).astype(np.float32)


def _close(got, exp, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(exp),
                               atol=tol, rtol=tol)


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_param_tree_is_the_reference_tree():
    """Shapes against ``jax.eval_shape`` of the reference's init; the
    leaves that do not depend on the key equal, the random ones at the
    reference's mean and std (as ``test_torch_models.py`` holds the
    decoder-only configs)."""
    cfg, jcfg = _cfgs()
    ref0, ref1 = (_leaves(JT.init_model(jcfg, jax.random.PRNGKey(k),
                                        dtype=jnp.float32)) for k in (0, 1))
    model = T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    ours = _leaves(params_to_numpy(cfg, model))
    npy = _leaves(reference_params_numpy(cfg, 0))
    assert ours.keys() == npy.keys() == ref0.keys()
    assert any(k.startswith("['encoder']") for k in ref0)
    assert "['periods']['slot0']['xattn']['wq']" in ref0
    for key, want in ref0.items():
        for got in (ours[key], npy[key]):
            assert got.shape == want.shape and got.dtype == np.float32, key
            if np.array_equal(want, ref1[key]):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
            else:
                tol = 5 / np.sqrt(want.size)
                assert abs(got.std() / want.std() - 1) < tol, key
                assert abs(got.mean() - want.mean()) < 2 * tol * want.std(), key


def test_convert_round_trips_the_tree():
    cfg, _ = _cfgs()
    tree = reference_params_numpy(cfg, 3)
    model = params_from_numpy(cfg, tree, device="cpu")
    assert len(model.encoder) == cfg.n_enc_layers
    back = _leaves(params_to_numpy(cfg, model))
    want = _leaves(tree)
    assert back.keys() == want.keys()
    for key, arr in want.items():
        assert np.array_equal(back[key], arr), key


def test_forward_prefill_decode_match_reference():
    cfg, jcfg = _cfgs()
    tree = reference_params_numpy(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    frames = _frames(cfg, 2)
    tt, tf = torch.from_numpy(tokens), torch.from_numpy(frames)

    logits, aux = T.forward_train(cfg, model, tt, tf)
    jlogits, jaux = JT.forward_train(jcfg, jparams, jnp.asarray(tokens),
                                     enc_frames=jnp.asarray(frames))
    assert float(aux.detach()) == 0.0 == float(jaux)
    _close(logits, jlogits)

    cache = T.init_cache(cfg, 2, 64, device="cpu", dtype=torch.float32)
    last, cache, memory = T.prefill(cfg, model, tt, cache, tf)
    jcache = JT.init_cache(jcfg, 2, 64, dtype=jnp.float32)
    jlast, jcache, jmemory = JT.prefill(jcfg, jparams, jnp.asarray(tokens),
                                        jcache,
                                        enc_frames=jnp.asarray(frames))
    assert memory.shape == (2, cfg.n_frames, cfg.d_model)
    _close(memory, jmemory)
    _close(last, jlast)
    _close(last[:, 0], logits[:, -1].detach().numpy())

    seq = tokens
    for k in range(4):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        dec, cache = T.decode_step(cfg, model, torch.from_numpy(nxt), cache,
                                   24 + k, memory)
        jdec, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(nxt),
                                      jcache, jnp.int32(24 + k),
                                      memory=jmemory)
        _close(dec, jdec)
        seq = np.concatenate([seq, nxt], 1)
    full, _ = T.forward_train(cfg, model, torch.from_numpy(seq), tf)
    _close(dec[:, 0], full[:, -1].detach().numpy())


def test_an_encoder_decoder_needs_its_frames():
    cfg, _ = _cfgs()
    model = T.init_model(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32)
    toks = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_frames"):
        T.forward_train(cfg, model, toks)
    cache = T.init_cache(cfg, 1, 8, "cpu", torch.float32)
    with pytest.raises(ValueError, match="memory"):
        T.decode_step(cfg, model, toks[:, :1], cache, 0)


def _margin(logits):
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def _requests(cfg, make, n=8, prompt_len=16, max_new=8, seed=0):
    """The launcher's request stream (``launch/serve.py``)."""
    rng = np.random.default_rng([seed, 0])
    return [make(i, rng.integers(0, cfg.vocab, size=int(
        rng.integers(2, prompt_len + 1))).astype(np.int32), max_new=max_new)
        for i in range(n)]


def test_serve_engine_matches_reference(monkeypatch):
    cfg, jcfg = _cfgs()
    tree = reference_params_numpy(cfg, seed=1)
    # the smoke init's logits spread about 0.1; scaled, they spread a few
    # units and no argmax is a near tie
    tree["lm_head"] *= 50.0
    frames = _frames(cfg, 4, seed=1)
    margins = []

    def watch(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            margins.append(_margin(out[0][:, -1]))
            return out
        return wrapped

    monkeypatch.setattr(E.T, "prefill", watch(T.prefill))
    monkeypatch.setattr(E.T, "decode_step", watch(T.decode_step))
    eng = E.ServeEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                        E.EngineConfig(batch=4, cache_len=64, device="cpu"))
    for r in _requests(cfg, E.Request):
        eng.submit(r)
    done = eng.run(enc_frames=torch.from_numpy(frames))

    jeng = JE.ServeEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                          JE.EngineConfig(batch=4, cache_len=64))
    for r in _requests(cfg, JE.Request):
        jeng.submit(r)
    jdone = jeng.run(enc_frames=jnp.asarray(frames))

    assert [r.rid for r in done] == [r.rid for r in jdone] == list(range(8))
    assert all(len(r.out_tokens) == 8 for r in done)
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert len(margins) == 2 * (1 + 8) and min(margins) > 1e-3, margins


def _steps(plan_accum, n_steps, grads=False):
    """The port's and the reference's train steps on one tree, batch 4 ×
    32 with frames; returns both (losses, grad norms) and, with ``grads``,
    both first-step gradient trees."""
    cfg, jcfg = _cfgs()
    tree = reference_params_numpy(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(cfg, tree, device="cpu")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=4, seq=32))
    frames = _frames(cfg, 4)
    out = {}
    if grads:
        toks = pipe.batch_at(0)
        out["jgrads"] = _leaves(jax.grad(lambda p: JS.loss_fn(
            jcfg, p, jnp.asarray(toks), jnp.asarray(frames),
            remat=False)[0])(jparams))
        S.loss_fn(cfg, model, torch.from_numpy(toks),
                  torch.from_numpy(frames), remat=False)[0].backward()
        out["grads"] = _leaves(params_to_numpy(
            cfg, model, {n: p.grad for n, p in model.named_parameters()}))
        for p in model.parameters():
            p.grad = None
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    opt_cfg, jopt_cfg = adamw.AdamWConfig(**kw), JA.AdamWConfig(**kw)
    jstep = jax.jit(JS.make_train_step(
        jcfg, JS.CellPlan(grad_accum=plan_accum, remat=False,
                          param_dtype=jnp.float32), jopt_cfg))
    step = S.make_train_step(cfg, S.CellPlan(grad_accum=plan_accum,
                                             remat=False,
                                             param_dtype=torch.float32),
                             opt_cfg)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    jstate = JA.init_state(jparams, jopt_cfg)
    ours, ref = [], []
    for i in range(n_steps):
        toks = pipe.batch_at(i)
        jparams, jstate, jloss, jgnorm = jstep(
            jparams, jstate, jnp.asarray(toks), jnp.asarray(frames))
        state, loss, gnorm = step(model, state, torch.from_numpy(toks),
                                  torch.from_numpy(frames))
        ours.append((float(loss), float(gnorm)))
        ref.append((float(jloss), float(jgnorm)))
    out["ours"], out["ref"] = ours, ref
    return out


def test_first_step_gradients_match_reference():
    out = _steps(1, 1, grads=True)
    exp, got = out["jgrads"], out["grads"]
    assert got.keys() == exp.keys()
    assert sum(k.startswith("['encoder']") for k in exp) == 10
    for key, want in exp.items():
        scale = max(float(np.abs(want).max()), 1e-12)
        assert scale > 1e-8, key     # every leaf takes a gradient
        assert float(np.abs(got[key] - want).max()) <= 1e-4 * scale, key
    assert out["ours"][0] == pytest.approx(out["ref"][0], rel=1e-5)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_reference(grad_accum):
    out = _steps(grad_accum, 3)
    for i in (0, 2):
        for a, b in zip(out["ours"][i], out["ref"][i]):
            assert a == pytest.approx(b, rel=1e-5), (i, out)


def test_serve_main_on_cpu(capsys):
    steps = []
    done, stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--requests", "5", "--max-new", "3"],
                             step_hook=lambda kind, dt: steps.append(kind))
    assert [r.rid for r in done] == list(range(5))
    assert stats["tokens"] == 15
    assert all(0 <= t < 256 for r in done for t in r.out_tokens)
    assert steps == (["prefill"] + ["decode"] * 3) * 2
    assert "served 5 requests, 15 tokens" in capsys.readouterr().out


def test_train_main_and_crash_resume(tmp_path):
    """Three launcher steps train; 6 steps straight equal 3 steps, a
    checkpoint (the encoder's parameters and moments with the rest) and a
    resumed 3."""
    base = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
            "--log-every", "100", "--device", "cpu"]
    losses = train.main([*base, "--steps", "3"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    ck1, ck2 = str(tmp_path / "a"), str(tmp_path / "b")
    full = train.main([*base, "--steps", "6", "--ckpt-dir", ck1,
                       "--ckpt-every", "3"])
    train.main([*base, "--steps", "3", "--ckpt-dir", ck2, "--ckpt-every",
                "3"])
    resumed = train.main([*base, "--steps", "6", "--ckpt-dir", ck2,
                          "--resume"])
    assert full[:3] == losses
    assert len(resumed) == 3
    assert resumed == pytest.approx(full[3:], rel=1e-6)
    model = T.init_model(get_config(ARCH, smoke=True),
                         torch.Generator().manual_seed(0), dtype=torch.float32)
    tree = train.checkpoint_tree(model, adamw.init_state(
        list(model.parameters()), adamw.AdamWConfig()))
    for key in ("params/encoder.1.attn.wq", "params/enc_final_norm.scale",
                "opt/m/encoder.1.mlp.w_up", "opt/v/encoder.0.norm1.bias",
                "params/layers.0.xattn.wk", "opt/v/layers.1.xnorm.scale"):
        assert key in tree, key
