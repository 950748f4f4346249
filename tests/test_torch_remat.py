"""Rematerialisation in the port's train path, on the CPU.

The reference's plan checkpoints each period of layers by default
(``CellPlan.remat``, ``jax.checkpoint`` over ``_scan_periods``' body) and
always checkpoints whisper's encoder layers; the port does the same with
``torch.utils.checkpoint`` (``forward_train(remat=)``, ``run_encoder``).
On the smoke configs of smollm-135m, mamba2-1.3b, mixtral-8x7b (aux
loss), qwen2-vl-2b (M-RoPE), whisper-large-v3 (encoder-decoder over
seeded frames) and jamba-1.5-large-398b (a period of four layers), with
the reference's weights (``reference_params_numpy`` + ``params_from_numpy``)
and ``TokenPipeline`` batches:

* ``make_train_step`` with ``CellPlan(remat=True)`` and with
  ``CellPlan(remat=False)``, in f32 and in bf16, also at ``grad_accum=2``:
  two steps' losses, grad norms and every parameter equal bit for bit
  (the recompute is the same arithmetic);
* (``test_torch_remat_reference.py`` and ``_bf16.py``) the port's
  ``remat=True`` step against the reference's jitted ``make_train_step``
  with ``CellPlan(remat=True)``;
* the checkpointed regions of a step number ``n_periods(cfg)`` (plus one
  per encoder layer), each holding one period's layers and run twice
  (forward and recompute), jamba also at 8 layers (two regions of 4);
* with ``remat=False`` whisper's encoder layers are still checkpointed
  and its decoder's are not: the plain attention runs twice per encoder
  layer and once per decoder attention;
* under ``torch.no_grad()`` nothing is checkpointed and ``ServeEngine``'s
  tokens are the reference's;
* ``CellPlan()`` keeps the reference's default, and the launcher spells
  the reference launcher's ``remat=False``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils.checkpoint

from repro.configs.base import get_config as j_get_config
from repro.launch import steps as JS
from repro.serving import engine as JE
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, reference_params_numpy
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serving import engine as E
from test_torch_serve import _requests
from test_torch_train_bf16 import frames_bf16

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FAMILIES = ["smollm-135m", "mamba2-1.3b", "mixtral-8x7b", "qwen2-vl-2b",
            "whisper-large-v3", "jamba-1.5-large-398b"]
F32, BF16 = torch.float32, torch.bfloat16
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _frames(cfg, batch, dtype):
    """An encoder-decoder's seeded frames (``frames_bf16``'s draw) as
    ``(jax, torch)`` in ``dtype``, else ``(None, None)``."""
    j, t = frames_bf16(cfg, batch)
    if j is None or dtype == BF16:
        return j, t
    return j.astype(jnp.float32), t.float()


def _model(cfg, dtype):
    return params_from_numpy(cfg, reference_params_numpy(cfg, 0),
                             device="cpu", dtype=dtype)


def _train(cfg, dtype, remat, accum=1, n_steps=2, batch=2, seq=32):
    """``n_steps`` of the port's step → (model, [(loss, gnorm)] tensors)."""
    model = _model(cfg, dtype)
    _, frames = _frames(cfg, batch, dtype)
    opt_cfg = adamw.AdamWConfig(**OPT)
    step = S.make_train_step(cfg, S.CellPlan(grad_accum=accum, remat=remat,
                                             param_dtype=dtype), opt_cfg)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq))
    out = []
    for i in range(n_steps):
        state, loss, gnorm = step(model, state,
                                  torch.from_numpy(pipe.batch_at(i)), frames)
        out.append((loss, gnorm))
    return model, out


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_and_no_remat_train_bit_equal(arch, dtype, accum):
    cfg = get_config(arch, smoke=True)
    m_on, on = _train(cfg, dtype, True, accum)
    m_off, off = _train(cfg, dtype, False, accum)
    for i, ((l1, g1), (l0, g0)) in enumerate(zip(on, off)):
        assert torch.equal(l1, l0) and torch.equal(g1, g0), (i, l1, l0, g1,
                                                             g0)
    for (name, a), b in zip(m_on.named_parameters(), m_off.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name


class _Regions:
    """Counts ``torch.utils.checkpoint.checkpoint`` calls: for each region,
    the layers (``_apply_slot`` calls) of each run of its function."""

    def __init__(self, monkeypatch):
        self.runs, self.kwargs, self._slots = [], [], 0
        real_cp, real_slot = torch.utils.checkpoint.checkpoint, T._apply_slot

        def slot(*args, **kwargs):
            self._slots += 1
            return real_slot(*args, **kwargs)

        def checkpoint(fn, *args, **kwargs):
            runs = []

            def counted(*a):
                # the recompute stops early, once the region's last saved
                # tensor is back: count the layers it entered
                before = self._slots
                try:
                    return fn(*a)
                finally:
                    runs.append(self._slots - before)
            self.runs.append(runs)
            self.kwargs.append(kwargs)
            return real_cp(counted, *args, **kwargs)
        monkeypatch.setattr(T, "_apply_slot", slot)
        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", checkpoint)


@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in FAMILIES]
                         + [("jamba-1.5-large-398b", 8)])
def test_one_checkpoint_per_period(arch, n_layers, monkeypatch):
    cfg = get_config(arch, smoke=True)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    regions = _Regions(monkeypatch)
    _train(cfg, F32, True, n_steps=1)
    enc = cfg.n_enc_layers if cfg.enc_dec else 0
    assert len(regions.runs) == enc + T.n_periods(cfg)
    # the encoder's layers first, then one period of layers a region, each
    # run by the forward and again by the backward
    assert regions.runs == [[0, 0]] * enc \
        + [[T.period_len(cfg)] * 2] * T.n_periods(cfg)
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False}
               for kw in regions.kwargs)
    if arch.startswith("jamba"):
        assert T.period_len(cfg) == 4
        assert T.n_periods(cfg) == (2 if n_layers == 8 else 1)

    regions.runs.clear()
    _train(cfg, F32, False, n_steps=1)
    assert regions.runs == [[0, 0]] * enc


@pytest.mark.parametrize("remat", [False, True])
def test_whisper_encoder_is_checkpointed_without_remat(remat, monkeypatch):
    """The plain attention's calls in one step at seq 16 over 32 frames:
    the encoder's (non-causal, F × F) twice a layer either way, the
    decoder's self (causal) and cross (16 × F) attention once each
    without remat and twice with it."""
    cfg = get_config("whisper-large-v3", smoke=True)
    calls = {}
    real = fa_ops.attention_ref

    def plain(q, k, v, **kw):
        key = ("encoder" if q.shape[1] == cfg.n_frames else
               "self" if kw["causal"] else "cross")
        calls[key] = calls.get(key, 0) + 1
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa_ops, "attention_ref", plain)
    _train(cfg, F32, remat, n_steps=1, seq=16)
    per_decoder = 2 if remat else 1
    assert cfg.n_frames != 16
    assert calls == {"encoder": 2 * cfg.n_enc_layers,
                     "self": per_decoder * cfg.n_layers,
                     "cross": per_decoder * cfg.n_layers}


def test_nothing_is_checkpointed_without_grad(monkeypatch):
    """Serving (``prefill``, ``decode_step``) and a ``forward_train``
    under ``torch.no_grad()`` wrap nothing, whisper's encoder and jamba's
    period included."""
    regions = _Regions(monkeypatch)
    for arch in ("whisper-large-v3", "jamba-1.5-large-398b"):
        cfg = get_config(arch, smoke=True)
        model = _model(cfg, F32)
        _, frames = _frames(cfg, 2, F32)
        toks = torch.from_numpy(TokenPipeline(DataConfig(
            vocab=cfg.vocab, batch=2, seq=8)).batch_at(0))
        cache = T.init_cache(cfg, 2, 16, device="cpu", dtype=F32)
        _, cache, memory = T.prefill(cfg, model, toks, cache, frames)
        T.decode_step(cfg, model, toks[:, :1], cache, 8, memory)
        with torch.no_grad():
            logits, _ = T.forward_train(cfg, model, toks, frames)
        assert not logits.requires_grad
    assert regions.runs == []


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-1.5-large-398b"])
def test_serving_tokens_unchanged(arch, monkeypatch):
    """``ServeEngine`` with checkpointing made to fail: it never calls it,
    and its greedy tokens are the reference engine's."""
    def fail(*args, **kwargs):
        raise AssertionError("serving checkpointed a region")
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", fail)
    cfg = get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, seed=1)
    tree["lm_head" if "lm_head" in tree else "embed"] *= 50.0
    eng = E.ServeEngine(cfg, params_from_numpy(cfg, tree, device="cpu"),
                        E.EngineConfig(batch=4, cache_len=64, device="cpu"))
    jeng = JE.ServeEngine(j_get_config(arch, smoke=True),
                          jax.tree.map(jnp.asarray, tree),
                          JE.EngineConfig(batch=4, cache_len=64))
    for r, jr in zip(_requests(cfg, E.Request), _requests(cfg, JE.Request)):
        eng.submit(r)
        jeng.submit(jr)
    done, jdone = eng.run(), jeng.run()
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]
    assert all(len(r.out_tokens) == 8 for r in done)


def test_plan_keeps_the_reference_default():
    assert S.CellPlan().remat is True
    assert S.CellPlan().remat == JS.CellPlan().remat
    assert S.CellPlan(remat=False).remat is False


def test_launcher_plan_is_the_reference_launchers(monkeypatch):
    """``launch.train`` runs ``CellPlan(grad_accum=1, remat=False,
    param_dtype=f32)``, as the reference's launcher does."""
    plans = []
    real = S.make_train_step

    def spy(cfg, plan, opt_cfg=None):
        plans.append(plan)
        return real(cfg, plan, opt_cfg)
    monkeypatch.setattr(train.steps_mod, "make_train_step", spy)
    train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1",
                "--batch", "2", "--seq", "16", "--log-every", "100",
                "--device", "cpu"])
    assert plans == [S.CellPlan(grad_accum=1, remat=False,
                                param_dtype=torch.float32)]
