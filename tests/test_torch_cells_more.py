"""The serving step builders against the reference's, for the archs that
``test_torch_cells.py`` leaves out: whisper-large-v3, mixtral-8x7b and
dbrx-132b here, stablelm-1.6b and yi-34b in
``test_torch_cells_more_dense.py`` (each file under ~40 s alone).

As ``test_torch_cells.py`` runs them (``make_prefill_step`` then
``make_decode_step``, mirroring ``src/repro/launch/steps.py:135-156``): a
prompt of 2,112 tokens, past the 2,048² up to which the reference's
attention takes its direct path, then 8 greedy decode steps, on smoke
configs with one numpy weight tree.  whisper's seeded numpy frames
(normals × 0.02) go through both prefill steps and the memory each
returns to its own decode steps; mixtral's prefill overruns its 16-slot
ring and the decode wraps it.  In f32: the greedy tokens equal, the last
logits, K/V (and whisper's memory) within 2e-4, ``pos_tab`` and ``pos``
bit-exact.  In bf16: teacher-forced, the logits at the reference's top-5
ids within ``LAYER_ULPS`` a layer + 2 of the largest logit, ``pos_tab``
and ``pos`` bit-exact.

A MoE decode step is discontinuous where a token's k-th and (k+1)-th
router probabilities tie: a bf16 rounding then sends the token to another
expert in one framework than in the other (dbrx-132b's smoke config on
``test_torch_cells.py``'s prompt has such a token, a margin of 1.6e-5 in
f32, and its bf16 logits then stray 12 ulps).  Both tests assert that
every decode token of the port's run clears ``ROUTER_MARGIN``, so a near
tie fails loudly; dbrx's prompt is drawn from ``PROMPT_SEEDS``' seed, the
first after the shared one whose tokens clear it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JS
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from test_torch_bf16 import _f32, model_tol, teacher_forced
from test_torch_cells import (BATCH, N_DECODE, PROMPT, _check_positions,
                              _check_state, _weights)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

MORE_STEP_ARCHS = ["whisper-large-v3", "mixtral-8x7b", "dbrx-132b"]
#: The archs of ``test_torch_cells_more_dense.py``.
DENSE_STEP_ARCHS = ["stablelm-1.6b", "yi-34b"]
#: The prompt's numpy seed where it is not ``test_torch_cells.py``'s 7.
PROMPT_SEEDS = {"dbrx-132b": 8}
#: Least gap between a decode token's k-th and (k+1)-th router
#: probability (bf16 rounding of the router's input moves them by ~1e-3).
ROUTER_MARGIN = 1e-3


def _run_both(arch, dtype, forced):
    """The port's and the reference's prefill step (an encoder-decoder's
    over the same frames), then ``N_DECODE`` decode steps given each one's
    memory.  ``forced``: both decode the reference's greedy tokens.
    Returns the per-step logits [B,V] of each, each one's tokens, the
    caches after the prefill and at the end, the two memories and the
    port's least router margin over the decode tokens (None without
    MoE)."""
    cfg, jcfg, model, jparams = _weights(arch, dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    plan = S.CellPlan(param_dtype=dtype)
    jplan = JS.CellPlan(param_dtype=jdtype)
    seq = PROMPT + N_DECODE
    rng = np.random.default_rng(PROMPT_SEEDS.get(arch, 7))
    prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    frames, jframes = (), ()
    if cfg.enc_dec:
        f = (rng.standard_normal((BATCH, cfg.n_frames, cfg.d_model))
             * 0.02).astype(np.float32)
        frames = (torch.from_numpy(f).to(dtype),)
        jframes = (jnp.asarray(f).astype(jdtype),)

    out = S.make_prefill_step(cfg, plan, seq, BATCH)(
        model, torch.from_numpy(prompt), *frames)
    jout = jax.jit(JS.make_prefill_step(jcfg, jplan, seq, BATCH))(
        jparams, jnp.asarray(prompt), *jframes)
    assert len(out) == len(jout) == (3 if cfg.enc_dec else 2)
    (last, cache), (jlast, jcache) = out[:2], jout[:2]
    memory, jmemory = (out[2], jout[2]) if cfg.enc_dec else (None, None)
    # the port's cache is updated in place: keep the prefill's
    prefilled = ([{k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in c.items()} for c in cache], jcache)
    step = S.make_decode_step(cfg, plan)
    jstep = jax.jit(JS.make_decode_step(jcfg, jplan))
    logits, jlogits = [_f32(last)[:, 0]], [_f32(jlast)[:, 0]]
    tok = last[:, -1].argmax(-1)[:, None].to(torch.int32)
    jtok = jnp.argmax(jlast[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, jtoks = [tok.numpy()[:, 0]], [np.asarray(jtok)[:, 0]]
    margins, route = [], L.moe_route

    def margin_route(cfg, p, xf):
        r = route(cfg, p, xf)
        top = r.probs.sort(-1, descending=True).values
        margins.append(float((top[:, cfg.top_k - 1]
                              - top[:, cfg.top_k]).min()))
        return r
    for k in range(N_DECODE):
        feed = torch.from_numpy(np.array(jtok)) if forced else tok
        L.moe_route = margin_route
        try:
            tok, lg, cache = step(model, feed, cache, PROMPT + k, memory)
        finally:
            L.moe_route = route
        jtok, jlg, jcache = jstep(jparams, jtok, jcache,
                                  jnp.int32(PROMPT + k), jmemory)
        assert tok.dtype == torch.int32 and tok.shape == (BATCH, 1)
        logits.append(_f32(lg)[:, -1])
        jlogits.append(_f32(jlg)[:, -1])
        toks.append(tok.numpy()[:, 0])
        jtoks.append(np.asarray(jtok)[:, 0])
    return (cfg, logits, jlogits, np.stack(toks, 1), np.stack(jtoks, 1),
            prefilled, (cache, jcache), (memory, jmemory),
            min(margins) if margins else None)


def _check_router_margin(cfg, margin):
    if cfg.n_experts:
        assert margin is not None and margin > ROUTER_MARGIN, margin
    else:
        assert margin is None


def check_f32(arch):
    cfg, logits, jlogits, toks, jtoks, (c0, j0), (c1, j1), (m, jm), \
        margin = _run_both(arch, torch.float32, forced=False)
    _check_router_margin(cfg, margin)
    np.testing.assert_array_equal(toks, jtoks)
    for got, exp in zip(logits, jlogits):
        np.testing.assert_allclose(got, exp, atol=2e-4, rtol=2e-4)
    for cache, jcache in ((c0, j0), (c1, j1)):
        _check_positions(cfg, cache, jcache)
        _check_state(cfg, cache, jcache)
    if cfg.enc_dec:
        assert m.shape == (BATCH, cfg.n_frames, cfg.d_model)
        np.testing.assert_allclose(m.numpy(), _f32(jm), atol=2e-4,
                                   rtol=2e-4)
    if cfg.window is not None:
        # the prefill kept the window's last 16 positions and the decode
        # overwrote the oldest slots, in ring order
        tab = c1[0]["pos_tab"].numpy()
        assert sorted(tab) == list(range(PROMPT + N_DECODE - cfg.window,
                                         PROMPT + N_DECODE))
        np.testing.assert_array_equal(tab % cfg.window,
                                      np.arange(cfg.window))


def check_bf16(arch):
    cfg, logits, jlogits, _, jtoks, (c0, j0), (c1, j1), (m, jm), \
        margin = _run_both(arch, torch.bfloat16, forced=True)
    _check_router_margin(cfg, margin)
    tol = max(model_tol(cfg, x) for x in jlogits)
    teacher_forced(jlogits, logits, jtoks, tol)
    for cache, jcache in ((c0, j0), (c1, j1)):
        _check_positions(cfg, cache, jcache)
    if cfg.enc_dec:
        assert m.dtype == torch.bfloat16 and str(jm.dtype) == "bfloat16"


@pytest.mark.parametrize("arch", MORE_STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", MORE_STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_bf16(arch):
    check_bf16(arch)
