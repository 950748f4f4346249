"""The port's cell grid and serving step builders against the reference's.

Mirrors ``src/repro/launch/steps.py``: ``SHAPES`` (``:30-35``),
``default_plan`` (``:52``), ``skip_reason`` (``:66``), the prefill and
decode step builders (``:135``, ``:146``) and ``input_specs`` (``:169``).

The step test runs a prompt of 2,112 tokens, so that S·T = 2,112² is past
the 2,048² up to which the reference's ``layers.attention`` (``:225-234``)
takes its direct path: smollm's and qwen2-vl's (M-RoPE) prefills go
through ``_chunked_attention`` (``:142``), danube's (window 16) through
``_banded_attention`` (``:186``), and there the prefill overruns the
16-slot ring (``_KVView.update``'s ``s >= t_max`` branch) and the decode
wraps it; mamba2's prefill hands its SSM state to the decode.  Then 8
greedy decode steps.  In f32 (mirroring ``test_models.py:71-92``, 2e-4):
the greedy tokens equal, the last logits, K/V and SSM state within 2e-4,
``pos_tab`` and ``pos`` bit-exact.  In bf16 (mirroring
``test_torch_bf16.py``'s model rule): teacher-forced, the logits at the
reference's top-5 ids within ``LAYER_ULPS`` a layer + 2 of the largest
logit, ``pos_tab`` and ``pos`` bit-exact.

Also K3's start-tile rule for a sorted position table
(``flash_attention.ref.live_tile_range``, by ``torch.searchsorted``: the
range the kernels' warp search finds) against brute-force classification
of every tile, and the wrapper's rule for when a prefill searches
(``flash_attention.ops.bounded_walk``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch import steps as JS
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_numpy, reference_params_numpy
from repro_torch.kernels.flash_attention import ops as K3_ops
from repro_torch.kernels.flash_attention import ref as K3
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from test_torch_bf16 import _f32, model_tol, teacher_forced
from test_torch_serve import _to_jax

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PROMPT = 2112           # 2,112² > 2,048²: the reference's long paths
N_DECODE = 8
BATCH = 2
STEP_ARCHS = ["smollm-135m", "h2o-danube-3-4b", "mamba2-1.3b",
              "qwen2-vl-2b"]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


# ---------------------------------------------------------------------------
# a. the grid and the plan
# ---------------------------------------------------------------------------

def test_shapes_skip_reason_and_default_plan_match_reference():
    assert S.SHAPES == JS.SHAPES
    for arch in list_archs():
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for shape in S.SHAPES:
            assert S.skip_reason(cfg, shape) == JS.skip_reason(jcfg, shape)
            got, exp = S.default_plan(cfg, shape), JS.default_plan(jcfg,
                                                                   shape)
            assert got.grad_accum == exp.grad_accum, (arch, shape)
            assert got.remat == exp.remat
            assert got.param_dtype == DTYPES[exp.param_dtype]
            assert got.opt_state_dtype == DTYPES[exp.opt_state_dtype]
    # long_500k is kept for the window and SSM archs alone
    assert {a for a in list_archs()
            if S.skip_reason(get_config(a), "long_500k") is None} == {
        "h2o-danube-3-4b", "mamba2-1.3b", "mixtral-8x7b",
        "jamba-1.5-large-398b"}


# ---------------------------------------------------------------------------
# d. input_specs
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_input_specs_match_reference(dtype):
    """Every arch × shape: each input's shape and type equal the
    reference's ``input_specs`` (its ``jax.eval_shape`` of ``init_cache``
    against the port's ``init_cache`` on ``meta``); the reference's cache
    stacks each slot over the periods, the port's has a dict a layer."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for arch in list_archs():
        cfg, jcfg = get_config(arch), j_get_config(arch)
        pl = T.period_len(cfg)
        for shape in S.SHAPES:
            got = S.input_specs(cfg, shape, S.CellPlan(param_dtype=dtype))
            exp = JS.input_specs(jcfg, shape, JS.CellPlan(param_dtype=jdtype))
            assert got.keys() == exp.keys(), (arch, shape)
            for key in got.keys() - {"cache"}:
                shp, dt = got[key]
                assert shp == tuple(exp[key].shape), (arch, shape, key)
                assert _dtype_name(dt) == str(exp[key].dtype), (arch, key)
            if "cache" not in got:
                continue
            assert len(got["cache"]) == cfg.n_layers
            for li, layer in enumerate(got["cache"]):
                ref = exp["cache"][f"slot{li % pl}"]
                assert layer.keys() == ref.keys(), (arch, li)
                for k, (shp, dt) in layer.items():
                    assert (T.n_periods(cfg),) + shp == ref[k].shape, \
                        (arch, shape, li, k)
                    assert _dtype_name(dt) == str(ref[k].dtype)


def test_input_specs_batch_is_the_card_s_rows():
    cfg = get_config("h2o-danube-3-4b")
    whole = S.input_specs(cfg, "decode_32k", S.CellPlan())
    card = S.input_specs(cfg, "decode_32k", S.CellPlan(), batch=4)
    assert whole["tokens"] == ((128, 1), torch.int32)
    assert card["tokens"] == ((4, 1), torch.int32)
    # the window's ring, not the 32,768 slots
    assert card["cache"][0]["k"] == ((4, 4096, 8, 120), torch.bfloat16)
    assert card["cache"][0]["pos_tab"] == ((4096,), torch.int32)


# ---------------------------------------------------------------------------
# b, c. prefill, then greedy decode steps, against the reference's
# ---------------------------------------------------------------------------

def _weights(arch, dtype):
    """Port model and reference params on one numpy tree (the logits
    spread a few units: the embedding or head × 50, as the serve tests)."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, 1)
    tree["lm_head" if "lm_head" in tree else "embed"] *= 50.0
    model = params_from_numpy(cfg, tree, device="cpu", dtype=dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return cfg, jcfg, model, _to_jax(tree, T.param_spec(cfg), jdtype)


def _run_both(arch, dtype, forced):
    """The port's and the reference's prefill step, then N_DECODE decode
    steps.  ``forced``: both decode the reference's greedy tokens.  Returns
    the per-step logits [B,V] of each, each one's tokens, and the caches
    after the prefill and at the end."""
    cfg, jcfg, model, jparams = _weights(arch, dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    plan = S.CellPlan(param_dtype=dtype)
    jplan = JS.CellPlan(param_dtype=jdtype)
    seq = PROMPT + N_DECODE
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)

    last, cache = S.make_prefill_step(cfg, plan, seq, BATCH)(
        model, torch.from_numpy(prompt))
    jlast, jcache = jax.jit(JS.make_prefill_step(jcfg, jplan, seq, BATCH))(
        jparams, jnp.asarray(prompt))
    # the port's cache is updated in place: keep the prefill's
    prefilled = ([{k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in c.items()} for c in cache], jcache)
    step = S.make_decode_step(cfg, plan)
    jstep = jax.jit(JS.make_decode_step(jcfg, jplan))
    logits, jlogits = [_f32(last)[:, 0]], [_f32(jlast)[:, 0]]
    tok = last[:, -1].argmax(-1)[:, None].to(torch.int32)
    jtok = jnp.argmax(jlast[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, jtoks = [tok.numpy()[:, 0]], [np.asarray(jtok)[:, 0]]
    for k in range(N_DECODE):
        feed = torch.from_numpy(np.array(jtok)) if forced else tok
        tok, lg, cache = step(model, feed, cache, PROMPT + k)
        jtok, jlg, jcache = jstep(jparams, jtok, jcache,
                                  jnp.int32(PROMPT + k))
        assert tok.dtype == torch.int32 and tok.shape == (BATCH, 1)
        logits.append(_f32(lg)[:, -1])
        jlogits.append(_f32(jlg)[:, -1])
        toks.append(tok.numpy()[:, 0])
        jtoks.append(np.asarray(jtok)[:, 0])
    return (cfg, logits, jlogits, np.stack(toks, 1), np.stack(jtoks, 1),
            prefilled, (cache, jcache))


def _check_positions(cfg, cache, jcache):
    pl = T.period_len(cfg)
    for li, c in enumerate(cache):
        ref = {k: np.asarray(v[li // pl])
               for k, v in jcache[f"slot{li % pl}"].items()}
        assert c["pos"] == int(ref["pos"]), li
        if "pos_tab" in c:
            np.testing.assert_array_equal(c["pos_tab"].numpy(),
                                          ref["pos_tab"])


def _check_state(cfg, cache, jcache, tol=2e-4):
    pl = T.period_len(cfg)
    for li, c in enumerate(cache):
        ref = jcache[f"slot{li % pl}"]
        for k in ("k", "v", "conv", "ssm"):
            if k in c:
                np.testing.assert_allclose(
                    c[k].float().numpy(), _f32(ref[k][li // pl]), atol=tol,
                    rtol=tol, err_msg=f"layer {li} {k}")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_f32(arch):
    cfg, logits, jlogits, toks, jtoks, (c0, j0), (c1, j1) = _run_both(
        arch, torch.float32, forced=False)
    np.testing.assert_array_equal(toks, jtoks)
    for got, exp in zip(logits, jlogits):
        np.testing.assert_allclose(got, exp, atol=2e-4, rtol=2e-4)
    for cache, jcache in ((c0, j0), (c1, j1)):
        _check_positions(cfg, cache, jcache)
        _check_state(cfg, cache, jcache)
    if cfg.window is not None:
        # the prefill kept the window's last 16 positions and the decode
        # overwrote the oldest slots, in ring order
        tab = c1[0]["pos_tab"].numpy()
        assert sorted(tab) == list(range(PROMPT + N_DECODE - cfg.window,
                                         PROMPT + N_DECODE))
        np.testing.assert_array_equal(tab % cfg.window,
                                      np.arange(cfg.window))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_decode_steps_match_reference_bf16(arch):
    cfg, logits, jlogits, _, jtoks, (c0, j0), (c1, j1) = _run_both(
        arch, torch.bfloat16, forced=True)
    tol = max(model_tol(cfg, x) for x in jlogits)
    teacher_forced(jlogits, logits, jtoks, tol)
    for cache, jcache in ((c0, j0), (c1, j1)):
        _check_positions(cfg, cache, jcache)


# ---------------------------------------------------------------------------
# e. K3's start-tile rule for a sorted position table
# ---------------------------------------------------------------------------

def _live_tiles(k_pos, q_lo, q_hi, causal, window, tile):
    """The starts of the tiles with a key that can be live for a row in
    [q_lo, q_hi], by the kernels' ``maybe_live`` on every key."""
    live = (k_pos >= 0) & ((not causal) | (k_pos <= q_hi)) & (
        (window <= 0) | (k_pos > q_lo - window))
    return [t0 for t0 in range(0, len(k_pos), tile)
            if live[t0:t0 + tile].any()]


@pytest.mark.parametrize("tile", [64, 128])
def test_live_tile_range_matches_brute_force(tile):
    """The tiles the bounded walk visits are exactly the live ones, over
    sorted tables with gaps, repeats, empty slots (−1) and arange, with
    and without windows, causal and not."""
    rng = np.random.default_rng(tile)
    for case in range(300):
        t = int(rng.integers(1, 6000))
        k_pos = np.sort(rng.integers(0, 4 * t, t)).astype(np.int32)
        if case % 4 == 1:
            k_pos = np.arange(t, dtype=np.int32)   # a prefill's arange
        if case % 3 == 0:
            k_pos[:int(rng.integers(0, t))] = -1   # empty slots sort first
        q_lo = int(rng.integers(-50, 4 * t + 50))
        q_hi = q_lo + int(rng.integers(0, 300))
        causal = bool(rng.integers(0, 2))
        window = int(rng.choice([0, 1, 16, 64, 4096,
                                 int(rng.integers(1, 500))]))
        lo, hi = K3.live_tile_range(torch.from_numpy(k_pos), q_lo, q_hi,
                                    causal, window, tile)
        if not causal and window <= 0:
            assert (lo, hi) == (0, t)       # every tile: no search
            continue
        assert lo % tile == 0 or lo == t, (case, lo)
        visited = list(range(lo, min(hi, t), tile))
        assert visited == _live_tiles(k_pos, q_lo, q_hi, causal, window,
                                      tile), (case, lo, hi)


def test_live_tile_range_keeps_every_tile_unsorted_or_unbounded():
    k_pos = torch.arange(4000, dtype=torch.int32)
    # no window and not causal: every tile
    assert K3.live_tile_range(k_pos, 10, 20, False, 0, 128) == (0, 4000)
    # a 4 × 512 prefill walks its tiles from key 0: the wrapper asks for
    # no search up to SEARCH_MIN_KEYS keys, nor ever for an unsorted table
    assert not K3_ops.bounded_walk(512, True)
    assert not K3_ops.bounded_walk(K3_ops.SEARCH_MIN_KEYS, True)
    assert K3_ops.bounded_walk(K3_ops.SEARCH_MIN_KEYS + 1, True)
    assert not K3_ops.bounded_walk(524288, False)
    # causal prefill rows 0..127 over 4,000 keys: the first tile alone
    lo, hi = K3.live_tile_range(k_pos, 0, 127, True, 0, 128)
    assert (lo, hi) == (0, 128)
    # danube's window at the last query tile of 32,768
    k_pos = torch.arange(32768, dtype=torch.int32)
    lo, hi = K3.live_tile_range(k_pos, 32640, 32767, True, 4096, 128)
    assert (lo, hi) == (28544 // 128 * 128, 32768)


def test_prefill_cache_keeps_no_view_of_the_prompt():
    """Each layer's cache owns only its own storage after a prefill: the
    Mamba conv state is the last K−1 positions, not a view of the padded
    prompt [B, S+K−1, C] (a view pinned 1.1 GB a layer of mamba2-1.3b at
    4 × 32,768 tokens; the reference returns new arrays)."""
    for arch in ("mamba2-1.3b", "smollm-135m"):
        cfg = get_config(arch, smoke=True)
        model = T.init_model(cfg, torch.Generator().manual_seed(0),
                             dtype=torch.float32)
        prompt = torch.randint(0, cfg.vocab, (2, 200), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        _, cache = S.make_prefill_step(
            cfg, S.CellPlan(param_dtype=torch.float32), 256, 2)(model,
                                                                prompt)
        for layer in cache:
            for key, t in layer.items():
                if isinstance(t, torch.Tensor):
                    assert t.untyped_storage().nbytes() \
                        == t.numel() * t.element_size(), (arch, key)
