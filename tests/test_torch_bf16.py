"""The port in bf16 against the JAX reference in bf16, on the CPU.

The reference's working type is bf16 (``init_model(dtype=jnp.bfloat16)``,
``init_cache(dtype=)``, ``EngineConfig.dtype``); the port takes the same
``dtype`` arguments.  Here:

* K3's plain version in bf16 against the Pallas kernel in interpret mode on
  the same bf16 inputs, over the shapes of ``test_torch_attention.py:56``
  (causal, windowed, non-causal; mirrors ``test_kernels.py:294-313``), and
  the plain split-key decode algebra in bf16 against it on rolled caches;
* K4's plain version in bf16 against the Pallas ``ssd_scan`` in interpret
  mode (mirrors ``test_kernels.py:320-354``) and against the model's
  ``ssd_chunked`` in bf16;
* ``init_model(dtype=bf16)``'s leaf types are the reference's
  ``init_model(dtype=jnp.bfloat16)``'s leaf for leaf, for every registered
  smoke config (``test_models.py``'s init test in bf16);
* ``params_from_numpy(dtype=bf16)`` rounds as ``astype`` does and
  ``params_to_numpy`` gives it back exactly;
* ``forward_train``, ``prefill`` and ``decode_step`` in bf16 against the
  reference's on the smollm, mamba2, mixtral, qwen2-vl, whisper and yi-34b
  smoke configs (mirrors ``test_models.py:71-92``);
* ``ServeEngine(EngineConfig(dtype=bf16))`` against the reference's engine,
  teacher-forced (mirrors ``test_serve_engine_matches_reference``).

Tolerances, in bf16 ulps (``ulp(x) = 2^(floor(log2|x|) - 7)``):

* a kernel's plain version against the Pallas kernel: ``KERNEL_ULPS`` of
  each output row's largest |entry|: both compute in f32 from the same bf16
  inputs and round the result once, but sum in other orders, so P (K3) or
  y may round to the other side of a boundary;
* K4's plain version against ``ssd_chunked`` in bf16, which rounds its
  decay matrix, state and ``exp(cum)`` to bf16 on the way
  (``mamba2.py:96-120``): ``CHUNKED_ULPS``;
* the model against the reference: ``LAYER_ULPS`` per layer (encoder layers
  included) plus two, of the largest |logit|; the two round in different
  places (the reference's attention rounds the normalised probabilities,
  ``layers.py:137``, the port's the unnormalised P as the Pallas kernel
  does; its SSD returns f32 where the port's kernel rounds y; XLA's and
  torch's bf16 matmuls and elementwise ops round at other steps), and each
  layer adds its share;
* greedy decoding in bf16 is teacher-forced: the port decodes the
  reference's tokens; at each step its logits at the reference's top-5 ids
  are within the model tolerance, and its argmax is the reference's token
  wherever the reference's top-1/top-2 margin exceeds twice the tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.kernels.flash_attention.ops import gqa_attention as j_gqa
from repro.kernels.ssd_scan.ops import ssd as j_ssd
from repro.models import transformer as JT
from repro.models.mamba2 import ssd_chunked
from repro.serving import engine as JE
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_params_numpy)
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     rolled_pos_tab,
                                                     split_attention_ref)
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import random_inputs
from repro_torch.models import transformer as T
from repro_torch.serving import engine as E
from test_torch_serve import _requests, _to_jax

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BF16 = torch.bfloat16
KERNEL_ULPS = 4
CHUNKED_ULPS = 16
LAYER_ULPS = 2


def _ulp(x):
    """One bf16 ulp of |x| (f32 numpy), elementwise."""
    top = np.maximum(np.abs(np.asarray(x, np.float32)), 2.0 ** -100)
    return np.exp2(np.floor(np.log2(top)) - 7)


def _rows_close(got, exp, ulps):
    """|got − exp| within ``ulps`` bf16 ulps of each last-axis row's
    largest |exp|."""
    g = got.float().numpy() if isinstance(got, torch.Tensor) else got
    e = np.asarray(exp, np.float32)
    tol = ulps * _ulp(np.abs(e).max(-1, keepdims=True))
    gap = np.abs(np.asarray(g, np.float32) - e)
    assert (gap <= tol).all(), float((gap / tol).max()) * ulps


def _bf16(a):
    """f32 numpy → (jnp bf16, torch bf16) holding the same numbers."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


# ---------------------------------------------------------------------------
# K3 and K4: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 2, 2, 32, True, 64),
    (2, 100, 200, 4, 1, 16, False, None),
    (1, 1, 384, 8, 4, 64, True, None),
    (1, 128, 128, 2, 2, 64, True, None),
    # head dims the kernels run at a wider tile (padded_head_dim)
    (2, 100, 100, 8, 1, 8, True, None),
    (1, 150, 150, 6, 2, 24, True, 50),
    (1, 130, 130, 8, 2, 120, True, None),
])
def test_bf16_attention_plain_matches_pallas(b, s, t, hq, hk, d, causal,
                                             win):
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (
        _bf16(rng.standard_normal(shape).astype(np.float32)) for shape in
        ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d)))
    before = dict(_lib.LAUNCHES)
    got = gqa_attention(q, k, v, q_pos=torch.arange(s, dtype=torch.int32),
                        k_pos=torch.arange(t, dtype=torch.int32),
                        causal=causal, window=win)
    assert _lib.LAUNCHES == before          # a CPU tensor takes the plain path
    assert got.dtype == BF16 and got.shape == q.shape
    exp = j_gqa(jq, jk, jv, causal=causal, window=win, impl="pallas",
                q_block=64, kv_block=64)
    assert exp.dtype == jnp.bfloat16
    _rows_close(got, exp.astype(jnp.float32), KERNEL_ULPS)


@pytest.mark.parametrize("t_max,first,last,empty,s,hq,hk,d,window", [
    (200, 0, 149, [], 1, 9, 3, 64, None),
    (256, 100, 611, list(range(64, 128)), 1, 8, 1, 32, None),
    (1024, 600, 1299, [5, 77, 700, 1023], 1, 56, 8, 128, 256),
    (130, 0, 129, [3], 2, 16, 2, 128, None),
])
def test_bf16_split_key_decode_algebra_matches_attention_ref(
        t_max, first, last, empty, s, hq, hk, d, window):
    """The kernel's split-and-merge decode in bf16 (P rounded per split)
    against the direct bf16 algebra over rolled caches with dead splits."""
    rng = np.random.default_rng(t_max + s)
    q, k, v = (_bf16(rng.standard_normal(shape).astype(np.float32))[1]
               for shape in ((2, s, hq, d), (2, t_max, hk, d),
                             (2, t_max, hk, d)))
    k_pos = torch.from_numpy(rolled_pos_tab(t_max, first, last, empty))
    q_pos = torch.arange(last + 1 - s, last + 1, dtype=torch.int32)
    got = split_attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              window=window)
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window)
    assert got.dtype == exp.dtype == BF16
    _rows_close(got, exp.float().numpy(), KERNEL_ULPS)


SSD_CASES = [(2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
             (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32)]


def _ssd_bf16(seed, b, s, h, p, g, n):
    """(jax inputs, torch inputs, f32 state): x, b and c in bf16, dt and a
    in f32, as the model hands them to the scan."""
    x, dt, a, bb, cc, s0 = random_inputs(seed, b, s, h, p, g, n)
    (jx, tx), (jb, tb), (jc, tc) = (_bf16(t) for t in (x, bb, cc))
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc), s0)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_bf16_ssd_plain_matches_pallas_and_ssd_chunked(b, s, h, p, g, n,
                                                        chunk):
    jargs, targs, s0 = _ssd_bf16(1, b, s, h, p, g, n)
    y, st = ssd(*targs, chunk=chunk)
    assert y.dtype == BF16 and st.dtype == torch.float32
    yj, sj = j_ssd(*jargs, impl="pallas", chunk=chunk)
    assert yj.dtype == jnp.bfloat16
    _rows_close(y, yj.astype(jnp.float32), KERNEL_ULPS)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-4,
                               rtol=2e-4)
    y, st = ssd(*targs, chunk=chunk, init_state=torch.from_numpy(s0))
    yc, sc = ssd_chunked(*jargs, chunk=chunk, init_state=jnp.asarray(s0))
    _rows_close(y, np.asarray(yc, np.float32), CHUNKED_ULPS)
    np.testing.assert_allclose(st.numpy(), np.asarray(sc), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _port_types(cfg, model):
    """{the reference's keystr: (shape with the leading period / layer
    axis, dtype name)} of the port's parameters."""
    pl = T.period_len(cfg)
    out = {}
    for name, prm in model.named_parameters():
        parts = name.split(".")
        lead = ()
        if parts[0] == "layers":
            parts = ["periods", f"slot{int(parts[1]) % pl}", *parts[2:]]
            lead = (T.n_periods(cfg),)
        elif parts[0] == "encoder":
            parts = ["encoder", *parts[2:]]
            lead = (cfg.n_enc_layers,)
        key = "".join(f"['{k}']" for k in parts)
        out[key] = (lead + tuple(prm.shape), str(prm.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_init_model_bf16_leaf_types_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    ref = jax.eval_shape(lambda: JT.init_model(
        j_get_config(arch, smoke=True), jax.random.PRNGKey(0),
        dtype=jnp.bfloat16))
    exp = {jax.tree_util.keystr(path): (tuple(leaf.shape), str(leaf.dtype))
           for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    got = _port_types(cfg, T.init_model(cfg, torch.Generator().manual_seed(0),
                                        dtype=BF16))
    assert got == exp
    assert {dt for _, dt in exp.values()} == {"bfloat16", "float32"}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-large-v3"])
def test_bf16_params_round_trip_bit_exact(arch):
    """``params_from_numpy(dtype=bf16)`` holds each leaf as the reference's
    ``astype`` rounds it (f32 where the reference keeps f32), and
    ``params_to_numpy`` gives those numbers back exactly."""
    cfg = get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, 0)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        _to_jax(jax.tree.map(np.copy, tree),
                                T.param_spec(cfg)))
    model = params_from_numpy(cfg, tree, device="cpu", dtype=BF16)
    back = params_to_numpy(cfg, model)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_w) == len(flat_b)
    for path, w in flat_w:
        got = flat_b[path]
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), w.view(np.uint32)), path
    assert {p.dtype for p in model.parameters()} == {BF16, torch.float32}


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

MODEL_ARCHS = ["smollm-135m", "mamba2-1.3b", "mixtral-8x7b", "qwen2-vl-2b",
               "whisper-large-v3", "yi-34b"]


def model_tol(cfg, ref_logits):
    """The bf16 model tolerance: ``LAYER_ULPS`` per layer (encoder layers
    included) plus two, of the largest |reference logit|."""
    depth = cfg.n_layers + cfg.n_enc_layers
    return (LAYER_ULPS * depth + 2) * float(_ulp(np.abs(
        np.asarray(ref_logits, np.float32)).max()))


def _both(arch, seed=0, scale=None):
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    tree = reference_params_numpy(cfg, seed)
    if scale is not None:
        tree["lm_head" if "lm_head" in tree else "embed"] *= scale
    model = params_from_numpy(cfg, tree, device="cpu", dtype=BF16)
    return cfg, jcfg, model, _to_jax(tree, T.param_spec(cfg))


def _frames(cfg, batch, seed=5):
    """An encoder-decoder's frames in bf16 (jax, torch), else Nones."""
    if not cfg.enc_dec:
        return None, None
    rng = np.random.default_rng(seed)
    return _bf16((rng.standard_normal((batch, cfg.n_frames, cfg.d_model))
                  * 0.02).astype(np.float32))


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_bf16_forward_prefill_decode_match_reference(arch):
    cfg, jcfg, model, jparams = _both(arch)
    assert model.embed.dtype == BF16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    tt, tn = torch.from_numpy(tokens), torch.from_numpy(nxt)
    jf, tf = _frames(cfg, 2)

    with torch.no_grad():
        logits, _ = T.forward_train(cfg, model, tt, tf)
    jlogits, _ = JT.forward_train(jcfg, jparams, jnp.asarray(tokens), jf)
    assert logits.dtype == BF16 and jlogits.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=0,
                               atol=model_tol(cfg, _f32(jlogits)))

    cache = T.init_cache(cfg, 2, 64, device="cpu")
    assert all(c[k].dtype == (torch.float32 if k == "ssm" else BF16)
               for c in cache for k in ("k", "v", "conv", "ssm") if k in c)
    last, cache, memory = T.prefill(cfg, model, tt, cache, tf)
    jcache = JT.init_cache(jcfg, 2, 64)
    jlast, jcache, jmemory = JT.prefill(jcfg, jparams, jnp.asarray(tokens),
                                        jcache, enc_frames=jf)
    np.testing.assert_allclose(_f32(last), _f32(jlast), rtol=0,
                               atol=model_tol(cfg, _f32(jlast)))

    dec, _ = T.decode_step(cfg, model, tn, cache, 24, memory)
    jdec, _ = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                             jnp.int32(24), memory=jmemory)
    assert dec.dtype == BF16
    np.testing.assert_allclose(_f32(dec), _f32(jdec), rtol=0,
                               atol=model_tol(cfg, _f32(jdec)))


def teacher_forced(ref_steps, port_steps, ref_tokens, tol):
    """Hold ``port_steps`` (the port's logits [B,V] at each step, given the
    reference's tokens) to ``ref_steps`` (the reference's): the port's
    logits at the reference's top-5 ids within ``tol``, its argmax the
    reference's token wherever the reference's top-1/top-2 margin exceeds
    ``2·tol``.  Returns the near ties, (step, row, margin), which hold the
    logits only."""
    ties = []
    for k, (ref, got) in enumerate(zip(ref_steps, port_steps)):
        top5 = np.argsort(-ref, axis=-1, kind="stable")[:, :5]
        gap = np.abs(np.take_along_axis(got, top5, -1)
                     - np.take_along_axis(ref, top5, -1))
        assert gap.max() <= tol, (k, float(gap.max()), tol)
        srt = np.sort(ref, axis=-1)
        for row, margin in enumerate(srt[:, -1] - srt[:, -2]):
            assert ref[row].argmax() == ref_tokens[row][k]
            if margin > 2 * tol:
                assert got[row].argmax() == ref_tokens[row][k], (k, row)
            else:
                ties.append((k, row, float(margin)))
    return ties


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b",
                                  "mixtral-8x7b", "qwen2-vl-2b",
                                  "whisper-large-v3"])
def test_bf16_serve_engine_matches_reference_teacher_forced(arch,
                                                            monkeypatch):
    """Both engines in bf16 on the launcher's request stream (one batch of
    4): the reference's serves greedily; the port's decodes the
    reference's tokens, and every logit row it takes an argmax of is held
    to the reference's (:func:`teacher_forced`).  The embedding is scaled by
    50 as in ``test_torch_serve.py``, so that the logits spread a few
    units."""
    cfg, jcfg, model, jparams = _both(arch, seed=1, scale=50.0)
    jf, tf = _frames(cfg, 4)
    reqs = _requests(cfg, JE.Request, n=4)
    ref_steps = []
    jeng = JE.ServeEngine(jcfg, jparams,
                          JE.EngineConfig(batch=4, cache_len=64,
                                          dtype=jnp.bfloat16))
    for name in ("_prefill", "_decode"):
        fn = getattr(jeng, name)

        def rec(*args, fn=fn, **kwargs):
            out = fn(*args, **kwargs)
            ref_steps.append(np.asarray(out[0][:, -1].astype(jnp.float32)))
            return out
        setattr(jeng, name, rec)
    for r in reqs:
        jeng.submit(r)
    ref_done = jeng.run(enc_frames=jf)
    ref_tokens = [r.out_tokens for r in ref_done]

    port_steps, fed = [], []

    def watch(fn, forced):
        def wrapped(c, m, tokens, *args, **kwargs):
            if forced:
                k = len(fed)
                fed.append(tokens)
                tokens = torch.tensor([[t[k]] for t in ref_tokens],
                                      dtype=tokens.dtype)
            out = fn(c, m, tokens, *args, **kwargs)
            port_steps.append(out[0][:, -1].float().numpy())
            return out
        return wrapped

    monkeypatch.setattr(E.T, "prefill", watch(T.prefill, False))
    monkeypatch.setattr(E.T, "decode_step", watch(T.decode_step, True))
    eng = E.ServeEngine(cfg, model, E.EngineConfig(
        batch=4, cache_len=64, dtype=BF16, device="cpu"))
    for r in _requests(cfg, E.Request, n=4):
        eng.submit(r)
    done = eng.run(enc_frames=tf)
    assert [r.rid for r in done] == [r.rid for r in ref_done]
    assert len(port_steps) == len(ref_steps) == 1 + 8
    # the last decode step's output is never used as a token
    tol = model_tol(cfg, np.stack(ref_steps))
    ties = teacher_forced(ref_steps[:-1], port_steps[:-1], ref_tokens, tol)
    assert len(ties) < 8 * 4 // 2, ties


def test_bf16_engine_with_an_f32_cache_raises():
    """A bf16 model with ``EngineConfig``'s default f32 cache gives the
    attention bf16 q over an f32 cache, which raises: nothing is cast."""
    cfg = get_config("smollm-135m", smoke=True)
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    eng = E.ServeEngine(cfg, model,
                        E.EngineConfig(batch=2, cache_len=32, device="cpu"))
    eng.submit(E.Request(0, np.arange(5, dtype=np.int32), max_new=2))
    with pytest.raises(ValueError, match="share one type"):
        eng.run()


def test_bf16_and_f32_dtype_arguments_default_as_the_reference():
    """``init_model`` / ``init_cache`` default to bf16, ``EngineConfig`` to
    f32, ``params_from_numpy`` to f32, as the reference's do."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True))
    model = T.init_model(cfg, torch.Generator().manual_seed(0))
    assert model.embed.dtype == BF16
    cache = T.init_cache(cfg, 1, 8, device="cpu")
    assert {str(c[k].dtype) for c in cache for k in c
            if k in ("k", "v", "conv")} == {"torch.bfloat16"}
    assert {c["ssm"].dtype for c in cache if "ssm" in c} == {torch.float32}
    assert E.EngineConfig().dtype == torch.float32
    assert JE.EngineConfig().dtype == jnp.float32
    model = params_from_numpy(cfg, reference_params_numpy(cfg, 0), "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
