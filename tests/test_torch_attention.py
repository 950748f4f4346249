"""The port's attention (its plain version, on the CPU) against the JAX
reference.

* ``gqa_attention`` over the ``test_kernels.py:294-313`` cases
  (``test_flash_attention_sweep``) against the reference's
  ``gqa_attention`` with ``impl="pallas"`` (the Pallas kernel in interpret
  mode) and ``impl="ref"``: f32 within 2e-5, bf16 within 2e-2, the
  reference's tolerances.  Positions are ``arange``, which is what the
  Pallas kernel assumes.
* ``layers.attention`` over absolute positions against the reference's
  ``layers.attention``: decode over a cache whose position table is rolled
  and partly empty (−1), with and without a sliding window, and a few
  queries at once over the same cache; f32 within 2e-5.
* ``split_attention_ref``, the plain-torch algebra of the kernel's
  split-key decode (partials per 64-key split, merged in index order),
  against ``attention_ref`` and the reference's ``layers.attention`` on
  rolled caches with wholly dead splits and windows; f32 within 2e-5.
* ``decode_splits``, the bf16 decode's split rule: every key in exactly
  one split, splits a multiple of 64 keys, at most 8, none empty by shape,
  the serving shapes' splits on 132 and 114 multiprocessors.
* The backward's 3xTF32 products (``attention_bwd_ref(tf32x3=True)``,
  TF32 by clearing the low 13 mantissa bits) against ``jax.grad`` of the
  reference's ``layers.attention``: within 1e-4 of each gradient's
  largest entry, the kernel's tolerance, at whisper-like non-causal
  shapes and a windowed GQA one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_attention as j_gqa
from repro.models import layers as JL
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ops import (DECODE_MAX_SPLITS,
                                                     DECODE_SPLIT_TILES,
                                                     TILE_WIDTHS,
                                                     decode_splits,
                                                     gqa_attention,
                                                     padded_head_dim,
                                                     uses_decode)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref, live_mask,
                                                     rolled_pos_tab,
                                                     split_attention_ref,
                                                     tf32_split)
from repro_torch.models import layers as TL

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _qkv(seed, b, s, t, hq, hk, d, dtype=jnp.float32):
    """Seeded inputs, rounded to ``dtype``: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win,dtype", [
    (2, 128, 128, 4, 2, 64, True, None, jnp.float32),
    (1, 256, 256, 2, 2, 32, True, 64, jnp.float32),
    (2, 100, 200, 4, 1, 16, False, None, jnp.float32),
    (1, 1, 384, 8, 4, 64, True, None, jnp.float32),
    (1, 128, 128, 2, 2, 64, True, None, jnp.bfloat16),
    # head dims the kernels run at a wider tile (padded_head_dim)
    (2, 100, 100, 8, 1, 8, True, None, jnp.float32),
    (1, 150, 150, 6, 2, 24, True, 50, jnp.float32),
    (1, 130, 130, 8, 2, 120, True, None, jnp.float32),
    (1, 100, 180, 4, 4, 120, False, None, jnp.float32),
])
def test_gqa_attention_matches_pallas_and_ref(b, s, t, hq, hk, d, causal,
                                              win, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(0, b, s, t, hq, hk, d, dtype)
    before = dict(_lib.LAUNCHES)
    got = gqa_attention(q, k, v, q_pos=torch.arange(s, dtype=torch.int32),
                        k_pos=torch.arange(t, dtype=torch.int32),
                        causal=causal, window=win)
    assert _lib.LAUNCHES == before          # a CPU tensor takes the plain path
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    for impl in ("pallas", "ref"):
        exp = j_gqa(jq, jk, jv, causal=causal, window=win, impl=impl,
                    q_block=64, kv_block=64)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(exp, np.float32),
                                   atol=tol, rtol=tol, err_msg=impl)


@pytest.mark.parametrize("s,window", [(1, None), (1, 48), (4, None),
                                      (4, 40)])
def test_attention_over_absolute_positions_matches_layers(s, window):
    b, t_max, hq, hk, d = 2, 96, 6, 2, 32
    (jq, jk, jv), (q, k, v) = _qkv(1, b, s, t_max, hq, hk, d)
    # positions 40..159 went through a 96-slot buffer: slots 0..63 hold
    # 96..159, slots 64..95 hold 64..95, and a few slots are empty
    k_pos = rolled_pos_tab(t_max, 40, 159, [3, 17, 70, 71, 90])
    q_pos = np.arange(160 - s, 160, dtype=np.int32)
    got = TL.attention(q, k, v, q_pos=torch.from_numpy(q_pos),
                       k_pos=torch.from_numpy(k_pos), causal=True,
                       window=window)
    exp = JL.attention(jq, jk, jv, q_pos=jnp.asarray(q_pos),
                       k_pos=jnp.asarray(k_pos), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


def _split_case(seed, b, s, t, hq, hk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d))]


@pytest.mark.parametrize("t_max,first,last,empty,s,hq,hk,d,window,n_dead", [
    # one lap of a 200-slot cache: slots 150..199 never written, so the
    # last split (192..199) is dead; T is not a multiple of 64
    (200, 0, 149, [], 1, 9, 3, 64, None, 1),
    # rolled over, slots 64..127 cleared: a wholly empty split
    (256, 100, 611, list(range(64, 128)), 1, 8, 1, 32, None, 1),
    # windows that leave whole splits outside them
    (256, 100, 611, [5, 70], 1, 3, 3, 16, 40, 2),
    (1024, 600, 1299, [5, 77, 700, 1023], 1, 9, 3, 64, 256, 11),
    # a few rows at once (S · Hq/Hkv = 16, the dispatch line)
    (130, 0, 129, [3], 2, 16, 2, 128, None, 0),
    (130, 0, 129, [3], 4, 8, 2, 32, 50, 1),
])
def test_split_key_decode_algebra_matches_attention_ref(
        t_max, first, last, empty, s, hq, hk, d, window, n_dead):
    """The split-and-merge of the kernel's decode path, in plain torch,
    against the direct masked softmax over a rolled cache."""
    q, k, v = _split_case(t_max + s, 2, s, t_max, hq, hk, d)
    k_pos = torch.from_numpy(rolled_pos_tab(t_max, first, last, empty))
    q_pos = torch.arange(last + 1 - s, last + 1, dtype=torch.int32)
    dead = [t0 for t0 in range(0, t_max, 64)
            if not live_mask(q_pos, k_pos[t0:t0 + 64], True, window).any()]
    assert len(dead) == n_dead
    got = split_attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              window=window)
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window)
    np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_split_key_decode_algebra_writes_zero_for_a_row_without_keys():
    """A row none of whose keys is live is 0 (m = −inf, l = 0 in every
    split), while its neighbours in the same splits are not."""
    q, k, v = _split_case(3, 1, 2, 150, 2, 1, 16)
    k_pos = torch.arange(150, dtype=torch.int32)
    q_pos = torch.tensor([-5, 149], dtype=torch.int32)   # row 0: no key
    got = split_attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos)
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos)
    np.testing.assert_allclose(got[:, 1].numpy(), exp[:, 1].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_split_key_decode_algebra_matches_the_reference_layer():
    """Over the rolled, partly empty cache of
    ``test_attention_over_absolute_positions_matches_layers``, against the
    JAX reference's ``layers.attention``."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 1, 96, 6, 2, 32)
    k_pos = rolled_pos_tab(96, 40, 159, [3, 17, 70, 71, 90])
    q_pos = np.array([159], np.int32)
    for window in (None, 48):
        got = split_attention_ref(q, k, v, q_pos=torch.from_numpy(q_pos),
                                  k_pos=torch.from_numpy(k_pos),
                                  window=window, split=16)
        exp = JL.attention(jq, jk, jv, q_pos=jnp.asarray(q_pos),
                           k_pos=jnp.asarray(k_pos), causal=True,
                           window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("s,hq,hk,decode", [
    (1, 9, 3, True), (1, 128, 8, True), (1, 32, 1, False), (16, 4, 4, True),
    (17, 4, 4, False), (4, 8, 2, True), (2, 24, 2, False), (512, 9, 3, False),
])
def test_dispatch_line_between_decode_and_prefill(s, hq, hk, decode):
    assert uses_decode(s, hq, hk) is decode


@pytest.mark.parametrize("d", range(8, 129, 8))
def test_every_multiple_of_8_up_to_128_is_a_head_dim(d):
    """The kernels take head dim d at the smallest tile width that holds
    it."""
    w = padded_head_dim(d)
    assert w in TILE_WIDTHS and w >= d
    assert all(t < d for t in TILE_WIDTHS if t < w)


@pytest.mark.parametrize("d", [12, 136, 0, 4, 129])
def test_other_head_dims_raise_naming_the_head_dim(d):
    with pytest.raises(ValueError, match=f"head dim {d} "):
        padded_head_dim(d)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("b,t,hk", [
    (4, 1024, 8), (4, 1500, 20), (4, 1024, 3), (2, 511, 1), (2, 512, 1),
    (2, 513, 1), (1, 64, 1), (1, 1, 1), (64, 1024, 8), (4, 8192, 8),
    (1, 100_000, 1)])
def test_decode_splits_cover_the_keys_once(b, t, hk, sms):
    n_split, split_keys = decode_splits(b, t, hk, sms)
    assert 1 <= n_split <= DECODE_MAX_SPLITS and split_keys % 64 == 0
    assert (n_split - 1) * split_keys < t <= n_split * split_keys
    # splits of at most DECODE_SPLIT_TILES tiles where the cluster's size
    # allows it, and never more splits than the rule asks for
    if n_split < DECODE_MAX_SPLITS:
        assert split_keys <= 64 * DECODE_SPLIT_TILES
    assert n_split <= max(-(-sms // (b * hk)),
                          -(-t // (64 * DECODE_SPLIT_TILES)))


@pytest.mark.parametrize("sms,shape,want", [
    (132, (4, 1024, 8), (4, 256)),     # yi-34b, danube: the serve cache
    (132, (4, 1500, 20), (4, 384)),    # whisper's cross decode
    (114, (4, 1500, 20), (4, 384)),
    (132, (4, 1024, 3), (8, 128)),     # smollm
    (114, (4, 1024, 3), (8, 128)),
    (132, (4, 8192, 8), (8, 1024)),    # a long cache: 8 splits at most
    (132, (64, 1024, 8), (3, 384)),    # blocks enough: splits of 6 tiles
])
def test_decode_splits_at_the_serving_shapes(sms, shape, want):
    assert decode_splits(*shape, sms) == want


def test_tf32_split_keeps_19_bits_and_the_rest():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool(((x - hi) != 0).any())
    assert float(((x - hi - lo).abs() / x.abs()).max()) < 2.0 ** -19


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,window", [
    (1, 40, 150, 4, 4, 64, False, None),   # whisper cross: S != T
    (1, 96, 96, 4, 4, 64, False, None),    # whisper encoder
    (2, 48, 48, 6, 2, 32, True, 20)])
def test_attention_bwd_3xtf32_matches_jax_grad(b, s, t, hq, hk, d, causal,
                                               window):
    """The backward kernel's algebra with its 3xTF32 products holds the
    kernel's tolerance, 1e-4 of each gradient's largest entry, against
    ``jax.grad`` of the reference attention in f32; it is not the f32
    algebra bit for bit (the emulation is live)."""
    rng = np.random.default_rng(s + t)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, hk, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((b, s, hq, d)).astype(np.float32)
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
    got = attention_bwd_ref(tq, tk, tv, out, tdo, lse, tf32x3=True, **pos)
    f32 = attention_bwd_ref(tq, tk, tv, out, tdo, lse, **pos)
    assert not all(torch.equal(a, c) for a, c in zip(got, f32))
    for g, e in zip(got, exp):
        e = np.asarray(e)
        assert g.shape == e.shape
        assert float(np.abs(g.numpy() - e).max()) \
            <= 1e-4 * float(np.abs(e).max())
