"""K3's and K4's backward mirrors in bf16 against ``jax.grad``, on the CPU.

The plain versions that the card holds the bf16 backward kernels to
(``attention_bwd_ref`` and ``ssd_bwd_ref`` on bf16 inputs, with the
kernels' rounding) against the JAX reference's gradient of its own
``layers.attention`` and ``mamba2.ssd_chunked`` in bf16 (the gradients a
bf16 train step of the reference takes, ``src/repro/models/layers.py:225``
and ``src/repro/models/mamba2.py:64``), on ``test_torch_attention.py``'s
shapes (causal, windowed, non-causal with S != T, GQA 1 to 8, head dims 8
to 120) and ``test_torch_ssd_bwd.py``'s (ragged tails, two heads a group;
with and without an initial state and a final-state cotangent); mirrors
``test_torch_train.py``'s f32 ``test_attention_bwd_ref_matches_jax_grad``
and ``test_torch_ssd_bwd.py``.  Within ``BWD_REF_ULPS`` bf16 ulps of each
gradient's largest |entry| (measured: within 1.0); the reference rounds
the normalised probabilities and dP to bf16 on the way (``layers.py:137``)
and its scan rounds its decay matrix and states, where the mirrors keep
f32 and round each result once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.ssd_scan.ref import random_inputs, ssd_bwd_ref
from test_torch_train_bf16 import BF16, ulps_of_largest

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BWD_REF_ULPS = 2


def _bf16_pair(x):
    """f32 numpy → (jax bf16, torch bf16) of the same numbers."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", [
    (2, 128, 128, 4, 2, 64, True, None), (1, 256, 256, 2, 2, 32, True, 64),
    (2, 100, 200, 4, 1, 16, False, None), (1, 1, 384, 8, 4, 64, True, None),
    (2, 100, 100, 8, 1, 8, True, None), (1, 150, 150, 6, 2, 24, True, 50),
    (1, 130, 130, 8, 2, 120, True, None),
    (1, 100, 180, 4, 4, 120, False, None)])
def test_bf16_attention_bwd_ref_matches_jax_grad(b, s, t, hq, hk, d, causal,
                                                 win):
    rng = np.random.default_rng(s + t)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _bf16_pair(rng.standard_normal(shape).astype(np.float32))
        for shape in ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d),
                      (b, s, hq, d)))
    q_pos = np.arange(s, dtype=np.int32)
    k_pos = np.arange(t, dtype=np.int32)

    def f(q_, k_, v_):
        out = JL.attention(q_, k_, v_, q_pos=jnp.asarray(q_pos),
                           k_pos=jnp.asarray(k_pos), causal=causal,
                           window=win)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))
    exp = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jq, jk, jv)
    pos = dict(q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
               causal=causal, window=win)
    got = attention_bwd_ref(q, k, v, attention_ref(q, k, v, **pos), do,
                            attention_lse_ref(q, k, **pos), **pos)
    for g, e in zip(got, exp):
        assert g.dtype == BF16 and tuple(g.shape) == e.shape
        assert ulps_of_largest(g.float().numpy(),
                               e.astype(jnp.float32)) <= BWD_REF_ULPS


SSD_CASES = [(2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
             (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32)]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_bf16_ssd_bwd_ref_matches_jax_vjp(case, with_init, with_dstate):
    """x, b, c and dy in bf16 (dt, a, the states f32): the mirror's dx, db
    and dc come back in bf16, ddt, da and dinit in f32.  The reference's
    ``ssd_chunked`` returns y in f32 for bf16 inputs, so its cotangent is
    dy's bf16 numbers in f32."""
    bsz, s, h, p, g, n, chunk = case
    x, dt, a, bb, cc, s0 = random_inputs(sum(case), bsz, s, h, p, g, n)
    rng = np.random.default_rng(sum(case) + 1)
    (jx, tx), (jb, tb), (jc, tc), (jdy, tdy) = (
        _bf16_pair(z) for z in (x, bb, cc, rng.standard_normal(
            (bsz, s, h, p)).astype(np.float32)))
    ds = (rng.standard_normal((bsz, h, p, n)) * 0.5).astype(np.float32) \
        if with_dstate else np.zeros_like(s0)
    init = s0 if with_init else np.zeros_like(s0)

    def f(*xs):
        return ssd_chunked(*xs[:5], chunk=chunk, init_state=xs[5])
    exp = jax.jit(lambda *xs: jax.vjp(f, *xs[:6])[1](xs[6:]))(
        jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, jnp.asarray(init),
        jdy.astype(jnp.float32), jnp.asarray(ds))
    got = ssd_bwd_ref(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                      tdy, torch.from_numpy(ds) if with_dstate else None,
                      chunk=chunk, init_state=torch.from_numpy(s0)
                      if with_init else None)
    for name, gg, e in zip(("dx", "ddt", "da", "db", "dc", "dinit"), got,
                           exp):
        if name == "dinit" and not with_init:
            assert gg is None
            continue
        want = BF16 if name in ("dx", "db", "dc") else torch.float32
        assert gg.dtype == want and tuple(gg.shape) == e.shape, name
        assert ulps_of_largest(gg.float().numpy(),
                               e.astype(jnp.float32)) <= BWD_REF_ULPS, name
