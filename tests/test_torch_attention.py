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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import gqa_attention as j_gqa
from repro.models import layers as JL
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ops import gqa_attention
from repro_torch.kernels.flash_attention.ref import rolled_pos_tab
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
