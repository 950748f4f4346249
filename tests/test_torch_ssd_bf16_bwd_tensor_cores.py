"""K4's bf16 backward's tensor-core algebra, emulated in plain torch,
against the JAX reference on the CPU.

The bf16 backward's kernels on Hopper take dy·xᵀ on its bf16 values and
every other product with its f32 side split into three bf16 parts (hi =
bf16(v), mid = bf16(v − hi), lo = v − hi − mid: their sum is v exactly) on
``wgmma``.  The plain mirror takes the products the same way on request
(``ssd_bwd_ref(..., tensor_cores=True)``, through ``einsum_3xbf16``), so
the card's tolerance is checked here against the reference: within
``BWD_REF_ULPS`` bf16 ulps of each gradient's largest entry of
``jax.vjp`` of ``ssd_chunked`` in bf16, on the cases of
``test_torch_train_bf16_mirrors.py``'s
``test_bf16_ssd_bwd_ref_matches_jax_vjp`` (with and without an initial
state and a final-state cotangent).  The split is exact, and the
emulation differs from the plain algebra somewhere: it is live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (bf16_split3, einsum_3xbf16,
                                              random_inputs, ssd_bwd_ref)
from test_torch_train_bf16 import BF16, ulps_of_largest
from test_torch_train_bf16_mirrors import BWD_REF_ULPS, SSD_CASES, _bf16_pair

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")


@pytest.mark.parametrize("low,high", [(-100, -60), (-60, -20), (-20, 20),
                                      (20, 60), (60, 100)])
def test_three_part_split_is_exact(low, high):
    """hi + mid + lo equals x bit for bit for f32 values of both signs over
    exponents 2^low..2^high (away from the bottom of the range, where lo
    would be a bf16 subnormal), each part a bf16 value, |mid| and |lo| at
    most half an ulp of the part before."""
    rng = np.random.default_rng(1000 + low)
    x = torch.from_numpy((rng.uniform(1, 2, 100_000) * np.exp2(
        rng.integers(low, high, 100_000)) * rng.choice([-1, 1], 100_000))
        .astype(np.float32))
    hi, mid, lo = bf16_split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    assert torch.equal(hi.float() + (mid.float() + lo.float()), x)
    ulp_hi = torch.exp2(torch.floor(torch.log2(hi.float().abs())) - 7)
    assert bool((mid.float().abs() <= ulp_hi / 2).all())


def test_three_part_product_is_f32_exact_to_the_sums():
    """a (f32) times b (bf16 values): each part's products are exact in f32,
    so the three passes stay within f32 rounding of the f64 product, where
    a bf16 a (one pass) does not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 48)).astype(
        np.float32)).bfloat16().float()
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    three = einsum_3xbf16("ik,kj->ij", a, b)
    assert float((three.double() - exact).abs().max()) <= 1e-6 * scale
    one = a.bfloat16().float() @ b
    assert float((one.double() - exact).abs().max()) > 1e-4 * scale


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_bf16_tensor_core_backward_matches_jax_vjp(case, with_init,
                                                   with_dstate):
    """The mirror of the Hopper kernels' products against ``jax.vjp`` of
    the reference's ``ssd_chunked`` in bf16, within ``BWD_REF_ULPS`` of each
    gradient's largest entry; it differs from the plain algebra's
    gradients somewhere."""
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
    kw = dict(chunk=chunk, init_state=torch.from_numpy(s0)
              if with_init else None)
    args = (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc, tdy,
            torch.from_numpy(ds) if with_dstate else None)
    got = ssd_bwd_ref(*args, tensor_cores=True, **kw)
    plain = ssd_bwd_ref(*args, **kw)
    for name, gg, e in zip(NAMES, got, exp):
        if name == "dinit" and not with_init:
            assert gg is None
            continue
        want = BF16 if name in ("dx", "db", "dc") else torch.float32
        assert gg.dtype == want and tuple(gg.shape) == e.shape, name
        assert ulps_of_largest(gg.float().numpy(),
                               e.astype(jnp.float32)) <= BWD_REF_ULPS, name
    assert any(gg is not None and not torch.equal(gg, pp)
               for gg, pp in zip(got, plain))
