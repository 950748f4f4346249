"""K4's bf16 forward's tensor-core algebra, emulated in plain torch,
against the JAX reference on the CPU.

The bf16 forward's kernels take C·Bᵀ in bf16 and the other three products
with the f32 operand split in two (TF32 hi + lo) and the bf16 one whole.
The plain mirror takes the products the same way on request
(``ssd_ref(..., tensor_cores=True)``), so the card's tolerance is checked
here against the reference: within 4 bf16 ulps of each row's largest
entry of the Pallas ``ssd_scan`` in interpret mode, as
``test_torch_bf16.py`` holds the plain path.  The emulation must differ
from the f32 algebra somewhere: it is live.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as j_ssd
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import einsum_2xtf32, ssd_ref
from test_torch_bf16 import (CHUNKED_ULPS, KERNEL_ULPS, SSD_CASES,
                             _rows_close, _ssd_bf16)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_bf16_tensor_core_forward_matches_pallas(b, s, h, p, g, n, chunk):
    jargs, targs, s0 = _ssd_bf16(1, b, s, h, p, g, n)
    y, st = ssd_ref(*targs, chunk=chunk, tensor_cores=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yj, sj = j_ssd(*jargs, impl="pallas", chunk=chunk)
    _rows_close(y, yj.astype(jnp.float32), KERNEL_ULPS)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-4,
                               rtol=2e-4)
    assert not torch.equal(st, ssd_ref(*targs, chunk=chunk)[1])
    y, st = ssd_ref(*targs, chunk=chunk, init_state=torch.from_numpy(s0),
                    tensor_cores=True)
    yc, sc = ssd_chunked(*jargs, chunk=chunk, init_state=jnp.asarray(s0))
    _rows_close(y, np.asarray(yc, np.float32), CHUNKED_ULPS)
    np.testing.assert_allclose(st.numpy(), np.asarray(sc), atol=2e-2,
                               rtol=2e-2)


def test_two_pass_product_keeps_f32_accuracy():
    """a (f32) times b (bf16 values): the two TF32 passes stay within a few
    parts in 2^20 of the f64 product, where one TF32 pass does not."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 48)).astype(
        np.float32)).bfloat16().float()
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    two = einsum_2xtf32("ik,kj->ij", a, b)
    assert float((two.double() - exact).abs().max()) <= 4e-6 * scale
    hi = a.view(torch.int32) & -8192
    one = hi.view(torch.float32) @ b
    assert float((one.double() - exact).abs().max()) > 4e-6 * scale
