"""The port's plain SSD scan (``kernels/ssd_scan/ref.py``, the CPU path of
``ops.ssd``) against the JAX reference.

Mirrors ``test_kernels.py:320-354`` (``test_ssd_kernel_sweep``,
``test_model_ssd_matches_recurrence``) at the reference's 2e-4, on its
shapes: from a zero state against ``ssd(impl="pallas")`` (the Pallas kernel
in interpret mode) and ``ssd(impl="ref")`` (the per-token recurrence), and
from a non-zero ``init_state`` against the model's ``ssd_chunked`` and the
recurrence started from the same state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as j_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as j_recurrence
from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels import _lib
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import random_inputs

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CASES = [(2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
         (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32)]


def _close(got, exp):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_plain_ssd_matches_pallas_and_recurrence(b, s, h, p, g, n, chunk):
    x, dt, a, bb, cc, _ = random_inputs(1, b, s, h, p, g, n)
    before = dict(_lib.LAUNCHES)
    y, st = ssd(*map(torch.from_numpy, (x, dt, a, bb, cc)), chunk=chunk)
    assert _lib.LAUNCHES == before          # a CPU tensor takes the plain path
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    for impl in ("pallas", "ref"):
        yj, sj = j_ssd(*map(jnp.asarray, (x, dt, a, bb, cc)), impl=impl,
                       chunk=chunk)
        _close(y, yj)
        _close(st, sj)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_plain_ssd_from_a_state_matches_ssd_chunked(b, s, h, p, g, n, chunk):
    x, dt, a, bb, cc, s0 = random_inputs(2, b, s, h, p, g, n)
    y, st = ssd(*map(torch.from_numpy, (x, dt, a, bb, cc)), chunk=chunk,
                init_state=torch.from_numpy(s0))
    yj, sj = ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=chunk,
                         init_state=jnp.asarray(s0))
    _close(y, yj)
    _close(st, sj)
    # the per-token recurrence from the same state, in its [B·H, S, ·] layout
    rep = h // g
    yr, sr = j_recurrence(
        jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, p)),
        jnp.asarray(dt.transpose(0, 2, 1).reshape(b * h, s)),
        jnp.asarray(np.tile(a, b)),
        jnp.asarray(np.repeat(bb, rep, 2).transpose(0, 2, 1, 3)
                    .reshape(b * h, s, n)),
        jnp.asarray(np.repeat(cc, rep, 2).transpose(0, 2, 1, 3)
                    .reshape(b * h, s, n)),
        init_state=jnp.asarray(s0.reshape(b * h, p, n)))
    _close(y, np.asarray(yr).reshape(b, h, s, p).transpose(0, 2, 1, 3))
    _close(st, np.asarray(sr).reshape(b, h, p, n))
