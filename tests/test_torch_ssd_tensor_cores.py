"""K4's backward's tensor-core algebra, emulated in plain torch, against
the JAX reference on the CPU.

The backward's kernels take every product on tensor cores as 3xTF32.  The
plain mirror takes the products the same way on request
(``ssd_bwd_ref(..., tf32x3=True)``), so the card's tolerance is checked
here against the reference: within 1e-4 of each gradient's largest entry
of ``jax.vjp`` of ``ssd_chunked`` (``K4_BWD_TOL`` of ``chip_smoke.py``) on
``test_torch_ssd_bwd.py``'s cases, with and without an ``init_state`` and
a final-state cotangent.  The emulation must differ from the f32 algebra
somewhere: it is live.  The bf16 forward's algebra is held in
``test_torch_ssd_bf16_tensor_cores.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref
from test_torch_ssd_bwd import CASES, NAMES, _inputs

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

TOL = 1e-4

@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_tf32x3_backward_matches_jax_vjp(case, with_init, with_dstate):
    args, init, dy, ds = _inputs(case, with_init, with_dstate)
    s0 = np.zeros_like(ds) if init is None else init

    def f(*xs):
        return ssd_chunked(*xs[:5], chunk=case[-1], init_state=xs[5])
    _, vjp = jax.vjp(f, *map(jnp.asarray, (*args, s0)))
    exp = list(vjp((jnp.asarray(dy), jnp.asarray(ds))))
    t = [torch.from_numpy(v) for v in (*args, dy)]
    kw = dict(chunk=case[-1],
              init_state=None if init is None else torch.from_numpy(init))
    dstate = torch.from_numpy(ds) if with_dstate else None
    got = ssd_bwd_ref(*t, dstate, tf32x3=True, **kw)
    for name, g, e in zip(NAMES, got, exp):
        if init is None and name == "dinit":
            assert g is None
            continue
        e = np.asarray(e)
        assert tuple(g.shape) == e.shape, name
        gap = float(np.abs(g.numpy() - e).max())
        assert gap <= TOL * float(np.abs(e).max()), (name, gap)
    f32 = ssd_bwd_ref(*t, dstate, **kw)
    assert any(not torch.equal(g, e) for g, e in zip(got, f32)
               if g is not None)
