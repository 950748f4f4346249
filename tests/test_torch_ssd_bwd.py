"""The plain mirror of K4's backward (``kernels/ssd_scan/ref.ssd_bwd_ref``)
against the JAX reference's gradient of the SSD scan, on the CPU.

Mirrors ``test_kernels.py:320-354`` (the SSD scan's sweep, here for its
gradient) and ``test_torch_train.py:363``
(``test_attention_bwd_ref_matches_jax_grad``: K3's mirror against
``jax.grad``, within 1e-5 of each gradient's largest entry).  On ``test_torch_ssd.py``'s shapes (ragged tails at s = 200,
chunk 64 and s = 80, chunk 32; two heads a group), each with and without
an ``init_state`` and with a zero and a random cotangent of the final
state: the six gradients against ``jax.vjp`` of the reference model's
``mamba2.ssd_chunked`` and against torch autograd through ``ssd_ref``.
The mirror over segments (``ssd_bwd_ref_segments``, what the card holds
K4's backward to past 65,535 chunk-head rows) against the same
``jax.vjp`` over the whole sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (autograd_grads, random_inputs,
                                              ssd_bwd_ref,
                                              ssd_bwd_ref_segments, ssd_ref)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CASES = [(2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
         (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32)]
NAMES = ("dx", "ddt", "da", "db", "dc", "dinit")
TOL = 1e-5


def _inputs(case, with_init, with_dstate):
    b, s, h, p, g, n, _ = case
    x, dt, a, bb, cc, s0 = random_inputs(sum(case), b, s, h, p, g, n)
    rng = np.random.default_rng(sum(case) + 1)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32) \
        if with_dstate else np.zeros_like(s0)
    return (x, dt, a, bb, cc), (s0 if with_init else None), dy, ds


def _mirror(case, args, init, dy, ds, with_dstate):
    t = [torch.from_numpy(v) for v in (*args, dy)]
    return ssd_bwd_ref(*t, torch.from_numpy(ds) if with_dstate else None,
                       chunk=case[-1],
                       init_state=None if init is None
                       else torch.from_numpy(init))


def _assert_close(got, exp):
    for name, g, e in zip(NAMES, got, exp):
        if e is None:
            assert g is None, name
            continue
        e = np.asarray(e)
        assert tuple(g.shape) == e.shape, name
        gap = float(np.abs(g.numpy() - e).max())
        assert gap <= TOL * float(np.abs(e).max()), (name, gap)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_ssd_bwd_ref_matches_jax_vjp(case, with_init, with_dstate):
    args, init, dy, ds = _inputs(case, with_init, with_dstate)
    s0 = np.zeros_like(ds) if init is None else init

    def f(*xs):
        return ssd_chunked(*xs[:5], chunk=case[-1], init_state=xs[5])
    _, vjp = jax.vjp(f, *map(jnp.asarray, (*args, s0)))
    exp = list(vjp((jnp.asarray(dy), jnp.asarray(ds))))
    if init is None:
        exp[5] = None
    _assert_close(_mirror(case, args, init, dy, ds, with_dstate), exp)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_ssd_bwd_ref_matches_autograd_through_ssd_ref(case, with_init,
                                                      with_dstate):
    args, init, dy, ds = _inputs(case, with_init, with_dstate)
    exp = autograd_grads(ssd_ref, [torch.from_numpy(v) for v in args],
                         None if init is None else torch.from_numpy(init),
                         torch.from_numpy(dy), torch.from_numpy(ds),
                         chunk=case[-1])
    _assert_close(_mirror(case, args, init, dy, ds, with_dstate), exp)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case,segment", [(CASES[0], 64), (CASES[2], 16),
                                          (CASES[3], 32)])
def test_ssd_bwd_ref_over_segments_matches_jax_vjp(case, segment, with_init,
                                                   with_dstate):
    """The mirror run segment by segment (the state carried forward, its
    cotangent carried back, ``da`` summed) against ``jax.vjp`` of
    ``ssd_chunked`` over the whole sequence; a ragged last segment at
    s = 96 over 64 and s = 80 over 32."""
    args, init, dy, ds = _inputs(case, with_init, with_dstate)
    s0 = np.zeros_like(ds) if init is None else init

    def f(*xs):
        return ssd_chunked(*xs[:5], chunk=case[-1], init_state=xs[5])
    _, vjp = jax.vjp(f, *map(jnp.asarray, (*args, s0)))
    exp = list(vjp((jnp.asarray(dy), jnp.asarray(ds))))
    if init is None:
        exp[5] = None
    t = [torch.from_numpy(v) for v in (*args, dy)]
    got = ssd_bwd_ref_segments(
        *t, torch.from_numpy(ds) if with_dstate else None, segment=segment,
        chunk=case[-1],
        init_state=None if init is None else torch.from_numpy(init))
    _assert_close(got, exp)


def test_ssd_bwd_ref_segments_must_hold_whole_chunks():
    args, _, dy, _ = _inputs(CASES[0], False, False)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_bwd_ref_segments(*(torch.from_numpy(v) for v in (*args, dy)),
                             None, segment=48, chunk=32)
