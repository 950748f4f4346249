"""The port's FailRank (COO iteration and the fused dense step) against the
JAX reference.

The MCG comes from the reference's ``Sloth.detect`` (darknet19, 4×4 mesh,
core 5 at 10×) and is converted with ``mcg_from_numpy``, so both packages
iterate on one graph.  Mirrors ``test_kernels.py:361-390``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.failrank import failrank as j_failrank
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import Mesh2D
from repro.core.sloth import Sloth
from repro.kernels.failrank_step.kernel import failrank_step as j_step
from repro.kernels.failrank_step.ops import failrank_dense as j_dense
from repro.kernels.failrank_step.ref import failrank_step_ref as j_step_ref
from repro_torch.convert import mcg_from_numpy
from repro_torch.core.failrank import failrank
from repro_torch.kernels import _lib
from repro_torch.kernels.failrank_step.ops import (failrank_dense,
                                                   failrank_step)
from repro_torch.kernels.failrank_step.ref import failrank_step_ref

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def ref_mcg():
    sloth = Sloth(build_workload("darknet19"), Mesh2D(4))
    v = sloth.detect([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)
    return v.mcg


def _step_inputs(n):
    rng = np.random.default_rng(n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return (w, rng.random((n, n)).astype(np.float32),
            rng.random(n).astype(np.float32),
            rng.random(n).astype(np.float32))


@pytest.mark.parametrize("n", [40, 130, 260])
def test_failrank_step_ref_matches_pallas_interpret(n):
    x = _step_inputs(n)
    sp, lp = j_step(*map(jnp.asarray, x))
    st, lt = failrank_step_ref(*map(torch.from_numpy, x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sp), atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lp), atol=1e-5)
    sr, lr = j_step_ref(*map(jnp.asarray, x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), atol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lr), atol=1e-5)


def test_coo_failrank_matches_reference(ref_mcg):
    """Same algorithm, same graph: equal iteration counts and residual
    trace length, raw scores within 1e-6."""
    exp = j_failrank(ref_mcg)
    got = failrank(mcg_from_numpy(ref_mcg), device="cpu")
    assert got.iterations == exp.iterations
    assert len(got.residuals) == len(exp.residuals) == got.iterations
    # each residual is an L1 sum over ~500 float32 terms, summed in another
    # order than XLA's: agreement to 1e-6 absolute
    np.testing.assert_allclose(got.residuals, exp.residuals, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.raw_node_scores, exp.raw_node_scores,
                               atol=1e-6)
    np.testing.assert_allclose(got.raw_edge_scores, exp.raw_edge_scores,
                               atol=1e-6)
    np.testing.assert_allclose(got.node_scores, exp.node_scores, atol=1e-6)


def test_failrank_dense_matches_reference(ref_mcg):
    """The dense iteration equals the reference's (impl="ref") with equal
    iterations, and agrees with the COO scores to 1e-4; the dense and COO
    iterations differ in count (the dense step also moves L off the
    edges)."""
    _, s_j, l_j, it_j = j_dense(ref_mcg, impl="ref")
    before = _lib.LAUNCHES["failrank_step"]
    soft, s, l, it = failrank_dense(mcg_from_numpy(ref_mcg), device="cpu")
    assert _lib.LAUNCHES["failrank_step"] == before
    assert it == it_j
    np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(l, np.asarray(l_j), atol=1e-6)
    coo = failrank(mcg_from_numpy(ref_mcg), device="cpu")
    np.testing.assert_allclose(s, coo.raw_node_scores, atol=1e-4)
    assert it != coo.iterations
    assert soft.shape == (ref_mcg.n_nodes,)


def test_failrank_without_edges():
    mcg = mcg_from_numpy(_EmptyMCG())
    r = failrank(mcg, device="cpu")
    assert r.iterations == 0 and np.array_equal(r.raw_node_scores, mcg.s0)


class _EmptyMCG:
    class mesh:
        width = height = 2
    n_windows, n_nodes = 1, 5
    edge_src = edge_dst = np.zeros(0, np.int64)
    edge_w = l0 = np.zeros(0)
    edge_link_path = []
    s0 = np.arange(5.0)
    node_window = np.zeros(5, np.int64)
