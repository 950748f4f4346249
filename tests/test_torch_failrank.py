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

from repro.core.failrank import FailRankParams as JParams
from repro.core.failrank import failrank as j_failrank
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import Mesh2D
from repro.core.sloth import Sloth
from repro.kernels.failrank_step.kernel import failrank_step as j_step
from repro.kernels.failrank_step.ops import failrank_dense as j_dense
from repro.kernels.failrank_step.ref import failrank_step_ref as j_step_ref
from repro_torch.convert import mcg_from_numpy
from repro_torch.core.failrank import FailRankParams, failrank
from repro_torch.kernels import _lib
from repro_torch.kernels.failrank_step.ops import (failrank_dense,
                                                   failrank_iterate,
                                                   failrank_step, mcg_dense,
                                                   row_classes)
from repro_torch.kernels.failrank_step.ref import (failrank_iterate_ordered,
                                                   failrank_iterate_ref,
                                                   failrank_step_ref)

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


@pytest.mark.parametrize("eps,max_iters", [
    (1e-4, 100), (1e-6, 100), (1e-4, 5), (1e-4, 1), (1e-4, 0)])
def test_failrank_dense_iterations_match_reference(ref_mcg, eps, max_iters):
    """The CPU iteration stops where the reference's ``failrank_dense``
    does, at the tolerance and at the step limit."""
    _, s_j, l_j, it_j = j_dense(
        ref_mcg, JParams(eps=eps, max_iters=max_iters), impl="ref")
    _, s, l, it = failrank_dense(
        mcg_from_numpy(ref_mcg), FailRankParams(eps=eps,
                                                max_iters=max_iters),
        device="cpu")
    assert it == it_j == min(it_j, max_iters)
    np.testing.assert_allclose(s, np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(l, np.asarray(l_j), atol=1e-6)


def test_failrank_dense_one_step_is_the_step(ref_mcg):
    """``max_iters = 1`` is exactly one ``failrank_step_ref`` from s0, and
    ``failrank_iterate`` returns the step count on the inputs' device."""
    mcg = mcg_from_numpy(ref_mcg)
    p = FailRankParams(max_iters=1)
    _, s, l, it = failrank_dense(mcg, p, device="cpu")
    w, l0 = map(torch.from_numpy, mcg_dense(mcg))
    s0 = torch.as_tensor(mcg.s0, dtype=torch.float32)
    s_exp, l_exp = failrank_step_ref(w, l0, s0, s0, lam=p.lam,
                                     alpha=p.alpha, beta=p.beta,
                                     gamma=p.gamma)
    assert it == 1
    assert np.array_equal(s, s_exp.numpy())
    assert np.array_equal(l, l_exp.numpy())
    s2, l2, steps = failrank_iterate(w, l0, s0, s0, max_iters=1)
    assert steps.dtype == torch.int32 and int(steps) == 1
    assert torch.equal(s2, s_exp) and torch.equal(l2, l_exp)
    s3, l3 = failrank_step(w, l0, s0, s0)
    assert torch.equal(s3, s_exp) and torch.equal(l3, l_exp)


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


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("n", [68, 260, 1028])
def test_pallas_iteration_counts_are_the_pinned_ones(n):
    """The reference's Pallas ``failrank_step`` (interpret mode) iterated on
    ``chip_smoke.failrank_inputs``' seeded inputs at n, stopping as
    ``failrank_dense`` stops (the L1 residual below 1e-4, or 100 steps),
    takes the steps ``chip_smoke.REFERENCE[("failrank_loop", n)]`` pins,
    which the card holds K2's whole iteration to."""
    cs = _chip_smoke()
    w, l, s, s0 = (jnp.asarray(x.numpy())
                   for x in cs.failrank_inputs("cpu", n))
    it = 0
    for it in range(1, 101):
        s_new, l_new = j_step(w, l, s, s0, interpret=True)
        delta = float(abs(s_new - s).sum() + abs(l_new - l).sum())
        s, l = s_new, l_new
        if delta < 1e-4:
            break
    assert it == cs.REFERENCE[("failrank_loop", n)]


@pytest.mark.parametrize("n,on_chip", [(68, True), (260, True), (68, False),
                                       (260, False), (1028, False)])
def test_kernel_order_stops_at_the_pallas_counts(n, on_chip):
    """K2's order of sums, mirrored in f32 on the CPU
    (``failrank_iterate_ordered`` at the path's row classes and threads,
    ``row_classes``), stops at the reference's Pallas step count at n on
    both paths: the residual sits at eps there, so the order decides the
    step.  The card holds the kernel to the same count and to the mirror's
    residual bit for bit."""
    cs = _chip_smoke()
    classes, threads = row_classes(n, on_chip)
    x = cs.failrank_inputs("cpu", n)
    s, l, steps, res = failrank_iterate_ordered(*x, classes=classes,
                                                threads=threads)
    assert steps == cs.REFERENCE[("failrank_loop", n)]
    assert res[-2] >= 1e-4 > res[-1]
    s_p, l_p, it_p = failrank_iterate_ref(*x, max_iters=steps, eps=-1.0)
    torch.testing.assert_close(s, s_p, atol=1e-6, rtol=0)
    torch.testing.assert_close(l, l_p, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,classes,want", [(68, 68, 32), (1028, 7, 36)])
def test_former_device_order_stopped_one_step_early(n, classes, want):
    """The device-memory path's former order (1,024 threads over the
    stripe's width: 68 classes at n = 68, 7 at 1,028) stops one step before
    the Pallas count, as the card showed."""
    cs = _chip_smoke()
    x = cs.failrank_inputs("cpu", n)
    steps = failrank_iterate_ordered(*x, classes=classes, threads=1024)[2]
    assert steps == want == cs.REFERENCE[("failrank_loop", n)] - 1
