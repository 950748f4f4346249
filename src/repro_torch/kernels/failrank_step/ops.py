"""Public API: the dense FailRank iteration and its single step.

``failrank_iterate`` launches ``csrc/failrank_step.cu`` once for the whole
iteration on CUDA tensors (the residual and the ``eps`` stop stay on the
card) and runs :func:`.ref.failrank_iterate_ref` on CPU tensors.
``failrank_step`` is one step: the same kernel with ``max_iters = 1``.
``failrank_dense`` iterates over an MCG to the L1 tolerance, like the COO
iteration in ``core/failrank.py``; the two are different iterations (the
dense step also moves L at non-edge entries, by β·s[u]), so they agree on
``s`` to a tolerance and not on the iteration count.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.failrank import FailRankParams, _softmax_per_level
from ...core.mcg import MCG
from ...device import resolve_device
from .. import _lib
from .ref import failrank_iterate_ref, failrank_step_ref

#: What ``analysis/kernel_audit.py`` (and, on the card, ``chip_smoke.py``
#: in the SASS) holds ``csrc/failrank_step.cu`` to: no atomics; the
#: cluster's blocks exchange sums through distributed shared memory in a
#: fixed order.
AUDIT = {"float_atomics": 0, "int_atomics": {}, "one_block_per": {}}


def _load():
    lib = _lib.load("failrank_step")
    lib.failrank_iterate.restype = ctypes.c_int
    lib.failrank_iterate.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
        + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
    return lib


#: Row classes of a column's sum on the device-memory path (the
#: shared-memory path takes 256 threads over the stripe's width).  The
#: residual sits at eps when the iteration stops, so the order of the sums
#: decides the step: with 39 classes the kernel stops at the reference's
#: Pallas step counts at n = 68 and 1,028 (33 and 37), as
#: :func:`.ref.failrank_iterate_ordered` shows on the CPU; with 1,024
#: threads over the stripe's width (68 and 7 classes) it stopped one step
#: early at both.
DEVICE_ROW_CLASSES = 39


def row_classes(n: int, on_chip: bool) -> tuple[int, int]:
    """``(classes, threads)`` of the kernel's path at n, as
    ``col_parts`` in ``csrc/failrank_step.cu`` takes them: on chip 256
    threads and 256 // cw classes, in device memory 1,024 threads and
    :data:`DEVICE_ROW_CLASSES` (at most 8,192 // cw); at most n, at least
    one (cw = ceil(n / 8), the width of a block's stripe)."""
    cw = max(1, -(-n // 8))
    classes = 256 // cw if on_chip \
        else min(DEVICE_ROW_CLASSES, 8 * 1024 // cw)
    return max(1, min(classes, n)), 256 if on_chip else 1024


#: ``stripes`` of :func:`failrank_iterate_cuda`: where the kernel keeps W
#: and L (``None``: shared memory where they fit, else device memory).
STRIPES = {None: -1, "device": 0, "shared": 1}


def failrank_iterate_cuda(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                          gamma=0.6, eps=1e-4, max_iters=100, stripes=None,
                          with_residual=False):
    """One launch for up to ``max_iters`` steps; returns ``(s, L, steps)``
    on the card without waiting for them (``steps``: int32 scalar), and
    with ``with_residual`` the last step's L1 residual (f32 scalar) after
    them.  ``stripes`` (a key of :data:`STRIPES`) forces where W and L
    live, so that the two paths can be timed at one n."""
    n = s.shape[0]
    dev = w.device
    for name, x, shape in (("w", w, (n, n)), ("l", l, (n, n)),
                           ("s", s, (n,)), ("s0", s0, (n,))):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"failrank_step: {name} must be a contiguous float32 "
                f"tensor of shape {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if n == 0:
        raise ValueError("failrank_step: empty graph")
    s_new = torch.empty_like(s)
    l_new = torch.empty_like(l)
    steps = torch.empty((), dtype=torch.int32, device=dev)
    residual = torch.empty((), dtype=torch.float32, device=dev) \
        if with_residual else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(_load().failrank_iterate(
            w.data_ptr(), l.data_ptr(), s.data_ptr(), s0.data_ptr(),
            s_new.data_ptr(), l_new.data_ptr(), steps.data_ptr(),
            0 if residual is None else residual.data_ptr(), n, max_iters,
            DEVICE_ROW_CLASSES, 1.0 - lam, lam, alpha, beta, gamma, eps,
            STRIPES[stripes], stream),
            "failrank_step")
    _lib.count("failrank_step")
    if with_residual:
        return s_new, l_new, steps, residual
    return s_new, l_new, steps


def failrank_iterate(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                     gamma=0.6, eps=1e-4, max_iters=100):
    """Steps until the L1 residual is below ``eps`` or ``max_iters``
    steps → ``(s, L, steps)``; one kernel launch for CUDA tensors."""
    run = failrank_iterate_cuda if w.device.type == "cuda" \
        else failrank_iterate_ref
    return run(w, l, s, s0, lam=lam, alpha=alpha, beta=beta, gamma=gamma,
               eps=eps, max_iters=max_iters)


def failrank_step(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                  gamma=0.6):
    """One fused step → ``(s', L')``; the kernel for CUDA tensors."""
    if w.device.type == "cuda":
        return failrank_iterate_cuda(w, l, s, s0, lam=lam, alpha=alpha,
                                     beta=beta, gamma=gamma, eps=-1.0,
                                     max_iters=1)[:2]
    return failrank_step_ref(w, l, s, s0, lam=lam, alpha=alpha, beta=beta,
                             gamma=gamma)


def mcg_dense(mcg: MCG):
    n = mcg.n_nodes
    w = np.zeros((n, n), np.float32)
    l = np.zeros((n, n), np.float32)
    w[mcg.edge_src, mcg.edge_dst] = mcg.edge_w
    l[mcg.edge_src, mcg.edge_dst] = mcg.l0
    return w, l


def failrank_dense(mcg: MCG, params: FailRankParams = FailRankParams(),
                   device=None):
    """Returns (node_scores softmaxed, raw s, raw dense L, iterations).
    On the card the whole iteration is one launch and the host reads s, L
    and the step count once."""
    dev = resolve_device(device)
    w, l = (torch.from_numpy(x).to(dev) for x in mcg_dense(mcg))
    s0 = torch.as_tensor(mcg.s0, dtype=torch.float32, device=dev)
    s, l, steps = failrank_iterate(
        w, l, s0, s0, lam=params.lam, alpha=params.alpha, beta=params.beta,
        gamma=params.gamma, eps=params.eps, max_iters=params.max_iters)
    s_np = s.cpu().numpy()
    node_soft = _softmax_per_level(s_np.astype(np.float64), mcg.node_window)
    return node_soft, s_np, l.cpu().numpy(), int(steps)
