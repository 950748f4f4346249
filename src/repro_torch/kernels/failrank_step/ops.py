"""Public API: the fused dense FailRank step and the dense iteration.

``failrank_step`` launches ``csrc/failrank_step.cu`` for CUDA tensors and
runs :func:`.ref.failrank_step_ref` for CPU tensors.  ``failrank_dense``
iterates it over an MCG to the L1 tolerance, like the COO iteration in
``core/failrank.py``; the two are different iterations (the dense step
also moves L at non-edge entries, by β·s[u]), so they agree on ``s`` to a
tolerance and not on the iteration count.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.failrank import FailRankParams, _softmax_per_level
from ...core.mcg import MCG
from ...device import resolve_device
from .. import _lib
from .ref import failrank_step_ref


def failrank_step_cuda(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                       gamma=0.6):
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
    fn = _lib.load("failrank_step").failrank_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(fn(w.data_ptr(), l.data_ptr(), s.data_ptr(),
                      s0.data_ptr(), s_new.data_ptr(), l_new.data_ptr(), n,
                      1.0 - lam, lam, alpha, beta, gamma, stream),
                   "failrank_step")
    _lib.LAUNCHES["failrank_step"] += 1
    return s_new, l_new


def failrank_step(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                  gamma=0.6):
    """One fused step → ``(s', L')``; the kernel for CUDA tensors."""
    step = failrank_step_cuda if w.device.type == "cuda" \
        else failrank_step_ref
    return step(w, l, s, s0, lam=lam, alpha=alpha, beta=beta, gamma=gamma)


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
    The residual is reduced on the device and read by the host after
    every step."""
    dev = resolve_device(device)
    w, l = (torch.from_numpy(x).to(dev) for x in mcg_dense(mcg))
    s0 = torch.as_tensor(mcg.s0, dtype=torch.float32, device=dev)
    s = s0
    it = 0
    for it in range(1, params.max_iters + 1):
        s_new, l_new = failrank_step(
            w, l, s, s0, lam=params.lam, alpha=params.alpha,
            beta=params.beta, gamma=params.gamma)
        delta = float((s_new - s).abs().sum() + (l_new - l).abs().sum())
        s, l = s_new, l_new
        if delta < params.eps:
            break
    s_np = s.cpu().numpy()
    node_soft = _softmax_per_level(s_np.astype(np.float64), mcg.node_window)
    return node_soft, s_np, l.cpu().numpy(), it
