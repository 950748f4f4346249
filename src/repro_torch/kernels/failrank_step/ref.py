"""Plain torch version of the dense FailRank step and of its iteration:
the reference for ``csrc/failrank_step.cu`` and the path the wrappers take
for CPU tensors."""

from __future__ import annotations

import torch


def failrank_step_ref(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                      gamma=0.6):
    """w/l [n, n] (w[u, v] = propagation weight), s/s0 [n] → (s', L')."""
    s_new = (1.0 - lam) * s0 + lam * (w.T @ s)
    l_new = alpha * w + beta * s[:, None] + gamma * l
    return s_new, l_new


def failrank_iterate_ref(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                         gamma=0.6, eps=1e-4, max_iters=100):
    """Steps from ``(s, l)`` until the L1 residual ``Σ|s'−s| + Σ|L'−L|``
    (read by the host after every step) is below ``eps``, or
    ``max_iters`` steps.  Returns ``(s, L, steps)``, ``steps`` an int32
    scalar tensor on the inputs' device."""
    it = 0
    for it in range(1, max_iters + 1):
        s_new, l_new = failrank_step_ref(w, l, s, s0, lam=lam, alpha=alpha,
                                         beta=beta, gamma=gamma)
        delta = float((s_new - s).abs().sum() + (l_new - l).abs().sum())
        s, l = s_new, l_new
        if delta < eps:
            break
    return s, l, torch.tensor(it, dtype=torch.int32, device=s.device)
