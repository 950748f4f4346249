"""Plain torch version of the fused dense FailRank step: the reference for
``csrc/failrank_step.cu`` and the path the wrapper takes for CPU
tensors."""

from __future__ import annotations


def failrank_step_ref(w, l, s, s0, *, lam=0.55, alpha=0.1, beta=0.3,
                      gamma=0.6):
    """w/l [n, n] (w[u, v] = propagation weight), s/s0 [n] → (s', L')."""
    s_new = (1.0 - lam) * s0 + lam * (w.T @ s)
    l_new = alpha * w + beta * s[:, None] + gamma * l
    return s_new, l_new
