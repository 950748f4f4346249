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


#: Blocks of the kernel's cluster (``CLUSTER`` in ``csrc/failrank_step.cu``).
CLUSTER = 8


def failrank_iterate_ordered(w, l, s, s0, *, classes, threads, lam=0.55,
                             alpha=0.1, beta=0.3, gamma=0.6, eps=1e-4,
                             max_iters=100):
    """:func:`failrank_iterate_ref` with the sums in the kernel's order, in
    f32 and without fused multiply-adds (the kernel's build), for a path of
    ``threads`` threads a block whose column sums run over ``classes`` row
    classes.  Block r of the cluster owns columns ``r·cw ..`` (cw =
    ceil(n / 8)); its item ``(p, v)`` (item k: p = k // width, v = k %
    width) sums rows u = p, p + classes, ... of column v in order into a
    partial, and the partials of a column are added in class order.  Thread
    t takes items t, t + threads, ...: its part of Σ|L' − L| runs over
    those items and their rows in order, its part of Σ|s' − s| is its
    column's (t < width).  A warp sums its lanes as the kernel's butterfly
    does (lane 0's value), a block its warps in order, the cluster its
    blocks in order, and the stop is (s-part + L-part) < eps.  Returns
    ``(s, L, steps, residuals)``, the last a list of each step's
    residual."""
    f32 = torch.float32
    oml, lam_, al, be, ga = (torch.tensor(v, dtype=f32)
                             for v in (1.0 - lam, lam, alpha, beta, gamma))
    n = s.shape[0]
    cw = -(-n // CLUSTER)
    k = -(-n // classes)
    pad = k * classes - n

    def lane0(x):  # [..., 32] -> the butterfly's lane 0
        while x.shape[-1] > 1:
            x = x[..., :x.shape[-1] // 2] + x[..., x.shape[-1] // 2:]
        return x[..., 0]
    residuals = []
    for _ in range(max_iters):
        wp = torch.cat([w, w.new_zeros(pad, n)]).reshape(k, classes, n)
        sp = torch.cat([s, s.new_zeros(pad)]).reshape(k, classes)
        part = torch.zeros(classes, n, dtype=f32)
        for r in range(k):
            part = part + wp[r] * sp[r][:, None]
        acc = torch.zeros(n, dtype=f32)
        for p in range(classes):
            acc = acc + part[p]
        s_new = oml * s0 + lam_ * acc
        l_new = al * w + be * s[:, None] + ga * l
        dl_all = (l_new - l).abs()
        total_s = total_l = torch.zeros((), dtype=f32)
        for rank in range(CLUSTER):
            c0 = min(n, rank * cw)
            width = min(n, c0 + cw) - c0
            ds = torch.zeros(threads, dtype=f32)
            ds[:width] = (s_new - s).abs()[c0:c0 + width]
            dl = torch.zeros(threads, dtype=f32)
            items = torch.arange(classes * width)
            for first in range(0, len(items), threads):
                it = items[first:first + threads]
                p, v = it // width, it % width
                t = it - first
                for r in range(k):
                    u = p + r * classes
                    dl[t] = dl[t] + torch.where(
                        u < n, dl_all[u.clamp(max=n - 1), c0 + v], 0.0)
            bs, bl = (lane0(x.reshape(-1, 32)) for x in (ds, dl))
            sum_s = sum_l = torch.zeros((), dtype=f32)
            for wi in range(bs.shape[0]):
                sum_s, sum_l = sum_s + bs[wi], sum_l + bl[wi]
            total_s, total_l = total_s + sum_s, total_l + sum_l
        res = total_s + total_l
        residuals.append(float(res))
        s, l = s_new, l_new
        if float(res) < eps:
            break
    return s, l, len(residuals), residuals
