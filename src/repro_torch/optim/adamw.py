"""AdamW with global-norm clipping and a warmup + cosine schedule.

A port of the reference's ``optim/adamw.py`` as plain functions on a list
of tensors, the model's parameters in one fixed order
(``list(model.parameters())``), with the state's moments in the same
order.  ``torch.optim.AdamW`` is not used: its clipping and schedule
differ.  ``state_dtype`` keeps the moments in bf16 where asked (the update
is computed in f32).  A bf16 parameter is updated in f32 and rounded back
to nearest even, as the reference's ``astype(p.dtype)`` rounds.

Unlike the reference, which returns new arrays, :func:`apply` updates the
parameters and the moments in place: a train step holds one copy of
each.  It updates the leaves a group of at most :data:`GROUP_ELEMS`
elements at a time, a larger leaf in pieces of its flattened entries, so
the update's temporaries (about seven copies of a group) stay bounded
whatever the model's size and its largest leaf (dbrx-132b's experts:
1.06 G entries a leaf); each entry's arithmetic is the same whatever the
grouping.  The step count stays a Python int, so
the schedule needs no read from the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


#: Most elements (1 GiB in f32) one multi-tensor pass of :func:`apply`
#: updates (a larger leaf in pieces) and of the global norm takes (a
#: larger leaf alone).
GROUP_ELEMS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: torch.dtype = torch.float32


def init_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside ``params`` (a sequence of tensors), step 0."""
    def zeros():
        return [torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
                for p in params]
    return {"m": zeros(), "v": zeros(), "step": 0}


def schedule(step: int, cfg: AdamWConfig) -> float:
    """The learning rate at ``step`` (1 for the first update), in f32 as
    the reference computes it."""
    f = np.float32
    warm = min(f(step) / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip(f(step - cfg.warmup_steps)
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * prog))
    frac = f(cfg.min_lr_frac) + (f(1) - f(cfg.min_lr_frac)) * cos
    return float(f(cfg.lr) * warm * frac)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (an f32 scalar on the
    tensors' device), from each leaf's L2 norm in f32, summed in leaf
    order.  On the card the norms are a multi-tensor launch (tree
    reductions) per group of :func:`apply`'s (:func:`_groups`), so at most
    one group's f32 copy of bf16 leaves is alive (f32 leaves are read in
    place); a leaf's norm is the same bits whatever its group.  On the
    CPU each leaf's norm accumulates in f64: torch's f32 norm there drifts
    with the leaf's size (3e-4 of the norm at 2²⁰ entries, 2e-2 at
    whisper's 66 M-entry embedding)."""
    if tensors[0].device.type == "cuda":
        norms = _group_norms(tensors)
    else:
        norms = [torch.linalg.vector_norm(x, dtype=torch.float64).float()
                 for x in tensors]
    return torch.stack(norms).square().sum().sqrt()


def _group_norms(tensors) -> list:
    """Each leaf's L2 norm in f32, one multi-tensor call per group of
    :func:`_groups`, on that group's f32 copies alone."""
    norms = []
    for idx in _groups(tensors):
        norms += torch._foreach_norm([tensors[i].float() for i in idx])
    return norms


@torch.no_grad()
def apply(params, grads, state: dict, cfg: AdamWConfig):
    """One clipped AdamW update of ``params`` (in place) from ``grads``.
    Returns the new state (its moments updated in place) and
    ``{"grad_norm": the raw global norm (a device scalar), "lr": the
    step's learning rate}``.

    The update is the reference's, leaf for leaf, in PyTorch's
    multi-tensor (``_foreach``) ops: each line below is a handful of
    launches over all leaves instead of one launch per leaf."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - np.float32(b1) ** np.float32(step))
    bc2 = float(1 - np.float32(b2) ** np.float32(step))
    for grp in _pieces(params):
        # views: the update writes through them
        p_grp, m_grp, v_grp = ([t.view(-1)[lo:hi] for t, lo, hi in
                                _take(ts, grp)]
                               for ts in (params, state["m"], state["v"]))
        f32 = [p.float() for p in p_grp]
        g = torch._foreach_mul([t.reshape(-1)[lo:hi].float()
                                for t, lo, hi in _take(grads, grp)], scale)
        m = [x.float() for x in m_grp]
        v = [x.float() for x in v_grp]
        m = torch._foreach_add(torch._foreach_mul(m, b1),
                               torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul(v, b2),
                               torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1 - b2))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(v, bc2)), cfg.eps)
        delta = torch._foreach_add(
            torch._foreach_div(torch._foreach_div(m, bc1), denom),
            torch._foreach_mul(f32, cfg.weight_decay))
        new = torch._foreach_sub(f32, torch._foreach_mul(delta, lr))
        for dst, src in ((p_grp, new), (m_grp, m), (v_grp, v)):
            torch._foreach_copy_(dst, src)
    return {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


def _groups(params) -> list[range]:
    """Consecutive runs of leaf indices of at most :data:`GROUP_ELEMS`
    elements each (a larger leaf alone)."""
    return _runs([p.numel() for p in params])


def _runs(sizes) -> list[range]:
    """Consecutive runs of indices whose sizes add to at most
    :data:`GROUP_ELEMS` (a larger size alone)."""
    out, start, n = [], 0, 0
    for i, size in enumerate(sizes):
        if i > start and n + size > GROUP_ELEMS:
            out.append(range(start, i))
            start, n = i, 0
        n += size
    out.append(range(start, len(sizes)))
    return out


def _take(tensors, grp):
    """``(tensor, start, stop)`` of each piece of ``grp``."""
    return [(tensors[i], lo, hi) for i, lo, hi in grp]


def _pieces(params) -> list[list[tuple[int, int, int]]]:
    """:func:`apply`'s groups: each leaf's flattened entries cut into
    pieces ``(leaf index, start, stop)`` of at most :data:`GROUP_ELEMS`,
    the pieces in leaf order grouped as :func:`_runs` groups them."""
    pieces = [(i, lo, min(lo + GROUP_ELEMS, p.numel()))
              for i, p in enumerate(params)
              for lo in range(0, max(p.numel(), 1), GROUP_ELEMS)]
    return [[pieces[j] for j in run]
            for run in _runs([hi - lo for _, lo, hi in pieces])]
