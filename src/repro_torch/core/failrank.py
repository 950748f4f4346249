"""FailRank: PageRank-inspired root-cause ranking on the MCG (§III-D3).

Node update:  s⁽ᵏ⁺¹⁾(v) = (1−λ)·s₀(v) + λ·Σ_{(u,v)∈E} w(u,v)·s⁽ᵏ⁾(u)
Edge update:  l⁽ᵏ⁺¹⁾(u,v) = α·w(u,v) + β·s⁽ᵏ⁾(u) + γ·l⁽ᵏ⁾(u,v)

with the paper's coefficients α=0.1, β=0.3, γ=0.6 and damping λ.  The
iteration stops when ‖v⁽ᵏ⁾−v⁽ᵏ⁻¹⁾‖₁ < ε (=1e-4); final scores are
softmax-normalised within each MCG level.

Implementation: the MCG is sparse (mesh + DRAM edges), so the propagation
step is a gather and a segment sum over the COO edges, in float32 on
``device``.  The segment sum is a gather into a ``[n_nodes, max in-degree]``
table padded with zeros and a sum over its rows: a fixed-order reduction,
so the result is the same from run to run on the card (a float
``index_add_`` there uses atomics and is not).  The L1 residual is read by
the host after every step, and the per-iteration trace is returned for
the convergence analysis (Fig 15).  The fused dense step, a CUDA kernel,
lives in ``repro_torch.kernels.failrank_step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .mcg import MCG


@dataclasses.dataclass(frozen=True)
class FailRankParams:
    lam: float = 0.55          # damping λ
    alpha: float = 0.1         # edge: propagation-weight term
    beta: float = 0.3          # edge: source-node term
    gamma: float = 0.6         # edge: momentum term
    eps: float = 1e-4          # L1 convergence tolerance
    max_iters: int = 100


@dataclasses.dataclass
class FailRankResult:
    node_scores: np.ndarray        # softmax-normalised per level
    edge_scores: np.ndarray
    raw_node_scores: np.ndarray    # pre-softmax (for thresholding)
    raw_edge_scores: np.ndarray
    iterations: int
    residuals: np.ndarray          # Δ_k trace (L1), for Fig 15


def _in_edge_table(dst: np.ndarray, n: int) -> np.ndarray:
    """``[n, max in-degree]`` edge indices per destination, in edge order,
    padded with ``len(dst)`` (the index of an appended zero)."""
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = max(int(counts.max()), 1)
    table = np.full((n, width), len(dst), dtype=np.int64)
    pos = np.arange(len(dst)) - np.repeat(starts, counts)
    table[dst[order], pos] = order
    return table


def _failrank_iterate(s0, l0, w, src, in_edges, p: FailRankParams):
    zero = torch.zeros(1, dtype=w.dtype, device=w.device)
    s, l = s0, l0
    res = []
    delta = float("inf")
    eps = float(np.float32(p.eps))     # the tolerance as a float32, like s
    while delta >= eps and len(res) < p.max_iters:
        s_src = s[src]
        contrib = torch.cat([w * s_src, zero])
        s_new = (1.0 - p.lam) * s0 + p.lam * contrib[in_edges].sum(dim=1)
        l_new = p.alpha * w + p.beta * s_src + p.gamma * l
        delta = float((s_new - s).abs().sum() + (l_new - l).abs().sum())
        res.append(delta)
        s, l = s_new, l_new
    return s, l, len(res), np.asarray(res, dtype=np.float64)


def _softmax_per_level(scores: np.ndarray, levels: np.ndarray) -> np.ndarray:
    out = np.zeros_like(scores)
    for lv in np.unique(levels):
        sel = levels == lv
        x = scores[sel]
        e = np.exp(x - x.max())
        out[sel] = e / e.sum()
    return out


def failrank(mcg: MCG, params: FailRankParams = FailRankParams(),
             device=None) -> FailRankResult:
    if len(mcg.edge_src) == 0:
        z = np.zeros(mcg.n_nodes)
        return FailRankResult(z, np.zeros(0), mcg.s0.copy(), np.zeros(0), 0,
                              np.zeros(0))
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    s, l, k, res = _failrank_iterate(
        f32(mcg.s0), f32(mcg.l0), f32(mcg.edge_w),
        torch.as_tensor(mcg.edge_src, device=dev),
        torch.as_tensor(_in_edge_table(mcg.edge_dst, mcg.n_nodes),
                        device=dev),
        params)
    s = s.cpu().numpy().astype(np.float64)
    l = l.cpu().numpy().astype(np.float64)

    node_soft = _softmax_per_level(s, mcg.node_window)
    edge_levels = np.minimum(mcg.edge_src // mcg.mesh.n_cores,
                             mcg.n_windows - 1)
    edge_soft = _softmax_per_level(l, edge_levels)
    return FailRankResult(node_soft, edge_soft, s, l, k, res)


def attribute_links(mcg: MCG, result: FailRankResult,
                    link_theta: np.ndarray | None = None) -> np.ndarray:
    """Fold MCG edge scores back onto physical links.

    Each edge's score is attributed along its XY path; when the EM-inferred
    θ is available the blame concentrates on the path's most anomalous link
    (θ-weighted), otherwise it spreads uniformly.
    """
    n_links = mcg.mesh.n_links
    link_scores = np.zeros(n_links)
    for i, path in enumerate(mcg.edge_link_path):
        if not path:
            continue
        score = result.raw_edge_scores[i]
        if link_theta is not None:
            w = int(min(mcg.edge_src[i] // mcg.mesh.n_cores,
                        mcg.n_windows - 1))
            th = link_theta[w, path]
            share = th / max(th.sum(), 1e-300)
        else:
            share = np.full(len(path), 1.0 / len(path))
        for lid, sh in zip(path, share):
            link_scores[lid] = max(link_scores[lid], score * sh)
    return link_scores
