"""Multi-level Communication Graph (paper §III-D3).

Nodes are (time-window, core) pairs plus one virtual DRAM node per window
boundary; edges are core→core communication dependencies inside a window,
weighted by traffic volume and normalised per source (Σ_out w = 1), so
w(u,v) reads as the probability that a slowdown propagates along (u,v).
Virtual DRAM nodes connect consecutive windows (the temporal dimension).

The builder also keeps, for every MCG edge, the physical XY link path and
per-link traffic so FailRank's edge scores can be attributed back to
physical links.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .detection import (CoreCandidate, LinkInference, assign_window)
from .routing import Topology
from .sketch import Pattern


@dataclasses.dataclass
class MCG:
    mesh: Topology
    n_windows: int
    n_nodes: int                     # windows*cores + windows (DRAM)
    # edges (COO): weights normalised per source node
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_w: np.ndarray
    edge_link_path: list[list[int]]  # physical links per edge ([] = virtual)
    s0: np.ndarray                   # initial node fail-slow scores
    l0: np.ndarray                   # initial edge fail-slow scores
    node_window: np.ndarray          # level of each node (for softmax)

    def node_id(self, window: int, core: int) -> int:
        return window * self.mesh.n_cores + core

    def dram_id(self, window: int) -> int:
        return self.n_windows * self.mesh.n_cores + window

    def is_core_node(self, nid: int) -> bool:
        return nid < self.n_windows * self.mesh.n_cores

    def node_core(self, nid: int) -> int:
        return nid % self.mesh.n_cores


DRAM_EDGE_WEIGHT = 0.1   # relative weight of inter-level (memory) edges


def build_mcg(comm_patterns: list[Pattern], mesh: Topology, total_time: float,
              core_cands: list[CoreCandidate], link_inf: LinkInference,
              n_windows: int = 4) -> MCG:
    n_cores = mesh.n_cores
    n_nodes = n_windows * n_cores + n_windows

    # -- aggregate traffic per (window, src, dst) ---------------------------
    traffic: dict[tuple[int, int, int], float] = {}
    if comm_patterns:
        keys = np.array([p.key for p in comm_patterns], dtype=np.int64)
        src = (keys & 0xFFF).astype(np.int64)
        dst = ((keys >> 12) & 0xFFF).astype(np.int64)
        vol = np.array([p.sum_val for p in comm_patterns])
        t_mid = np.array([(p.t_first + p.t_last) / 2 for p in comm_patterns])
        win = assign_window(t_mid, total_time, n_windows)
        for s, d, v, w in zip(src, dst, vol, win):
            if s == d:
                continue
            k = (int(w), int(s), int(d))
            traffic[k] = traffic.get(k, 0.0) + float(v)

    edge_src, edge_dst, edge_vol, paths = [], [], [], []
    for (w, s, d), v in sorted(traffic.items()):
        edge_src.append(w * n_cores + s)
        edge_dst.append(w * n_cores + d)
        edge_vol.append(v)
        paths.append(mesh.route(s, d))

    # -- virtual DRAM nodes: core(w) → DRAM(w) → core(w+1) ------------------
    mean_vol = float(np.mean(edge_vol)) if edge_vol else 1.0
    active: dict[int, set[int]] = {w: set() for w in range(n_windows)}
    for (w, s, d) in traffic:
        active[w].update((s, d))
    for w in range(n_windows - 1):
        dram = n_windows * n_cores + w
        for c in sorted(active[w]) or range(n_cores):
            edge_src.append(w * n_cores + c)
            edge_dst.append(dram)
            edge_vol.append(mean_vol * DRAM_EDGE_WEIGHT)
            paths.append([])
        nxt = sorted(active[w + 1]) or range(n_cores)
        for c in nxt:
            edge_src.append(dram)
            edge_dst.append((w + 1) * n_cores + c)
            edge_vol.append(mean_vol * DRAM_EDGE_WEIGHT)
            paths.append([])

    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    edge_vol = np.asarray(edge_vol, dtype=np.float64)

    # -- normalise traffic per source: Σ_{(u,·)} w = 1 ----------------------
    out_sum = np.zeros(n_nodes)
    np.add.at(out_sum, edge_src, edge_vol)
    edge_w = edge_vol / np.maximum(out_sum[edge_src], 1e-300)

    # -- initial scores ------------------------------------------------------
    s0 = np.zeros(n_nodes)
    for c in core_cands:
        s0[c.window * n_cores + c.core] = max(
            s0[c.window * n_cores + c.core], c.prob)

    link_prob = np.zeros((n_windows, mesh.n_links))
    for lc in link_inf.candidates:
        link_prob[lc.window, lc.link] = max(link_prob[lc.window, lc.link],
                                            lc.prob)
    l0 = np.zeros(len(edge_src))
    win_of_edge = np.minimum(edge_src // n_cores, n_windows - 1)
    for i, path in enumerate(paths):
        if path:
            w = int(win_of_edge[i])
            l0[i] = float(link_prob[w, path].max())

    node_window = np.concatenate([
        np.repeat(np.arange(n_windows), n_cores),
        np.arange(n_windows),
    ])
    return MCG(mesh=mesh, n_windows=n_windows, n_nodes=n_nodes,
               edge_src=edge_src, edge_dst=edge_dst, edge_w=edge_w,
               edge_link_path=paths, s0=s0, l0=l0, node_window=node_window)
