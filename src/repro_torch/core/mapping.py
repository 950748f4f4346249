"""Gemini-like operator→core mapping.

Following Gemini [HPCA'24], each operator is spatially partitioned across a
block of cores: large ops are split into `P` volume-equivalent parts (tensor
partitions), each assigned to a distinct core.  Consecutive stages are placed
with locality (same block ordering) so most traffic is neighbour-to-neighbour
with a deterministic shuffle fan-in — the communication pattern the NoC
actually sees.

The equal-split is what gives SL-Tracer its *volume-equivalent groups*: all
parts of one operator execute identical FLOPs on different cores.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CompGraph
from .routing import Topology


@dataclasses.dataclass
class Task:
    """One partition of an operator, mapped to a core."""
    task_id: int
    node_id: int
    part: int          # partition index within the operator
    n_parts: int
    core: int
    flops: float
    stage: int
    op_type: str


@dataclasses.dataclass
class Flow:
    """One core-to-core message (a partition-to-partition dependency)."""
    src_task: int
    dst_task: int
    src_core: int
    dst_core: int
    bytes: float
    stage: int         # consumer's stage


@dataclasses.dataclass
class MappedGraph:
    graph: CompGraph
    mesh: Topology
    tasks: list[Task]
    flows: list[Flow]

    def tasks_by_core(self) -> dict[int, list[Task]]:
        by: dict[int, list[Task]] = {c: [] for c in range(self.mesh.n_cores)}
        for t in self.tasks:
            by[t.core].append(t)
        return by


def _n_parts_for(flops: float, median_flops: float, n_cores: int) -> int:
    """Big ops get the whole mesh, small ops a few cores (Gemini-style)."""
    if flops <= 0:
        return 1
    ratio = flops / max(median_flops, 1.0)
    if ratio >= 1.0:
        return n_cores
    p = max(1, int(round(n_cores * ratio)))
    # round down to a power of two for even tiling
    return 1 << (p.bit_length() - 1)


def map_graph(graph: CompGraph, mesh: Topology, shuffle_fanin: int = 2,
              seed: int = 0, max_parts: int | None = None,
              exclude_cores=()) -> MappedGraph:
    """Partition every operator into volume-equivalent parts on the mesh.

    ``shuffle_fanin`` extra producers per consumer part model the tensor
    re-layout traffic between differently partitioned stages; ``max_parts``
    caps spatial spreading (Gemini trades spreading against locality).
    ``exclude_cores`` drops cores from the placement pool (the mitigation
    path: remap the workload off verdict-flagged cores); with an empty
    exclusion the placement arithmetic is unchanged bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    comp = [n.flops for n in graph.nodes if n.flops > 0]
    median_flops = float(np.median(comp)) if comp else 1.0
    excluded = frozenset(int(c) for c in exclude_cores)
    bad = sorted(excluded.difference(range(mesh.n_cores)))
    if bad:
        raise ValueError(f"exclude_cores out of range for mesh: {bad}")
    alive = [c for c in range(mesh.n_cores) if c not in excluded]
    if not alive:
        raise ValueError("exclude_cores removes every core in the mesh")
    n_cores = len(alive)

    tasks: list[Task] = []
    node_tasks: dict[int, list[int]] = {}
    # deterministic per-node core offset keeps stage blocks local but rotates
    # placement so all cores are used even by small ops.
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        if node.op_type in ("input", "output"):
            p = 1
        else:
            p = _n_parts_for(node.flops, median_flops, n_cores)
            if max_parts is not None:
                p = min(p, max_parts)
        offset = (node.node_id * 7) % n_cores
        ids = []
        for part in range(p):
            core = alive[(offset + part * (n_cores // p)) % n_cores]
            t = Task(len(tasks), nid, part, p, core, node.flops / p,
                     node.stage, node.op_type)
            tasks.append(t)
            ids.append(t.task_id)
        node_tasks[nid] = ids

    flows: list[Flow] = []
    for e in graph.edges:
        src_ids, dst_ids = node_tasks[e.src], node_tasks[e.dst]
        np_src, np_dst = len(src_ids), len(dst_ids)
        for j, dt in enumerate(dst_ids):
            # aligned producer part + a deterministic shuffle fan-in
            producers = {src_ids[j % np_src]}
            for k in range(1, shuffle_fanin + 1):
                producers.add(src_ids[(j + k * max(1, np_src // 4) + 1)
                                      % np_src])
            share = e.bytes / (np_dst * len(producers))
            for st in sorted(producers):
                flows.append(Flow(
                    src_task=st, dst_task=dt,
                    src_core=tasks[st].core, dst_core=tasks[dt].core,
                    bytes=share, stage=tasks[dt].stage))
    return MappedGraph(graph=graph, mesh=mesh, tasks=tasks, flows=flows)
