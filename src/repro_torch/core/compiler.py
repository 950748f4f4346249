"""SL-Compiler: DNN-graph-guided probe insertion (paper §III-B).

Given a computation graph and its operator→core mapping, SL-Compiler decides
*where* to probe and *what* to record, fully automatically:

1. parse the graph: layer sequence, dependencies, operator types;
2. classify each operator as computation-heavy (→ Exec/Comp/Post probes) or
   communication-intensive (→ Route/Comm/Pre probes) from its FLOPs vs the
   data volume it moves;
3. emit the probe plan (a list of five-tuples + the simulator-facing
   ProbePlan) — users can still override with custom specs.
"""

from __future__ import annotations

import dataclasses

from .graph import CompGraph
from .mapping import MappedGraph
from .probes import (Fragment, InstrType, Level, Location, ProbeSpec,
                     Structure)
from .simulator import ProbePlan


@dataclasses.dataclass
class InstrumentationPlan:
    specs: list[ProbeSpec]
    # op types covered by Exec probes / comm stages covered by Route probes
    exec_ops: tuple[str, ...]
    route_stages: tuple[int, ...]
    sim_plan: ProbePlan

    def describe(self) -> str:
        return "\n".join(repr(s) for s in self.specs)


# bytes a core can move per FLOP it executes before we call the op
# communication-bound (arithmetic-intensity style threshold)
_COMM_BOUND_BYTES_PER_FLOP = 0.25


def plan_probes(graph: CompGraph, mapped: MappedGraph | None = None,
                level: Level = Level.INST,
                structure: Structure = Structure.SKETCH,
                include_mem: bool = False) -> InstrumentationPlan:
    """Analyse ``graph`` and generate the probe configuration."""
    # Step 1+2: classify operators.
    exec_ops: set[str] = set()
    route_stages: set[int] = set()
    for n in graph.nodes:
        if n.op_type in ("input", "output"):
            continue
        out_bytes = sum(e.bytes for e in graph.out_edges(n.node_id))
        in_bytes = sum(e.bytes for e in graph.in_edges(n.node_id))
        moved = out_bytes + in_bytes
        if n.flops > 0 and moved / max(n.flops, 1.0) \
                < _COMM_BOUND_BYTES_PER_FLOP:
            exec_ops.add(n.op_type)       # compute-heavy → Exec probe
        if moved > 0:
            route_stages.add(n.stage)     # data movement → Route probe

    specs = [
        ProbeSpec(Fragment.EXEC, InstrType.COMP, Location.SURROUND, level,
                  structure, target_ops=tuple(sorted(exec_ops))),
        ProbeSpec(Fragment.ROUTE, InstrType.COMM, Location.PRE, level,
                  structure),
    ]
    if include_mem:
        specs.append(ProbeSpec(Fragment.MEM, InstrType.IO, Location.POST,
                               Level.STAGE, structure))

    sim_plan = ProbePlan(comp=True, comm=True,
                         level=level.value,
                         surround=True)
    return InstrumentationPlan(specs=specs, exec_ops=tuple(sorted(exec_ops)),
                               route_stages=tuple(sorted(route_stages)),
                               sim_plan=sim_plan)


def plan_for_mode(mode: str) -> ProbePlan:
    """The three instrumentation configurations evaluated in Fig 10."""
    if mode == "comm":
        return ProbePlan(comp=False, comm=True, level="inst")
    if mode == "comp":
        return ProbePlan(comp=True, comm=False, level="inst")
    if mode == "full":
        return ProbePlan(comp=True, comm=True, level="inst")
    if mode == "none":
        return None  # type: ignore[return-value]
    raise ValueError(mode)
