"""Built-in mitigation policies: remap / reroute / quarantine / none.

Each policy reads the verdict's implicated sites (``flagged_sites``) and
edits the deployment the way an operator would:

* ``remap`` — re-run the Gemini-style mapper with verdict-flagged *cores*
  excluded from the placement pool.  Link/router sites are out of scope
  for remap (compute placement cannot dodge a slow wire).
* ``reroute`` — detour flows around flagged *links* via
  :class:`~repro_torch.core.routing.DetourTopology`.  When several flagged links
  share one router (≥2 incident) the router itself is presumed slow and
  the policy falls back to remap for it: its core leaves the placement
  pool and *all* its links are detoured.  Core sites likewise fall back
  to remap-style exclusion.
* ``quarantine`` — belt and braces: drop the flagged resource *and* its
  neighbourhood (a core with its 4-neighbours; a link with both endpoint
  cores and every link touching them).
* ``none`` — the experimental control: never acts, so its mitigated
  makespan is the failed makespan and its recovered throughput is
  exactly zero.

All exclusion/avoidance tuples are sorted, so plans are deterministic and
identical across campaign executors.
"""

from __future__ import annotations

import dataclasses

from ..core.detectors import Verdict
from ..core.mapping import MappedGraph, map_graph
from ..core.routing import DetourTopology, Topology
from .policy import (MitigationPlan, _register_builtin_policy, flagged_sites)

__all__ = ["NonePolicy", "RemapPolicy", "ReroutePolicy", "QuarantinePolicy"]

#: flagged incident links at-or-above which a router (not just its links)
#: is presumed slow — a single flagged link touches two routers once each,
#: so the threshold of 2 never fires on an isolated link verdict.
ROUTER_LINK_THRESHOLD = 2


def _not_acted(name: str, reason: str) -> MitigationPlan:
    return MitigationPlan(policy=name, acted=False, reason=reason)


def _cap_exclusion(cores: list[int], n_cores: int) -> tuple[int, ...]:
    """Never exclude the whole mesh: keep at least one core alive by
    truncating the (sorted) exclusion list deterministically."""
    cores = sorted(dict.fromkeys(cores))
    if len(cores) >= n_cores:
        cores = cores[:n_cores - 1]
    return tuple(cores)


def _finish(name: str, mesh: Topology, exclude: list[int],
            avoid: list[int], reason: str) -> MitigationPlan:
    exclude_t = _cap_exclusion(exclude, mesh.n_cores)
    avoid_t = tuple(sorted(dict.fromkeys(int(l) for l in avoid)))
    if not exclude_t and not avoid_t:
        return _not_acted(name, reason or "no actionable site")
    return MitigationPlan(policy=name, acted=True, exclude_cores=exclude_t,
                          avoid_links=avoid_t, reason=reason)


def _apply_edits(plan: MitigationPlan, mapped: MappedGraph) -> MappedGraph:
    """Materialise a plan: wrap the fabric in a DetourTopology when links are
    avoided, re-map when cores are excluded, and leave ``mapped``
    untouched either way."""
    mesh: Topology = mapped.mesh
    if plan.avoid_links:
        mesh = DetourTopology(mapped.mesh, plan.avoid_links)
    if plan.exclude_cores:
        return map_graph(mapped.graph, mesh,
                         exclude_cores=plan.exclude_cores)
    if mesh is mapped.mesh:
        return mapped
    # placement is untouched; only path selection changes
    return dataclasses.replace(mapped, mesh=mesh)


class NonePolicy:
    """Control policy: observes the verdict, does nothing."""

    name = "none"

    def plan(self, verdict: Verdict, mapped: MappedGraph | None,
             mesh: Topology, cfg=None) -> MitigationPlan:
        return _not_acted(self.name, "control policy")

    def apply(self, plan: MitigationPlan, mapped: MappedGraph,
              cfg=None) -> MappedGraph:
        return mapped


class RemapPolicy:
    """Re-map the workload with verdict-flagged cores excluded."""

    name = "remap"

    def plan(self, verdict: Verdict, mapped: MappedGraph | None,
             mesh: Topology, cfg=None) -> MitigationPlan:
        sites = flagged_sites(verdict)
        if not sites:
            return _not_acted(self.name, "verdict not flagged")
        cores = [loc for kind, loc in sites if kind == "core"]
        if not cores:
            return _not_acted(self.name, "no core site to remap away from")
        return _finish(self.name, mesh, cores, [],
                       f"exclude {len(cores)} flagged core(s)")

    def apply(self, plan: MitigationPlan, mapped: MappedGraph,
              cfg=None) -> MappedGraph:
        return _apply_edits(plan, mapped)


class ReroutePolicy:
    """Detour flows around flagged links; fall back to remap for flagged
    cores and for routers implicated by ≥2 flagged incident links."""

    name = "reroute"

    def plan(self, verdict: Verdict, mapped: MappedGraph | None,
             mesh: Topology, cfg=None) -> MitigationPlan:
        sites = flagged_sites(verdict)
        if not sites:
            return _not_acted(self.name, "verdict not flagged")
        link_sites = [loc for kind, loc in sites if kind == "link"]
        core_sites = [loc for kind, loc in sites if kind == "core"]

        incident: dict[int, int] = {}
        for lid in dict.fromkeys(link_sites):
            for end in mesh.links[lid]:
                incident[end] = incident.get(end, 0) + 1
        slow_routers = sorted(c for c, n in incident.items()
                              if n >= ROUTER_LINK_THRESHOLD)

        exclude = list(core_sites)
        avoid = list(link_sites)
        notes = []
        if link_sites:
            notes.append(f"detour {len(dict.fromkeys(link_sites))} link(s)")
        if slow_routers:
            # router fallback: the router's core leaves the placement pool
            # and every one of its links is detoured
            for c in slow_routers:
                exclude.append(c)
                avoid.extend(mesh.links_of_router(c))
            notes.append(f"remap fallback for router(s) {slow_routers}")
        if core_sites:
            notes.append(f"remap fallback for {len(core_sites)} core site(s)")
        return _finish(self.name, mesh, exclude, avoid, "; ".join(notes))

    def apply(self, plan: MitigationPlan, mapped: MappedGraph,
              cfg=None) -> MappedGraph:
        return _apply_edits(plan, mapped)


class QuarantinePolicy:
    """Drop the flagged resource and its neighbourhood."""

    name = "quarantine"

    def plan(self, verdict: Verdict, mapped: MappedGraph | None,
             mesh: Topology, cfg=None) -> MitigationPlan:
        sites = flagged_sites(verdict)
        if not sites:
            return _not_acted(self.name, "verdict not flagged")
        exclude: list[int] = []
        avoid: list[int] = []
        for kind, loc in sites:
            if kind == "core":
                exclude.append(loc)
                exclude.extend(mesh.neighbours(loc))
            elif kind == "link":
                u, v = mesh.links[loc]
                exclude.extend((u, v))
                avoid.extend(mesh.links_of_router(u))
                avoid.extend(mesh.links_of_router(v))
        return _finish(self.name, mesh, exclude, avoid,
                       f"quarantine {len(sites)} site(s) + neighbourhood")

    def apply(self, plan: MitigationPlan, mapped: MappedGraph,
              cfg=None) -> MappedGraph:
        return _apply_edits(plan, mapped)


_register_builtin_policy("remap", RemapPolicy)
_register_builtin_policy("reroute", ReroutePolicy)
_register_builtin_policy("quarantine", QuarantinePolicy)
_register_builtin_policy("none", NonePolicy)
