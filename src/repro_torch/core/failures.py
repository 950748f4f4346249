"""Fail-slow failure model (paper §IV-A).

A fail-slow instance is (kind, location, t0, duration, slowdown), active
during ``[t0, t0 + duration)``.  ``truth_candidates`` and
``judge_verdict`` are the router-aware judging rule every verdict is
scored by.  The evaluation dataset generator (``make_dataset``) belongs
to the campaign layer and is not part of this package yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .routing import Topology


@dataclasses.dataclass(frozen=True)
class FailSlow:
    kind: str          # 'core' | 'link' | 'router'
    location: int      # core id, link id or router(core) id
    t0: float
    duration: float
    slowdown: float = 10.0

    def label(self) -> tuple[str, int]:
        return (self.kind, self.location)


def truth_candidates(failure: FailSlow, mesh: Topology) \
        -> set[tuple[str, int]]:
    """Acceptable (kind, location) verdicts for an injected failure.

    This is the single router-aware judging rule shared by
    ``Verdict.matches``, the campaign judge and the baseline scoring: the
    detector localises at core/link granularity, so a router failure is
    correctly localised by naming any link of the slowed router."""
    if failure.kind == "router":
        return {("link", lid)
                for lid in mesh.links_of_router(failure.location)}
    return {(failure.kind, failure.location)}


def judge_verdict(verdict, failures, mesh: Topology) \
        -> tuple[bool, int | None, tuple, set[tuple[str, int]]]:
    """(matched, best_rank, per_failure_ranks, candidate_union) for one
    verdict against a set of ground truths — the single judging rule every
    detector is scored by.

    ``verdict`` is any unified :class:`~repro_torch.core.detectors.Verdict`
    (duck-typed: ``flagged``, ``ranking``, ``matches``).  Matching is
    router-aware via :func:`truth_candidates`: matched means the top-1
    verdict names *any* injected truth; ranks are 1-based positions of
    each truth in the ranking (``None`` when unranked); the union of
    acceptable (kind, location) answers is returned for callers that score
    auxiliary signals by the same rule.  An empty ``failures`` tuple is a
    negative sample: matched ⇔ not flagged.
    """
    if not failures:
        return (not verdict.flagged), None, (), set()
    ranks: list[int | None] = []
    union: set[tuple[str, int]] = set()
    for f in failures:
        cands = truth_candidates(f, mesh)
        union |= cands
        rank = None
        for i, (k, l, _) in enumerate(verdict.ranking):
            if (k, l) in cands:
                rank = i + 1
                break
        ranks.append(rank)
    matched = any(verdict.matches(f, mesh) for f in failures)
    ranked = [r for r in ranks if r is not None]
    return matched, (min(ranked) if ranked else None), tuple(ranks), union
