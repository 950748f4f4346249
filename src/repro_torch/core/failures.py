"""Fail-slow failure model and dataset generation (paper §IV-A).

A fail-slow instance is (kind, location, t0, duration, slowdown).  The
dataset mirrors the paper: 152 base instances at a 7:3 core:link split
(optionally diluted by a router share, see ``make_dataset``'s
``router_ratio``), onsets U(0, 6 s), durations **U(1, 10) s**, 10×
slowdown, scaled proportionally for larger meshes, plus an equal pool of
negative (failure-free) samples.

The duration range deserves a note: the paper's §IV-A draws failure
windows uniformly over the ~10 s run, which taken literally is U(0, 10 s).
We truncate the low end at 1 s — sub-second windows on an ≈8 s simulated
run inject so few affected records that no detector (SLOTH or baseline)
has evidence to act on, and the paper itself excludes failures that
"cannot affect execution".  U(1, 10) s is therefore the modelled
distribution everywhere: this docstring, ``make_dataset`` (whose
``min_dur``/``max_dur`` parameters expose it) and the drawn samples agree.
(The module docstring used to say "U(0, 10 s)" while the code drew
``uniform(1, 10)`` — the code's range was the intended one.)
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


@dataclasses.dataclass(frozen=True)
class Sample:
    """One evaluation sample: zero or one injected failure."""
    sample_id: int
    failure: FailSlow | None   # None → negative sample

    @property
    def positive(self) -> bool:
        return self.failure is not None


def effective_samples(samples: list[Sample], healthy_total: float,
                      used_links: set[int] | None = None,
                      mesh: Topology | None = None) -> list[Sample]:
    """Drop positive samples that cannot affect execution (the paper:
    "failures ... occurring on unused resources are excluded"): failures
    starting after the run completes, links that carry no traffic, and —
    when ``mesh`` is provided alongside ``used_links`` — routers none of
    whose adjacent links carry traffic (a router slows only its links, so
    such a failure is unobservable and would be an unwinnable positive in
    any accuracy evaluation)."""
    out = []
    for s in samples:
        f = s.failure
        if f is not None:
            if f.t0 >= healthy_total * 0.98:
                continue
            if f.kind == "link" and used_links is not None \
                    and f.location not in used_links:
                continue
            if f.kind == "router" and used_links is not None \
                    and mesh is not None \
                    and not any(lid in used_links
                                for lid in mesh.links_of_router(
                                    f.location)):
                continue
        out.append(s)
    return out


def make_dataset(mesh: Topology, n_failures: int = 152, seed: int = 7,
                 core_link_ratio: float = 0.7, max_t0: float = 6.0,
                 slowdown: float = 10.0, base_cores: int = 16,
                 n_negatives: int | None = None,
                 router_ratio: float = 0.0,
                 min_dur: float = 1.0, max_dur: float = 10.0) \
        -> list[Sample]:
    """Generate the fail-slow dataset.

    ``n_failures`` is scaled by mesh size relative to the paper's 4×4 chip
    ("for larger architectures we generate additional failures proportional
    to the expanded resource count").  Durations are **U(min_dur,
    max_dur) = U(1, 10) s** by default — see the module docstring for why
    the low end is truncated at 1 s rather than the paper's literal 0.

    ``router_ratio`` is the fraction of positives injected as router
    fail-slows (a router slows every adjacent link); the remainder keeps
    the paper's ``core_link_ratio`` core:link split.  The default of 0.0
    preserves the historical core/link-only draws bit-for-bit at any seed,
    so existing evaluations are unaffected; any positive value makes
    dataset-driven evaluation cover all three kinds that ``FailSlow``,
    ``truth_candidates`` and the campaign grid already support.
    """
    if not 0.0 <= router_ratio <= 1.0:
        raise ValueError(f"router_ratio must be in [0, 1], "
                         f"got {router_ratio}")
    rng = np.random.default_rng(seed)
    scale = mesh.n_cores / base_cores
    n_pos = max(1, int(round(n_failures * scale)))
    n_neg = n_pos if n_negatives is None else n_negatives

    samples: list[Sample] = []
    for i in range(n_pos):
        # one uniform draw decides the kind: the top router_ratio slice
        # goes to routers, the rest splits core:link at core_link_ratio —
        # with router_ratio=0 the draw sequence (and therefore every
        # sample) is identical to the historical two-kind generator
        r = rng.random()
        if r >= 1.0 - router_ratio:
            kind = "router"
            loc = int(rng.integers(mesh.n_cores))
        elif r < core_link_ratio * (1.0 - router_ratio):
            kind = "core"
            loc = int(rng.integers(mesh.n_cores))
        else:
            kind = "link"
            loc = int(rng.integers(mesh.n_links))
        t0 = float(rng.uniform(0.0, max_t0))
        dur = float(rng.uniform(min_dur, max_dur))
        samples.append(Sample(i, FailSlow(kind, loc, t0, dur, slowdown)))
    for i in range(n_neg):
        samples.append(Sample(n_pos + i, None))
    return samples
