"""Campaign metric aggregation (paper §IV: Table III, Figs 11/12/16/17).

Pure, deterministic reductions over per-scenario outcomes.  The campaign
runner (``campaign.py``) produces one :class:`ScenarioOutcome` per injected
(or failure-free) scenario; this module turns a list of outcomes into the
paper-style aggregates.

Unified-detector layout
-----------------------
Every scenario's trace is analysed by **all** requested detectors (the
campaign's ``detectors=("sloth", "thres", ...)`` axis), so a
:class:`ScenarioOutcome` carries one :class:`DetectorOutcome` per detector
— flagged / top-1 prediction / router-aware match / per-truth ranks / wall
time — all judged by the single rule in
:func:`repro_torch.core.failures.judge_verdict`.  Each aggregate therefore takes
a ``detector=`` selector (default: the campaign's *primary* detector, the
first one requested), and :func:`by_detector` / :func:`detector_cells`
produce the full SLOTH-vs-baselines table in one pass.

A scenario may carry **several simultaneous injected failures** (the grid's
``n_failures`` axis): ground truth is therefore a *tuple* of truths
(``truth_locations`` / ``truth_t0s`` / ``truth_durations``, all empty for
negatives), each with its own 1-based rank in the verdict's ranking
(``truth_ranks``; ``None`` when unranked).  Failures within one scenario
may be of **different kinds** (the grid's ``kind='mixed'`` / explicit
kind-tuple entries): ``truth_kinds`` records each injected failure's kind
index-aligned with the other truth tuples, and :func:`by_truth_kind`
splits per-failure recall@k and rank statistics by that kind — so a mixed
campaign reports how well each detector localises core vs link vs router
root causes *within heterogeneous scenarios*.  Severity may likewise vary
per failure (``truth_severities`` / ``effective_truth_severities``, set by
the grid's per-failure severity tuples).  :func:`severity_curve` slices
positives by injected severity (accuracy / recall@k per severity,
negatives' FPR alongside) for near-threshold sweeps, and
:func:`severity_curve_by_mesh` splits the same curve per mesh size.  The
aggregates are:

* **accuracy (any-match)** — fraction of *positive* scenarios whose top-1
  verdict names any of the injected root causes (router failures accept any
  link of the slowed router, since detectors localise at link granularity),
* **FPR** — fraction of *negative* (failure-free) scenarios that were
  flagged,
* **top-k localisation rate** — fraction of positives with *some* ground
  truth within the first k entries of the ranking (monotone in k),
* **recall@k** — fraction of *individual injected failures* (over all
  positives) ranked within the top k; for single-failure grids this
  coincides with top-k,
* **detection latency** — on streaming campaigns
  (``run_campaign(streaming=...)``), the simulated time from the
  earliest failure onset to the first flagged streaming verdict
  (:func:`detection_latency_stats`: detected fraction with a Wilson CI,
  mean / p95 over the detected positives).  Per outcome the latency is
  ``None`` (not streamed / negative), ``inf`` (streamed, never flagged)
  or finite (detected); it is simulated time, hence deterministic and
  part of outcome equality,
* **recovered throughput** — on mitigated campaigns
  (``run_campaign(mitigation=...)``), each (detector, policy) cell's
  :class:`MitigationOutcome` per scenario reduces via
  :func:`by_mitigation` to a :class:`MitigationStat`: post-mitigation
  slowdown vs healthy, the fraction of the failure-induced gap recovered
  under correct verdicts, and the mis-mitigation penalty paid when the
  policy acted on a wrong or false verdict — all binomial rates with
  Wilson CIs,
* **compression ratio** and **probe overhead** means.  Probe overhead is
  a per-deployment quantity; the headline mean weights each deployment by
  the number of scenarios it served (``mean_probe_overhead``), with the
  unweighted per-deployment mean kept alongside
  (``mean_probe_overhead_unweighted``),
* **wall-time telemetry** — per-detector analyse time and per-scenario
  simulate time (:func:`wall_time_stats`: mean / p95 / total).  Wall
  times are measurements, not results: they are excluded from outcome
  equality so executor-equivalence comparisons stay bit-exact.

Binomial rates carry Wilson score confidence intervals so small grid cells
report honest uncertainty.  Everything here is plain float arithmetic in a
fixed order: identical outcome lists produce bit-identical metrics.
"""

from __future__ import annotations

import dataclasses
import math

from .routing import topology_spec


@dataclasses.dataclass(frozen=True)
class DetectorOutcome:
    """One detector's judged verdict for one scenario.  Plain scalars and
    tuples only — picklable across process-pool boundaries.  ``wall_time``
    (seconds spent in ``analyse``) is telemetry and excluded from
    equality."""
    detector: str              # registry name ('sloth', 'thres', ...)
    flagged: bool
    pred_kind: str | None      # top-1 prediction ('core' | 'link')
    pred_location: int | None
    score: float
    matched: bool              # top-1 matches any truth (router-aware)
    truth_rank: int | None     # best 1-based rank over truths, or None
    # per-failure rank (int | None), aligned with the scenario's
    # truth_locations
    truth_ranks: tuple = ()
    wall_time: float = dataclasses.field(default=0.0, compare=False)
    # streaming detection latency (simulated seconds from earliest failure
    # onset to the first flagged streaming verdict): None when the
    # scenario was not streamed or is a negative sample, math.inf when
    # streamed but never flagged, finite when detected.  Deterministic
    # (simulated time, not wall time), so it participates in equality.
    detection_latency: float | None = None


@dataclasses.dataclass(frozen=True)
class MitigationOutcome:
    """One (detector, policy) mitigation attempt for one scenario.

    Produced by ``run_campaign(mitigation=...)``: the policy planned
    against the detector's verdict, the plan was applied, and the
    mitigated deployment was re-simulated over the remaining failure
    window.  ``correct`` is the judged correctness of the *acted-on
    verdict* (router-aware top-1 match for positives, not-flagged for
    negatives) — so wrong/false verdicts can be sliced out to measure the
    mis-mitigation penalty.  ``switch_time`` is the simulated stream time
    at which mitigation engaged (first streaming flag); ``None`` models a
    post-hoc restart over the full window.  All times are simulated and
    deterministic; ``wall_time`` (plan+apply+re-simulate seconds) is
    telemetry, excluded from equality.
    """
    detector: str
    policy: str
    acted: bool                # the plan edited the deployment
    correct: bool              # the verdict acted on was judged correct
    exclude_cores: tuple[int, ...]
    avoid_links: tuple[int, ...]
    healthy_time: float        # failure-free makespan (probed reference)
    failed_time: float         # un-mitigated makespan under the failures
    mitigated_time: float      # makespan after mitigation (== failed when
    #                            the policy did not act)
    switch_time: float | None = None
    wall_time: float = dataclasses.field(default=0.0, compare=False)

    @property
    def gap(self) -> float:
        """Failure-induced throughput gap (seconds lost to the failure)."""
        return self.failed_time - self.healthy_time

    @property
    def recovered_frac(self) -> float:
        """Fraction of the failure-induced gap the mitigation clawed back:
        1.0 = back to healthy, 0.0 = no change, negative = made it worse.
        Defined as 0.0 when there is no gap to recover."""
        gap = self.gap
        if gap <= 0.0:
            return 0.0
        return (self.failed_time - self.mitigated_time) / gap

    @property
    def slowdown_vs_healthy(self) -> float:
        """Post-mitigation makespan relative to the healthy reference."""
        if self.healthy_time <= 0.0:
            return 0.0
        return self.mitigated_time / self.healthy_time

    @property
    def penalty(self) -> float:
        """Relative slowdown *introduced* by acting: positive only when
        mitigation made the run slower than leaving the failure alone —
        the cost of acting on a wrong or false verdict."""
        if self.failed_time <= 0.0:
            return 0.0
        return max(0.0, self.mitigated_time / self.failed_time - 1.0)


@dataclasses.dataclass(frozen=True)
class ScenarioOutcome:
    """Result of one campaign scenario (the exchange record between the
    runner and the aggregators).  Picklable: plain scalars, tuples and
    :class:`DetectorOutcome` tuples only, so outcomes cross process
    boundaries under ``executor='process'``.  ``sim_wall_time`` is
    telemetry (excluded from equality, like ``DetectorOutcome.wall_time``).
    """
    scenario_id: int
    workload: str
    mesh_w: int
    mesh_h: int
    # 'core' | 'link' | 'router' | 'none' | 'mixed' | 'core+link'-style
    # composites (per-failure kinds are in truth_kinds)
    kind: str
    # injected slowdown (0.0 for 'none'); a tuple for per-failure severity
    # mixes (the grid's explicit-tuple severity entries, e.g. a 1.5× core
    # with a 10× link in one scenario — see ``truth_severities``)
    severity: float | tuple[float, ...]
    n_failures: int            # simultaneous injected failures (0 = 'none')
    rep: int                   # replicate index within the grid cell
    sim_seed: int              # simulator seed actually used
    # ground truth (empty tuples for negative samples), index-aligned
    truth_locations: tuple[int, ...]
    truth_t0s: tuple[float, ...]
    truth_durations: tuple[float, ...]
    # one judged verdict per requested detector, in request order (the
    # first entry is the campaign's primary detector)
    detector_results: tuple[DetectorOutcome, ...]
    # accounting
    compression_ratio: float   # recorder compression (0.0 if no detector
    #                            produced recorder artifacts)
    total_time: float
    probe_overhead: float          # of the deployment that ran the scenario
    sim_wall_time: float = dataclasses.field(default=0.0, compare=False)
    # per-failure kinds, index-aligned with truth_locations; empty both for
    # negatives and for outcomes predating the mixed-kind axis (see
    # ``effective_truth_kinds``)
    truth_kinds: tuple[str, ...] = ()
    # per-failure injected slowdowns, index-aligned with truth_locations;
    # empty for negatives and for outcomes predating per-failure severity
    # mixes (see ``effective_truth_severities``)
    truth_severities: tuple[float, ...] = ()
    # one mitigation attempt per (detector, policy) pair, detector-major
    # in request order; empty on campaigns without ``mitigation=``
    mitigation_results: tuple[MitigationOutcome, ...] = ()
    # registry fabric key ('mesh' | 'torus' | 'het:fast2slow1' | ...);
    # 'mesh' both for default fabrics and for outcomes predating the
    # topology axis.  Joined with (mesh_w, mesh_h) into the canonical
    # fabric label by ``topology_label`` / ``by_topology``.
    topology: str = "mesh"

    @property
    def positive(self) -> bool:
        return self.kind != "none"

    @property
    def effective_truth_kinds(self) -> tuple[str, ...]:
        """Per-failure kinds with the single-kind fallback: outcomes from
        homogeneous scenarios (or synthesised without ``truth_kinds``)
        report every failure as the scenario's own kind."""
        if self.truth_kinds:
            return self.truth_kinds
        return (self.kind,) * len(self.truth_locations)

    @property
    def effective_truth_severities(self) -> tuple[float, ...]:
        """Per-failure severities with the uniform-severity fallback:
        outcomes from scalar-severity scenarios (or synthesised without
        ``truth_severities``) report every failure at the scenario's own
        severity."""
        if self.truth_severities:
            return self.truth_severities
        if isinstance(self.severity, tuple):
            return tuple(float(s) for s in self.severity)
        return (float(self.severity),) * len(self.truth_locations)

    # -- primary-detector convenience views --------------------------------
    @property
    def primary(self) -> DetectorOutcome:
        return self.detector_results[0]

    @property
    def flagged(self) -> bool:
        return self.primary.flagged

    @property
    def pred_kind(self) -> str | None:
        return self.primary.pred_kind

    @property
    def pred_location(self) -> int | None:
        return self.primary.pred_location

    @property
    def score(self) -> float:
        return self.primary.score

    @property
    def matched(self) -> bool:
        return self.primary.matched

    @property
    def truth_rank(self) -> int | None:
        return self.primary.truth_rank

    @property
    def truth_ranks(self) -> tuple:
        return self.primary.truth_ranks

    # -- single-failure convenience views (first truth or None) ------------
    @property
    def truth_location(self) -> int | None:
        return self.truth_locations[0] if self.truth_locations else None

    @property
    def t0(self) -> float | None:
        return self.truth_t0s[0] if self.truth_t0s else None

    @property
    def duration(self) -> float | None:
        return self.truth_durations[0] if self.truth_durations else None

    def result_for(self, detector: str | None) -> DetectorOutcome:
        """This scenario's :class:`DetectorOutcome` for ``detector``
        (``None`` → primary)."""
        if detector is None:
            return self.detector_results[0]
        for d in self.detector_results:
            if d.detector == detector:
                return d
        raise KeyError(
            f"scenario {self.scenario_id} carries no verdict for "
            f"detector {detector!r}; ran: "
            f"{tuple(d.detector for d in self.detector_results)}")

    def mitigation_for(self, detector: str,
                       policy: str) -> MitigationOutcome:
        """This scenario's :class:`MitigationOutcome` for one
        (detector, policy) cell."""
        for m in self.mitigation_results:
            if m.detector == detector and m.policy == policy:
                return m
        raise KeyError(
            f"scenario {self.scenario_id} carries no mitigation outcome "
            f"for ({detector!r}, {policy!r}); ran: "
            f"{tuple((m.detector, m.policy) for m in self.mitigation_results)}")

    def cell(self) -> tuple:
        # topology is appended (not inserted) so positional consumers of
        # the historical 6 fields keep their indices
        return (self.workload, self.mesh_w, self.mesh_h, self.kind,
                self.severity, self.n_failures, self.topology)

    def deploy_key(self) -> tuple:
        return (self.workload, self.topology, self.mesh_w, self.mesh_h)

    def topology_label(self) -> str:
        """Canonical fabric spec of this scenario's deployment
        (``'mesh:4x4'``, ``'torus:8x8'``, ``'het:4x4:fast2slow1'``)."""
        return topology_spec(self.topology, self.mesh_w, self.mesh_h)


@dataclasses.dataclass(frozen=True)
class BinomialStat:
    """k successes out of n trials with a Wilson score interval."""
    successes: int
    trials: int
    z: float = 1.96

    @property
    def rate(self) -> float:
        return self.successes / self.trials if self.trials else 0.0

    @property
    def interval(self) -> tuple[float, float]:
        return wilson_interval(self.successes, self.trials, self.z)

    def pct(self) -> float:
        return 100.0 * self.rate


def wilson_interval(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion (exact at n=0)."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1.0 + z * z / n
    centre = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (max(0.0, centre - half), min(1.0, centre + half))


def _rate_at(pairs: tuple[tuple[int, BinomialStat], ...], k: int) -> float:
    """Look up the rate for ``k`` in a ``((k, stat), ...)`` table — the
    one accessor behind every ``topk_rate``/``recall_at``."""
    for kk, stat in pairs:
        if kk == k:
            return stat.rate
    raise KeyError(k)


@dataclasses.dataclass(frozen=True)
class LatencyStat:
    """Detection-latency summary over the streamed positive scenarios of
    a campaign: ``detected`` counts finite latencies (failure flagged
    while streaming) out of all streamed positives; ``mean``/``p95``
    summarise the finite latencies (simulated seconds from earliest
    failure onset to the first flagged streaming verdict; 0.0 when
    nothing was detected)."""
    detected: BinomialStat
    mean: float
    p95: float

    @property
    def n_measured(self) -> int:
        return self.detected.trials

    @property
    def n_detected(self) -> int:
        return self.detected.successes


def detection_latency_stats(outcomes: list[ScenarioOutcome],
                            detector: str | None = None) \
        -> LatencyStat | None:
    """Reduce streamed positives to a :class:`LatencyStat` for one
    detector (``None`` → primary); ``None`` when no positive scenario
    carries a latency measurement (non-streaming campaign)."""
    lats = [o.result_for(detector).detection_latency
            for o in outcomes if o.positive]
    lats = [x for x in lats if x is not None]
    if not lats:
        return None
    finite = [x for x in lats if math.isfinite(x)]
    return LatencyStat(
        detected=BinomialStat(len(finite), len(lats)),
        mean=sum(finite) / len(finite) if finite else 0.0,
        p95=_p95(finite))


@dataclasses.dataclass(frozen=True)
class CampaignMetrics:
    """Aggregate metrics over a set of scenario outcomes, for one
    detector."""
    n_scenarios: int
    accuracy: BinomialStat          # any-match, over positives
    fpr: BinomialStat               # over negatives
    topk: tuple[tuple[int, BinomialStat], ...]   # ((k, stat), ...)
    recall: tuple[tuple[int, BinomialStat], ...]  # per-failure recall@k
    mean_compression: float
    mean_probe_overhead: float      # weighted by per-deployment scenarios
    mean_probe_overhead_unweighted: float   # plain mean over deployments
    # detection-latency summary over streamed positives (None on
    # non-streaming campaigns)
    detection: LatencyStat | None = None

    def topk_rate(self, k: int) -> float:
        return _rate_at(self.topk, k)

    def recall_at(self, k: int) -> float:
        return _rate_at(self.recall, k)


@dataclasses.dataclass(frozen=True)
class WallTimeStat:
    """Telemetry summary of a wall-time population (seconds)."""
    mean: float
    p95: float
    total: float
    n: int


def _p95(xs: list[float]) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def detectors_in(outcomes: list[ScenarioOutcome]) -> tuple[str, ...]:
    """Detector names present in ``outcomes``, in request order."""
    return (tuple(d.detector for d in outcomes[0].detector_results)
            if outcomes else ())


def topk_stat(outcomes: list[ScenarioOutcome], k: int,
              detector: str | None = None) -> BinomialStat:
    """Scenario-level: some truth ranked within the top k."""
    pos = [o for o in outcomes if o.positive]
    hits = 0
    for o in pos:
        r = o.result_for(detector).truth_rank
        hits += int(r is not None and r <= k)
    return BinomialStat(hits, len(pos))


def deployment_overheads(outcomes: list[ScenarioOutcome]) \
        -> dict[tuple, float]:
    """Per-deployment probe overhead, keyed ``deploy_key()``, in
    first-occurrence order.  The single reduction shared by ``aggregate``
    and ``CampaignResult.probe_overheads``."""
    dep_ov: dict[tuple, float] = {}
    for o in outcomes:
        dep_ov.setdefault(o.deploy_key(), o.probe_overhead)
    return dep_ov


def recall_stat(outcomes: list[ScenarioOutcome], k: int,
                detector: str | None = None) -> BinomialStat:
    """Failure-level recall@k: each injected failure of each positive
    scenario is one trial; a hit is that failure's own truth ranked ≤ k."""
    hits = trials = 0
    for o in outcomes:
        if not o.positive:
            continue
        for r in o.result_for(detector).truth_ranks:
            trials += 1
            hits += int(r is not None and r <= k)
    return BinomialStat(hits, trials)


def aggregate(outcomes: list[ScenarioOutcome],
              ks: tuple[int, ...] = (1, 3, 5),
              detector: str | None = None) -> CampaignMetrics:
    """Reduce outcomes to campaign metrics for one detector (``None`` →
    the primary, i.e. first-requested, detector).

    Positives feed accuracy/top-k/recall; negatives feed FPR only — a grid
    cell with ``kind='none'`` therefore contributes zero accuracy trials.
    Compression is averaged over outcomes that produced recorder artifacts.
    Probe overhead is aggregated both scenario-weighted (each outcome
    contributes its deployment's overhead) and unweighted over the distinct
    deployments that appear in ``outcomes``; both are per-deployment
    quantities independent of the detector selector.
    """
    pos = [o for o in outcomes if o.positive]
    neg = [o for o in outcomes if not o.positive]
    acc = BinomialStat(sum(o.result_for(detector).matched for o in pos),
                       len(pos))
    fpr = BinomialStat(sum(o.result_for(detector).flagged for o in neg),
                       len(neg))
    comp = [o.compression_ratio for o in outcomes
            if o.compression_ratio > 0]
    mean_comp = sum(comp) / len(comp) if comp else 0.0
    ov = [o.probe_overhead for o in outcomes]
    mean_ov = sum(ov) / len(ov) if ov else 0.0
    dep_ov = deployment_overheads(outcomes)
    # sorted(): dict order reflects outcome arrival, which differs per
    # executor/shard merge — summing floats in a fixed order keeps the
    # serial == thread == process bit-identity contract.
    mean_ov_unw = (sum(sorted(dep_ov.values())) / len(dep_ov)) \
        if dep_ov else 0.0
    return CampaignMetrics(
        n_scenarios=len(outcomes),
        accuracy=acc,
        fpr=fpr,
        topk=tuple((k, topk_stat(outcomes, k, detector)) for k in ks),
        recall=tuple((k, recall_stat(outcomes, k, detector)) for k in ks),
        mean_compression=mean_comp,
        mean_probe_overhead=mean_ov,
        mean_probe_overhead_unweighted=mean_ov_unw,
        detection=detection_latency_stats(outcomes, detector),
    )


def by_detector(outcomes: list[ScenarioOutcome],
                ks: tuple[int, ...] = (1, 3, 5)) \
        -> dict[str, CampaignMetrics]:
    """Per-detector campaign metrics, in detector request order — the
    SLOTH-vs-baselines comparison table in one reduction."""
    return {name: aggregate(outcomes, ks=ks, detector=name)
            for name in detectors_in(outcomes)}


def by_cell(outcomes: list[ScenarioOutcome],
            ks: tuple[int, ...] = (1, 3, 5),
            detector: str | None = None) \
        -> dict[tuple, CampaignMetrics]:
    """Per-cell aggregation for one detector, keyed (workload, mesh_w,
    mesh_h, kind, severity, n_failures).  Cells appear in first-occurrence
    (enumeration) order."""
    cells: dict[tuple, list[ScenarioOutcome]] = {}
    for o in outcomes:
        cells.setdefault(o.cell(), []).append(o)
    return {c: aggregate(v, ks=ks, detector=detector)
            for c, v in cells.items()}


def detector_cells(outcomes: list[ScenarioOutcome],
                   ks: tuple[int, ...] = (1, 3, 5)) \
        -> dict[str, dict[tuple, CampaignMetrics]]:
    """Per-detector per-cell metrics: ``{detector: {cell: metrics}}`` —
    every accuracy/FPR/top-k number of the paper's comparison tables."""
    return {name: by_cell(outcomes, ks=ks, detector=name)
            for name in detectors_in(outcomes)}


#: Materiality floor for recovered-throughput means: positives whose
#: failure-induced gap is below this fraction of the healthy makespan are
#: excluded from ``recovered_mean``/``improved`` (a near-zero gap turns the
#: recovered fraction into amplified simulator noise), but still count in
#: ``acted`` and the slowdown mean.
MIN_GAP_FRAC = 0.01


@dataclasses.dataclass(frozen=True)
class MitigationStat:
    """Recovered-throughput summary for one (detector, policy) cell.

    Three populations, judged by the verdict the policy acted on:

    * *correct positives* (failure present, verdict matched) with a
      material gap feed ``improved`` (mitigated < failed, Wilson CI) and
      ``recovered_mean`` — the headline "fraction of the failure-induced
      gap recovered under correct verdicts";
    * *wrong/false verdicts* (mismatched positives + false-flagged
      negatives) feed ``mis_acted`` (the policy acted on bad information),
      ``worsened`` (acting made the run slower than the failure alone) and
      ``penalty_mean`` — the mis-mitigation cost;
    * all positives feed ``slowdown_mean`` (post-mitigation makespan vs
      healthy, 1.0 = full recovery).
    """
    detector: str
    policy: str
    n_positive: int
    n_negative: int
    acted: BinomialStat        # plans that edited the deployment, over all
    improved: BinomialStat     # correct material positives: mitigated < failed
    recovered_mean: float      # mean recovered_frac over that population
    slowdown_mean: float       # mean mitigated/healthy over positives
    mis_acted: BinomialStat    # wrong/false verdicts where the policy acted
    worsened: BinomialStat     # acted wrong/false: mitigated > failed
    penalty_mean: float        # mean penalty over acted wrong/false


def mitigations_in(outcomes: list[ScenarioOutcome]) \
        -> tuple[tuple[str, str], ...]:
    """(detector, policy) pairs present in ``outcomes``, in request order
    (detector-major)."""
    return (tuple((m.detector, m.policy)
                  for m in outcomes[0].mitigation_results)
            if outcomes else ())


def mitigation_stats(outcomes: list[ScenarioOutcome], detector: str,
                     policy: str) -> MitigationStat:
    """Reduce one (detector, policy) cell to a :class:`MitigationStat`."""
    pos: list[MitigationOutcome] = []
    neg: list[MitigationOutcome] = []
    for o in outcomes:
        for m in o.mitigation_results:
            if m.detector == detector and m.policy == policy:
                (pos if o.positive else neg).append(m)
    all_m = pos + neg
    material = [m for m in pos if m.correct
                and m.gap > MIN_GAP_FRAC * m.healthy_time]
    wrong = [m for m in pos + neg if not m.correct]
    wrong_acted = [m for m in wrong if m.acted]
    slowdowns = [m.slowdown_vs_healthy for m in pos]
    recovered = [m.recovered_frac for m in material]
    penalties = [m.penalty for m in wrong_acted]
    return MitigationStat(
        detector=detector,
        policy=policy,
        n_positive=len(pos),
        n_negative=len(neg),
        acted=BinomialStat(sum(m.acted for m in all_m), len(all_m)),
        improved=BinomialStat(
            sum(m.mitigated_time < m.failed_time for m in material),
            len(material)),
        recovered_mean=(sum(recovered) / len(recovered)) if recovered
        else 0.0,
        slowdown_mean=(sum(slowdowns) / len(slowdowns)) if slowdowns
        else 0.0,
        mis_acted=BinomialStat(len(wrong_acted), len(wrong)),
        worsened=BinomialStat(
            sum(m.mitigated_time > m.failed_time for m in wrong_acted),
            len(wrong_acted)),
        penalty_mean=(sum(penalties) / len(penalties)) if penalties
        else 0.0,
    )


def by_mitigation(outcomes: list[ScenarioOutcome]) \
        -> dict[tuple[str, str], MitigationStat]:
    """Per-(detector, policy) recovered-throughput table, in request
    order — the detect → mitigate analogue of :func:`by_detector`."""
    return {pair: mitigation_stats(outcomes, *pair)
            for pair in mitigations_in(outcomes)}


@dataclasses.dataclass(frozen=True)
class TruthKindMetrics:
    """Per-failure statistics for the injected failures of one truth kind
    (the ``by_truth_kind`` split of a mixed-kind campaign)."""
    kind: str                  # 'core' | 'link' | 'router'
    n_failures: int            # injected failures of this kind (trials)
    ranked: BinomialStat       # fraction of them ranked at all
    recall: tuple[tuple[int, BinomialStat], ...]   # per-failure recall@k
    mean_rank: float | None    # mean 1-based rank over the ranked subset

    def recall_at(self, k: int) -> float:
        return _rate_at(self.recall, k)


def by_truth_kind(outcomes: list[ScenarioOutcome],
                  ks: tuple[int, ...] = (1, 3, 5),
                  detector: str | None = None) \
        -> dict[str, TruthKindMetrics]:
    """Split per-failure recall@k and ranks by the *truth's* kind.

    Every injected failure of every positive scenario is one trial,
    bucketed by its own kind (``effective_truth_kinds``) — so a mixed-kind
    scenario contributes to several buckets at once, and the table answers
    "which root-cause kinds does this detector localise well inside
    heterogeneous failure populations?".  Buckets appear in canonical
    ('core', 'link', 'router') order first, then any others in
    first-occurrence order.
    """
    ranks: dict[str, list[int | None]] = {}
    for o in outcomes:
        if not o.positive:
            continue
        r = o.result_for(detector).truth_ranks
        for kind, rank in zip(o.effective_truth_kinds, r):
            ranks.setdefault(kind, []).append(rank)
    order = [k for k in ("core", "link", "router") if k in ranks]
    order += [k for k in ranks if k not in order]
    out: dict[str, TruthKindMetrics] = {}
    for kind in order:
        rs = ranks[kind]
        ranked = [r for r in rs if r is not None]
        out[kind] = TruthKindMetrics(
            kind=kind,
            n_failures=len(rs),
            ranked=BinomialStat(len(ranked), len(rs)),
            recall=tuple(
                (k, BinomialStat(sum(r <= k for r in ranked), len(rs)))
                for k in ks),
            mean_rank=(sum(ranked) / len(ranked)) if ranked else None,
        )
    return out


@dataclasses.dataclass(frozen=True)
class SeverityPoint:
    """One severity slice of a campaign: accuracy / recall over the
    positive scenarios injected at exactly this severity.  ``fpr`` is the
    campaign's negative-sample rate (negatives collapse the severity axis,
    so the same reference stat is attached to every point)."""
    severity: float | tuple[float, ...]   # tuple for per-failure mixes
    n_scenarios: int
    accuracy: BinomialStat          # any-match over this slice's positives
    fpr: BinomialStat               # campaign negatives (shared reference)
    recall: tuple[tuple[int, BinomialStat], ...]

    def recall_at(self, k: int) -> float:
        return _rate_at(self.recall, k)


def severity_curve(outcomes: list[ScenarioOutcome],
                   ks: tuple[int, ...] = (1, 3, 5),
                   detector: str | None = None) \
        -> tuple[SeverityPoint, ...]:
    """Accuracy / FPR / recall@k as a function of injected severity, in
    ascending severity order — the near-threshold sweep readout.  Each
    distinct positive severity becomes one :class:`SeverityPoint`; Wilson
    intervals come with every stat, so sparse sweep points report honest
    uncertainty."""
    neg = [o for o in outcomes if not o.positive]
    fpr = BinomialStat(sum(o.result_for(detector).flagged for o in neg),
                       len(neg))
    by_sev: dict[float | tuple, list[ScenarioOutcome]] = {}
    for o in outcomes:
        if o.positive:
            key = (tuple(float(s) for s in o.severity)
                   if isinstance(o.severity, tuple) else float(o.severity))
            by_sev.setdefault(key, []).append(o)
    points = []
    # scalar severities first (ascending), then per-failure severity
    # tuples (lexicographic)
    for sev in sorted(by_sev, key=lambda s: (isinstance(s, tuple),
                                             s if isinstance(s, tuple)
                                             else (s,))):
        outs = by_sev[sev]
        acc = BinomialStat(
            sum(o.result_for(detector).matched for o in outs), len(outs))
        hits = {k: 0 for k in ks}
        trials = 0
        for o in outs:
            for r in o.result_for(detector).truth_ranks:
                trials += 1
                for k in ks:
                    hits[k] += int(r is not None and r <= k)
        points.append(SeverityPoint(
            severity=sev, n_scenarios=len(outs), accuracy=acc, fpr=fpr,
            recall=tuple((k, BinomialStat(hits[k], trials)) for k in ks)))
    return tuple(points)


def by_topology(outcomes: list[ScenarioOutcome],
                ks: tuple[int, ...] = (1, 3, 5),
                detector: str | None = None) \
        -> dict[str, CampaignMetrics]:
    """Campaign metrics split per deployment fabric, keyed by the
    canonical topology spec (``'mesh:4x4'``, ``'torus:8x8'``,
    ``'het:4x4:fast2slow1'``) in first-occurrence order — the paper's
    cross-architecture readout.  Each fabric's FPR uses that fabric's
    own negative scenarios."""
    groups: dict[str, list[ScenarioOutcome]] = {}
    for o in outcomes:
        groups.setdefault(o.topology_label(), []).append(o)
    return {t: aggregate(v, ks=ks, detector=detector)
            for t, v in groups.items()}


def severity_curve_by_mesh(outcomes: list[ScenarioOutcome],
                           ks: tuple[int, ...] = (1, 3, 5),
                           detector: str | None = None) \
        -> dict[tuple[int, int], tuple[SeverityPoint, ...]]:
    """:func:`severity_curve` split per mesh size, keyed ``(w, h)`` in
    first-occurrence order — near-threshold behaviour per topology scale
    instead of pooled over every mesh.  Each mesh's FPR reference uses
    that mesh's own negatives."""
    groups: dict[tuple[int, int], list[ScenarioOutcome]] = {}
    for o in outcomes:
        groups.setdefault((o.mesh_w, o.mesh_h), []).append(o)
    return {m: severity_curve(v, ks=ks, detector=detector)
            for m, v in groups.items()}


def wall_time_stats(outcomes: list[ScenarioOutcome]) \
        -> dict[str, WallTimeStat]:
    """Wall-time telemetry per detector (analyse time), plus the
    ``'simulate'`` key for trace generation.  Telemetry only: these values
    vary run-to-run and never participate in outcome equality."""
    out: dict[str, WallTimeStat] = {}
    sims = [o.sim_wall_time for o in outcomes]
    if sims:
        out["simulate"] = WallTimeStat(sum(sims) / len(sims), _p95(sims),
                                       sum(sims), len(sims))
    for name in detectors_in(outcomes):
        xs = [o.result_for(name).wall_time for o in outcomes]
        out[name] = WallTimeStat(sum(xs) / len(xs), _p95(xs), sum(xs),
                                 len(xs))
    return out
