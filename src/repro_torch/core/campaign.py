"""Batched scenario-campaign runner — the evaluation substrate.

The paper's headline numbers (detection accuracy, FPR, compression ratio)
are *campaign* statistics: aggregates over many injected fail-slow scenarios
across workloads, failure kinds and mesh sizes.  This module turns
single-scenario detection into a reproducible grid evaluation, and — via
the unified detector API (:mod:`repro_torch.core.detectors`) — into the paper's
SLOTH-vs-baselines comparison: ``run_campaign(grid, detectors=("sloth",
"thres", "mscope", "iaso", "perseus", "adr"))`` analyses every scenario's
trace with every requested detector under one judging rule and returns
per-detector accuracy / FPR / top-k / recall@k cells.

Scenario-grid schema
--------------------
A :class:`CampaignGrid` is the cross product

    workload × mesh × failure kind × severity × n_failures × replicate

with ``kind ∈ {'core', 'link', 'router', 'none', 'mixed'}`` or an explicit
per-failure kind tuple.  Mesh entries may be a square width ``W``, a
``(W, H)`` pair or a ``'WxH'`` string — they are normalised to ``(W, H)``
tuples at grid construction, so rectangular meshes (``12×8``, ``16×8``, …)
flow through scenario keys, cache keys and metric cells unchanged.  A
mesh entry may also be a full fabric spec ``'name:WxH[:variant]'``
(``'torus:8x8'``, ``'systolic:8x8'``, ``'het:4x4:fast2slow1'``) resolved
through the topology registry (:mod:`repro_torch.core.routing`); such entries
normalise to a canonical spec string, the topology name rides through
``Scenario.topology`` / cache keys / metric cells, and
``CampaignResult.by_topology()`` splits results per fabric.  Plain
``W``/``'WxH'`` entries stay the default mesh and stay bit-identical to
the pre-topology pipeline (the RNG key only grows a topology word on
non-mesh fabrics).
``n_failures`` entries are k ≥ 1 *simultaneous* failures at k distinct
locations (ground truth becomes a set; see ``metrics.py`` for any-match
accuracy and per-failure recall@k).

Heterogeneous (mixed-kind) scenarios come in two grid spellings:

* ``kind='mixed'`` — each of the scenario's k failures samples its own
  kind by drawing without replacement from the *union population* of the
  deployment's resources (every core, every used link, every used router),
  so a failure's kind probability is proportional to that kind's live
  resource count — the heterogeneous-fleet model of the paper's §IV-A
  7:3 core:link populations, extended to routers.
* an explicit kind tuple of **two or more** components, e.g.
  ``('core', 'link')`` (equivalently the string ``'core+link'``) —
  exactly those kinds, one failure each, at distinct locations per kind.
  A tuple entry pins the scenario's failure count to its length, so it
  collapses the ``n_failures`` axis the same way ``'none'`` collapses
  severity.  A single-kind tuple is rejected as ambiguous: spell it as
  the plain kind (swept by the axis) or pin via ``n_failures=(1,)``.

``metrics.by_truth_kind`` then splits per-failure recall@k and ranks by
each *truth's* kind, so mixed campaigns report per-kind localisation
quality inside heterogeneous scenarios.  ``'none'`` cells are negative
(failure-free) samples and collapse both the severity and n_failures axes
— they are enumerated once per replicate with ``severity = 0.0`` and
``n_failures = 0``.

``kind='mixed'`` additionally honours the grid's ``mixed_weights`` knob
(e.g. ``{'core': 7, 'link': 3}`` for the paper's 7:3 core:link split):
each kind's weight is split uniformly over its placeable pool, and kinds
absent from the mapping are never drawn.  The default ``None`` keeps the
uniform union-population draw bit-identically.

Severity is a first-class swept axis: ``severities`` entries may be plain
floats, a ``'linspace:LO:HI:N'`` string or a ``('linspace', lo, hi, n)``
tuple — linspace specs expand (via ``np.linspace``) at grid construction,
which makes near-detection-threshold sweeps one-line grid edits.  A
*nested* tuple of ≥2 numbers (``severities=((1.5, 10.0),)``) is a
**per-failure severity mix**: each of the scenario's failures gets its
own slowdown (the i-th severity to the i-th drawn site — for composite
kinds that is the canonicalised component order), and the mix pins the
scenario's failure count to the tuple length the same way composite kinds
do.  Per-failure severities are carried in
``ScenarioOutcome.truth_severities``.
``CampaignResult.severity_curve()`` returns the per-severity
accuracy / FPR / recall@k readout with Wilson CIs, and
``severity_curve_by_mesh()`` splits it per mesh size.

Every scenario is fully determined by ``(campaign_seed, workload, mesh,
kind, severity, n_failures, rep)``: locations, onset times, durations and
the simulator seed are drawn from a private ``numpy`` generator keyed on
exactly that tuple (``np.random.default_rng([...])``), so there is **no
global RNG state** and the same grid always materialises bit-identical
scenarios, regardless of worker count, executor or execution order.  The
severity enters the key through its IEEE-754 bit pattern
(``np.float64(severity).view(np.uint64)``), so severities arbitrarily
close together — exactly the near-threshold sweep case — still key
distinct streams (keying on ``int(severity * 1000)`` used to collide
severities closer than 1e-3 into identical location/onset/duration
draws).

Link/router placements are restricted to resources the healthy run actually
exercises (the paper: "failures occurring on unused resources are
excluded"), using the deployment's cached healthy simulation.

Detector model
--------------
``detectors=`` names registry entries (:func:`repro_torch.core.detectors
.get_detector`); each deployment prepares one instance per name against
its healthy profiling run, the first name being the campaign's *primary*
detector (top-level ``metrics`` / ``cells``).  Every scenario is simulated
**once** and the one trace is analysed by all detectors, so the comparison
is on identical data by construction.  Per-detector analyse wall time and
per-scenario simulate wall time are recorded as telemetry (excluded from
outcome equality, surfaced by ``CampaignResult.summary()``).

The SL-Recorder implementation is likewise campaign-selectable: the
``cfg`` a campaign passes keys the deployment cache, so
``run_campaign(grid, cfg=SlothConfig(recorder_impl="batched"))`` measures
the on-device batched recorder (run-compressed scan + drained-eviction
stream) against the same scenarios the default per-run oracle sees.
Compression ratios, pattern key sets, counts and eviction structure are
bit-identical across impls; verdicts agree wherever detector scores are
not within float32 rounding of a flag threshold (the batched Stage-2
statistics are f32 vs the oracle's f64), which
``python -m repro_torch.launch.campaign --recorder-impl both`` asserts on
its decisively-failing grid.

Streaming axis
--------------
``run_campaign(..., streaming=N)`` replays every scenario's trace
chunk-by-chunk through the always-on detection service
(:mod:`repro_torch.core.streaming`) instead of one-shot post-hoc analysis:
each detector exposing ``stream_analyse`` observes ``N`` time-ordered
chunks, emitting one incremental verdict per window.  The final
streamed verdict is bit-equal to the post-hoc one on both recorder
impls (same record sequence through the same resident sketch), so the
judged accuracy/FPR/recall metrics are unchanged — what streaming adds
is **detection latency**: the simulated time from the earliest failure
onset to the first flagged window, aggregated by
``metrics.detection_latency_stats`` into the campaign's
``metrics.detection`` summary.  ``python -m repro_torch.launch.campaign
--streaming N`` runs the streaming-vs-post-hoc parity gate.

Mitigation axis
---------------
``run_campaign(..., mitigation=('remap', 'none'))`` closes the detect →
mitigate loop: every detector's judged verdict is handed to every named
mitigation policy (:mod:`repro_torch.mitigate` — registered like detectors),
the policy's plan is applied to the deployment (cores excluded from the
mapping, links detoured via ``DetourMesh``), and the mitigated deployment
is re-simulated over the remaining failure window with the scenario's own
simulator seed and probe plan.  Each (detector, policy) pair yields one
``MitigationOutcome`` per scenario; ``metrics.by_mitigation`` reduces
them to recovered-throughput statistics — the fraction of the
failure-induced gap recovered under correct verdicts, the post-mitigation
slowdown vs healthy, and the mis-mitigation penalty paid when a policy
acted on a wrong or false verdict (a sharp end-to-end measure of verdict
quality).  Combined with ``streaming=N``, mitigation engages at each
detector's first flagged window, so detection latency composes with
recovery; without streaming it models a post-hoc restart.  The ``none``
policy is the control: it never acts and its recovered throughput is
exactly zero.

Device
------
``run_campaign(..., device=None)`` runs every deployment's SLOTH pipeline
on one torch device, resolved by :func:`repro_torch.device.resolve_device`:
the card unless ``device="cpu"`` is asked for, raising without one.  With
``SlothConfig(recorder_impl="batched")`` the recorder runs the sketch
kernel there (post-hoc and streamed); FailRank runs there on either
recorder impl.  The simulator, the baselines, mitigation and the metrics
are host code (numpy), as in the reference.

Execution model
---------------
``run_campaign(..., workers=N, executor='thread'|'process')``:

* ``executor='thread'`` (default) — deployments are built serially into the
  shared :class:`DeploymentCache`, then scenarios fan out over a thread
  pool.  Fine for small grids; the pure-Python simulator holds the GIL, so
  threads mostly pipeline rather than parallelise.  On the card the
  threads launch the sketch kernel on one stream; loading and launch
  counting are locked (``kernels/_lib``).
* ``executor='process'`` — scenarios are dispatched to a
  ``ProcessPoolExecutor`` of spawned workers.  Only the picklable ``(grid,
  scenario, config, detector names, device string)`` coordinates cross the
  process boundary; on the card the kernels are built in the parent before
  the pool starts, each worker opens its own CUDA context and only loads
  them.  Each worker
  process lazily rebuilds the deployments (and prepared detectors) it
  needs into its own module-level :class:`DeploymentCache` (construction
  is deterministic, so a rebuilt deployment is identical to the parent's).
  Custom detectors must therefore be registered at import time of their
  defining module to be resolvable inside spawned workers.  A ``cache=``
  argument is not consulted on this path.  Outcomes are collected in
  scenario order and are **bit-identical** to serial/thread execution for
  any worker count.

``workers=None`` → cpu count; ``0``/``1`` or a single-scenario grid →
serial in-process execution for either executor.

Performance
-----------
``(workload, mesh, config, device, detectors)`` deployments — mapped
graph, probe plan, healthy simulation, probe-overhead calibration,
prepared detector instances — are built once per cache
(:class:`DeploymentCache`) and shared read-only by all scenarios of the
grid.  The cache key normalises ``cfg=None`` to the default
:class:`SlothConfig`, so explicit-default and implicit-default callers
share one deployment; it holds the device, so a CPU deployment never
serves a campaign on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from ..device import resolve_device
from .detectors import (DEFAULT_DETECTORS, Detector, get_detector,
                        instantiate_detector)
from .failures import FailSlow, judge_verdict, truth_candidates
from .graph import build_workload
from .metrics import (CampaignMetrics, DetectorOutcome, MitigationOutcome,
                      MitigationStat, ScenarioOutcome, SeverityPoint,
                      TruthKindMetrics, aggregate, by_detector,
                      by_mitigation, by_topology, by_truth_kind,
                      deployment_overheads,
                      detector_cells, severity_curve, severity_curve_by_mesh,
                      wall_time_stats)
from .routing import build_topology, parse_topology_spec, topology_spec
from .simulator import SimResult, simulate, simulate_mitigated
from .sloth import Sloth, SlothConfig, SlothDetector
# submodule import (not the package) so a partially-initialised
# repro_torch.mitigate package during circular-ish import chains still resolves
from ..mitigate.policy import (get_policy, instantiate_policy,
                               work_done_frac)

__all__ = [
    "KINDS", "MIXED", "FAILURE_KINDS", "EXECUTORS", "DEFAULT_DETECTORS",
    "CampaignGrid", "Scenario", "Deployment", "DeploymentCache",
    "CampaignResult", "enumerate_scenarios", "materialise", "run_scenario",
    "run_campaign", "truth_candidates",
]

KINDS = ("core", "link", "router", "none")
MIXED = "mixed"
EXECUTORS = ("thread", "process")

#: Kinds a concrete failure may take (everything except 'none').
FAILURE_KINDS = ("core", "link", "router")


def _wall_clock() -> float:
    """The campaign's one blessed wall-clock read, feeding the
    ``compare=False`` wall-time telemetry only (``wall_time_stats``) —
    never a scenario outcome, verdict, or RNG stream.  Centralised so a
    determinism audit has exactly one reader to check."""
    return time.perf_counter()  # lint: allow-wallclock


def _normalise_kind(kind) -> str:
    """Normalise a grid kind entry to its canonical string form.

    Accepts the four base kinds, ``'mixed'``, an explicit kind tuple
    (``('core', 'link')``) or its ``'core+link'`` string spelling.
    Composite entries are canonicalised into ``FAILURE_KINDS`` order, so
    ``('link', 'core')`` and ``'core+link'`` name the same scenario cell
    (and the same RNG stream).
    """
    if isinstance(kind, (tuple, list)):
        parts = tuple(str(k).lower() for k in kind)
    elif isinstance(kind, str) and "+" in kind:
        parts = tuple(p.strip().lower() for p in kind.split("+"))
    else:
        k = str(kind).lower()
        if k not in KINDS and k != MIXED:
            raise ValueError(
                f"unknown failure kind {kind!r}; use one of "
                f"{KINDS + (MIXED,)}, a 'core+link' composite or a kind "
                f"tuple")
        return k
    bad = [p for p in parts if p not in FAILURE_KINDS]
    if bad or not parts:
        raise ValueError(
            f"bad composite kind {kind!r}: components must be drawn from "
            f"{FAILURE_KINDS}")
    if len(parts) == 1:
        # a 1-tuple cannot be distinguished from the plain kind once
        # normalised, so it could not honour the pin-to-length contract —
        # demand the unambiguous spelling instead
        raise ValueError(
            f"single-kind tuple {kind!r} is ambiguous: spell it as the "
            f"plain kind {parts[0]!r} (swept by the n_failures axis) or "
            f"pin one failure with n_failures=(1,)")
    return "+".join(sorted(parts, key=FAILURE_KINDS.index))


def _kind_parts(kind: str) -> tuple[str, ...]:
    """Per-failure kinds pinned by a composite entry ('' for the rest)."""
    return tuple(kind.split("+")) if "+" in kind else ()


def _mesh_dims(mesh) -> tuple[int, int]:
    """Normalise a mesh spec — ``12`` | ``(12, 8)`` | ``'12x8'`` — to
    ``(width, height)``."""
    if isinstance(mesh, str):
        parts = mesh.lower().split("x")
        if len(parts) == 1:
            parts = parts * 2
        if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
            raise ValueError(f"bad mesh spec {mesh!r}: use 'W' or 'WxH'")
        w, h = (int(p) for p in parts)
    elif isinstance(mesh, (int, np.integer)):
        w = h = int(mesh)
    else:
        try:
            if len(mesh) != 2:
                raise ValueError
            w, h = int(mesh[0]), int(mesh[1])
        except (TypeError, ValueError):
            raise ValueError(f"bad mesh spec {mesh!r}: use W, (W, H) "
                             f"or 'WxH'") from None
    if w < 1 or h < 1:
        raise ValueError(f"mesh dimensions must be >= 1, got {w}x{h}")
    return w, h


def _normalise_mesh(mesh):
    """Normalise one grid fabric entry.

    Plain mesh spellings — ``12`` | ``(12, 8)`` | ``'12x8'`` — keep their
    historical ``(width, height)`` tuple form (so existing grids compare,
    hash and RNG-key bit-identically); registry topology specs —
    ``'torus:8x8'``, ``'systolic:8x8'``, ``'het:4x4:fast2slow1'`` — are
    canonicalised to their spec string (see
    :func:`repro_torch.core.routing.parse_topology_spec` for the grammar).
    """
    if isinstance(mesh, str) and ":" in mesh:
        topo, w, h = parse_topology_spec(mesh)
        return topology_spec(topo, w, h)
    return _mesh_dims(mesh)


def _per_failure_severities(e) -> tuple[float, ...]:
    """Validate one per-failure severity mix entry (a tuple/list of ≥2
    slowdown factors, e.g. ``(1.5, 10.0)`` for a mild first failure with a
    severe second one)."""
    if len(e) == 1:
        # a 1-tuple would be indistinguishable from the scalar severity it
        # contains once a scenario carries one failure — demand the
        # unambiguous spelling (mirrors the single-kind-tuple rule)
        raise ValueError(
            f"single-entry severity tuple {tuple(e)!r} is ambiguous: "
            f"spell it as the plain severity {e[0]!r}")
    try:
        tup = tuple(float(x) for x in e)
    except (TypeError, ValueError):
        raise ValueError(
            f"bad severity entry {e!r}: tuple entries must be "
            f"('linspace', lo, hi, n) or a per-failure severity mix of "
            f"numbers") from None
    for x in tup:
        if not x > 0.0:
            raise ValueError(
                f"severities must be positive slowdown factors, got {x} "
                f"in {tup!r}")
    return tup


def _expand_severities(entries) -> tuple:
    """Expand a severities spec to a flat tuple of cells.

    Entries may be plain numbers, ``'linspace:LO:HI:N'`` strings,
    ``('linspace', lo, hi, n)`` tuples, or **per-failure severity mixes**
    — a tuple of ≥2 numbers like ``(1.5, 10.0)`` assigning each of a
    scenario's failures its own slowdown (the mix pins the scenario's
    failure count to the tuple length; with composite kinds the
    severities align index-wise with the canonicalised kind components).
    A per-failure mix must be *nested* (``severities=((1.5, 10.0),)``) —
    a bare top-level tuple of numbers remains a list of scalar severity
    cells.  Linspace specs expand via ``np.linspace`` so near-threshold
    sweeps are declared, not typed out.  Exact duplicates (e.g. a plain
    entry also covered by a linspace) are dropped, keeping first
    occurrence: duplicate severity cells would share one RNG stream and
    double-count bit-identical outcomes in every metric.
    """
    if isinstance(entries, (str, int, float)):
        entries = (entries,)
    elif isinstance(entries, (tuple, list)) and entries \
            and entries[0] == "linspace":
        entries = (tuple(entries),)    # a bare spec, not a list of specs
    out: list[float | tuple[float, ...]] = []
    for e in entries:
        spec = None
        if isinstance(e, str) and e.startswith("linspace"):
            spec = e.split(":")[1:]
        elif isinstance(e, (tuple, list)):
            if e and e[0] == "linspace":
                spec = list(e[1:])
            else:
                out.append(_per_failure_severities(e))
                continue
        if spec is not None:
            try:
                lo, hi, n = float(spec[0]), float(spec[1]), int(spec[2])
            except (IndexError, ValueError):
                raise ValueError(
                    f"bad severity spec {e!r}: use 'linspace:LO:HI:N' or "
                    f"('linspace', lo, hi, n)") from None
            if n < 1:
                raise ValueError(f"bad severity spec {e!r}: N must be >= 1")
            out.extend(float(x) for x in np.linspace(lo, hi, n))
        else:
            out.append(float(e))
    for s in out:
        if not isinstance(s, tuple) and not s > 0.0:
            raise ValueError(
                f"severities must be positive slowdown factors, got {s}")
    return tuple(dict.fromkeys(out))


def _normalise_detectors(detectors) -> tuple[str, ...]:
    """Resolve the ``detectors=`` request to a validated, deduplicated
    name tuple."""
    if isinstance(detectors, str):
        detectors = (detectors,)
    names = tuple(dict.fromkeys(str(n).lower() for n in detectors))
    if not names:
        raise ValueError("detectors must name at least one detector")
    for n in names:
        get_detector(n)          # raises KeyError for unknown names
    return names


def _normalise_policies(mitigation) -> tuple[str, ...]:
    """Resolve the ``mitigation=`` request to a validated, deduplicated
    policy-name tuple (``None``/``False``/empty → no mitigation)."""
    if mitigation is None or mitigation is False:
        return ()
    if isinstance(mitigation, str):
        mitigation = (mitigation,)
    names = tuple(dict.fromkeys(str(n).lower() for n in mitigation))
    for n in names:
        get_policy(n)            # raises KeyError for unknown names
    return names


def _normalise_mixed_weights(mw):
    """Normalise a ``mixed_weights`` spec — a ``{kind: weight}`` mapping or
    ``((kind, weight), ...)`` pairs — to canonical ``FAILURE_KINDS``-ordered
    pairs (hashable and spelling-independent).  Kinds absent from the spec
    get weight 0, i.e. are never drawn."""
    if mw is None:
        return None
    items = mw.items() if isinstance(mw, dict) else tuple(mw)
    out: dict[str, float] = {}
    for kind, wgt in items:
        k = str(kind).lower()
        if k not in FAILURE_KINDS:
            raise ValueError(
                f"mixed_weights kind {kind!r} must be one of "
                f"{FAILURE_KINDS}")
        if k in out:
            raise ValueError(f"mixed_weights repeats kind {k!r}")
        w = float(wgt)
        if not (math.isfinite(w) and w >= 0.0):
            raise ValueError(
                f"mixed_weights[{k!r}] must be a finite weight >= 0, "
                f"got {wgt!r}")
        out[k] = w
    if not out or not any(w > 0.0 for w in out.values()):
        raise ValueError("mixed_weights needs at least one positive weight")
    return tuple((k, out[k]) for k in FAILURE_KINDS if k in out)


# ---------------------------------------------------------------------------
# grid + scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CampaignGrid:
    """Declarative scenario grid (see module docstring for the schema)."""
    workloads: tuple[str, ...] = ("darknet19",)
    meshes: tuple = (4,)                     # W | (W, H) | 'WxH' entries
    kinds: tuple[str, ...] = KINDS
    severities: tuple[float, ...] = (10.0,)
    n_failures: tuple[int, ...] = (1,)       # simultaneous failures axis
    reps: int = 1                            # replicates per grid cell
    campaign_seed: int = 0
    max_t0_frac: float = 0.5                 # onset within healthy runtime
    min_dur_frac: float = 0.4                # duration ⊆ healthy runtime
    # Non-uniform kind weights for 'mixed' draws: a {kind: weight} mapping
    # (or ((kind, weight), ...) pairs), e.g. {'core': 7, 'link': 3} for the
    # paper's §IV-A 7:3 core:link population.  A kind's weight is split
    # uniformly over its placeable resources; kinds absent from the spec
    # are never drawn.  ``None`` (default) keeps the historical uniform
    # union-population draw bit-identically.
    mixed_weights: tuple | dict | None = None

    def __post_init__(self):
        # dedupe after normalisation: alias spellings ('core+link' vs
        # ('link', 'core')) would otherwise enumerate bit-identical
        # scenarios twice on one RNG stream, double-counting every metric
        kinds = tuple(dict.fromkeys(_normalise_kind(k)
                                    for k in self.kinds))
        object.__setattr__(self, "kinds", kinds)
        if self.reps < 1:
            raise ValueError("reps must be >= 1")
        if not self.n_failures or any(int(k) < 1 for k in self.n_failures):
            raise ValueError("n_failures entries must be >= 1")
        object.__setattr__(self, "meshes",
                           tuple(_normalise_mesh(m) for m in self.meshes))
        object.__setattr__(self, "severities",
                           _expand_severities(self.severities))
        object.__setattr__(self, "n_failures",
                           tuple(int(k) for k in self.n_failures))
        object.__setattr__(self, "mixed_weights",
                           _normalise_mixed_weights(self.mixed_weights))

    def _cells_for_kind(self, kind: str) -> tuple[tuple, ...]:
        """(severity, n_failures) cells swept for one kind entry: 'none'
        collapses both axes, a composite kind pins n_failures to its
        component count, and a per-failure severity mix pins n_failures
        to its own length (which must agree with a composite kind's pin)."""
        if kind == "none":
            return ((0.0, 0),)
        parts = _kind_parts(kind)
        cells: list[tuple] = []
        for sev in self.severities:
            if isinstance(sev, tuple):
                if parts and len(parts) != len(sev):
                    raise ValueError(
                        f"per-failure severity mix {sev!r} assigns "
                        f"{len(sev)} severities but composite kind "
                        f"{kind!r} pins {len(parts)} failures")
                cells.append((sev, len(sev)))
            elif parts:
                cells.append((sev, len(parts)))
            else:
                cells.extend((sev, nf) for nf in self.n_failures)
        return tuple(cells)

    def n_scenarios(self) -> int:
        per_deploy = sum(self.reps * len(self._cells_for_kind(k))
                         for k in self.kinds)
        return len(self.workloads) * len(self.meshes) * per_deploy


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-enumerated grid point (locations not yet materialised —
    that needs the deployment's used-resource sets).  Picklable, so it can
    be shipped to process-pool workers."""
    scenario_id: int
    workload: str
    mesh_w: int
    mesh_h: int
    kind: str
    severity: float | tuple[float, ...]   # tuple = per-failure mix
    n_failures: int        # 0 for 'none' scenarios
    rep: int
    # registry fabric key, optionally 'name:variant' ('het:fast2slow1');
    # 'mesh' is the historical default and keeps its RNG stream and cache
    # keys bit-identical
    topology: str = "mesh"


def enumerate_scenarios(grid: CampaignGrid) -> list[Scenario]:
    """Fixed nested-loop enumeration; scenario_id is the stable index."""
    out: list[Scenario] = []
    for wl in grid.workloads:
        for mesh in grid.meshes:
            topo, w, h = parse_topology_spec(mesh)
            for kind in grid.kinds:
                for sev, nf in grid._cells_for_kind(kind):
                    for rep in range(grid.reps):
                        out.append(Scenario(len(out), wl, w, h, kind,
                                            sev, nf, rep, topo))
    return out


def _kind_key(kind: str) -> int:
    """Stable integer key for a kind: the four base kinds keep their
    historical ``KINDS`` index (so pre-mixed grids reproduce their draws);
    'mixed' and composite kinds fold their **entire** name into the key
    (SeedSequence takes arbitrary-precision entropy) — a truncated prefix
    would collide long composites like 'core+link+link' vs
    'core+link+router' back onto one RNG stream."""
    try:
        return KINDS.index(kind)
    except ValueError:
        return int.from_bytes(kind.encode().ljust(8, b"\0"), "big")


def _severity_key(severity) -> int:
    """The severity's IEEE-754 bit pattern.  Keying on the float's bits
    (not on ``int(severity * 1000)``) keeps severities closer than 1e-3 —
    the near-threshold sweep case — on distinct RNG streams.  The bit
    pattern differs from the old key for every nonzero severity, so all
    positive-scenario draws re-keyed at this fix (0.0 still keys to 0;
    'none' draws re-keyed only via the full-name workload fold in
    ``_scenario_rng``, for workload names longer than 8 bytes) — pre-fix
    campaign recordings are not comparable.

    A per-failure severity mix folds every component's bit pattern into
    one arbitrary-precision key (SeedSequence accepts big ints), prefixed
    with a domain tag so a mix can never collide with a scalar severity's
    stream."""
    if isinstance(severity, tuple):
        key = 1
        for s in severity:
            key = (key << 64) | int(np.float64(s).view(np.uint64))
        return key
    return int(np.float64(severity).view(np.uint64))


def _scenario_rng(grid: CampaignGrid, s: Scenario) -> np.random.Generator:
    """Private per-scenario stream: keyed on the scenario coordinates, not
    on enumeration order, so sub-grids reproduce the full grid's draws.
    The workload key folds the **entire** name (an 8-byte-prefix fold
    would collide e.g. 'resnet50_v1'/'resnet50_v2' onto one stream — the
    same truncation class the severity/kind keys guard against)."""
    wl_key = int.from_bytes(s.workload.encode().ljust(8, b"\0"), "big")
    key = [grid.campaign_seed, wl_key, s.mesh_w, s.mesh_h,
           _kind_key(s.kind), _severity_key(s.severity), s.n_failures,
           s.rep]
    if s.topology != "mesh":
        # Non-mesh fabrics fold their full registry key ('torus',
        # 'het:fast2slow1', ...) as an extra entropy word; the default
        # mesh keeps its historical 8-word key so pre-topology campaign
        # recordings stay bit-identical.
        key.append(int.from_bytes(s.topology.encode().ljust(8, b"\0"),
                                  "big"))
    return np.random.default_rng(key)


# ---------------------------------------------------------------------------
# deployment cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Deployment:
    """Shared, read-only per-(workload, mesh) artifacts."""
    sloth: Sloth                   # simulation host (probe plan + traces)
    healthy: SimResult
    used_links: tuple[int, ...]
    used_routers: tuple[int, ...]  # routers with ≥1 used incident link
    probe_overhead: float          # (t_probed / t_unprobed - 1)
    detectors: tuple[Detector, ...] = ()   # prepared, in request order


class DeploymentCache:
    """(workload, mesh, config, device, detectors) → :class:`Deployment`,
    built once.

    Construction is the expensive part of the grid (graph build, mapping,
    probe planning, healthy calibration run, detector preparation);
    caching it means adding scenarios to a campaign costs one
    simulate+analyse each.  The cache is layered: the *host* artifacts
    (SLOTH pipeline, healthy run, used-resource sets, probe-overhead
    calibration) are keyed on (workload, mesh, cfg, device) only, and
    prepared detector instances on (host, name) — so campaigns that differ
    only in their detector subset or order share both the host and the
    per-name detectors.  ``cfg=None`` is normalised to the default
    ``SlothConfig()`` before keying, so both spellings share one
    deployment.  The device is part of the key: a host's SLOTH pipeline is
    bound to the device it was built on.
    """

    HEALTHY_SEED = 999

    def __init__(self):
        self._hosts: dict[tuple, Deployment] = {}      # detector-free
        self._detectors: dict[tuple, Detector] = {}
        self._cache: dict[tuple, Deployment] = {}

    def _host(self, workload: str, mesh_w: int, mesh_h: int,
              cfg: SlothConfig, hostkey: tuple, topology: str,
              device) -> Deployment:
        host = self._hosts.get(hostkey)
        if host is None:
            sloth = Sloth(build_workload(workload),
                          build_topology(topology, mesh_w, mesh_h),
                          cfg=cfg, device=device)
            healthy = sloth.run(None, seed=self.HEALTHY_SEED)
            used = set()
            for s, d in zip(healthy.comm["src"], healthy.comm["dst"]):
                if s != d:
                    used.update(sloth.mesh.route(int(s), int(d)))
            probed_cfg = dataclasses.replace(sloth.sim_cfg,
                                             seed=self.HEALTHY_SEED)
            t_none = simulate(sloth.mapped, probed_cfg,
                              probes=None).total_time
            t_full = simulate(sloth.mapped, probed_cfg,
                              probes=sloth.plan.sim_plan).total_time
            routers = {c for lid in used for c in sloth.mesh.links[lid]}
            host = Deployment(sloth=sloth, healthy=healthy,
                              used_links=tuple(sorted(used)),
                              used_routers=tuple(sorted(routers)),
                              probe_overhead=t_full / t_none - 1.0)
            self._hosts[hostkey] = host
        return host

    def get(self, workload: str, mesh_w: int, mesh_h: int,
            cfg: SlothConfig | None = None,
            detectors=("sloth",),
            topology: str = "mesh", device=None) -> Deployment:
        """The deployment on ``device`` (resolved by
        :func:`repro_torch.device.resolve_device`: the card unless
        ``"cpu"`` is asked for)."""
        names = _normalise_detectors(detectors)
        cfg = cfg if cfg is not None else SlothConfig()
        device = resolve_device(device)
        hostkey = (workload, topology, mesh_w, mesh_h, repr(cfg),
                   str(device))
        key = hostkey + (names,)
        dep = self._cache.get(key)
        if dep is None:
            host = self._host(workload, mesh_w, mesh_h, cfg, hostkey,
                              topology, device)
            dets = []
            for n in names:
                det = self._detectors.get(hostkey + (n,))
                if det is None:
                    det = instantiate_detector(n)
                    if type(det) is SlothDetector:
                        # the simulation host IS a prepared SLOTH pipeline
                        # for exactly this (graph, mesh, cfg) — adopt it
                        # instead of rebuilding an identical one (prepare
                        # is deterministic, so this changes cost, not
                        # results)
                        det.pipeline = host.sloth
                    else:
                        det.prepare(host.sloth.graph, host.sloth.mesh,
                                    host.healthy, cfg)
                    self._detectors[hostkey + (n,)] = det
                dets.append(det)
            dep = dataclasses.replace(host, detectors=tuple(dets))
            self._cache[key] = dep
        return dep


_DEFAULT_CACHE = DeploymentCache()

# Per-worker-process cache for ``executor='process'``: each worker rebuilds
# the deployments it needs lazily (construction is deterministic, so the
# rebuild is identical to the parent's deployment).
_WORKER_CACHE = DeploymentCache()


# ---------------------------------------------------------------------------
# materialisation + single-scenario execution
# ---------------------------------------------------------------------------

def _kind_pools(dep: Deployment) -> dict[str, tuple[int, ...]]:
    """Placement pools per failure kind: every core, plus the links and
    routers the healthy run actually exercises (the paper: "failures
    occurring on unused resources are excluded")."""
    return {"core": tuple(range(dep.sloth.mesh.n_cores)),
            "link": dep.used_links, "router": dep.used_routers}


def _draw_sites(rng: np.random.Generator, s: Scenario, dep: Deployment,
                mixed_weights=None) -> list[tuple[str, int]]:
    """Draw ``s.n_failures`` distinct (kind, location) failure sites.

    Homogeneous kinds reproduce the historical draw sequence exactly.
    ``'mixed'`` samples without replacement from the union population of
    all placeable resources — uniformly by default (kind probability ∝
    live resource count), or with ``mixed_weights`` splitting each kind's
    weight evenly over its pool (the paper's 7:3 core:link population);
    composite kinds (``'core+link'``) draw one failure per pinned kind,
    distinct within each kind's pool.
    """
    mesh = dep.sloth.mesh
    k = s.n_failures
    parts = _kind_parts(s.kind)
    if s.kind == MIXED:
        pools = _kind_pools(dep)
        if mixed_weights is None:
            union = [(kind, int(loc)) for kind in FAILURE_KINDS
                     for loc in pools[kind]]
            if k > len(union):
                raise ValueError(
                    f"cannot place {k} distinct mixed-kind failures: only "
                    f"{len(union)} placeable resources on {s.workload}@"
                    f"{s.mesh_w}x{s.mesh_h}")
            # no p= here: rng.choice consumes the stream differently with
            # an explicit distribution, and the uniform default must stay
            # bit-identical to historical draws
            return [union[int(i)]
                    for i in rng.choice(len(union), size=k, replace=False)]
        wmap = dict(mixed_weights)
        for kind in FAILURE_KINDS:
            if wmap.get(kind, 0.0) > 0.0 and not pools[kind]:
                raise ValueError(
                    f"mixed_weights gives positive weight to {kind!r} but "
                    f"no {kind}s are placeable on {s.workload}@"
                    f"{s.mesh_w}x{s.mesh_h} — drop the kind or zero its "
                    f"weight")
        union = [(kind, int(loc)) for kind in FAILURE_KINDS
                 if wmap.get(kind, 0.0) > 0.0 for loc in pools[kind]]
        if k > len(union):
            raise ValueError(
                f"cannot place {k} distinct mixed-kind failures: only "
                f"{len(union)} placeable resources carry positive "
                f"mixed_weights on {s.workload}@{s.mesh_w}x{s.mesh_h}")
        probs = np.array([wmap[kind] / len(pools[kind])
                          for kind, _ in union], dtype=np.float64)
        probs /= probs.sum()
        return [union[int(i)]
                for i in rng.choice(len(union), size=k, replace=False,
                                    p=probs)]
    if parts:
        pools = _kind_pools(dep)
        sites: list[tuple[str, int]] = []
        for kind in FAILURE_KINDS:
            count = parts.count(kind)
            if not count:
                continue
            pool = pools[kind]
            if not pool:
                raise ValueError(
                    f"no used {kind}s on {s.workload}@"
                    f"{s.mesh_w}x{s.mesh_h}: the healthy run has no "
                    f"cross-core traffic, so a {kind} fail-slow cannot "
                    f"affect execution — drop {s.kind!r} from the grid")
            if count > len(pool):
                raise ValueError(
                    f"cannot place {count} distinct {kind} failures: only "
                    f"{len(pool)} used {kind}s on {s.workload}@"
                    f"{s.mesh_w}x{s.mesh_h}")
            sites += [(kind, int(pool[int(i)]))
                      for i in rng.choice(len(pool), size=count,
                                          replace=False)]
        return sites
    if s.kind == "core":
        if k > mesh.n_cores:
            raise ValueError(
                f"cannot place {k} distinct core failures on a "
                f"{mesh.n_cores}-core {s.mesh_w}x{s.mesh_h} mesh")
        return [("core", int(c)) for c in rng.choice(mesh.n_cores, size=k,
                                                     replace=False)]
    # link/router — only resources carrying traffic
    pool = dep.used_links if s.kind == "link" else dep.used_routers
    if not pool:
        raise ValueError(
            f"no used {s.kind}s on {s.workload}@"
            f"{s.mesh_w}x{s.mesh_h}: the healthy run has no "
            f"cross-core traffic, so a {s.kind} fail-slow cannot "
            f"affect execution — drop this kind from the grid")
    if k > len(pool):
        raise ValueError(
            f"cannot place {k} distinct {s.kind} failures: only "
            f"{len(pool)} used {s.kind}s on {s.workload}@"
            f"{s.mesh_w}x{s.mesh_h}")
    return [(s.kind, int(pool[int(i)]))
            for i in rng.choice(len(pool), size=k, replace=False)]


def materialise(grid: CampaignGrid, s: Scenario, dep: Deployment) \
        -> tuple[tuple[FailSlow, ...], int]:
    """Derive (failures, sim_seed) for one scenario — deterministic in the
    scenario coordinates and the deployment's healthy run.  ``'none'``
    scenarios yield an empty failure tuple; positive scenarios yield
    ``s.n_failures`` simultaneous failures at distinct (kind, location)
    sites — all of ``s.kind`` for homogeneous scenarios, independently
    sampled kinds for ``'mixed'`` and per-component kinds for composite
    entries — each with its own onset and duration."""
    rng = _scenario_rng(grid, s)
    sim_seed = int(rng.integers(1 << 31))
    if s.kind == "none":
        return (), sim_seed
    sites = _draw_sites(rng, s, dep, mixed_weights=grid.mixed_weights)
    total = dep.healthy.total_time
    # a per-failure severity mix assigns severities[i] to the i-th drawn
    # site (for composite kinds that is the canonicalised component
    # order); a scalar severity applies uniformly — severity assignment
    # consumes no RNG, so scalar draws are unchanged
    if isinstance(s.severity, tuple):
        sevs = s.severity
    else:
        sevs = (s.severity,) * len(sites)
    failures = []
    for (kind, loc), sv in zip(sites, sevs):
        t0 = float(rng.uniform(0.0, grid.max_t0_frac * total))
        dur = float(rng.uniform(grid.min_dur_frac, 1.0) * total)
        failures.append(FailSlow(kind, loc, t0, dur, float(sv)))
    return tuple(failures), sim_seed


def _mitigate_scenario(dep: Deployment, failures, sim: SimResult,
                       sim_seed: int, verdict, detector_name: str,
                       policy, switch_time: float | None,
                       correct: bool) -> MitigationOutcome:
    """Close the loop for one (detector, policy) pair: plan against the
    verdict, apply, re-simulate the mitigated deployment over the
    remaining failure window, and score recovery against the deployment's
    healthy reference.

    ``switch_time`` — the stream time at which mitigation engaged (the
    detector's first flagged window): the composed makespan keeps the
    work already finished by then and runs the remainder at the mitigated
    deployment's rate (the steady-state approximation for iterative
    workloads).  ``None`` models a post-hoc restart: the whole workload
    re-runs on the mitigated deployment under the full failure windows.
    A plan that does not act re-simulates nothing, so the ``none``
    control's mitigated makespan equals the failed one *exactly*.
    """
    sloth = dep.sloth
    healthy_t = float(dep.healthy.total_time)
    failed_t = float(sim.total_time)
    t0 = _wall_clock()
    plan = policy.plan(verdict, sloth.mapped, sloth.mesh, sloth.cfg)
    if not plan.acted:
        return MitigationOutcome(
            detector=detector_name, policy=policy.name, acted=False,
            correct=correct, exclude_cores=(), avoid_links=(),
            healthy_time=healthy_t, failed_time=failed_t,
            mitigated_time=failed_t, switch_time=None,
            wall_time=_wall_clock() - t0)
    mitigated = policy.apply(plan, sloth.mapped, sloth.cfg)
    sim_cfg = dataclasses.replace(sloth.sim_cfg, seed=sim_seed)
    from_t = float(switch_time) if switch_time is not None else 0.0
    re_sim = simulate_mitigated(mitigated, sim_cfg, list(failures),
                                probes=sloth.plan.sim_plan,
                                from_time=from_t)
    if switch_time is None:
        mit_t = float(re_sim.total_time)
    else:
        done = work_done_frac(sim, from_t)
        mit_t = from_t + (1.0 - done) * float(re_sim.total_time)
    return MitigationOutcome(
        detector=detector_name, policy=policy.name, acted=True,
        correct=correct, exclude_cores=plan.exclude_cores,
        avoid_links=plan.avoid_links, healthy_time=healthy_t,
        failed_time=failed_t, mitigated_time=mit_t,
        switch_time=switch_time, wall_time=_wall_clock() - t0)


def run_scenario(grid: CampaignGrid, s: Scenario, dep: Deployment,
                 streaming: int = 0,
                 mitigation: tuple[str, ...] = ()) -> ScenarioOutcome:
    """Execute one scenario end-to-end against a cached deployment: one
    simulation, analysed by every prepared detector, every verdict judged
    by the shared router-aware rule (:func:`repro_torch.core.failures
    .judge_verdict`).

    ``streaming > 0`` replays the trace chunk-by-chunk (that many
    chunks) through every detector exposing ``stream_analyse`` instead
    of one-shot ``analyse``: the final streamed verdict — guaranteed
    equal to the post-hoc one — is judged as THE verdict, and positive
    scenarios additionally record the detection latency (stream time of
    the first flagged window minus the earliest failure onset; ``inf``
    when never flagged).  Detectors without ``stream_analyse`` fall back
    to post-hoc analysis with no latency measurement.

    ``mitigation`` names registered policies
    (:func:`repro_torch.mitigate.get_policy`): each detector's judged verdict is
    handed to each policy and the mitigated deployment re-simulated (see
    :func:`_mitigate_scenario`) — one :class:`MitigationOutcome` per
    (detector, policy) pair, detector-major.  On streaming scenarios the
    mitigation engages at the detector's first flagged window, so
    detection latency composes with recovery; post-hoc scenarios model a
    full restart."""
    failures, sim_seed = materialise(grid, s, dep)
    policies = [instantiate_policy(p) for p in mitigation]
    t0 = _wall_clock()
    sim = dep.sloth.run(list(failures) if failures else None, seed=sim_seed)
    sim_wall = _wall_clock() - t0
    mesh = dep.sloth.mesh
    results = []
    mitigations: list[MitigationOutcome] = []
    compression = 0.0
    total_time = float(sim.total_time)
    for det in dep.detectors:
        t1 = _wall_clock()
        latency = None
        first_flag = None
        streamed = streaming > 0 and hasattr(det, "stream_analyse")
        if streamed:
            v, first_flag = det.stream_analyse(sim, n_chunks=streaming)
            if failures:
                onset = min(f.t0 for f in failures)
                latency = (float(first_flag) - onset
                           if first_flag is not None else math.inf)
        else:
            v = det.analyse(sim)
        wall = _wall_clock() - t1
        matched, rank, ranks, _ = judge_verdict(v, failures, mesh)
        if compression == 0.0 and v.recorder is not None:
            compression = float(v.recorder.compression_ratio)
        results.append(DetectorOutcome(
            detector=det.name, flagged=bool(v.flagged), pred_kind=v.kind,
            pred_location=v.location, score=float(v.score),
            matched=matched, truth_rank=rank, truth_ranks=ranks,
            wall_time=wall, detection_latency=latency))
        switch = (float(first_flag) if streamed and first_flag is not None
                  else None)
        for pol in policies:
            mitigations.append(_mitigate_scenario(
                dep, failures, sim, sim_seed, v, det.name, pol,
                switch, matched))
    return ScenarioOutcome(
        scenario_id=s.scenario_id, workload=s.workload,
        mesh_w=s.mesh_w, mesh_h=s.mesh_h, kind=s.kind,
        topology=s.topology,
        severity=s.severity, n_failures=len(failures), rep=s.rep,
        sim_seed=sim_seed,
        truth_locations=tuple(f.location for f in failures),
        truth_t0s=tuple(f.t0 for f in failures),
        truth_durations=tuple(f.duration for f in failures),
        truth_kinds=tuple(f.kind for f in failures),
        truth_severities=tuple(f.slowdown for f in failures),
        detector_results=tuple(results),
        mitigation_results=tuple(mitigations),
        compression_ratio=compression,
        total_time=total_time,
        probe_overhead=float(dep.probe_overhead),
        sim_wall_time=sim_wall,
    )


def _run_in_worker(grid: CampaignGrid, cfg: SlothConfig | None,
                   detectors: tuple[str, ...], streaming: int,
                   mitigation: tuple[str, ...], device: str,
                   s: Scenario) -> ScenarioOutcome:
    """Process-pool entry point: resolve the deployment from this worker
    process's own cache (lazily built on ``device``), then run the
    scenario."""
    dep = _WORKER_CACHE.get(s.workload, s.mesh_w, s.mesh_h,
                            cfg=cfg, detectors=detectors,
                            topology=s.topology, device=device)
    return run_scenario(grid, s, dep, streaming=streaming,
                        mitigation=mitigation)


# ---------------------------------------------------------------------------
# campaign driver
# ---------------------------------------------------------------------------

def _sev_str(sev) -> str:
    """Render a severity cell — scalar or per-failure mix — for tables."""
    if isinstance(sev, tuple):
        return "(" + ",".join(f"{s:g}" for s in sev) + ")"
    return f"{sev:g}"


@dataclasses.dataclass
class CampaignResult:
    grid: CampaignGrid
    detectors: tuple[str, ...]             # request order; [0] is primary
    outcomes: list[ScenarioOutcome]
    metrics: CampaignMetrics               # primary detector
    cells: dict[tuple, CampaignMetrics]    # primary detector, per cell
    detector_metrics: dict[str, CampaignMetrics]
    detector_cells: dict[str, dict[tuple, CampaignMetrics]]
    probe_overheads: dict[tuple, float]    # (workload, w, h) → overhead
    # mitigation request + recovered-throughput table, empty on campaigns
    # without ``mitigation=``
    policies: tuple[str, ...] = ()
    mitigation: dict[tuple[str, str], MitigationStat] = \
        dataclasses.field(default_factory=dict)

    def severity_curve(self, detector: str | None = None,
                       ks: tuple[int, ...] = (1, 3, 5)) \
            -> tuple[SeverityPoint, ...]:
        """Accuracy / FPR / recall@k per injected severity (ascending),
        with Wilson CIs — the near-threshold sweep readout for one
        detector (``None`` → primary)."""
        return severity_curve(self.outcomes, ks=ks, detector=detector)

    def severity_curve_by_mesh(self, detector: str | None = None,
                               ks: tuple[int, ...] = (1, 3, 5)) \
            -> dict[tuple[int, int], tuple[SeverityPoint, ...]]:
        """The severity curve split per mesh size (``(w, h)`` keys) —
        near-threshold behaviour per topology scale instead of pooled."""
        return severity_curve_by_mesh(self.outcomes, ks=ks,
                                      detector=detector)

    def by_topology(self, detector: str | None = None,
                    ks: tuple[int, ...] = (1, 3, 5)) \
            -> dict[str, CampaignMetrics]:
        """Campaign metrics split per deployment fabric, keyed by the
        canonical topology spec (``'mesh:4x4'``, ``'torus:8x8'``,
        ``'het:4x4:fast2slow1'``) — the paper's cross-architecture
        readout for one detector (``None`` → primary)."""
        return by_topology(self.outcomes, ks=ks, detector=detector)

    def by_truth_kind(self, detector: str | None = None,
                      ks: tuple[int, ...] = (1, 3, 5)) \
            -> dict[str, TruthKindMetrics]:
        """Per-failure recall@k and ranks split by each truth's own kind
        — the mixed-kind campaign readout for one detector (``None`` →
        primary)."""
        return by_truth_kind(self.outcomes, ks=ks, detector=detector)

    def summary(self) -> str:
        m = self.metrics
        lines = [
            f"scenarios: {m.n_scenarios}",
            f"primary:   {self.detectors[0]}",
            f"accuracy:  {m.accuracy.pct():.2f}% "
            f"({m.accuracy.successes}/{m.accuracy.trials}, "
            f"CI [{m.accuracy.interval[0]*100:.1f}, "
            f"{m.accuracy.interval[1]*100:.1f}])",
            f"FPR:       {m.fpr.pct():.2f}% "
            f"({m.fpr.successes}/{m.fpr.trials}, "
            f"CI [{m.fpr.interval[0]*100:.1f}, "
            f"{m.fpr.interval[1]*100:.1f}])",
        ] + [
            f"top-{k}:     {stat.pct():.2f}%" for k, stat in m.topk
        ] + [
            f"recall@{k}:  {stat.pct():.2f}% "
            f"({stat.successes}/{stat.trials})" for k, stat in m.recall
        ] + [
            f"compression: {m.mean_compression:.1f}x",
            f"probe overhead: {m.mean_probe_overhead*100:.3f}% "
            f"(scenario-weighted; unweighted per-deployment "
            f"{m.mean_probe_overhead_unweighted*100:.3f}%)",
        ]
        if m.detection is not None:
            d = m.detection
            lines.append(
                f"detection latency: mean {d.mean:.4g}s p95 {d.p95:.4g}s "
                f"(detected {d.n_detected}/{d.n_measured} streamed "
                f"positives)")
        if len(self.detectors) > 1:
            lines.append("per-detector (acc / FPR / top-3 / recall@3):")
            for name, dm in self.detector_metrics.items():
                lines.append(
                    f"  {name:8s} {dm.accuracy.pct():6.2f}% "
                    f"{dm.fpr.pct():6.2f}% "
                    f"{dm.topk_rate(3)*100:6.2f}% "
                    f"{dm.recall_at(3)*100:6.2f}%")
        by_topo = self.by_topology()
        if len(by_topo) > 1:
            lines.append("per fabric (acc / FPR / recall@3):")
            for label, tm in by_topo.items():
                lines.append(
                    f"  {label:20s} {tm.accuracy.pct():6.2f}% "
                    f"{tm.fpr.pct():6.2f}% "
                    f"{tm.recall_at(3)*100:6.2f}%  (n={tm.n_scenarios})")
        if len({o.severity for o in self.outcomes if o.positive}) > 1:
            by_mesh = self.severity_curve_by_mesh()
            if len(by_mesh) > 1:
                lines.append("severity curve per mesh "
                             "(accuracy / recall@3):")
                for (w, h), pts in by_mesh.items():
                    lines.append(f"  {w}x{h}:")
                    for p in pts:
                        lines.append(
                            f"    x{_sev_str(p.severity):<8s} "
                            f"{p.accuracy.pct():6.2f}% "
                            f"{p.recall_at(3)*100:6.2f}%  "
                            f"(n={p.n_scenarios})")
            else:
                lines.append("severity curve (accuracy / recall@3):")
                for p in self.severity_curve():
                    lines.append(
                        f"  x{_sev_str(p.severity):<8s} "
                        f"{p.accuracy.pct():6.2f}% "
                        f"{p.recall_at(3)*100:6.2f}%  (n={p.n_scenarios})")
        kinds = self.by_truth_kind()
        if len(kinds) > 1:
            lines.append("per truth kind (recall@1 / recall@3 / "
                         "mean rank):")
            for kind, tk in kinds.items():
                rank = (f"{tk.mean_rank:5.2f}" if tk.mean_rank is not None
                        else "  n/a")
                lines.append(
                    f"  {kind:8s} {tk.recall_at(1)*100:6.2f}% "
                    f"{tk.recall_at(3)*100:6.2f}% {rank}  "
                    f"(n={tk.n_failures})")
        if self.mitigation:
            lines.append("mitigation (acted / recovered / slowdown vs "
                         "healthy / mis-mitigation):")
            for (det, pol), st in self.mitigation.items():
                ci = st.improved.interval
                lines.append(
                    f"  {det}x{pol:<11s} "
                    f"acted {st.acted.successes}/{st.acted.trials}  "
                    f"recovered {st.recovered_mean*100:6.1f}% "
                    f"(improved {st.improved.successes}/"
                    f"{st.improved.trials}, CI [{ci[0]*100:.0f}, "
                    f"{ci[1]*100:.0f}])  "
                    f"slowdown {st.slowdown_mean:.3f}x  "
                    f"mis-acted {st.mis_acted.successes}/"
                    f"{st.mis_acted.trials} "
                    f"penalty {st.penalty_mean*100:+.1f}%")
        wall = wall_time_stats(self.outcomes)
        if wall:
            lines.append("wall time per scenario (mean / p95):")
            for name, w in wall.items():
                lines.append(f"  {name:8s} {w.mean*1e3:8.2f}ms "
                             f"{w.p95*1e3:8.2f}ms")
        return "\n".join(lines)


#: Chunk count used when a campaign requests ``streaming=True``.
DEFAULT_STREAM_CHUNKS = 4


def run_campaign(grid: CampaignGrid, *, workers: int | None = None,
                 executor: str = "thread",
                 cfg: SlothConfig | None = None,
                 detectors=("sloth",),
                 streaming: bool | int = False,
                 mitigation=None,
                 cache: DeploymentCache | None = None,
                 progress=None, device=None) -> CampaignResult:
    """Run every scenario of ``grid`` and aggregate paper-style metrics.

    ``workers`` — pool width (``None`` → cpu count, ``0``/``1`` → serial).
    ``executor`` — ``'thread'`` (shared deployments, GIL-bound) or
    ``'process'`` (per-worker deployment caches, true multi-core; see the
    module docstring).  Outcomes are **bit-identical** across executors and
    worker counts.  ``detectors`` — registry names analysing every
    scenario's trace; the first is the primary detector for the top-level
    ``metrics``/``cells`` (per-detector tables are in
    ``detector_metrics``/``detector_cells``).
    ``streaming`` — replay every trace chunk-by-chunk through the
    streaming detection service instead of one-shot post-hoc analysis
    (``True`` → ``DEFAULT_STREAM_CHUNKS`` chunks, an int → that many):
    judged verdicts are unchanged (the final streamed verdict equals the
    post-hoc one by construction), and positive scenarios additionally
    report detection latency (``metrics.detection``; see
    :func:`run_scenario`).  ``mitigation`` — registered mitigation-policy
    names (a name, an iterable, or ``None``): every detector's judged
    verdict is acted on by every policy and the mitigated deployment
    re-simulated over the remaining failure window, producing the
    recovered-throughput table in ``result.mitigation`` (per
    (detector, policy), Wilson CIs; see
    :func:`repro_torch.core.metrics.mitigation_stats`).  With streaming, the
    mitigation engages at each detector's first flagged window, so
    detection latency composes with recovery.  ``cache`` — share
    deployments across campaigns (defaults to a process-wide cache;
    ignored by process-pool workers, which keep their own).  ``device`` —
    where the SLOTH pipelines run (see the module docstring): the card
    unless ``"cpu"`` is asked for.
    """
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; "
                         f"options: {EXECUTORS}")
    if streaming is True:
        streaming = DEFAULT_STREAM_CHUNKS
    streaming = int(streaming)
    if streaming < 0:
        raise ValueError("streaming must be False or a chunk count >= 1")
    device = resolve_device(device)
    names = _normalise_detectors(detectors)
    pols = _normalise_policies(mitigation)
    scenarios = enumerate_scenarios(grid)
    workers = (os.cpu_count() or 1) if workers is None else workers
    parallel = workers > 1 and len(scenarios) > 1

    if executor == "process" and parallel:
        # spawn, not fork: a forked child cannot use its parent's CUDA
        # context (nor torch's thread pools).  Workers re-import the package
        # cleanly (sys.path is inherited) and open their own context; the
        # kernels are built here first, so that workers only load them.
        if device.type == "cuda":
            from ..kernels import _lib
            _lib.build_all()
        ctx = multiprocessing.get_context("spawn")
        fn = functools.partial(_run_in_worker, grid, cfg, names, streaming,
                               pols, str(device))
        outcomes = []
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as pool:
            for o in pool.map(fn, scenarios):
                if progress is not None:
                    progress(o)
                outcomes.append(o)
    else:
        cache = cache if cache is not None else _DEFAULT_CACHE
        # Build deployments serially first: construction is the expensive,
        # cache-mutating step; scenario execution then only reads shared
        # state.
        deps: dict[tuple, Deployment] = {}
        for s in scenarios:
            k = (s.workload, s.topology, s.mesh_w, s.mesh_h)
            if k not in deps:
                deps[k] = cache.get(s.workload, s.mesh_w, s.mesh_h,
                                    cfg=cfg, detectors=names,
                                    topology=s.topology, device=device)

        def run_one(s: Scenario) -> ScenarioOutcome:
            o = run_scenario(grid, s,
                             deps[(s.workload, s.topology,
                                   s.mesh_w, s.mesh_h)],
                             streaming=streaming, mitigation=pols)
            if progress is not None:
                progress(o)
            return o

        if parallel:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                outcomes = list(pool.map(run_one, scenarios))
        else:
            outcomes = [run_one(s) for s in scenarios]

    det_metrics = by_detector(outcomes)
    det_cells = detector_cells(outcomes)
    primary = names[0]
    return CampaignResult(
        grid=grid, detectors=names, outcomes=outcomes,
        metrics=(det_metrics[primary] if outcomes else aggregate(outcomes)),
        cells=det_cells.get(primary, {}),
        detector_metrics=det_metrics,
        detector_cells=det_cells,
        probe_overheads=deployment_overheads(outcomes),
        policies=pols,
        mitigation=by_mitigation(outcomes),
    )
