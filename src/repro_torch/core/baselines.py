"""Five baseline fail-slow detectors (paper §IV-A), adapted to the
many-core accelerator domain as in-house implementations and registered
under the unified :class:`~repro_torch.core.detectors.Detector` protocol:

  thres    — static 2× threshold over profiled nominal latency
  mscope   — Microscope: dependency DAG + random-walk root-cause scoring
  iaso     — peer timeout signals → AIMD scores → DBSCAN outlier cluster
  perseus  — polynomial regression on latency-vs-throughput, p99.9 outliers
  adr      — sliding windows, adaptive thresholds from history percentiles

All consume the same raw trace infrastructure (``SimResult``) as SLOTH for
a fair comparison: ``prepare(graph, mesh, profile, cfg)`` fits each
detector's nominal model against a healthy profiling run, and
``analyse(sim)`` returns the unified
:class:`~repro_torch.core.detectors.Verdict` with the mesh attached, so
``Verdict.matches`` applies the shared router-aware judging rule (a
baseline naming any link of a slowed router is correct) and the
campaign's top-k / recall@k metrics treat baselines and SLOTH
identically.

Every baseline emits its **full ranked candidate list**: all resources
whose statistic is above (or near) the detector's decision bar, in
descending suspicion order, capped at ``max_ranked`` entries.  The top-1
entry — and therefore accuracy/FPR — is unchanged from the historical
single-entry behaviour; the tail is what makes baseline top-k / recall@k
cells non-degenerate in multi-failure and mixed-kind campaigns (a
single-entry ranking can never recall the second of two simultaneous
failures).  Rankings are reported even below the flag threshold, exactly
as SLOTH does, so near-threshold severity sweeps can measure graded
localisation; ``flagged`` / ``kind`` / ``location`` keep their old
semantics.

The baselines are host code (numpy, float64), as in the reference: they
read the raw trace, not the sketch, and launch no kernel.
"""

from __future__ import annotations

import numpy as np

from .detectors import Verdict, _register_builtin
from .routing import Topology
from .simulator import SimResult

__all__ = ["Thres", "Mscope", "IASO", "Perseus", "ADR", "ALL_BASELINES",
           "BASELINE_NAMES"]


def _per_core_rates(sim: SimResult):
    """mean FLOPs/s per (core, stage) and per core."""
    comp = sim.comp
    dur = np.maximum(comp["t_end"] - comp["t_start"], 1e-12)
    rate = comp["flops"] / dur
    return comp["core"], comp["stage"], rate, dur


def _per_link_latency(sim: SimResult, mesh: Topology):
    comm = sim.comm
    lat = {}
    for s, d, svc in zip(comm["src"], comm["dst"], comm["service"]):
        if s == d:
            continue
        for lid in mesh.route(int(s), int(d)):
            lat.setdefault(lid, []).append(svc / max(1, len(
                mesh.route(int(s), int(d)))))
    return lat


class _Baseline:
    """Shared life cycle for the five baselines.

    Subclasses implement ``_fit(mesh, profile)`` (nominal model from a
    healthy run) and ``analyse(sim)``; the registry path is
    ``Cls().prepare(graph, mesh, profile, cfg)``.
    """

    name = "baseline"

    def __init__(self):
        self.mesh: Topology | None = None

    def prepare(self, graph, mesh: Topology, profile: SimResult,
                cfg=None) -> "_Baseline":
        """Fit nominal models against a healthy profiling run.  ``graph``
        and ``cfg`` (a ``SlothConfig``) are accepted for protocol
        uniformity; the baselines derive everything from the trace."""
        self.mesh = mesh
        self._fit(mesh, profile)
        return self

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        raise NotImplementedError

    def analyse(self, sim: SimResult) -> Verdict:
        raise NotImplementedError

    #: cap on the emitted ranking length (suspicion-ordered prefix)
    max_ranked = 16

    def _verdict(self, sim: SimResult, flagged: bool,
                 kind: str | None, location: int | None,
                 score: float, ranking=None) -> Verdict:
        """Build the unified verdict.  ``ranking`` is the full
        suspicion-ordered candidate list (truncated to ``max_ranked``);
        when omitted, the historical single-entry ranking is synthesised
        from the top-1 fields.  When flagged, the top-1 fields must agree
        with ``ranking[0]`` — the campaign judge scores accuracy on the
        former and recall@k on the latter."""
        if ranking is None:
            ranking = ([(kind, int(location), float(score))]
                       if flagged else [])
        else:
            ranking = [(k, int(l), float(v))
                       for k, l, v in ranking[:self.max_ranked]]
        return Verdict(flagged=bool(flagged), kind=kind,
                       location=(int(location) if flagged else None),
                       score=float(score), ranking=ranking,
                       total_time=float(sim.total_time), mesh=self.mesh,
                       detector=self.name)


# ---------------------------------------------------------------------------
# (1) Threshold filtering
# ---------------------------------------------------------------------------

class Thres(_Baseline):
    """Flags any component whose latency exceeds 2× the profiled nominal.

    The ranking lists *every* core and link whose observed slowdown is
    above ``rank_floor`` (near the 2× statistic), worst first — with k
    simultaneous failures each victim clears the bar independently, so
    the ranking carries all of them, not just the global worst."""

    name = "thres"
    flag_ratio = 2.0
    rank_floor = 1.25          # include near-statistic resources

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        cores, stages, rate, _ = _per_core_rates(profile)
        self.nominal = {}
        for c, s, r in zip(cores, stages, rate):
            self.nominal.setdefault((int(c), int(s)), []).append(r)
        self.nominal = {k: float(np.median(v))
                        for k, v in self.nominal.items()}
        link_lat = _per_link_latency(profile, mesh)
        self.link_nominal = {k: float(np.median(v))
                             for k, v in link_lat.items()}

    def analyse(self, sim: SimResult) -> Verdict:
        cores, stages, rate, _ = _per_core_rates(sim)
        slow_by: dict[tuple[str, int], float] = {}
        for c, s, r in zip(cores, stages, rate):
            nom = self.nominal.get((int(c), int(s)))
            if not nom or r <= 0:
                continue
            key = ("core", int(c))
            slow = nom / r
            if slow > slow_by.get(key, 0.0):
                slow_by[key] = slow
        for lid, lats in _per_link_latency(sim, self.mesh).items():
            nom = self.link_nominal.get(lid)
            if not nom:
                continue
            key = ("link", int(lid))
            slow = float(np.median(lats)) / nom
            if slow > slow_by.get(key, 0.0):
                slow_by[key] = slow
        worst = max(slow_by.values(), default=1.0)
        worst = max(worst, 1.0)
        ranking = sorted(((k, l, v) for (k, l), v in slow_by.items()
                          if v >= self.rank_floor),
                         key=lambda x: (-x[2], x[0], x[1]))
        if worst >= self.flag_ratio and ranking:
            return self._verdict(sim, True, ranking[0][0], ranking[0][1],
                                 worst, ranking)
        return self._verdict(sim, False, None, None, worst, ranking)


# ---------------------------------------------------------------------------
# (2) Microscope: dependency DAG + random walk
# ---------------------------------------------------------------------------

class Mscope(_Baseline):
    name = "mscope"
    walks = 200
    walk_seed = 0

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        cores, stages, rate, _ = _per_core_rates(profile)
        self.nominal = {}
        for c, s, r in zip(cores, stages, rate):
            self.nominal.setdefault(int(c), []).append(r)
        self.nominal = {k: float(np.median(v))
                        for k, v in self.nominal.items()}

    def analyse(self, sim: SimResult) -> Verdict:
        rng = np.random.default_rng(self.walk_seed)
        cores, stages, rate, _ = _per_core_rates(sim)
        anomaly = np.zeros(self.mesh.n_cores)
        for c, r in zip(cores, rate):
            nom = self.nominal.get(int(c), 0)
            if nom > 0 and r > 0:
                anomaly[int(c)] = max(anomaly[int(c)], nom / r - 1.0)
        # service dependency graph: consumer → producer edges weighted by
        # traffic (we walk *backwards* towards root causes)
        comm = sim.comm
        w = {}
        for s, d, b in zip(comm["src"], comm["dst"], comm["bytes"]):
            if s != d:
                w[(int(d), int(s))] = w.get((int(d), int(s)), 0.0) + b
        nbr = {}
        for (d, s), b in w.items():
            nbr.setdefault(d, []).append((s, b))
        visits = np.zeros(self.mesh.n_cores)
        anomalous = np.nonzero(anomaly > 0.5)[0]
        if len(anomalous) == 0:
            return self._verdict(sim, False, None, None, 0.0)
        for _ in range(self.walks):
            node = int(rng.choice(anomalous))
            for _ in range(8):
                visits[node] += anomaly[node] + 0.1
                opts = nbr.get(node)
                if not opts or rng.random() < 0.2:
                    break
                probs = np.array([b * (1 + anomaly[s]) for s, b in opts])
                probs /= probs.sum()
                node = int(opts[rng.choice(len(opts), p=probs)][0])
        # every visited core, most-visited first (argmax tie-break: lowest
        # index), is a root-cause candidate — the walk mass spreads over
        # all simultaneous anomaly sources
        ranking = [("core", int(c), float(visits[c]))
                   for c in sorted(np.nonzero(visits > 0)[0],
                                   key=lambda c: (-visits[c], c))]
        loc = int(np.argmax(visits))
        return self._verdict(sim, True, "core", loc, float(visits[loc]),
                             ranking)


# ---------------------------------------------------------------------------
# (3) IASO: timeout signals → AIMD score → DBSCAN
# ---------------------------------------------------------------------------

def _dbscan_1d(x: np.ndarray, eps: float, min_pts: int = 3) -> np.ndarray:
    """1-D DBSCAN; returns cluster labels (-1 = noise)."""
    order = np.argsort(x)
    labels = np.full(len(x), -1)
    cid = -1
    prev = None
    for i in order:
        if prev is not None and x[i] - x[prev] <= eps:
            labels[i] = labels[prev] if labels[prev] >= 0 else cid
        else:
            cid += 1
        if labels[i] < 0:
            labels[i] = cid
        prev = i
    # enforce min_pts: clusters smaller than min_pts become noise
    for c in np.unique(labels):
        if (labels == c).sum() < min_pts:
            labels[labels == c] = -1
    return labels


class IASO(_Baseline):
    name = "iaso"

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        cores, stages, rate, dur = _per_core_rates(profile)
        self.expected = {}
        for c, s, d in zip(cores, stages, dur):
            self.expected.setdefault((int(c), int(s)), []).append(d)
        self.expected = {k: float(np.median(v)) * 2.0
                         for k, v in self.expected.items()}

    def analyse(self, sim: SimResult) -> Verdict:
        cores, stages, rate, dur = _per_core_rates(sim)
        score = np.zeros(self.mesh.n_cores)
        order = np.argsort(sim.comp["t_start"])
        for i in order:
            c, s, d = int(cores[i]), int(stages[i]), float(dur[i])
            lim = self.expected.get((c, s))
            if lim is None:
                continue
            if d > lim:
                score[c] += 1.0          # additive increase on timeout
            else:
                score[c] *= 0.7          # multiplicative decrease
        labels = _dbscan_1d(score, eps=max(score.std(), 1e-9) * 0.5)
        # outliers = cores not in the majority cluster with high score;
        # the ranking lists outlier candidates first (max-tuple tie-break:
        # highest index), then every other core with AIMD mass, so all
        # simultaneous timeout sources stay recallable
        def _order(idxs):
            return sorted(idxs, key=lambda i: (-score[i], -i))

        if len(np.unique(labels[labels >= 0])) == 0:
            cand = []              # every cluster dissolved into noise
        else:
            major = np.bincount(labels[labels >= 0]).argmax()
            cand = [i for i in range(len(score))
                    if labels[i] != major and score[i] > score.mean() + 2]
        cand_set = set(cand)
        ordered_cand = _order(cand)
        rest = [i for i in range(len(score))
                if score[i] > 0 and i not in cand_set]
        ranking = [("core", int(i), float(score[i]))
                   for i in ordered_cand + _order(rest)]
        if not cand:               # unflagged still reports the AIMD mass
            return self._verdict(sim, False, None, None,
                                 float(score.max()), ranking)
        loc = ordered_cand[0]
        return self._verdict(sim, True, "core", int(loc),
                             float(score[loc]), ranking)


# ---------------------------------------------------------------------------
# (4) Perseus: regression on latency-vs-throughput
# ---------------------------------------------------------------------------

class Perseus(_Baseline):
    name = "perseus"

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        cores, stages, rate, dur = _per_core_rates(profile)
        x = np.log(np.maximum(profile.comp["flops"], 1.0))
        y = np.log(np.maximum(dur, 1e-12))
        self.poly = np.polyfit(x, y, 2)
        resid = y - np.polyval(self.poly, x)
        self.p999 = float(np.quantile(resid, 0.999))

    def analyse(self, sim: SimResult) -> Verdict:
        cores = sim.comp["core"]
        x = np.log(np.maximum(sim.comp["flops"], 1.0))
        y = np.log(np.maximum(sim.comp["t_end"] - sim.comp["t_start"],
                              1e-12))
        resid = y - np.polyval(self.poly, x)
        out = resid > self.p999
        if not out.any():
            return self._verdict(sim, False, None, None,
                                 float(resid.max() - self.p999))
        counts = np.bincount(cores[out], minlength=self.mesh.n_cores)
        # every core with p99.9 outlier instructions, most first (argmax
        # tie-break: lowest index) — simultaneous failures each contribute
        # their own outlier population
        ranking = [("core", int(c), float(counts[c]))
                   for c in sorted(np.nonzero(counts > 0)[0],
                                   key=lambda c: (-counts[c], c))]
        loc = int(np.argmax(counts))
        return self._verdict(sim, True, "core", loc, float(counts[loc]),
                             ranking)


# ---------------------------------------------------------------------------
# (5) ADR: sliding windows with adaptive thresholds
# ---------------------------------------------------------------------------

class ADR(_Baseline):
    name = "adr"
    n_windows = 8
    flag_ratio = 1.5
    rank_floor = 1.1           # include near-threshold window drops

    def _fit(self, mesh: Topology, profile: SimResult) -> None:
        pass                     # purely self-referential, no nominal model

    def analyse(self, sim: SimResult) -> Verdict:
        n_windows = self.n_windows
        cores, stages, rate, dur = _per_core_rates(sim)
        t_mid = (sim.comp["t_start"] + sim.comp["t_end"]) / 2
        total = max(sim.total_time, 1e-9)
        win = np.clip((t_mid / total * n_windows).astype(int), 0,
                      n_windows - 1)
        per_core: dict[int, float] = {}    # worst window drop per core
        for c in range(self.mesh.n_cores):
            sel = cores == c
            if sel.sum() < 2 * n_windows:
                continue
            r = rate[sel]
            w = win[sel]
            hist = []
            for k in range(n_windows):
                vals = r[w == k]
                if len(vals) == 0:
                    continue
                cur = float(np.median(vals))
                if len(hist) >= 2:
                    thr = np.quantile(hist, 0.1)   # adaptive threshold
                    if cur < thr:
                        slow = thr / max(cur, 1e-12)
                        if slow > per_core.get(c, 0.0):
                            per_core[c] = slow
                hist.append(cur)
        worst = max(per_core.values(), default=0.0)
        # every core whose own windows dropped below its adaptive
        # threshold, worst first (ties: lowest core id) — one entry per
        # simultaneously degraded core
        ranking = [("core", int(c), float(s))
                   for c, s in sorted(per_core.items(),
                                      key=lambda x: (-x[1], x[0]))
                   if s >= self.rank_floor]
        if worst > self.flag_ratio and ranking:
            return self._verdict(sim, True, "core", ranking[0][1], worst,
                                 ranking)
        return self._verdict(sim, False, None, None, worst, ranking)


ALL_BASELINES = [Thres, Mscope, IASO, Perseus, ADR]
BASELINE_NAMES = tuple(cls.name for cls in ALL_BASELINES)

for _cls in ALL_BASELINES:
    _register_builtin(_cls.name, _cls)
