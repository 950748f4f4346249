"""SL-Tracer stage 1: core-level and link-level fail-slow detection.

* Core level (§III-D1): compute patterns are partitioned by execution stage
  and grouped into volume-equivalent sets (same stage / op / FLOP bucket →
  the DP-replica structure of the mapping guarantees comparability).  Within
  a group, per-core FLOP/s is compared against the group baseline with
  robust (median/MAD) outlier detection; candidates get an initial
  fail-slow probability from the variance distribution.

* Link level (§III-D2): each communication pattern gives (volume, observed
  transfer time, src, dst); XY routing maps it to a link set.  The
  underdetermined system  A · (V θ) = T  (θ_l = 1/bw_l) is solved with an
  EM (Richardson–Lucy style multiplicative) algorithm; per-link fail-slow
  probabilities come from a Gamma model over the inferred θ.

No scipy: the regularised incomplete gamma function is implemented here
(series + continued fraction).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import probes as P
from .routing import Topology
from .sketch import Pattern

# ---------------------------------------------------------------------------
# special functions (scipy-free)
# ---------------------------------------------------------------------------


def _gammp(a: float, x: float) -> float:
    """Regularised lower incomplete gamma P(a, x)."""
    if x <= 0.0:
        return 0.0
    if x < a + 1.0:     # series
        ap, s, d = a, 1.0 / a, 1.0 / a
        for _ in range(200):
            ap += 1.0
            d *= x / ap
            s += d
            if abs(d) < abs(s) * 1e-12:
                break
        return s * math.exp(-x + a * math.log(x) - math.lgamma(a))
    # continued fraction for Q(a, x)
    b, c, dd, h = x + 1.0 - a, 1e308, 1.0 / (x + 1.0 - a), 1.0 / (x + 1.0 - a)
    for i in range(1, 200):
        an = -i * (i - a)
        b += 2.0
        dd = an * dd + b
        dd = b + an / c if abs(dd) < 1e-300 else dd
        c = b + an / c
        c = 1e-300 if abs(c) < 1e-300 else c
        dd = 1.0 / dd
        delta = dd * c
        h *= delta
        if abs(delta - 1.0) < 1e-12:
            break
    q = math.exp(-x + a * math.log(x) - math.lgamma(a)) * h
    return 1.0 - q


def gamma_sf(x: float, shape: float, scale: float) -> float:
    """P(X ≥ x) for X ~ Gamma(shape, scale)."""
    return 1.0 - _gammp(shape, max(x, 0.0) / scale)


# ---------------------------------------------------------------------------
# core-level detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoreCandidate:
    core: int
    window: int
    prob: float
    z: float
    stage: int


def assign_window(t_mid: np.ndarray, total_time: float,
                  n_windows: int) -> np.ndarray:
    w = np.floor(t_mid / max(total_time, 1e-12) * n_windows).astype(np.int64)
    return np.clip(w, 0, n_windows - 1)


def detect_cores(patterns: list[Pattern], total_time: float,
                 n_windows: int = 4, z_flag: float = 2.5,
                 min_group: int = 3,
                 rate_scale=None) -> list[CoreCandidate]:
    """Stage-aware group outlier detection on compute patterns.

    ``rate_scale`` — optional per-core baseline-capacity multipliers (a
    fabric's :attr:`~repro_torch.core.routing.Topology.rate_class`): observed
    FLOP/s are divided by the core's nominal rate before grouping, so a
    healthy slow-class core on a heterogeneous fabric is not flagged as a
    fail-slow outlier against its full-rate peers.  All-ones (or ``None``)
    leaves the historical rates bit-identical.
    """
    if not patterns:
        return []
    keys = np.array([p.key for p in patterns], dtype=np.int64)
    cores = (keys & 0xFFF).astype(np.int64)
    stages = ((keys >> 12) & 0xFFFF).astype(np.int64)
    group_sig = keys >> 12          # stage | op | flops-bucket (drop core)
    rate = np.array([p.sum_val / max(p.sum_dur, 1e-12) for p in patterns])
    if rate_scale is not None:
        rate = rate / np.asarray(rate_scale, dtype=np.float64)[cores]
    t_mid = np.array([(p.t_first + p.t_last) / 2 for p in patterns])
    windows = assign_window(t_mid, total_time, n_windows)

    # group by signature only (stage | op | FLOP bucket): a slow core's own
    # timestamps stretch into later windows, so windowing the *grouping*
    # would strip it from its volume-equivalent peers.  The window of the
    # resulting candidate is taken from the pattern's own mid-time.
    cands: dict[tuple[int, int], CoreCandidate] = {}
    order = np.argsort(group_sig, kind="stable")
    bounds = np.nonzero(np.diff(group_sig[order]) != 0)[0] + 1
    for grp in np.split(order, bounds):
        if len(grp) < min_group:
            continue
        r = rate[grp]
        med = np.median(r)
        mad = np.median(np.abs(r - med)) * 1.4826
        sigma = max(mad, 0.02 * med, 1e-12)
        z = (med - r) / sigma        # positive z → slower than peers
        for gi, zi in zip(grp, z):
            if zi <= 0:
                continue
            prob = 1.0 / (1.0 + math.exp(-(zi - z_flag)))
            c, w = int(cores[gi]), int(windows[gi])
            prev = cands.get((c, w))
            if prev is None or prob > prev.prob:
                cands[(c, w)] = CoreCandidate(c, w, float(prob), float(zi),
                                              int(stages[gi]))
    return sorted(cands.values(), key=lambda c: -c.prob)


# ---------------------------------------------------------------------------
# link-level detection (EM on the underdetermined path system)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkCandidate:
    link: int
    window: int
    prob: float
    theta: float       # inferred inverse bandwidth (s/B)
    z: float


@dataclasses.dataclass
class LinkInference:
    theta: np.ndarray          # [n_windows, n_links]
    observed: np.ndarray       # [n_windows, n_links] bool: link had traffic
    candidates: list[LinkCandidate]


def em_link_inverse_bw(A: np.ndarray, T: np.ndarray, V: np.ndarray,
                       weights: np.ndarray, hop_latency: float = 0.0,
                       iters: int = 60) -> np.ndarray:
    """EM for  T_e ≈ Σ_l A_el · V_e · θ_l.

    E-step: split each observed delay over its links proportionally to the
    current θ; M-step: re-estimate θ_l from its expected delay share.
    Multiplicative updates keep θ ≥ 0 (bandwidths are positive).
    """
    n_e, n_l = A.shape
    T = np.maximum(T - hop_latency * A.sum(axis=1), 1e-12)
    # A is 0/1: a sum over events of A_el·c_e adds c_e for the events that
    # cross l, in event order, as the dense sum over axis 0 adds its rows,
    # so the sparse sums equal the dense ones bit for bit (a non-finite
    # c_e, where 0·c_e is not 0, takes the dense sum)
    ev, lk = np.nonzero(A)

    def over_events(c):
        if not np.isfinite(c).all():
            return (A * c[:, None]).sum(axis=0)
        return np.bincount(lk, weights=c[ev], minlength=n_l)

    traffic = over_events(weights * V)                        # Σ_e w V A
    seen = traffic > 0
    AV = A * V[:, None]
    theta0 = float((T / np.maximum(AV.sum(axis=1), 1e-12)).mean())
    theta = np.full(n_l, theta0)
    for _ in range(iters):
        pred = AV @ theta                                      # T̂_e
        ratio = T / np.maximum(pred, 1e-300)
        # expected delay on link l: Σ_e w_e · A_el V_e θ_l · ratio_e
        num = theta * over_events(weights * V * ratio)
        theta_new = num / np.maximum(traffic, 1e-300)
        theta = np.where(seen, theta_new, theta)
    # shrink poorly-observed links toward the global estimate: a link seen by
    # <~3 events has an essentially unidentified θ in the underdetermined
    # system, and the raw EM value is an artefact of the initialisation.
    if seen.any():
        n_events = (A > 0).sum(axis=0)
        lam = n_events / (n_events + 3.0)
        shrunk = lam * theta + (1 - lam) * np.median(theta[seen])
        theta = np.where(seen, shrunk, theta)
    return theta


def detect_links(patterns: list[Pattern], mesh: Topology, total_time: float,
                 n_windows: int = 4, hop_latency: float = 50e-9,
                 ratio_flag: float = 3.0, em_iters: int = 60) -> LinkInference:
    """Link-level inference in two passes.

    1. **Global EM** (the paper's underdetermined-system solver) on the
       *minimum* per-pattern transfer times (queue-free service estimates)
       gives baseline inverse bandwidths θ̄ over the whole run.
    2. **Per-window slowdown regression**: with path shares
       s_el = V_e·θ̄_l / T̂_e, a single slow link l with slowdown ρ makes
       T_e/T̂_e − 1 ≈ s_el·(ρ−1) for events crossing it, so
       δ_l(w) = Σ w_e·s_el·(ratio_e−1) / Σ w_e·s_el² is a weighted LS
       estimate of ρ−1 in window w.  This keeps the global (identifiable)
       attribution while localising anomalies in time.

    Ratios are self-normalised by each link's healthiest window, so a
    transient failure stands out even if it contaminates the global θ̄.
    A Gamma model over healthy ratios converts anomaly to probability.
    """
    n_l = mesh.n_links
    theta = np.zeros((n_windows, n_l))
    observed = np.zeros((n_windows, n_l), dtype=bool)
    cands: list[LinkCandidate] = []
    if not patterns:
        return LinkInference(theta, observed, cands)

    keys = np.array([p.key for p in patterns], dtype=np.int64)
    src = (keys & 0xFFF).astype(np.int64)
    dst = ((keys >> 12) & 0xFFF).astype(np.int64)
    min_T = np.array([p.min_dur for p in patterns])
    mean_V = np.array([p.sum_val / max(p.count, 1) for p in patterns])
    cnt = np.array([p.count for p in patterns], dtype=np.float64)
    t_mid = np.array([(p.t_first + p.t_last) / 2 for p in patterns])
    windows = assign_window(t_mid, total_time, n_windows)

    inter = np.nonzero(src != dst)[0]
    if len(inter) == 0:
        return LinkInference(theta, observed, cands)
    pairs = [(int(src[i]), int(dst[i])) for i in inter]
    A = mesh.path_matrix(pairs)                     # [events, links]
    T = np.maximum(min_T[inter] - hop_latency * A.sum(axis=1), 1e-12)
    V = mean_V[inter]
    W = cnt[inter]
    win = windows[inter]

    theta_bar = em_link_inverse_bw(A, min_T[inter], V, W, hop_latency,
                                   em_iters)
    seen_any = A.sum(axis=0) > 0
    if seen_any.any():
        # floor θ̄: the multiplicative EM can drive rarely-blamed links to 0,
        # which would make their events' predicted time vanish
        theta_bar = np.maximum(theta_bar,
                               0.05 * np.median(theta_bar[seen_any]))
    pred = (A * V[:, None]) @ theta_bar             # T̂_e
    ratio_e = np.clip(T / np.maximum(pred, 1e-300), 0.0, 50.0)
    share = (A * (V[:, None] * theta_bar[None, :])) \
        / np.maximum(pred, 1e-300)[:, None]          # s_el

    MIN_SHARE = 0.15   # only events where link l dominates carry information
    ratios = np.ones((n_windows, n_l))
    for w in range(n_windows):
        sel = np.nonzero(win == w)[0]
        if len(sel) == 0:
            continue
        for li in np.nonzero(seen_any)[0]:
            ev = sel[share[sel, li] >= MIN_SHARE]
            if len(ev) < 3:
                continue
            # per-event single-slow-link estimate, robustly aggregated
            est = np.maximum((ratio_e[ev] - 1.0) / share[ev, li] + 1.0, 0.1)
            ratios[w, li] = max(float(np.median(est)), 0.25)
            observed[w, li] = True
        theta[w] = np.where(observed[w], theta_bar * ratios[w], 0.0)

    # All links share one nominal bandwidth (the paper's Gamma bandwidth
    # model), so judge each (window, link) θ against the cross-link
    # population — an absolute comparison that works even when a failure
    # spans the link's whole observation window.
    pop_theta = float(np.median(theta_bar[seen_any]))
    norm = np.where(observed, theta / max(pop_theta, 1e-300), 1.0)

    # Gamma model over the healthy slowdown population (lower 90%)
    pool = norm[observed]
    shape = scale = None
    if len(pool) >= 8:
        lo = pool[pool <= np.quantile(pool, 0.9)]
        mu, var = float(lo.mean()), float(max(lo.var(), 1e-6))
        if mu > 0:
            shape, scale = mu * mu / var, var / mu

    for w in range(n_windows):
        for li in np.nonzero(observed[w])[0]:
            r = float(norm[w, li])
            if r <= ratio_flag * 0.6:
                continue
            prob = 1.0 / (1.0 + math.exp(-1.5 * (r - ratio_flag)))
            if shape is not None:
                # p-value of the ratio under the healthy Gamma model
                pval = gamma_sf(r, shape, scale)
                prob *= (1.0 - pval)
            cands.append(LinkCandidate(int(li), w, float(prob),
                                       float(theta[w, li]), r))
    cands.sort(key=lambda c: -c.prob)
    return LinkInference(theta, observed, cands)
