"""SL-Recorder: the Fail-Slow Sketch (paper §III-C, Algorithm 1).

Two stages:

* **Stage-1** — ``d`` hash tables × ``m`` buckets of (pattern key, freq) with
  the majority-style insertion rule: match → freq+1 (promote to Stage-2 when
  freq ≥ H), empty → claim with freq 1, occupied by another key → freq−1
  (clear at 0).
* **Stage-2** — a bounded pattern list (≤ MAX_LENGTH, arrival-time/FIFO
  eviction) holding per-pattern compressed statistics: arrival count, sum /
  sum-of-squares of record durations, summed value (FLOPs or bytes), first
  and last timestamps.

Keys are stored as two int32 halves so the packed-state implementations
(the plain torch loop and the CUDA kernel, which keep int32 state) are
bit-identical to this reference.

This module is the *oracle*: ``kernels/sketch_update`` (plain torch and
CUDA) must match it exactly.  ``insert_run`` is an algebraically-exact fast path
for runs of identical keys (instruction expansion produces such runs), used
by the benchmarks; ``test_sketch.py`` proves run/record equivalence.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MASK32 = 0xFFFFFFFF

# Hash constants (shared verbatim with the torch and CUDA kernels).  One row per
# hash table; supports up to MAX_D tables.
MAX_D = 8
HASH_A1 = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09],
                   dtype=np.int64)
HASH_A2 = np.array([0x632BE59B, 0x9E3779B9, 0x7F4A7C15, 0xF39CC060,
                    0x1F83D9AB, 0x5BE0CD19, 0xCA62C1D6, 0x8F1BBCDC],
                   dtype=np.int64)
HASH_B = np.array([0x7ED55D16, 0xC761C23C, 0x165667B1, 0xD3A2646C,
                   0xFD7046C5, 0xB55A4F09, 0x2DEB33A5, 0x14292967],
                  dtype=np.int64)


def split_key(key: np.ndarray | int):
    """int64 pattern key → (lo, hi) int32 halves (non-negative)."""
    key = np.asarray(key, dtype=np.int64)
    lo = (key & 0x7FFFFFFF).astype(np.int32)
    hi = ((key >> 31) & 0x7FFFFFFF).astype(np.int32)
    return lo, hi


def hash_bucket(lo, hi, table: int, m: int):
    """Deterministic 32-bit mix; bit-identical in numpy int64 arithmetic
    (masked) and uint32 wraparound arithmetic (the CUDA kernel), because
    the final value is masked to 31 bits before the modulus."""
    x = (HASH_A1[table] * np.int64(lo) + HASH_A2[table] * np.int64(hi)
         + HASH_B[table]) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 13)
    return int((x & 0x7FFFFFFF) % m)


#: Bytes of one Stage-2 pattern slot (keys + count + 4 f32 stats + f64
#: timestamp span + arrival).  The unit for drained-pattern accounting:
#: each FIFO-evicted pattern costs exactly one slot in the off-chip
#: compressed stream, independent of L — never derive it by dividing
#: ``stage2_bytes()`` by L, which floor-truncates the moment
#: ``stage2_bytes`` gains any non-slot component.
STAGE2_SLOT_BYTES = 4 + 4 + 4 + 4 * 4 + 8 + 4


@dataclasses.dataclass(frozen=True)
class SketchParams:
    d: int = 2          # hash tables
    m: int = 1024       # buckets per table
    H: int = 8          # promotion threshold
    L: int = 1024       # Stage-2 MAX_LENGTH

    def __post_init__(self):
        if not (1 <= self.d <= MAX_D):
            raise ValueError(f"d must be in [1,{MAX_D}]")

    def stage1_bytes(self) -> int:
        return self.d * self.m * (4 + 4 + 4)      # lo, hi, freq

    def stage2_slot_bytes(self) -> int:
        """Exact bytes of one Stage-2 slot (see
        :data:`STAGE2_SLOT_BYTES`) — the per-pattern cost of the
        drained-eviction stream."""
        return STAGE2_SLOT_BYTES

    def stage2_bytes(self) -> int:
        return self.L * self.stage2_slot_bytes()

    def total_bytes(self) -> int:
        return self.stage1_bytes() + self.stage2_bytes()


@dataclasses.dataclass
class Pattern:
    key: int
    count: int          # records observed after promotion
    sum_dur: float
    sum_sq_dur: float
    sum_val: float      # FLOPs (comp) or bytes (comm)
    t_first: float
    t_last: float
    arrival: int        # monotone promotion counter (FIFO eviction order)
    min_dur: float = float("inf")   # uncongested service-time estimate

    @property
    def mean_dur(self) -> float:
        return self.sum_dur / max(self.count, 1)

    @property
    def var_dur(self) -> float:
        mu = self.mean_dur
        return max(self.sum_sq_dur / max(self.count, 1) - mu * mu, 0.0)

    @property
    def duration(self) -> float:
        return self.t_last - self.t_first


def accumulate_pattern(merged: dict[int, Pattern], p: Pattern) -> None:
    """Merge the partial pattern ``p`` into ``merged`` by key: counts and
    sums add, time bounds and ``min_dur`` extremise, ``arrival`` keeps the
    earliest.  The one definition of partial-pattern merging — shared by
    the oracle's ``patterns(include_drained=True)`` and the kernel-side
    decode (``kernels/sketch_update/ops.patterns``), whose exact agreement
    is the ref-vs-batched parity contract."""
    q = merged.get(p.key)
    if q is None:
        merged[p.key] = dataclasses.replace(p)
        return
    q.count += p.count
    q.sum_dur += p.sum_dur
    q.sum_sq_dur += p.sum_sq_dur
    q.sum_val += p.sum_val
    q.t_first = min(q.t_first, p.t_first)
    q.t_last = max(q.t_last, p.t_last)
    q.min_dur = min(q.min_dur, p.min_dur)
    q.arrival = min(q.arrival, p.arrival)


class FailSlowSketch:
    """Numpy reference implementation of Algorithm 1."""

    def __init__(self, params: SketchParams):
        self.p = params
        d, m = params.d, params.m
        self.keys_lo = np.zeros((d, m), dtype=np.int32)
        self.keys_hi = np.zeros((d, m), dtype=np.int32)
        self.valid = np.zeros((d, m), dtype=bool)
        self.freq = np.zeros((d, m), dtype=np.int64)
        self.stage2: dict[int, Pattern] = {}
        self._arrival = 0
        self.n_inserted = 0
        self.n_evicted = 0
        # Evicted patterns are drained to the off-chip compressed stream (the
        # deployment writes Stage-2 evictions to DRAM/host); analysis may
        # consume live + drained patterns.  On-chip memory is only Stage-1 +
        # the live Stage-2 list.
        self.drained: list[Pattern] = []

    # -- Stage-2 ------------------------------------------------------------
    def _stage2_touch(self, key: int, count: int, dur: float, val: float,
                      t_first: float, t_last: float, sum_dur: float,
                      sum_sq: float, sum_val: float):
        pat = self.stage2.get(key)
        if pat is not None:   # Update
            pat.count += count
            pat.sum_dur += sum_dur
            pat.sum_sq_dur += sum_sq
            pat.sum_val += sum_val
            pat.t_first = min(pat.t_first, t_first)
            pat.t_last = max(pat.t_last, t_last)
            pat.min_dur = min(pat.min_dur, dur)
            return
        if len(self.stage2) >= self.p.L:   # FIFO eviction (arrival-time)
            victim = min(self.stage2.values(), key=lambda q: q.arrival)
            del self.stage2[victim.key]
            self.drained.append(victim)
            self.n_evicted += 1
        self.stage2[key] = Pattern(key, count, sum_dur, sum_sq, sum_val,
                                   t_first, t_last, self._arrival,
                                   min_dur=dur)
        self._arrival += 1

    # -- per-record insertion (Algorithm 1, the ground truth) ---------------
    def insert(self, key: int, dur: float, val: float, t: float):
        self.n_inserted += 1
        lo, hi = split_key(key)
        lo_i, hi_i = int(lo), int(hi)
        promoted = False
        for i in range(self.p.d):
            j = hash_bucket(lo_i, hi_i, i, self.p.m)
            if self.valid[i, j] and self.keys_lo[i, j] == lo_i \
                    and self.keys_hi[i, j] == hi_i:
                self.freq[i, j] += 1
                if self.freq[i, j] >= self.p.H:
                    promoted = True
            elif not self.valid[i, j]:
                self.keys_lo[i, j] = lo_i
                self.keys_hi[i, j] = hi_i
                self.valid[i, j] = True
                self.freq[i, j] = 1
                if self.freq[i, j] >= self.p.H:
                    promoted = True
            else:
                self.freq[i, j] -= 1
                if self.freq[i, j] <= 0:
                    self.valid[i, j] = False
                    self.freq[i, j] = 0
        if promoted:
            self._stage2_touch(key, 1, dur, val, t, t + dur, dur,
                               dur * dur, val)

    # -- exact run-compressed insertion --------------------------------------
    def insert_run(self, key: int, r: int, dur: float, val: float,
                   t0: float, dt: float):
        """Equivalent to ``r`` consecutive ``insert``s of the same key where
        record k starts at ``t0 + k*dt`` and lasts ``dur``."""
        if r <= 0:
            return
        self.n_inserted += r
        lo, hi = split_key(key)
        lo_i, hi_i = int(lo), int(hi)
        first_promo = r  # index of first promoted record, r = none
        for i in range(self.p.d):
            j = hash_bucket(lo_i, hi_i, i, self.p.m)
            if self.valid[i, j] and self.keys_lo[i, j] == lo_i \
                    and self.keys_hi[i, j] == hi_i:
                f0 = int(self.freq[i, j])
                self.freq[i, j] = f0 + r
                # record k (0-based) has freq f0+k+1; promoted iff ≥ H
                k = self.p.H - f0 - 1
            elif not self.valid[i, j]:
                self.keys_lo[i, j] = lo_i
                self.keys_hi[i, j] = hi_i
                self.valid[i, j] = True
                self.freq[i, j] = r
                k = self.p.H - 1
            else:
                f0 = int(self.freq[i, j])
                if r <= f0:
                    self.freq[i, j] = f0 - r
                    if self.freq[i, j] == 0:
                        self.valid[i, j] = False
                    k = r  # never promoted on this table
                else:
                    # f0 decrements clear the bucket, record f0 claims it
                    self.keys_lo[i, j] = lo_i
                    self.keys_hi[i, j] = hi_i
                    self.valid[i, j] = True
                    self.freq[i, j] = r - f0
                    # record f0+k' has freq k'+1 → promoted iff k'+1 ≥ H
                    k = f0 + self.p.H - 1
            first_promo = min(first_promo, max(k, 0))
        if first_promo < r:
            n = r - first_promo
            ts = t0 + dt * np.arange(first_promo, r, dtype=np.float64)
            self._stage2_touch(key, n, dur, val, float(ts[0]),
                               float(ts[-1]) + dur, n * dur,
                               n * dur * dur, n * val)

    # -- bulk APIs ------------------------------------------------------------
    def insert_stream(self, keys, durs, vals, ts):
        for k, d_, v, t in zip(keys, durs, vals, ts):
            self.insert(int(k), float(d_), float(v), float(t))

    def insert_runs(self, keys, reps, durs, vals, t0s, dts):
        for k, r, d_, v, t0, dt in zip(keys, reps, durs, vals, t0s, dts):
            self.insert_run(int(k), int(r), float(d_), float(v), float(t0),
                            float(dt))

    # -- outputs ---------------------------------------------------------------
    def patterns(self, include_drained: bool = True) -> list[Pattern]:
        """Compressed trace patterns.  ``include_drained`` adds patterns that
        were FIFO-evicted to the off-chip stream; note a drained key that
        re-promotes later appears as two partial patterns (merged here)."""
        live = list(self.stage2.values())
        if not include_drained:
            return sorted(live, key=lambda p: p.arrival)
        merged: dict[int, Pattern] = {}
        for p in self.drained + live:
            accumulate_pattern(merged, p)
        return sorted(merged.values(), key=lambda p: p.arrival)

    def onchip_bytes(self) -> int:
        """SRAM-resident state: Stage-1 tables + live Stage-2 list."""
        return self.p.total_bytes()

    def compressed_bytes(self) -> int:
        """Total compressed trace: on-chip state + drained pattern
        stream, each drained pattern at exactly one Stage-2 slot
        (``stage2_slot_bytes()`` — not ``stage2_bytes() // L``, whose
        floor truncation under-counts whenever ``stage2_bytes`` is not
        an exact multiple of ``L``)."""
        return (self.p.total_bytes()
                + len(self.drained) * self.p.stage2_slot_bytes())

    def compression_ratio(self, raw_bytes: float) -> float:
        return raw_bytes / max(self.compressed_bytes(), 1)


def retention_lower_bound(N: float, f_i: float, params: SketchParams)\
        -> float:
    """Lemma 3.1: P(R_i) ≥ 1 − ((N − f_i) / (m (f_i − H)))^d.

    The result is a probability, clamped to [0, 1]: for ``N < f_i`` the
    numerator goes negative and an odd ``d`` would push ``1 − x**d``
    above 1."""
    if f_i <= params.H:
        return 0.0
    x = (N - f_i) / (params.m * (f_i - params.H))
    return min(1.0, max(0.0, 1.0 - x ** params.d))
