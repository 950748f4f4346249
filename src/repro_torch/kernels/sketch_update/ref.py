"""Plain torch version of the Fail-Slow Sketch insertion (runs and records).

The reference for the CUDA kernel ``csrc/sketch_insert.cu`` and the path
the wrapper takes for CPU tensors.  It is a Python loop over runs, one run
at a time, in the order that Algorithm 1 makes semantic; it is a
correctness reference, not a yardstick of speed.  ``insert_runs_plain``
finds each Stage-2 row by a scan; ``insert_runs_indexed`` mirrors the
kernel's O(1) bookkeeping (:class:`Stage2Index`: key index, free bitmap,
FIFO ring, and the precondition they need) and must give the same answer.

State layout (``make_state``; the same keys and dtypes as the reference
package's ``kernels/sketch_update/ref.make_state``):
  keys_lo/keys_hi/valid/freq        [d, m]  int32
  s2_lo/s2_hi/s2_valid/s2_count     [L]     int32
  s2_sum/s2_sumsq/s2_val            [L]     f32
  s2_tmin/s2_tmax/s2_min            [L]     f32
  s2_arrival                        [L]     int32
  counter                           []      int32 (arrival counter)

Drained-eviction stream (``make_drain``):
  d_lo/d_hi/d_count/d_arrival       [cap]   int32
  d_sum/d_sumsq/d_val               [cap]   f32
  d_tmin/d_tmax/d_min               [cap]   f32
  d_n                               []      int32 (rows written)

A run ``i`` stands for ``reps[i]`` records of key ``(lo[i], hi[i])``,
record ``k`` starting at ``t0[i] + k·dt[i]`` and lasting ``dur[i]``.
Stage-1 moves by ±r with the exact promote/steal index algebra of
``FailSlowSketch.insert_run``; the promoted tail reaches Stage-2 as
closed-form float32 aggregates, in the same operation order as the CUDA
kernel, so the two agree bit for bit; the run's first and last start,
``t0 + dt·k``, round once as a fused multiply-add (:func:`fma_f32`), as
the reference's scan compiled by XLA on the CPU rounds them.  A record is a run with ``reps = 1``
and ``dt = 0``, which reduces to the per-record update exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.sketch import HASH_A1, HASH_A2, HASH_B, SketchParams

_BIG = 3.4e38
_I32MAX = 2**31 - 1
_MASK32 = 0xFFFFFFFF

S1_KEYS = ("keys_lo", "keys_hi", "valid", "freq")
S2I_KEYS = ("s2_lo", "s2_hi", "s2_valid", "s2_count", "s2_arrival")
S2F_KEYS = ("s2_sum", "s2_sumsq", "s2_val", "s2_tmin", "s2_tmax", "s2_min")
STATE_KEYS = S1_KEYS + S2I_KEYS + S2F_KEYS + ("counter",)
DI_KEYS = ("d_lo", "d_hi", "d_count", "d_arrival")
DF_KEYS = ("d_sum", "d_sumsq", "d_val", "d_tmin", "d_tmax", "d_min")
DRAIN_KEYS = DI_KEYS + DF_KEYS + ("d_n",)


def make_state(p: SketchParams, device="cpu") -> dict[str, torch.Tensor]:
    d, m, L = p.d, p.m, p.L
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    st = {k: torch.zeros((d, m), **i32) for k in S1_KEYS}
    st.update({k: torch.zeros((L,), **i32) for k in S2I_KEYS})
    st["s2_arrival"].fill_(_I32MAX)
    st.update({k: torch.zeros((L,), **f32) for k in S2F_KEYS})
    st["s2_tmin"].fill_(_BIG)
    st["s2_tmax"].fill_(-_BIG)
    st["s2_min"].fill_(_BIG)
    st["counter"] = torch.zeros((), **i32)
    return st


def make_drain(capacity: int, device="cpu") -> dict[str, torch.Tensor]:
    """Drained-eviction buffer for ``capacity`` evictions (floored at 1 so
    every array is indexable; ``d_n`` says how many rows are real)."""
    c = max(int(capacity), 1)
    dr = {k: torch.zeros((c,), dtype=torch.int32, device=device)
          for k in DI_KEYS}
    dr.update({k: torch.zeros((c,), dtype=torch.float32, device=device)
               for k in DF_KEYS})
    dr["d_n"] = torch.zeros((), dtype=torch.int32, device=device)
    return dr


def hash_all(lo: torch.Tensor, hi: torch.Tensor, d: int, m: int):
    """Bucket index ``[n, d]`` (int64) of every key in every table: the
    mix of ``core.sketch.hash_bucket`` in int64 masked to 32 bits."""
    dev = lo.device
    a1 = torch.tensor(HASH_A1[:d], dtype=torch.int64, device=dev)
    a2 = torch.tensor(HASH_A2[:d], dtype=torch.int64, device=dev)
    b = torch.tensor(HASH_B[:d], dtype=torch.int64, device=dev)
    lo = lo.to(torch.int64)[..., None]
    hi = hi.to(torch.int64)[..., None]
    x = ((a1 * lo) & _MASK32) + ((a2 * hi) & _MASK32) + b
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _MASK32
    x = x ^ (x >> 13)
    return (x & 0x7FFFFFFF) % m


def fma_f32(a: float, b: float, c: float) -> float:
    """``a·b + c`` for float32 values, rounded once to float32 (to nearest,
    ties to even), as a fused multiply-add (``__fmaf_rn``) rounds it.  In
    float64 the product is exact (two 24-bit significands) and the sum
    ``s`` rounds once, its error ``e`` exact (two-sum); rounding ``s`` to
    float32 rounds ``s + e`` the same way unless ``s`` falls on a float32
    midpoint, which one step of ``s`` towards ``e`` settles."""
    p = a * b
    s = p + c
    if not math.isfinite(s):
        return float(np.float32(a) * np.float32(b) + np.float32(c))
    v = s - p
    e = (p - (s - v)) + (c - v)
    f = np.float32(s)
    if e and float(f) != s:
        g = np.nextafter(f, np.float32(math.copysign(math.inf, s - float(f))))
        if (float(f) + float(g)) / 2 == s:
            f = np.float32(math.nextafter(s, math.copysign(math.inf, e)))
    return float(f)


class _Packed:
    """State and drain as the insertion loops work on them: Stage 1
    ``T [d, m, 4]`` (lo, hi, valid, freq), Stage 2 ``I [L, 5]`` (the int
    columns) and ``F [L, 6]`` (the float columns), the drain ``DI [cap,
    4]`` / ``DF [cap, 6]``, the arrival counter ``C`` and the drained-row
    count ``Dn``.  Copies: the caller's tensors are not modified."""

    def __init__(self, state, drain):
        self.dev = state["keys_lo"].device
        self.rows = torch.arange(state["keys_lo"].shape[0], device=self.dev)
        self.T = torch.stack([state[k] for k in S1_KEYS], dim=2)
        self.I = torch.stack([state[k] for k in S2I_KEYS], dim=1)
        self.F = torch.stack([state[k] for k in S2F_KEYS], dim=1)
        self.DI = torch.stack([drain[k] for k in DI_KEYS], dim=1)
        self.DF = torch.stack([drain[k] for k in DF_KEYS], dim=1)
        self.C = int(state["counter"])
        self.Dn = int(drain["d_n"])

    def stage1(self, bkt, lo_i: int, hi_i: int, r: int, H: int) -> int:
        """Every table moves by the whole run (``bkt``: its bucket in each
        table); returns the index of the first promoted record, ``r`` when
        none is."""
        T, rows = self.T, self.rows
        bk = T[rows, bkt]                                    # [d, 4]
        f0 = bk[:, 3]
        match = (bk[:, 2] == 1) & (bk[:, 0] == lo_i) & (bk[:, 1] == hi_i)
        empty = bk[:, 2] == 0
        steal = ~match & ~empty & (r > f0)
        newf = torch.where(match, f0 + r, torch.where(
            empty, torch.full_like(f0, r),
            torch.where(steal, r - f0, f0 - r)))
        claim = empty | steal
        newv = (match | claim | (newf > 0)).to(torch.int32)
        k = torch.where(match, H - f0 - 1, torch.where(
            empty, torch.full_like(f0, H - 1),
            torch.where(steal, f0 + H - 1, torch.full_like(f0, r))))
        T[rows, bkt] = torch.stack([
            torch.where(claim, lo_i, bk[:, 0]),
            torch.where(claim, hi_i, bk[:, 1]), newv, newf], dim=1)
        return min(int(k.clamp(min=0).min()), r)

    def write(self, j: int, exists: bool, evict: bool, lo_i: int, hi_i: int,
              first: int, r: int, dur, val, t0, dt):
        """Records ``first..r-1`` of the run reach Stage-2 row ``j``: an
        update of the key's row, or a new row (after draining the FIFO
        victim when ``evict``).  The aggregates are closed forms in the
        CUDA kernel's operation order."""
        I, F = self.I, self.F
        if evict and self.Dn < self.DI.shape[0]:    # drain the victim first
            self.DI[self.Dn] = I[j, [0, 1, 3, 4]]
            self.DF[self.Dn] = F[j]
            self.Dn += 1
        n = r - first
        nf = torch.tensor(float(n), dtype=torch.float32, device=self.dev)
        sdur = nf * dur
        ssq = sdur * dur
        sval = nf * val
        t0_f, dt_f = float(t0), float(dt)
        tfirst = torch.tensor(fma_f32(dt_f, float(first), t0_f),
                              dtype=torch.float32, device=self.dev)
        tlast = torch.tensor(fma_f32(dt_f, float(r - 1), t0_f),
                             dtype=torch.float32, device=self.dev) + dur
        if exists:
            I[j, 3] += n
            rf = F[j]
            F[j] = torch.stack([rf[0] + sdur, rf[1] + ssq, rf[2] + sval,
                                torch.minimum(rf[3], tfirst),
                                torch.maximum(rf[4], tlast),
                                torch.minimum(rf[5], dur)])
        else:
            I[j] = torch.tensor([lo_i, hi_i, 1, n, self.C],
                                dtype=torch.int32, device=self.dev)
            F[j] = torch.stack([sdur, ssq, sval, tfirst, tlast, dur])
            self.C += 1

    def unpack(self):
        st, dr = {}, {}
        for c, k in enumerate(S1_KEYS):
            st[k] = self.T[..., c].contiguous()
        for c, k in enumerate(S2I_KEYS):
            st[k] = self.I[:, c].contiguous()
        for c, k in enumerate(S2F_KEYS):
            st[k] = self.F[:, c].contiguous()
        st["counter"] = torch.tensor(self.C, dtype=torch.int32,
                                     device=self.dev)
        for c, k in enumerate(DI_KEYS):
            dr[k] = self.DI[:, c].contiguous()
        for c, k in enumerate(DF_KEYS):
            dr[k] = self.DF[:, c].contiguous()
        dr["d_n"] = torch.tensor(self.Dn, dtype=torch.int32, device=self.dev)
        return st, dr


def _runs(state, lo, hi, reps, dur, val, t0, dt):
    """Per-run Python lists and float32 tensors of a run stream, with each
    run's bucket in every table."""
    d, m = state["keys_lo"].shape
    return (hash_all(lo, hi, d, m), lo.tolist(), hi.tolist(), reps.tolist(),
            *(x.to(torch.float32) for x in (dur, val, t0, dt)))


def insert_runs_plain(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                      H: int):
    """Insert runs in order; returns new ``(state, drain)`` (the inputs
    are not modified).  Runs with ``reps ≤ 0`` are no-ops.  One run
    evicts at most one Stage-2 row, so ``make_drain(len(runs))`` never
    saturates; a smaller buffer saturates instead of overflowing.

    Stage 2 is found by a scan of all ``L`` rows: the key's row, else the
    lowest free row, else the valid row of the oldest arrival."""
    w = _Packed(state, drain)
    idx, lo_l, hi_l, reps_l, dur, val, t0, dt = _runs(
        state, lo, hi, reps, dur, val, t0, dt)
    for i, r in enumerate(reps_l):
        if r <= 0:
            continue
        lo_i, hi_i = lo_l[i], hi_l[i]
        first = w.stage1(idx[i], lo_i, hi_i, r, H)
        if first >= r:
            continue                       # nothing reaches Stage 2
        valid = w.I[:, 2]
        s2_match = (valid == 1) & (w.I[:, 0] == lo_i) & (w.I[:, 1] == hi_i)
        free = valid == 0
        exists = bool(s2_match.any())
        any_free = bool(free.any())
        if exists:
            j = int(s2_match.to(torch.int32).argmax())
        elif any_free:
            j = int(free.to(torch.int32).argmax())
        else:
            j = int(torch.where(valid == 1, w.I[:, 4], _I32MAX).argmin())
        w.write(j, exists, not exists and not any_free, lo_i, hi_i, first,
                r, dur[i], val[i], t0[i], dt[i])
    return w.unpack()


def insert_plain(state, drain, lo, hi, dur, val, t, *, H: int):
    """Per-record insertion (Algorithm 1): each record is a run of one."""
    ones = torch.ones_like(lo, dtype=torch.int32)
    return insert_runs_plain(state, drain, lo, hi, ones, dur, val, t,
                             torch.zeros_like(dur), H=H)


# ---------------------------------------------------------------------------
# The CUDA kernel's Stage 2: O(1) decisions from an index built at start
# ---------------------------------------------------------------------------

#: Bit ``b`` of a precondition code (the kernel's status word) stands for
#: ``PRECONDITION[b]``.
PRECONDITION = (
    "s2_valid holds a value other than 0 and 1",
    "a live Stage-2 arrival is outside counter - live rows .. counter - 1",
    "two live Stage-2 rows share an arrival",
    "two live Stage-2 rows share a key",
)


def stage2_violations(state) -> int:
    """The precondition code of a state: 0 when the Stage-2 index can be
    built from it.  Every state the insertion produces from ``make_state``
    satisfies it: a new row takes arrival ``counter`` and the counter then
    grows, an update keeps the row's arrival, an eviction drops the live
    row of the oldest arrival (so the live arrivals are always the last
    ``live`` values below the counter), and a key gets a new row only when
    no live row holds it."""
    v = state["s2_valid"]
    live = v == 1
    code = 0 if bool(((v == 0) | live).all()) else 1
    arr = state["s2_arrival"][live]
    counter = int(state["counter"])
    if bool(((arr >= counter) | (arr < counter - arr.numel())).any()):
        code |= 2
    if arr.unique().numel() != arr.numel():
        code |= 4
    keys = ((state["s2_lo"][live].to(torch.int64) & _MASK32)
            | (state["s2_hi"][live].to(torch.int64) << 32))
    if keys.unique().numel() != keys.numel():
        code |= 8
    return code


def raise_on_violations(code: int) -> None:
    if code:
        raise ValueError(
            "sketch state breaks the Stage-2 index's precondition: "
            + "; ".join(msg for b, msg in enumerate(PRECONDITION)
                        if code >> b & 1))


def index_size(L: int) -> int:
    """Slots of the key index: the least power of two ≥ 2L (load ≤ ½)."""
    t = 1
    while t < 2 * L:
        t *= 2
    return t


_IX_A, _IX_B = 0x9E3779B1, 0x85EBCA77


def index_home(lo: int, hi: int, mask: int) -> int:
    """Home slot of a key in the index (``index_home`` in the kernel, in
    uint32 wraparound)."""
    x = ((lo & _MASK32) * _IX_A + (hi & _MASK32) * _IX_B) & _MASK32
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & _MASK32
    x ^= x >> 12
    return x & mask


def index_home_twin(lo, hi):
    """Another key with the same home slot at every index size:
    ``(lo − B, hi + A)`` leaves ``A·lo + B·hi`` mod 2³², of which the home
    is a function, unchanged.  Numpy int32 arrays in and out; streams of
    keys and their twins make long probe runs and deletions that move
    entries."""
    lo2 = (np.asarray(lo, np.int64) - _IX_B) & _MASK32
    hi2 = (np.asarray(hi, np.int64) + _IX_A) & _MASK32
    return lo2.astype(np.uint32).view(np.int32), \
        hi2.astype(np.uint32).view(np.int32)


class Stage2Index:
    """Plain mirror of the kernel's Stage-2 bookkeeping, built from an
    incoming Stage 2 ``I [L, 5]`` that satisfies the precondition:

    * a key → row index: open addressing with linear probing over
      ``index_size(L)`` slots, entries ``(lo, hi, row, home)``, deletion by
      backward shift (no tombstones), so a lookup stops at the first empty
      slot.  Keys are unique among live rows, so the index gives the same
      row as a scan's lowest match;
    * a bitmap of free rows (``s2_valid == 0``).  Rows are overwritten,
      never cleared, so free rows never come back and the lowest free row
      is the lowest set bit;
    * a ring of the live rows in arrival order.  The live arrivals are
      ``counter − live .. counter − 1``, so a row's place is its arrival's
      offset.  A new row takes arrival ``counter`` and joins at the tail;
      with no free row the oldest live row is the ring's head.  A full ring
      of ``L`` rows evicts by advancing its head: the new row reuses the
      victim's place.
    """

    def __init__(self, I, counter: int):
        cols = I.tolist()
        self.L = len(cols)
        self.mask = index_size(self.L) - 1
        self.ent: list = [None] * (self.mask + 1)
        self.pos_of = [-1] * self.L
        self.free = [0] * ((self.L + 31) // 32)
        live = []
        for j, (lo, hi, v, _, arr) in enumerate(cols):
            if v == 0:
                self.free[j >> 5] |= 1 << (j & 31)
            elif v == 1:
                live.append((arr, j))
                self.insert(lo, hi, index_home(lo, hi, self.mask), j)
        self.ring = [0] * self.L
        for arr, j in live:
            self.ring[arr - (counter - len(live))] = j
        self.head, self.count = 0, len(live)
        self.evicted = self.shifted = 0

    def find(self, lo: int, hi: int, home: int) -> int:
        """The key's row, or −1."""
        q = home
        while self.ent[q] is not None:
            e = self.ent[q]
            if e[0] == lo and e[1] == hi:
                return e[2]
            q = (q + 1) & self.mask
        return -1

    def take_free(self) -> int:
        """The lowest free row, marked taken and appended to the ring."""
        w = next(k for k, word in enumerate(self.free) if word)
        bit = (self.free[w] & -self.free[w]).bit_length() - 1
        self.free[w] &= ~(1 << bit)
        j = 32 * w + bit
        self.ring[(self.head + self.count) % self.L] = j
        self.count += 1
        return j

    def evict(self) -> int:
        """The oldest live row; its key leaves the index."""
        j = self.ring[self.head]
        self.head = (self.head + 1) % self.L
        self._delete(j)
        self.evicted += 1
        return j

    def insert(self, lo: int, hi: int, home: int, j: int) -> None:
        q = home
        while self.ent[q] is not None:
            q = (q + 1) & self.mask
        self.ent[q] = (lo, hi, j, home)
        self.pos_of[j] = q

    def _delete(self, j: int) -> None:
        """Empty ``j``'s slot and pull back each later entry of the probe
        run whose home is not between the gap and itself."""
        p = self.pos_of[j]
        q = (p + 1) & self.mask
        while self.ent[q] is not None:
            e = self.ent[q]
            if (q - e[3]) & self.mask >= (q - p) & self.mask:
                self.ent[p] = e
                self.pos_of[e[2]] = p
                p = q
                self.shifted += 1
            q = (q + 1) & self.mask
        self.ent[p] = None


def insert_runs_indexed(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                        H: int):
    """Plain mirror of the CUDA kernel: ``insert_runs_plain`` with Stage 2
    decided by a :class:`Stage2Index` built from the incoming state instead
    of a scan.  Raises ``ValueError`` for a state that breaks the index's
    precondition.  Returns ``(state, drain, events)``; ``events`` counts
    the runs that reached Stage 2 (``promoted``), the FIFO evictions and
    the index entries moved by deletions (``shifted``)."""
    raise_on_violations(stage2_violations(state))
    w = _Packed(state, drain)
    ix = Stage2Index(w.I, w.C)
    idx, lo_l, hi_l, reps_l, dur, val, t0, dt = _runs(
        state, lo, hi, reps, dur, val, t0, dt)
    promoted = 0
    for i, r in enumerate(reps_l):
        if r <= 0:
            continue
        lo_i, hi_i = lo_l[i], hi_l[i]
        first = w.stage1(idx[i], lo_i, hi_i, r, H)
        if first >= r:
            continue
        promoted += 1
        home = index_home(lo_i, hi_i, ix.mask)
        j = ix.find(lo_i, hi_i, home)
        exists = j >= 0
        evict = not exists and ix.count == ix.L
        if not exists:
            j = ix.evict() if evict else ix.take_free()
            ix.insert(lo_i, hi_i, home, j)
        w.write(j, exists, evict, lo_i, hi_i, first, r, dur[i], val[i],
                t0[i], dt[i])
    st, dr = w.unpack()
    return st, dr, {"promoted": promoted, "evicted": ix.evicted,
                    "shifted": ix.shifted}
