"""Plain torch version of the Fail-Slow Sketch insertion (runs and records).

The reference for the CUDA kernel ``csrc/sketch_insert.cu`` and the path
the wrapper takes for CPU tensors.  It is a Python loop over runs, one run
at a time, in the order that Algorithm 1 makes semantic; it is a
correctness reference, not a yardstick of speed.

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
kernel, so the two agree bit for bit.  A record is a run with ``reps = 1``
and ``dt = 0``, which reduces to the per-record update exactly.
"""

from __future__ import annotations

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


def insert_runs_plain(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                      H: int):
    """Insert runs in order; returns new ``(state, drain)`` (the inputs
    are not modified).  Runs with ``reps ≤ 0`` are no-ops.  One run
    evicts at most one Stage-2 row, so ``make_drain(len(runs))`` never
    saturates; a smaller buffer saturates instead of overflowing."""
    st = {k: v.clone() for k, v in state.items()}
    dr = {k: v.clone() for k, v in drain.items()}
    d, m = st["keys_lo"].shape
    dev = st["keys_lo"].device
    rows = torch.arange(d, device=dev)
    T = torch.stack([st[k] for k in S1_KEYS], dim=2)        # [d, m, 4]
    I = torch.stack([st[k] for k in S2I_KEYS], dim=1)       # [L, 5]
    F = torch.stack([st[k] for k in S2F_KEYS], dim=1)       # [L, 6]
    DI = torch.stack([dr[k] for k in DI_KEYS], dim=1)       # [cap, 4]
    DF = torch.stack([dr[k] for k in DF_KEYS], dim=1)       # [cap, 6]
    C = int(st["counter"])
    Dn = int(dr["d_n"])
    cap = DI.shape[0]
    idx = hash_all(lo, hi, d, m)
    lo_l, hi_l, reps_l = lo.tolist(), hi.tolist(), reps.tolist()
    dur, val, t0, dt = (x.to(torch.float32) for x in (dur, val, t0, dt))

    for i, r in enumerate(reps_l):
        if r <= 0:
            continue
        lo_i, hi_i = lo_l[i], hi_l[i]
        # ---- Stage 1: every table moves by the whole run ----------------
        bk = T[rows, idx[i]]                                 # [d, 4]
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
        T[rows, idx[i]] = torch.stack([
            torch.where(claim, lo_i, bk[:, 0]),
            torch.where(claim, hi_i, bk[:, 1]), newv, newf], dim=1)
        first = min(int(k.clamp(min=0).min()), r)
        if first >= r:
            continue                       # nothing reaches Stage 2
        # ---- Stage 2: update, else first free slot, else FIFO evict ---
        valid = I[:, 2]
        s2_match = (valid == 1) & (I[:, 0] == lo_i) & (I[:, 1] == hi_i)
        free = valid == 0
        exists = bool(s2_match.any())
        any_free = bool(free.any())
        if exists:
            j = int(s2_match.to(torch.int32).argmax())
        elif any_free:
            j = int(free.to(torch.int32).argmax())
        else:
            j = int(torch.where(valid == 1, I[:, 4], _I32MAX).argmin())
            if Dn < cap:                   # drain the victim first
                DI[Dn] = I[j, [0, 1, 3, 4]]
                DF[Dn] = F[j]
                Dn += 1
        n = r - first
        nf = torch.tensor(float(n), dtype=torch.float32, device=dev)
        sdur = nf * dur[i]
        ssq = sdur * dur[i]
        sval = nf * val[i]
        tfirst = t0[i] + dt[i] * float(first)
        tlast = t0[i] + dt[i] * float(r - 1) + dur[i]
        if exists:
            I[j, 3] += n
            rf = F[j]
            F[j] = torch.stack([rf[0] + sdur, rf[1] + ssq, rf[2] + sval,
                                torch.minimum(rf[3], tfirst),
                                torch.maximum(rf[4], tlast),
                                torch.minimum(rf[5], dur[i])])
        else:
            I[j] = torch.tensor([lo_i, hi_i, 1, n, C], dtype=torch.int32,
                                device=dev)
            F[j] = torch.stack([sdur, ssq, sval, tfirst, tlast, dur[i]])
            C += 1

    for c, k in enumerate(S1_KEYS):
        st[k] = T[..., c].contiguous()
    for c, k in enumerate(S2I_KEYS):
        st[k] = I[:, c].contiguous()
    for c, k in enumerate(S2F_KEYS):
        st[k] = F[:, c].contiguous()
    st["counter"] = torch.tensor(C, dtype=torch.int32, device=dev)
    for c, k in enumerate(DI_KEYS):
        dr[k] = DI[:, c].contiguous()
    for c, k in enumerate(DF_KEYS):
        dr[k] = DF[:, c].contiguous()
    dr["d_n"] = torch.tensor(Dn, dtype=torch.int32, device=dev)
    return st, dr


def insert_plain(state, drain, lo, hi, dur, val, t, *, H: int):
    """Per-record insertion (Algorithm 1): each record is a run of one."""
    ones = torch.ones_like(lo, dtype=torch.int32)
    return insert_runs_plain(state, drain, lo, hi, ones, dur, val, t,
                             torch.zeros_like(dur), H=H)
