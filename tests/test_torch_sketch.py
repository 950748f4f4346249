"""The port's Fail-Slow Sketch insert against the JAX reference.

Every input is made with numpy from a seed and handed to both packages:
the port's plain torch version (the path a CPU tensor takes) against the
reference's run-compressed scan (``batched.insert_runs_vectorized``), its
per-record scan (``ref.insert_batch``) and its Pallas ``sketch_insert`` in
interpret mode.  Integer state and the drain are compared exactly; float
statistics at ``rtol=1e-5`` (both sides accumulate in float32 in the same
order, so this is tighter than the reference's own JAX-vs-oracle 1e-4).
The CUDA kernel is held against the plain version in
``test_torch_cuda.py``, which runs only where a card is present.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import (FailSlowSketch, SketchParams,
                               retention_lower_bound, split_key)
from repro.kernels.sketch_update import batched as JB
from repro.kernels.sketch_update import ops as JO
from repro.kernels.sketch_update import ref as JR
from repro_torch.convert import (drain_from_numpy, drain_to_numpy,
                                 sketch_state_from_numpy,
                                 sketch_state_to_numpy)
from repro_torch.core.sketch import SketchParams as TSketchParams
from repro_torch.core.sketch import \
    retention_lower_bound as t_retention_lower_bound
from repro_torch.kernels import _lib
from repro_torch.kernels.sketch_update import ops as TO
from repro_torch.kernels.sketch_update import ref as TR

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _tp(p: SketchParams) -> TSketchParams:
    return TSketchParams(d=p.d, m=p.m, H=p.H, L=p.L)


def _assert_dicts_equal(got: dict, exp: dict, rtol=1e-5):
    assert set(got) == set(exp)
    for k in exp:
        a, b = np.asarray(got[k]), np.asarray(exp[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "i":
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=k)


def _random_runs(seed, n, n_keys=20, max_rep=12):
    """A run stream spanning r < H, r ≈ H and r ≫ H (the cases of the
    reference's ``test_sketch_run_path_matches_insert_run_oracle``)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n).astype(np.int64) * 0x9E3779B9
    lo, hi = split_key(keys)
    return (lo, hi, rng.integers(1, max_rep, size=n).astype(np.int32),
            rng.random(n).astype(np.float32),
            (rng.random(n) * 3).astype(np.float32),
            np.cumsum(rng.random(n)).astype(np.float32),
            (rng.random(n) * 0.01).astype(np.float32))


def _port_runs(p, runs):
    tp = _tp(p)
    return TO.insert_runs(TR.make_state(tp), TR.make_drain(len(runs[0])),
                          *map(torch.from_numpy, runs), params=tp)


def _jax_runs(p, runs):
    st, dr = JB.insert_runs_vectorized(
        JR.make_state(p), JR.make_drain(len(runs[0])),
        *(jnp.asarray(x) for x in runs), H=p.H)
    return ({k: np.asarray(v) for k, v in st.items()},
            {k: np.asarray(v) for k, v in dr.items()})


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,m", [(2, 1024), (4, 777)])
def test_hash_all_bit_identical(d, m):
    rng = np.random.default_rng(d * 1000 + m)
    keys = rng.integers(0, 2**62, size=20_000, dtype=np.int64)
    lo, hi = split_key(keys)
    exp = np.asarray(JR.hash_all(jnp.asarray(lo), jnp.asarray(hi), d, m))
    got = TR.hash_all(torch.from_numpy(lo), torch.from_numpy(hi), d, m)
    assert np.array_equal(got.numpy(), exp.astype(np.int64))


# ---------------------------------------------------------------------------
# run-compressed path (mirrors test_kernels.py:212-287)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,d,m,H,L", [
    (0, 2, 64, 4, 16), (1, 1, 8, 2, 2), (2, 3, 16, 8, 4),
    (3, 2, 1024, 8, 1024), (4, 1, 16, 1, 4)])
def test_insert_runs_matches_jax_batched(seed, d, m, H, L):
    p = SketchParams(d=d, m=m, H=H, L=L)
    runs = _random_runs(seed, 150)
    st, dr = _port_runs(p, runs)
    st_j, dr_j = _jax_runs(p, runs)
    _assert_dicts_equal(sketch_state_to_numpy(st), st_j)
    _assert_dicts_equal(drain_to_numpy(dr), dr_j)


def test_insert_runs_forced_eviction_with_drain():
    """L=8 ≪ distinct promoted keys: every FIFO victim reaches the drain,
    and the merged patterns equal the numpy oracle's."""
    p = SketchParams(d=2, m=256, H=4, L=8)
    runs = _random_runs(5, 400, n_keys=60)
    st, dr = _port_runs(p, runs)
    st_j, dr_j = _jax_runs(p, runs)
    _assert_dicts_equal(sketch_state_to_numpy(st), st_j)
    _assert_dicts_equal(drain_to_numpy(dr), dr_j)
    assert int(dr["d_n"]) > p.L
    oracle = FailSlowSketch(p)
    keys = runs[0].astype(np.int64) + (runs[1].astype(np.int64) << 31)
    oracle.insert_runs(keys, *runs[2:])
    assert int(dr["d_n"]) == oracle.n_evicted
    got = {q.key: q for q in TO.patterns(st, dr)}
    exp = {q.key: q for q in oracle.patterns(include_drained=True)}
    assert set(got) == set(exp)
    for k, q in got.items():
        assert (q.count, q.arrival) == (exp[k].count, exp[k].arrival), k
        assert q.sum_dur == pytest.approx(exp[k].sum_dur, rel=1e-4)


def test_insert_runs_promotion_and_steal_branches():
    """Mid-run promotion at k = H − f0 − 1, a bucket steal at
    k = f0 + H − 1 and pure decrements, on one bucket
    (``test_sketch_run_path_promotion_and_steal_branches``)."""
    p = SketchParams(d=1, m=1, H=4, L=4)
    keys = np.array([7, 7, 9, 9, 5], dtype=np.int64)
    lo, hi = split_key(keys)
    n = len(keys)
    durs = np.full(n, 0.25, np.float32)
    runs = (lo, hi, np.array([2, 5, 3, 9, 3], np.int32), durs, durs * 2,
            (np.arange(n) * 10).astype(np.float32), np.full(n, 0.5,
                                                            np.float32))
    st, dr = _port_runs(p, runs)
    st_j, dr_j = _jax_runs(p, runs)
    _assert_dicts_equal(sketch_state_to_numpy(st), st_j)
    _assert_dicts_equal(drain_to_numpy(dr), dr_j)
    counts = {q.key: q.count for q in TO.patterns(st, dr)}
    assert counts == {7: 4, 9: 2}


def test_insert_runs_continues_from_state():
    """A second call continues from the state and drain the first left,
    as the reference's does; inputs are not modified."""
    p = SketchParams(d=2, m=32, H=2, L=4)
    a, b = _random_runs(6, 80), _random_runs(7, 80)
    st_j, dr_j = JB.insert_runs_vectorized(
        JR.make_state(p), JR.make_drain(160), *map(jnp.asarray, a), H=p.H)
    st_j, dr_j = JB.insert_runs_vectorized(st_j, dr_j, *map(jnp.asarray, b),
                                           H=p.H)
    tp = _tp(p)
    st0, dr0 = TR.make_state(tp), TR.make_drain(160)
    st1, dr1 = TO.insert_runs(st0, dr0, *map(torch.from_numpy, a), params=tp)
    st2, dr2 = TO.insert_runs(st1, dr1, *map(torch.from_numpy, b), params=tp)
    assert int(st0["counter"]) == 0 and int(dr0["d_n"]) == 0
    _assert_dicts_equal(sketch_state_to_numpy(st2),
                        {k: np.asarray(v) for k, v in st_j.items()})
    _assert_dicts_equal(drain_to_numpy(dr2),
                        {k: np.asarray(v) for k, v in dr_j.items()})


# ---------------------------------------------------------------------------
# per-record path (mirrors test_kernels.py:19-40 and 175-210)
# ---------------------------------------------------------------------------

def _records(seed, n, n_keys, mult=0x9E3779B9):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n).astype(np.int64) * mult
    lo, hi = split_key(keys)
    return (lo, hi, rng.random(n).astype(np.float32),
            (rng.random(n) * 5).astype(np.float32),
            np.cumsum(rng.random(n)).astype(np.float32))


@pytest.mark.parametrize("d,m,H,L,n", [(1, 32, 2, 8, 300),
                                       (2, 64, 4, 16, 700),
                                       (4, 128, 8, 32, 500)])
def test_insert_matches_jax_scan_ref(d, m, H, L, n):
    p = SketchParams(d=d, m=m, H=H, L=L)
    recs = _records(d * 100 + m, n, 80)
    st_j = JR.insert_batch(JR.make_state(p), *map(jnp.asarray, recs), H=H)
    st = TO.insert(TR.make_state(_tp(p)), *map(torch.from_numpy, recs),
                   params=_tp(p))
    _assert_dicts_equal(sketch_state_to_numpy(st),
                        {k: np.asarray(v) for k, v in st_j.items()})


def test_insert_with_drain_matches_pallas_interpret():
    """Per-record insertion under forced eviction equals the Pallas
    ``sketch_insert`` (interpret mode) state and drain."""
    p = SketchParams(d=2, m=64, H=2, L=4)
    lo, hi, dur, _, _ = _records(11, 500, 40, mult=31337)
    ts = np.arange(500, dtype=np.float32)
    recs = (lo, hi, dur, dur * 2, ts)
    st_j, dr_j = JO.insert(JO.make_state(p), *map(jnp.asarray, recs),
                           params=p, impl="pallas",
                           drain=JO.make_drain(500))
    st, dr = TO.insert(TR.make_state(_tp(p)), *map(torch.from_numpy, recs),
                       params=_tp(p), drain=TR.make_drain(500))
    _assert_dicts_equal(sketch_state_to_numpy(st),
                        {k: np.asarray(v) for k, v in st_j.items()})
    _assert_dicts_equal(drain_to_numpy(dr),
                        {k: np.asarray(v) for k, v in dr_j.items()})
    assert int(dr["d_n"]) > p.L


def test_patterns_decode_equal():
    """``patterns`` / ``drain_patterns`` on converted reference state give
    the reference decoders' pattern lists, field for field."""
    p = SketchParams(d=2, m=256, H=4, L=8)
    st_j, dr_j = _jax_runs(p, _random_runs(8, 300, n_keys=50))
    st = sketch_state_from_numpy(st_j)
    dr = drain_from_numpy(dr_j)
    tag = 1 << 62
    for got, exp in ((TO.patterns(st, dr, key_tag=tag),
                      JO.patterns(st_j, dr_j, key_tag=tag)),
                     (TO.patterns(st), JO.patterns(st_j)),
                     (TO.drain_patterns(dr, key_tag=tag),
                      JO.drain_patterns(dr_j, key_tag=tag))):
        assert [vars(q) for q in got] == [vars(q) for q in exp]
    assert len(TO.drain_patterns(dr)) > 0


def test_wrapper_routes_cpu_tensors_to_plain_version():
    p = SketchParams(d=2, m=64, H=4, L=16)
    runs = _random_runs(9, 50)
    before = dict(_lib.LAUNCHES)
    got = _port_runs(p, runs)
    exp = TR.insert_runs_plain(TR.make_state(_tp(p)), TR.make_drain(50),
                               *map(torch.from_numpy, runs), H=p.H)
    for a, b in zip(got, exp):
        _assert_dicts_equal(_to_np(a), _to_np(b), rtol=0)
    assert _lib.LAUNCHES == before


def _to_np(d):
    return {k: v.numpy() for k, v in d.items()}


# ---------------------------------------------------------------------------
# the CUDA kernel's Stage 2 (key index, free bitmap, FIFO ring), mirrored
# by ref.insert_runs_indexed
# ---------------------------------------------------------------------------

def _record_runs(seed, n, n_keys):
    """A per-record stream as runs of one (reps 1, dt 0)."""
    lo, hi, dur, val, ts = _records(seed, n, n_keys, mult=31337)
    return (lo, hi, np.ones(n, np.int32), dur, val, ts,
            np.zeros(n, np.float32))


def _twin_runs(seed, n, n_keys):
    """Runs over ``n_keys`` keys and their twins, which share their home
    slot in the key index (``ref.index_home_twin``): long probe runs, and
    deletions that move entries."""
    lo, hi, reps, dur, val, t0, dt = _random_runs(seed, n, n_keys, max_rep=4)
    lo2, hi2 = TR.index_home_twin(lo, hi)
    twin = np.random.default_rng(seed + 1).random(n) < 0.5
    return (np.where(twin, lo2, lo), np.where(twin, hi2, hi), reps, dur, val,
            t0, dt)


_INDEXED_CASES = {
    "d2m64L16": (SketchParams(d=2, m=64, H=4, L=16), [_random_runs(0, 150)]),
    "d1m8L2": (SketchParams(d=1, m=8, H=2, L=2), [_random_runs(1, 150)]),
    "d3m16L4": (SketchParams(d=3, m=16, H=8, L=4), [_random_runs(2, 150)]),
    "default_L1024": (SketchParams(d=2, m=1024, H=8, L=1024),
                      [_random_runs(3, 150)]),
    "H1": (SketchParams(d=1, m=16, H=1, L=4), [_random_runs(4, 150)]),
    "evict_L8_drain": (SketchParams(d=2, m=256, H=4, L=8),
                       [_random_runs(5, 400, n_keys=60)]),
    "carried_state": (SketchParams(d=2, m=32, H=2, L=4),
                      [_random_runs(6, 80), _random_runs(7, 80)]),
    "fifo_wraps": (SketchParams(d=2, m=64, H=2, L=8),
                   [_random_runs(12, 900, n_keys=300, max_rep=4)]),
    "records": (SketchParams(d=2, m=64, H=2, L=4), [_record_runs(11, 500, 40)]),
    "home_twins": (SketchParams(d=2, m=64, H=2, L=8), [_twin_runs(15, 600, 30)]),
}


@pytest.mark.parametrize("case", sorted(_INDEXED_CASES))
def test_indexed_mirror_matches_plain_and_jax(case):
    """The kernel's O(1) Stage-2 decisions give the scan's answers: state
    and drain bit-equal to ``insert_runs_plain`` and equal to the JAX
    ``insert_runs_vectorized``, call after call (the later calls build the
    index from a carried state)."""
    p, streams = _INDEXED_CASES[case]
    tp = _tp(p)
    cap = sum(len(r[0]) for r in streams)
    st_i = st_p = TR.make_state(tp)
    dr_i = dr_p = TR.make_drain(cap)
    st_j, dr_j = JR.make_state(p), JR.make_drain(cap)
    events = []
    for runs in streams:
        args = [torch.from_numpy(x) for x in runs]
        st_i, dr_i, ev = TR.insert_runs_indexed(st_i, dr_i, *args, H=p.H)
        st_p, dr_p = TR.insert_runs_plain(st_p, dr_p, *args, H=p.H)
        st_j, dr_j = JB.insert_runs_vectorized(
            st_j, dr_j, *map(jnp.asarray, runs), H=p.H)
        events.append(ev)
        _assert_dicts_equal(_to_np(st_i), _to_np(st_p), rtol=0)
        _assert_dicts_equal(_to_np(dr_i), _to_np(dr_p), rtol=0)
        _assert_dicts_equal(sketch_state_to_numpy(st_i),
                            {k: np.asarray(v) for k, v in st_j.items()})
        _assert_dicts_equal(drain_to_numpy(dr_i),
                            {k: np.asarray(v) for k, v in dr_j.items()})
    assert sum(ev["evicted"] for ev in events) == int(dr_i["d_n"])
    if case == "fifo_wraps":          # several trips round the ring, and
        assert events[0]["evicted"] > 5 * p.L      # deletions that moved
        assert events[0]["shifted"] > 0            # colliding entries
    if case == "home_twins":          # twins' entries moved by deletions
        assert events[0]["evicted"] > 0 and events[0]["shifted"] > 0
    if case == "carried_state":
        assert events[1]["promoted"] > 0 and int(st_i["counter"]) > p.L


def _broken(kind):
    """A state the sketch never produces, one per precondition bit."""
    p = TSketchParams(d=2, m=32, H=2, L=4)
    st, _ = TO.insert_runs(TR.make_state(p), TR.make_drain(80),
                           *map(torch.from_numpy, _random_runs(6, 80)),
                           params=p)
    assert bool((st["s2_valid"] == 1).all())
    if kind == "valid":                 # the oldest row: the rest stay in range
        st["s2_valid"][int(st["s2_arrival"].argmin())] = 2
    elif kind == "arrival_ge_counter":
        st["s2_arrival"][2] = st["counter"]
    elif kind == "arrival_below_the_live_range":
        st["s2_arrival"][2] = st["counter"] - 5
    elif kind == "arrival_twice":
        st["s2_arrival"][3] = st["s2_arrival"][0]
    else:
        st["s2_lo"][1], st["s2_hi"][1] = st["s2_lo"][0], st["s2_hi"][0]
    return p, st


@pytest.mark.parametrize("kind,bit", [
    ("valid", 0), ("arrival_ge_counter", 1),
    ("arrival_below_the_live_range", 1), ("arrival_twice", 2),
    ("key_twice", 3)])
def test_broken_stage2_precondition_raises(kind, bit):
    p, st = _broken(kind)
    assert TR.stage2_violations(st) == 1 << bit
    runs = [torch.from_numpy(x) for x in _random_runs(7, 20)]
    with pytest.raises(ValueError, match=TR.PRECONDITION[bit]):
        TR.insert_runs_indexed(st, TR.make_drain(20), *runs, H=p.H)
    with pytest.raises(ValueError, match=TR.PRECONDITION[bit]):
        TO.insert_runs(st, TR.make_drain(20), *runs, params=p)


def test_insert_runs_many_equals_single_calls():
    """Comp and comm sketches with different SketchParams in one call
    equal two single calls; the CPU launches nothing."""
    jobs = []
    for p, runs in ((TSketchParams(d=2, m=64, H=4, L=16),
                     _random_runs(13, 300, n_keys=40)),
                    (TSketchParams(d=3, m=32, H=2, L=8),
                     _random_runs(14, 200, n_keys=60))):
        jobs.append((TR.make_state(p), TR.make_drain(len(runs[0])),
                     tuple(map(torch.from_numpy, runs)), p))
    before = dict(_lib.LAUNCHES)
    got = TO.insert_runs_many(jobs)
    assert _lib.LAUNCHES == before
    assert TO.insert_runs_many([]) == []
    for (st, dr), (st0, dr0, runs, p) in zip(got, jobs):
        exp = TO.insert_runs(st0, dr0, *runs, params=p)
        _assert_dicts_equal(_to_np(st), _to_np(exp[0]), rtol=0)
        _assert_dicts_equal(_to_np(dr), _to_np(exp[1]), rtol=0)
        assert int(st0["counter"]) == 0
    assert int(got[1][1]["d_n"]) > 0


def test_retention_lower_bound_matches_reference():
    """Lemma 3.1's bound (``test_sketch.py``'s retention tests): equal to
    the reference's over a grid that covers f_i <= H, N < f_i with odd d
    (the clamp) and the usual N >> f_i."""
    rng = np.random.default_rng(5)
    for d, m, H in ((1, 16, 1), (2, 1024, 8), (3, 64, 4), (4, 777, 32)):
        p, tp = SketchParams(d=d, m=m, H=H, L=8), TSketchParams(d=d, m=m,
                                                                 H=H, L=8)
        for N, f in [(10.0, 50.0), (1e6, float(H)), (1e6, H + 0.5)] + [
                tuple(x) for x in rng.uniform(0, 1e5, size=(20, 2))]:
            b = t_retention_lower_bound(N, f, tp)
            assert b == retention_lower_bound(N, f, p)
            assert 0.0 <= b <= 1.0


def _fma_exact(a: float, b: float, c: float) -> float:
    """``a·b + c`` rounded once to float32 (to nearest, ties to even), by
    exact rational arithmetic."""
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return float(min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                           int(x.view(np.uint32)) & 1)))


@pytest.mark.parametrize("kind", ["starts", "midpoints"])
def test_fma_f32_rounds_once(kind):
    """``ref.fma_f32`` (a run's start ``t0 + dt·k``, as the kernel's
    ``__fmaf_rn`` rounds it) equals the exact product and sum rounded once,
    bit for bit: on run starts drawn as the recorder makes them, and on
    sums that land next to or on a float32 midpoint, where rounding twice
    (to float64, then to float32) would go wrong."""
    rng = np.random.default_rng(41)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    if kind == "starts":
        cases = [(f32(rng.uniform(0, 10) * 10.0 ** rng.integers(-4, 3)),
                  float(rng.integers(0, 5000)),
                  f32(rng.uniform(-1, 1) * 10.0 ** rng.integers(-3, 7)))
                 for _ in range(20000)]
    else:
        cases = []
        for _ in range(10000):
            a = f32(1 + int(rng.integers(1, 2 ** 12)) * 2.0 ** -23)
            b = float(rng.integers(1, 2 ** 12))
            cases += [(a, b, -f32(a * b)),
                      (a, b, f32(-a * b + rng.standard_normal() * 1e-3))]
        # 4,097 · (1 + 2^-12) − 4,098 is 2^-12; with the product rounded to
        # float32 first it is 0
        cases.append((f32(1 + 2.0 ** -12), 4097.0, -4098.0))
    bad = [c for c in cases if TR.fma_f32(*c) != _fma_exact(*c)]
    assert not bad, bad[:5]
    assert TR.fma_f32(f32(1 + 2.0 ** -12), 4097.0, -4098.0) == 2.0 ** -12
