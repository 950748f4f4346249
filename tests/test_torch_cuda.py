"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The file imports neither ``jax`` nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The sketch kernel must equal the plain version exactly (integer state,
drain and float statistics: both round each float operation alone, the
kernel being built with ``-fmad=false``), also from a carried state and
with two sketches of different geometry in one launch, and must raise for
a state that breaks its Stage-2 precondition.  The FailRank step's L' must
equal the plain version's exactly, its s' within 1e-5 (the plain version's
matrix-vector product sums in another order); the whole iteration in one
launch must stop within one step of the plain loop, with s and L within
1e-5 (same count) or 1e-4, the L1 tolerance (one step apart).  Flash attention is held at the reference's f32 tolerance,
2e-5, and the SSD scan at 2e-4 (both sum in another order than the plain
versions' einsums).  On the campaign path: the streaming recorder
launches the sketch kernel once per chunk from the carried state and its
output equals one-shot recording and the CPU's plain path bit for bit;
the ``--tiny`` campaign on the card equals the CPU port's (scores within
``rel=1e-5``), and its thread executor equals serial exactly.  On the
train path: K3's backward within 1e-4 of each gradient's largest entry
against torch autograd through the plain attention, bit-identical over
two runs; the log-sum-exp output leaves the prefill's output unchanged;
K4's backward through its autograd function within 1e-4 of each
gradient's largest entry against its plain mirror and torch autograd
through the plain scan, bit-identical over two runs; a full-size
smollm-135m train step launches K3's forward and backward 30 times each
and never the plain attention, and a full-size mamba2-1.3b step K4's
forward and backward 48 times each and never the plain scan.  At the
serving shapes of mixtral-8x7b and qwen2-vl-2b (head dim 128, GQA ratios 4
and 6, mixtral's 4,096 window wider than the 1,024-slot cache) both K3
entry points hold 2e-5; a mixture-of-experts layer run twice at mixtral's
and at dbrx's width gives the same bits (outputs, aux, routing); a
full-width mixtral-8x7b layer serves through K3 alone.  For the
encoder-decoder: K3 non-causal with S ≠ T, forward and backward, and its
split-key decode with the query below its keys, within the same
tolerances and bit-identical twice; whisper's smoke config served twice
gives equal tokens.  MoE training: three train steps of the mixtral smoke
config, and of dbrx's routing (16 experts, top-4), twice from one seed
give the same bits.  bf16: K3's prefill (tensor cores) and split-key decode
and K4's forward in bf16 against their plain versions in bf16, within four
bf16 ulps of each output row's largest entry (the kernel and the plain
version sum in other orders and may round P, or y, on either side of a
boundary), bit-identical over two runs; mixed types, and a bf16 call that
needs a gradient, raise.  Head dims that are no tile width (8, 24, 120):
each of K3's five entry points (the f32 prefill with and without its
log-sum-exp, the f32 split-key decode, the f32 backward, the bf16 prefill
and the bf16 decode) against the plain version at the tolerances above,
causal, windowed and non-causal, over caches with empty slots, GQA 4 at
120, two runs bit-identical; yi-34b's smoke config (head dim 8) and
h2o-danube-3-4b's at head dim 120 served on the card through K3 alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sketch import SketchParams, split_key
from repro_torch.kernels import _lib
from repro_torch.kernels.failrank_step import ops as fr_ops
from repro_torch.kernels.failrank_step.ref import (failrank_iterate_ref,
                                                   failrank_step_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     rolled_pos_tab,
                                                     split_attention_ref)
from repro_torch.kernels.sketch_update import ops as sk_ops
from repro_torch.kernels.sketch_update import ref as sk_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_plain
from repro_torch.kernels.ssd_scan.ref import (random_inputs, ssd_bwd_ref,
                                              ssd_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _runs(seed, n, n_keys):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, size=n).astype(np.int64) * 0x9E3779B9
    lo, hi = split_key(keys)
    return (lo, hi, rng.integers(1, 12, size=n).astype(np.int32),
            rng.random(n).astype(np.float32),
            (rng.random(n) * 3).astype(np.float32),
            np.cumsum(rng.random(n)).astype(np.float32),
            (rng.random(n) * 0.01).astype(np.float32))


def _assert_equal(got: dict, exp: dict):
    for k in exp:
        assert torch.equal(got[k].cpu(), exp[k].cpu()), k


@pytest.mark.parametrize("seed,d,m,H,L,n_keys", [
    (0, 2, 64, 4, 16, 20), (5, 2, 256, 4, 8, 60), (2, 3, 16, 8, 4, 20),
    (3, 2, 1024, 8, 1024, 200), (1, 1, 8, 2, 2, 20), (4, 1, 16, 1, 4, 20),
    (12, 2, 64, 2, 8, 300), (13, 2, 1024, 4, 2048, 200)])
def test_sketch_kernel_matches_plain(dev, seed, d, m, H, L, n_keys):
    p = SketchParams(d=d, m=m, H=H, L=L)
    args = [torch.from_numpy(x).to(dev) for x in _runs(seed, 300, n_keys)]
    before = _lib.LAUNCHES["sketch_insert_runs"]
    st_k, dr_k = sk_ops.insert_runs(sk_ref.make_state(p, dev),
                                    sk_ref.make_drain(300, dev), *args,
                                    params=p)
    assert _lib.LAUNCHES["sketch_insert_runs"] == before + 1
    st_p, dr_p = sk_ref.insert_runs_plain(sk_ref.make_state(p, dev),
                                          sk_ref.make_drain(300, dev), *args,
                                          H=H)
    torch.cuda.synchronize()
    _assert_equal(st_k, st_p)
    _assert_equal(dr_k, dr_p)


def test_sketch_kernel_at_the_pod_telemetry_geometry(dev):
    """SketchParams(d=2, m=1024, H=4, L=2048), the pod telemetry's sketch,
    with enough keys to fill Stage 2 and evict."""
    p = SketchParams(d=2, m=1024, H=4, L=2048)
    args = [torch.from_numpy(x).to(dev) for x in _runs(14, 5000, 6000)]
    st_k, dr_k = sk_ops.insert_runs(sk_ref.make_state(p, dev),
                                    sk_ref.make_drain(5000, dev), *args,
                                    params=p)
    st_p, dr_p = sk_ref.insert_runs_plain(sk_ref.make_state(p, dev),
                                          sk_ref.make_drain(5000, dev),
                                          *args, H=p.H)
    _assert_equal(st_k, st_p)
    _assert_equal(dr_k, dr_p)
    assert int(dr_k["d_n"]) > 0


def test_sketch_kernel_keys_sharing_a_home_slot(dev):
    """Keys and their twins, which share their home slot in the key index:
    long probe runs, and deletions that move entries."""
    p = SketchParams(d=2, m=64, H=2, L=8)
    lo, hi, *rest = _runs(15, 600, 30)
    lo2, hi2 = sk_ref.index_home_twin(lo, hi)
    twin = np.random.default_rng(16).random(600) < 0.5
    runs = [np.where(twin, lo2, lo), np.where(twin, hi2, hi), *rest]
    args = [torch.from_numpy(x).to(dev) for x in runs]
    st_k, dr_k = sk_ops.insert_runs(sk_ref.make_state(p, dev),
                                    sk_ref.make_drain(600, dev), *args,
                                    params=p)
    st_p, dr_p = sk_ref.insert_runs_plain(sk_ref.make_state(p, dev),
                                          sk_ref.make_drain(600, dev), *args,
                                          H=p.H)
    _assert_equal(st_k, st_p)
    _assert_equal(dr_k, dr_p)
    cpu = [torch.from_numpy(x) for x in runs]
    *_, events = sk_ref.insert_runs_indexed(
        sk_ref.make_state(p), sk_ref.make_drain(600), *cpu, H=p.H)
    assert events["evicted"] > 0 and events["shifted"] > 0


def test_sketch_kernel_per_record_matches_plain(dev):
    p = SketchParams(d=2, m=64, H=2, L=4)
    rng = np.random.default_rng(11)
    lo, hi = split_key(rng.integers(0, 40, size=500).astype(np.int64) * 31337)
    dur = rng.random(500).astype(np.float32)
    recs = [torch.from_numpy(x).to(dev) for x in
            (lo, hi, dur, dur * 2, np.arange(500, dtype=np.float32))]
    st_k, dr_k = sk_ops.insert(sk_ref.make_state(p, dev), *recs, params=p,
                               drain=sk_ref.make_drain(500, dev))
    st_p, dr_p = sk_ref.insert_plain(sk_ref.make_state(p, dev),
                                     sk_ref.make_drain(500, dev), *recs, H=2)
    _assert_equal(st_k, st_p)
    _assert_equal(dr_k, dr_p)
    assert int(dr_k["d_n"]) > p.L


def test_sketch_kernel_rejects_oversized_state(dev):
    p = SketchParams(d=8, m=8192, L=64)             # 16·d·m > 232,448 B
    args = [torch.from_numpy(x).to(dev) for x in _runs(0, 4, 4)]
    with pytest.raises(ValueError, match="shared memory"):
        sk_ops.insert_runs(sk_ref.make_state(p, dev),
                           sk_ref.make_drain(4, dev), *args, params=p)


def test_sketch_kernel_continues_from_state(dev):
    """A second launch builds its index, bitmap and ring from the state
    the first left (full Stage 2, evictions on both calls)."""
    p = SketchParams(d=2, m=32, H=2, L=4)
    st_k = st_p = sk_ref.make_state(p, dev)
    dr_k = dr_p = sk_ref.make_drain(400, dev)
    for seed in (6, 7):
        args = [torch.from_numpy(x).to(dev) for x in _runs(seed, 200, 40)]
        st_k, dr_k = sk_ops.insert_runs(st_k, dr_k, *args, params=p)
        st_p, dr_p = sk_ref.insert_runs_plain(st_p, dr_p, *args, H=p.H)
        _assert_equal(st_k, st_p)
        _assert_equal(dr_k, dr_p)
    assert int(dr_k["d_n"]) > p.L


def test_sketch_kernel_two_sketches_one_launch(dev):
    jobs = []
    for p, (seed, n, n_keys) in ((SketchParams(d=2, m=1024, H=8, L=1024),
                                  (20, 600, 300)),
                                 (SketchParams(d=3, m=64, H=2, L=8),
                                  (21, 400, 80))):
        args = tuple(torch.from_numpy(x).to(dev)
                     for x in _runs(seed, n, n_keys))
        jobs.append((sk_ref.make_state(p, dev), sk_ref.make_drain(n, dev),
                     args, p))
    before = _lib.LAUNCHES["sketch_insert_runs"]
    got = sk_ops.insert_runs_many(jobs)
    assert _lib.LAUNCHES["sketch_insert_runs"] == before + 1
    for (st_k, dr_k), (st0, dr0, args, p) in zip(got, jobs):
        st_p, dr_p = sk_ref.insert_runs_plain(st0, dr0, *args, H=p.H)
        _assert_equal(st_k, st_p)
        _assert_equal(dr_k, dr_p)
    assert int(got[1][1]["d_n"]) > 0


def test_sketch_kernel_refuses_more_sketches_than_it_takes(dev):
    p = SketchParams(d=1, m=8, H=2, L=2)
    args = tuple(torch.from_numpy(x).to(dev) for x in _runs(0, 4, 4))
    jobs = [(sk_ref.make_state(p, dev), sk_ref.make_drain(4, dev), args, p)]
    assert len(sk_ops.insert_runs_many(jobs * 8)) == 8
    with pytest.raises(RuntimeError, match="cudaError_t"):
        sk_ops.insert_runs_many(jobs * 9)


@pytest.mark.parametrize("bit", range(4))
def test_sketch_kernel_rejects_a_broken_state(dev, bit):
    p = SketchParams(d=2, m=32, H=2, L=4)
    args = [torch.from_numpy(x).to(dev) for x in _runs(6, 80, 20)]
    st, _ = sk_ops.insert_runs(sk_ref.make_state(p, dev),
                               sk_ref.make_drain(80, dev), *args, params=p)
    assert bool((st["s2_valid"] == 1).all())
    if bit == 0:                        # the oldest row: the rest stay in range
        st["s2_valid"][int(st["s2_arrival"].argmin())] = 2
    elif bit == 1:
        st["s2_arrival"][2] = st["counter"]
    elif bit == 2:
        st["s2_arrival"][3] = st["s2_arrival"][0]
    else:
        st["s2_lo"][1], st["s2_hi"][1] = st["s2_lo"][0], st["s2_hi"][0]
    with pytest.raises(ValueError, match=sk_ref.PRECONDITION[bit]):
        sk_ops.insert_runs(st, sk_ref.make_drain(80, dev), *args, params=p)


def _failrank_inputs(dev, n):
    rng = np.random.default_rng(n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    return [torch.from_numpy(a).to(dev) for a in
            (w, rng.random((n, n)).astype(np.float32),
             rng.random(n).astype(np.float32),
             rng.random(n).astype(np.float32))]


@pytest.mark.parametrize("n", [68, 260, 1028, 8200])
def test_failrank_kernel_matches_plain(dev, n):
    x = _failrank_inputs(dev, n)
    before = _lib.LAUNCHES["failrank_step"]
    s_k, l_k = fr_ops.failrank_step(*x)
    assert _lib.LAUNCHES["failrank_step"] == before + 1
    s_p, l_p = failrank_step_ref(*x)
    torch.testing.assert_close(s_k, s_p, atol=1e-5, rtol=0)
    assert torch.equal(l_k, l_p)


@pytest.mark.parametrize("n", [68, 260, 1028])
def test_failrank_loop_matches_plain_loop(dev, n):
    """The whole iteration in one launch (W and L in shared memory at 68
    and 260, in device memory at 1,028) against the plain loop."""
    x = _failrank_inputs(dev, n)
    before = _lib.LAUNCHES["failrank_step"]
    s_k, l_k, it_k = fr_ops.failrank_iterate(*x)
    assert _lib.LAUNCHES["failrank_step"] == before + 1
    s_p, l_p, it_p = failrank_iterate_ref(*x)
    gap = abs(int(it_k) - int(it_p))
    assert gap <= 1 and int(it_k) > 1
    tol = 1e-5 if gap == 0 else 1e-4
    torch.testing.assert_close(s_k, s_p, atol=tol, rtol=0)
    torch.testing.assert_close(l_k, l_p, atol=tol, rtol=0)


@pytest.mark.parametrize("n", [68, 260])
def test_failrank_loop_in_device_memory_matches_plain_loop(dev, n):
    """The device-memory path at the sizes the shared-memory path takes."""
    x = _failrank_inputs(dev, n)
    s_k, l_k, it_k = fr_ops.failrank_iterate_cuda(*x, stripes="device")
    s_p, l_p, it_p = failrank_iterate_ref(*x)
    gap = abs(int(it_k) - int(it_p))
    assert gap <= 1 and int(it_k) > 1
    tol = 1e-5 if gap == 0 else 1e-4
    torch.testing.assert_close(s_k, s_p, atol=tol, rtol=0)
    torch.testing.assert_close(l_k, l_p, atol=tol, rtol=0)


def _attn_inputs(dev, b, s, t, hq, hk, d):
    rng = np.random.default_rng(s * t + d)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev) for shape in ((b, s, hq, d), (b, t, hk, d),
                                   (b, t, hk, d))]


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", [
    (2, 128, 128, 4, 2, 64, True, None), (1, 256, 256, 2, 2, 32, True, 64),
    (2, 100, 200, 4, 1, 16, False, None), (1, 1, 384, 8, 4, 64, True, None),
    (2, 70, 70, 4, 4, 128, True, 20)])
def test_attention_kernel_matches_plain(dev, b, s, t, hq, hk, d, causal,
                                        win):
    q, k, v = _attn_inputs(dev, b, s, t, hq, hk, d)
    q_pos = torch.arange(s, dtype=torch.int32, device=dev)
    k_pos = torch.arange(t, dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention"]
    got = fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               causal=causal, window=win)
    assert _lib.LAUNCHES["flash_attention"] == before + 1
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                        window=win)
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [None, 100])
def test_attention_kernel_over_a_rolled_cache(dev, window):
    """Decode and a few queries over a 256-slot cache holding positions
    100..399 at slots pos % 256, some slots empty (−1)."""
    k_pos = torch.from_numpy(rolled_pos_tab(256, 100, 399, [0, 9, 200])
                             ).to(dev)
    for s in (1, 3):
        q, k, v = _attn_inputs(dev, 2, s, 256, 6, 2, 64)
        q_pos = torch.arange(400 - s, 400, dtype=torch.int32, device=dev)
        got = fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                   window=window)
        exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                            window=window)
        torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)


def test_attention_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _attn_inputs(dev, 1, 8, 8, 2, 2, 64)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fa_ops.gqa_attention(q.half(), k.half(), v.half(), q_pos=pos,
                             k_pos=pos)
    with pytest.raises(ValueError, match="int32"):
        fa_ops.gqa_attention(q, k, v, q_pos=pos.long(), k_pos=pos)
    for d in (12, 136):  # not a multiple of 8, wider than 128
        q, k, v = _attn_inputs(dev, 1, 8, 8, 2, 2, d)
        with pytest.raises(ValueError, match=f"head dim {d} "):
            fa_ops.gqa_attention(q, k, v, q_pos=pos, k_pos=pos)


def _ssd_inputs(dev, b, s, h, p, g, n, seed):
    return [torch.from_numpy(a).to(dev)
            for a in random_inputs(seed, b, s, h, p, g, n)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
    (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32),
    (1, 300, 16, 64, 2, 128, 128), (2, 24, 4, 32, 2, 16, 24)])
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk):
    *args, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s + chunk)
    for init in (None, s0):
        before = _lib.LAUNCHES["ssd_scan"]
        yk, sk = ssd_ops.ssd(*args, chunk=chunk, init_state=init)
        assert _lib.LAUNCHES["ssd_scan"] == before + 1
        yp, sp = ssd_ref(*args, chunk=chunk, init_state=init)
        torch.testing.assert_close(yk, yp, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(sk, sp, atol=2e-4, rtol=2e-4)


def test_ssd_kernel_rejects_what_it_does_not_take(dev):
    *args, _ = _ssd_inputs(dev, 1, 40, 4, 16, 2, 8, 0)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd(*args, chunk=256)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd(args[0].double(), *args[1:], chunk=16)
    *args, _ = _ssd_inputs(dev, 1, 8, 3, 16, 2, 8, 0)
    with pytest.raises(ValueError, match="groups"):
        ssd_ops.ssd(*args, chunk=16)
    # more chunks x heads, or batches, than a grid's y / z extent
    steps = ssd_ops.MAX_GRID_YZ // 2 + 1
    *args, _ = _ssd_inputs(dev, 1, steps, 2, 4, 1, 4, 0)
    with pytest.raises(ValueError, match="grid"):
        ssd_ops.ssd(*args, chunk=1)
    *args, _ = _ssd_inputs(dev, ssd_ops.MAX_GRID_YZ + 1, 1, 1, 4, 1, 4, 0)
    with pytest.raises(ValueError, match="grid"):
        ssd_ops.ssd(*args, chunk=1)
    # the backward: a cotangent of another shape, a scratch of another call
    *args, _ = _ssd_inputs(dev, 1, 40, 4, 16, 2, 8, 0)
    y, _, saved = ssd_ops.ssd_fwd_cuda(*args, chunk=16)
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_bwd_cuda(*args, y[:, :-1], None, saved=saved, chunk=16)
    with pytest.raises(ValueError, match="saved"):
        ssd_ops.ssd_bwd_cuda(*args, y, None, saved=saved[:-1], chunk=16)


@pytest.mark.parametrize("t_max,first,last,empty,s,hq,hk,d,window", [
    (200, 0, 149, [], 1, 9, 3, 64, None),             # dead last split
    (256, 100, 611, list(range(64, 128)), 1, 8, 1, 16, None),  # empty split
    (256, 100, 611, [5, 70], 1, 3, 3, 32, 40),         # splits outside window
    (1024, 600, 1299, [5, 77, 700, 1023], 1, 9, 3, 64, 256),
    (1024, 600, 1299, [5, 77, 700, 1023], 1, 9, 3, 64, None),
    (300, 0, 299, [], 2, 8, 1, 128, None),             # 16 rows: decode
    (300, 0, 299, [], 3, 6, 1, 32, 100),               # 18 rows: prefill
    (70, 0, 69, [0, 1], 16, 2, 2, 16, None),           # 16 rows: decode
    (70, 0, 69, [0, 1], 17, 2, 2, 64, 30),             # 17 rows: prefill
])
def test_attention_entry_points_over_rolled_caches(dev, t_max, first, last,
                                                   empty, s, hq, hk, d,
                                                   window):
    """Both entry points, picked by the wrapper from S · Hq/Hkv, against
    the plain version over rolled, partly empty caches."""
    q, k, v = _attn_inputs(dev, 2, s, t_max, hq, hk, d)
    k_pos = torch.from_numpy(rolled_pos_tab(t_max, first, last, empty)
                             ).to(dev)
    q_pos = torch.arange(last + 1 - s, last + 1, dtype=torch.int32,
                         device=dev)
    entry = ("flash_attention_decode" if fa_ops.uses_decode(s, hq, hk)
             else "flash_attention_prefill")
    before = dict(_lib.LAUNCHES)
    got = fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               window=window)
    assert _lib.LAUNCHES[entry] == before[entry] + 1
    assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window)
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)
    split = split_attention_ref(q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(),
                                k_pos=k_pos.cpu(), window=window)
    torch.testing.assert_close(got.cpu(), split, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("hq,hk", [(4, 4), (9, 3), (16, 2)])
def test_attention_decode_head_dims_and_groups(dev, d, hq, hk):
    """One decode row per query head over 200 slots (not a multiple of the
    64-key split), GQA ratios 1, 3 and 8."""
    q, k, v = _attn_inputs(dev, 3, 1, 200, hq, hk, d)
    k_pos = torch.from_numpy(rolled_pos_tab(200, 0, 180, [7, 100])).to(dev)
    q_pos = torch.tensor([180], dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention_decode"]
    got = fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos)
    assert _lib.LAUNCHES["flash_attention_decode"] == before + 1
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos)
    torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)


def test_attention_decode_row_without_keys_is_zero(dev):
    q, k, v = _attn_inputs(dev, 1, 1, 130, 3, 1, 64)
    k_pos = torch.full((130,), -1, dtype=torch.int32, device=dev)
    got = fa_ops.gqa_attention(q, k, v, q_pos=torch.tensor(
        [5], dtype=torch.int32, device=dev), k_pos=k_pos)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 100, 8, 64, 2, 128, 16), (1, 100, 4, 32, 4, 64, 24),
    (2, 300, 16, 64, 8, 128, 128), (1, 130, 2, 72, 1, 70, 128),
    (3, 77, 6, 16, 3, 16, 24), (1, 300, 4, 16, 2, 16, 16)])
def test_ssd_kernel_chunk_parallel_phases(dev, b, s, h, p, g, n, chunk):
    """Chunks 16, 24 and 128 with a ragged last chunk, P and N that are not
    multiples of the 64-wide tiles, more chunks (19) than the state pass
    keeps in flight, from a zero and a non-zero state."""
    *args, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s * chunk)
    assert s % chunk
    for init in (None, s0):
        yk, sk = ssd_ops.ssd(*args, chunk=chunk, init_state=init)
        yp, sp = ssd_ref(*args, chunk=chunk, init_state=init)
        torch.testing.assert_close(yk, yp, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(sk, sp, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("hq,hk,window", [(32, 8, 4096), (12, 2, None)])
def test_attention_at_the_moe_and_mrope_serving_shapes(dev, hq, hk, window):
    """mixtral-8x7b's (32 query heads over 8, window 4,096) and
    qwen2-vl-2b's (12 over 2) head dim 128: a 4 × 512 prefill, and a
    decode step over the serve run's fill of a 1,024-slot cache (positions
    0..543, the rest empty)."""
    q, k, v = _attn_inputs(dev, 4, 512, 512, hq, hk, 128)
    pos = torch.arange(512, dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention_prefill"]
    got = fa_ops.gqa_attention(q, k, v, q_pos=pos, k_pos=pos, window=window)
    assert _lib.LAUNCHES["flash_attention_prefill"] == before + 1
    torch.testing.assert_close(
        got, attention_ref(q, k, v, q_pos=pos, k_pos=pos, window=window),
        atol=2e-5, rtol=2e-5)
    q, k, v = _attn_inputs(dev, 4, 1, 1024, hq, hk, 128)
    k_pos = torch.full((1024,), -1, dtype=torch.int32, device=dev)
    k_pos[:544] = torch.arange(544, dtype=torch.int32, device=dev)
    q_pos = torch.tensor([543], dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention_decode"]
    got = fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                               window=window)
    assert _lib.LAUNCHES["flash_attention_decode"] == before + 1
    torch.testing.assert_close(
        got, attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_two_runs_are_bit_identical(dev, arch):
    """One MoE layer at the config's full width (dbrx: 16 experts, top-4,
    12.7 GB of f32 weights) on 4 × 512 tokens, twice: equal outputs, aux
    and routing (no atomics in the dispatch or the combine)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.ParamBlock(L.map_leaves(lambda leaf: L.draw(gen, leaf),
                                  L.init_moe(cfg)))
    x = torch.randn(4, 512, cfg.d_model, device=dev, generator=gen)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            r = L.moe_route(cfg, p, x.reshape(-1, cfg.d_model))
            runs.append((*L.moe(cfg, p, x), r.gate_idx, r.keep, r.slot))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(runs[0][0]).all())


def test_full_width_mixtral_layer_serves_through_the_kernel(dev,
                                                            monkeypatch):
    """mixtral-8x7b at full width with one layer: a 2 × 64 prefill and
    one decode step launch K3's prefill and decode entry points once each,
    never the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    def refuse(*a, **kw):
        raise AssertionError("attention reached its plain version")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=1)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=dev,
                         dtype=torch.int32)
    _lib.reset_launches()
    cache = T.init_cache(cfg, 2, 128, device=dev, dtype=torch.float32)
    last, cache, _ = T.prefill(cfg, model, toks, cache)
    out, cache = T.decode_step(cfg, model, last[:, -1].argmax(-1)[:, None],
                               cache, 64)
    assert _lib.LAUNCHES["flash_attention_prefill"] == 1
    assert _lib.LAUNCHES["flash_attention_decode"] == 1
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kernel", ["decode", "prefill", "ssd", "ssd_bwd",
                                    "sketch", "failrank"])
def test_two_runs_are_bit_identical(dev, kernel):
    if kernel == "sketch":                      # with evictions
        p = SketchParams(L=256)
        args = [torch.from_numpy(x).to(dev) for x in _runs(3, 2000, 1500)]
        runs = [sum((tuple(sk_ops.insert_runs(
            sk_ref.make_state(p, dev), sk_ref.make_drain(2000, dev), *args,
            params=p)[i].values()) for i in (0, 1)), ())
            for _ in range(2)]
        assert int(runs[0][-1]) > 0             # d_n, the drain's count
    elif kernel == "failrank":
        x = _failrank_inputs(dev, 260)
        runs = [fr_ops.failrank_iterate(*x) for _ in range(2)]
    elif kernel == "ssd":
        *args, s0 = _ssd_inputs(dev, 4, 512, 64, 64, 8, 128, 5)
        runs = [ssd_ops.ssd(*args, chunk=128, init_state=s0)
                for _ in range(2)]
    elif kernel == "ssd_bwd":
        *args, s0 = _ssd_inputs(dev, 4, 512, 64, 64, 8, 128, 5)
        dy, ds = _ssd_cotangents(dev, 4, 512, 64, 64, 128, 5)
        saved = ssd_ops.ssd_fwd_cuda(*args, chunk=128, init_state=s0)[2]
        runs = [ssd_ops.ssd_bwd_cuda(*args, dy, ds, saved=saved, chunk=128,
                                     init_state=s0) for _ in range(2)]
    else:
        s = 1 if kernel == "decode" else 200
        q, k, v = _attn_inputs(dev, 4, s, 1024, 9, 3, 64)
        k_pos = torch.full((1024,), -1, dtype=torch.int32, device=dev)
        k_pos[:544] = torch.arange(544, dtype=torch.int32, device=dev)
        q_pos = torch.arange(544 - s, 544, dtype=torch.int32, device=dev)
        runs = [(fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos),)
                for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the campaign path on the card: streaming, executors
# ---------------------------------------------------------------------------

def _darknet_trace():
    from repro_torch.core.failures import FailSlow
    from repro_torch.core.graph import build_workload
    from repro_torch.core.routing import Mesh2D
    from repro_torch.core.sloth import Sloth
    sloth = Sloth(build_workload("darknet19"), Mesh2D(4), device="cpu")
    return (sloth.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0),
            sloth.sim_cfg.hop_latency)


@pytest.mark.parametrize("L,n_chunks", [(1024, 4), (8, 7)])
def test_streaming_recorder_on_the_card(dev, L, n_chunks):
    """Each ``observe`` launches the sketch kernel once, from the state the
    last chunk left; the streamed output equals one-shot recording on the
    card and the CPU's plain path, bit for bit (patterns are compared with
    ``==``, float statistics included)."""
    from repro_torch.core.recorder import record
    from repro_torch.core.streaming import StreamingRecorder, split_sim
    sim, hop = _darknet_trace()
    p = SketchParams(d=2, m=256 if L == 8 else 1024, H=4 if L == 8 else 8,
                     L=L)
    chunks = split_sim(sim, n_chunks)
    live = sum(bool(len(c.comp["core"]) or len(c.comm["src"]))
               for c in chunks)
    outs = {}
    for where in (dev, "cpu"):
        rec = StreamingRecorder(p, hop_latency=hop, impl="batched",
                                device=where)
        before = _lib.LAUNCHES["sketch_insert_runs"]
        for c in chunks:
            rec.observe(c)
        launches = _lib.LAUNCHES["sketch_insert_runs"] - before
        assert launches == (live if where == dev else 0)
        outs[str(where)] = rec.output()
    one = record(sim, p, hop_latency=hop, impl="batched", device=dev)
    for out in outs.values():
        assert out.comp_patterns == one.comp_patterns
        assert out.comm_patterns == one.comm_patterns
        for f in ("sketch_comp_bytes", "sketch_comm_bytes",
                  "n_comp_drained", "n_comm_drained", "n_comp_records",
                  "n_comm_records"):
            assert getattr(out, f) == getattr(one, f), f
    if L == 8:
        assert one.n_comp_drained > 0 and one.n_comm_drained > 0


def _judged(outcomes):
    """Every compared field of the outcomes but the scores, and the
    scores."""
    import dataclasses
    rows, scores = [], []
    for o in outcomes:
        rows.append((dataclasses.replace(o, detector_results=()),
                     [dataclasses.replace(d, score=0.0)
                      for d in o.detector_results]))
        scores += [d.score for d in o.detector_results]
    return rows, scores


def test_tiny_campaign_on_the_card(dev):
    """The ``--tiny`` grid with all detectors, 4 streamed chunks, remap and
    reroute on the card: serial equals the CPU port's (scores within
    ``rel=1e-5``, FailRank adding in another order there; all else exact),
    and the thread executor equals serial exactly."""
    from repro_torch.core.campaign import (CampaignGrid, DeploymentCache,
                                           run_campaign)
    from repro_torch.core.detectors import DEFAULT_DETECTORS
    from repro_torch.core.sloth import SlothConfig
    grid = CampaignGrid(workloads=("darknet19",), meshes=(4,),
                        severities=(8.0,), reps=1, campaign_seed=0)
    kw = dict(detectors=DEFAULT_DETECTORS, streaming=4,
              mitigation=("remap", "reroute", "none"),
              cfg=SlothConfig(recorder_impl="batched"))
    _lib.reset_launches()
    card = run_campaign(grid, workers=0, device=dev,
                        cache=DeploymentCache(), **kw)
    assert _lib.LAUNCHES["sketch_insert_runs"] >= 4
    cpu = run_campaign(grid, workers=0, device="cpu",
                       cache=DeploymentCache(), **kw)
    (rows_g, s_g), (rows_c, s_c) = _judged(card.outcomes), \
        _judged(cpu.outcomes)
    assert rows_g == rows_c
    assert s_g == pytest.approx(s_c, rel=1e-5)
    thread = run_campaign(grid, workers=4, executor="thread", device=dev,
                          cache=DeploymentCache(), **kw)
    assert thread.outcomes == card.outcomes
    assert thread.mitigation == card.mitigation


# ---------------------------------------------------------------------------
# the train path on the card: K3's backward, the SSD guard, a train step
# ---------------------------------------------------------------------------

def _bwd_grads(q, k, v, dout, attend, **pos):
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    attend(qa, ka, va, **pos).backward(dout)
    return qa.grad, ka.grad, va.grad


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", [
    (4, 512, 512, 9, 3, 64, True, None), (2, 300, 300, 8, 2, 32, True, 100),
    (2, 200, 200, 6, 2, 16, True, None), (2, 130, 130, 8, 2, 128, True, None),
    (1, 100, 160, 4, 4, 64, False, None), (2, 3, 70, 6, 1, 32, True, 20)])
def test_attention_backward_matches_autograd_of_plain(dev, b, s, t, hq, hk,
                                                      d, causal, win):
    """K3's backward through ``gqa_attention`` against torch autograd
    through the plain version: within 1e-4 of each gradient's largest
    entry; the forward took the prefill entry point (it writes the
    log-sum-exp) and the backward launched once."""
    q, k, v = _attn_inputs(dev, b, s, t, hq, hk, d)
    dout = _attn_inputs(dev, b, s, s, hq, hk, d)[0]
    pos = dict(q_pos=torch.arange(t - s, t, dtype=torch.int32, device=dev),
               k_pos=torch.arange(t, dtype=torch.int32, device=dev),
               causal=causal, window=win)
    before = dict(_lib.LAUNCHES)
    got = _bwd_grads(q, k, v, dout, fa_ops.gqa_attention, **pos)
    assert _lib.LAUNCHES["flash_attention_bwd"] \
        == before["flash_attention_bwd"] + 1
    assert _lib.LAUNCHES["flash_attention_prefill"] \
        == before["flash_attention_prefill"] + 1
    exp = _bwd_grads(q, k, v, dout, attention_ref, **pos)
    for g, e in zip(got, exp):
        assert g.shape == e.shape
        assert float((g - e).abs().max()) <= 1e-4 * float(e.abs().max())


def test_attention_backward_two_runs_bit_identical(dev):
    q, k, v = _attn_inputs(dev, 4, 512, 512, 9, 3, 64)
    dout = _attn_inputs(dev, 4, 512, 512, 9, 3, 64)[0]
    pos = torch.arange(512, dtype=torch.int32, device=dev)
    a, b = (_bwd_grads(q, k, v, dout, fa_ops.gqa_attention, q_pos=pos,
                       k_pos=pos) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_attention_lse_output_leaves_the_prefill_unchanged(dev):
    """The prefill with a null ``lse`` writes what it writes with one, and
    the log-sum-exp equals the plain one."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    q, k, v = _attn_inputs(dev, 2, 200, 200, 8, 2, 64)
    pos = torch.arange(200, dtype=torch.int32, device=dev)
    plain = fa_ops.flash_attention_cuda(q, k, v, q_pos=pos, k_pos=pos,
                                        window=50)
    out, lse = fa_ops._prefill(q, k, v, q_pos=pos, k_pos=pos, window=50)
    assert torch.equal(out, plain)
    torch.testing.assert_close(lse, attention_lse_ref(
        q, k, q_pos=pos, k_pos=pos, window=50), atol=2e-5, rtol=2e-5)
    # a decode-shaped call that needs a gradient takes the prefill too
    q1 = _attn_inputs(dev, 2, 1, 200, 8, 2, 64)[0].requires_grad_(True)
    before = _lib.LAUNCHES["flash_attention_prefill"]
    fa_ops.gqa_attention(q1, k, v, q_pos=pos[-1:], k_pos=pos)
    assert _lib.LAUNCHES["flash_attention_prefill"] == before + 1


def _ssd_cotangents(dev, b, s, h, p, n, seed):
    return tuple(torch.from_numpy(t).to(dev)
                 for t in ssd_plain.random_cotangents(seed, b, s, h, p, n))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
    (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32),
    (1, 300, 16, 64, 2, 128, 128), (2, 24, 4, 32, 2, 16, 24),
    (1, 130, 2, 72, 1, 70, 128), (4, 512, 64, 64, 8, 128, 128)])
def test_ssd_backward_matches_plain_and_autograd(dev, b, s, h, p, g, n,
                                                 chunk):
    """K4's backward through ``ssd`` (``SSDScan``) against its plain
    mirror and torch autograd through the plain scan, from a zero and a
    non-zero state, with and without a final-state cotangent: within 1e-4
    of each gradient's largest entry; one forward and one backward launch
    a call."""
    *args, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s + chunk)
    dy, ds_rand = _ssd_cotangents(dev, b, s, h, p, n, s + chunk)
    for init in (None, s0):
        for ds in (None, ds_rand):
            before = dict(_lib.LAUNCHES)
            got = ssd_plain.autograd_grads(ssd_ops.ssd, args, init, dy, ds,
                                           chunk=chunk)
            assert _lib.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
            assert _lib.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
            mirror = ssd_bwd_ref(*args, dy, ds, chunk=chunk, init_state=init)
            auto = ssd_plain.autograd_grads(ssd_ref, args, init, dy, ds,
                                            chunk=chunk)
            for g_, m_, a_ in zip(got, mirror, auto):
                if m_ is None:
                    assert g_ is None and a_ is None
                    continue
                for e in (m_, a_):
                    assert float((g_ - e).abs().max()) \
                        <= 1e-4 * float(e.abs().max())


def test_full_size_mamba2_train_step_goes_through_the_kernels(dev,
                                                              monkeypatch):
    """One mamba2-1.3b train step at full size (batch 2 × 256, two
    chunks): 48 K4 forward and 48 backward launches, no call of the plain
    scan or its mirror, no attention launch, a finite loss and grad
    norm."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    def refuse(*a, **kw):
        raise AssertionError("the SSD scan reached its plain version")
    monkeypatch.setattr(ssd_ops, "ssd_ref", refuse)
    monkeypatch.setattr(ssd_plain, "ssd_bwd_ref", refuse)
    cfg = get_config("mamba2-1.3b")
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    toks = torch.randint(0, cfg.vocab, (2, 256), device=dev,
                         dtype=torch.int32)
    _lib.reset_launches()
    state, loss, gnorm = S.make_train_step(cfg, S.CellPlan(), opt_cfg)(
        model, state, toks)
    assert _lib.LAUNCHES["ssd_scan"] == 48
    assert _lib.LAUNCHES["ssd_scan_bwd"] == 48
    assert _lib.LAUNCHES["flash_attention"] == 0
    assert np.isfinite(loss.item()) and np.isfinite(gnorm.item())
    assert state["step"] == 1


def test_full_size_train_step_goes_through_the_kernels(dev, monkeypatch):
    """One smollm-135m train step at full size (batch 2 × 128): 30 K3
    forward and 30 backward launches, no call of the plain attention, a
    finite loss and grad norm."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    def refuse(*a, **kw):
        raise AssertionError("attention reached its plain version")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    cfg = get_config("smollm-135m")
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=dev,
                         dtype=torch.int32)
    _lib.reset_launches()
    state, loss, gnorm = S.make_train_step(cfg, S.CellPlan(), opt_cfg)(
        model, state, toks)
    assert _lib.LAUNCHES["flash_attention_prefill"] == 30
    assert _lib.LAUNCHES["flash_attention_bwd"] == 30
    assert _lib.LAUNCHES["flash_attention_decode"] == 0
    assert np.isfinite(loss.item()) and np.isfinite(gnorm.item())
    assert state["step"] == 1


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper) and MoE training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,hq,hk,d", [
    (2, 70, 150, 4, 4, 64), (1, 130, 90, 6, 2, 32), (2, 150, 1500, 2, 2, 16)])
def test_non_causal_attention_with_s_not_t(dev, b, s, t, hq, hk, d):
    """Cross-attention's shapes: S queries over T ≠ S keys, every key live
    (no causal mask, no window), the query positions below most keys.  The
    forward within 2e-5 of the plain version; the backward (the forward
    then through the prefill entry point) within 1e-4 of each gradient's
    largest entry against autograd through it, bit-identical twice."""
    q, k, v = _attn_inputs(dev, b, s, t, hq, hk, d)
    dout = _attn_inputs(dev, b, s, s, hq, hk, d)[0]
    pos = dict(q_pos=torch.arange(s, dtype=torch.int32, device=dev),
               k_pos=torch.arange(t, dtype=torch.int32, device=dev),
               causal=False)
    before = _lib.LAUNCHES["flash_attention_prefill"]
    got = fa_ops.gqa_attention(q, k, v, **pos)
    assert _lib.LAUNCHES["flash_attention_prefill"] == before + 1
    torch.testing.assert_close(got, attention_ref(q, k, v, **pos),
                               atol=2e-5, rtol=2e-5)
    before = _lib.LAUNCHES["flash_attention_bwd"]
    runs = [_bwd_grads(q, k, v, dout, fa_ops.gqa_attention, **pos)
            for _ in range(2)]
    assert _lib.LAUNCHES["flash_attention_bwd"] == before + 2
    exp = _bwd_grads(q, k, v, dout, attention_ref, **pos)
    for g, g2, e in zip(*runs, exp):
        assert torch.equal(g, g2)
        assert float((g - e).abs().max()) <= 1e-4 * float(e.abs().max())


@pytest.mark.parametrize("t,hq,hk,d", [(1500, 20, 20, 64), (200, 4, 4, 16),
                                       (130, 8, 2, 128)])
def test_non_causal_split_key_decode_below_its_keys(dev, t, hq, hk, d):
    """A cross-attention decode step: one query at position 10 over keys
    0..T−1 (T not a multiple of the 64-key split), non-causal, so the
    keys after the query's position stay live.  Through the split-key
    decode; within 2e-5 of the plain version; bit-identical twice."""
    q, k, v = _attn_inputs(dev, 4, 1, t, hq, hk, d)
    pos = dict(q_pos=torch.tensor([10], dtype=torch.int32, device=dev),
               k_pos=torch.arange(t, dtype=torch.int32, device=dev),
               causal=False)
    before = _lib.LAUNCHES["flash_attention_decode"]
    got, again = (fa_ops.gqa_attention(q, k, v, **pos) for _ in range(2))
    assert _lib.LAUNCHES["flash_attention_decode"] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, attention_ref(q, k, v, **pos),
                               atol=2e-5, rtol=2e-5)
    # the causal mask would leave keys 0..10 only: the answers differ
    causal = attention_ref(q, k, v, q_pos=pos["q_pos"], k_pos=pos["k_pos"])
    assert not torch.allclose(got, causal)


def test_whisper_smoke_serves_twice_with_equal_tokens(dev, monkeypatch):
    """``launch.serve.main`` on whisper's smoke config on the card, twice:
    equal tokens; per batch 2 encoder, 2 self and 2 cross attentions at the
    prefill and 4 a decode step, all through the kernel (a prompt of at
    most 16 tokens takes the decode entry point at its prefill too)."""
    from repro_torch.launch import serve

    def refuse(*a, **kw):
        raise AssertionError("attention reached its plain version")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    argv = ["--arch", "whisper-large-v3", "--smoke", "--requests", "5",
            "--max-new", "4", "--device", "cuda:0"]
    runs = []
    for _ in range(2):
        _lib.reset_launches()
        done, stats = serve.main(argv)
        runs.append([r.out_tokens for r in done])
        assert stats["tokens"] == 20
        assert _lib.LAUNCHES["flash_attention"] == 2 * (6 + 4 * 4)
        assert _lib.LAUNCHES["flash_attention_decode"] >= 2 * 4 * 4
    assert runs[0] == runs[1]


@pytest.mark.parametrize("arch,experts,top_k", [
    ("mixtral-8x7b", None, None), ("dbrx-132b", 16, 4)])
def test_moe_smoke_train_steps_are_bit_identical(dev, arch, experts, top_k):
    """Three train steps of a MoE smoke config on the card (dbrx's with its
    full config's 16 experts and top-4), twice from one seed: the losses,
    grad norms and every parameter after the last step equal bit for bit
    (the dispatch's and the combine's backward add into shared rows)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config(arch, smoke=True)
    if experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=experts, top_k=top_k)
    toks = torch.randint(0, cfg.vocab, (3, 4, 64), device=dev,
                         dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    runs = []
    for _ in range(2):
        model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.float32)
        opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
        state = adamw.init_state(list(model.parameters()), opt_cfg)
        step = S.make_train_step(cfg, S.CellPlan(), opt_cfg)
        out = []
        for tok in toks:
            state, loss, gnorm = step(model, state, tok)
            out += [loss, gnorm]
        runs.append(out + [p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(bool(torch.isfinite(x).all()) for x in runs[0])


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

#: bf16 kernels against their plain versions in bf16: within this many
#: ulps of each output row's largest |entry| (its last dimension).
BF16_ULPS = 4


def _assert_bf16_rows_close(got, exp, ulps=BF16_ULPS):
    assert got.dtype == exp.dtype == torch.bfloat16
    g, e = got.float(), exp.float()
    top = e.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    gap = (g - e).abs()
    assert bool((gap <= ulps * ulp).all()), float((gap / ulp).max())


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", [
    (2, 128, 128, 4, 2, 64, True, None), (1, 256, 256, 2, 2, 32, True, 64),
    (2, 100, 200, 4, 1, 16, False, None), (1, 1, 384, 8, 4, 64, True, None),
    (2, 70, 70, 4, 4, 128, True, 20), (2, 130, 130, 14, 2, 128, True, None),
    (1, 200, 300, 4, 4, 64, False, None)])
def test_bf16_attention_kernel_matches_plain(dev, b, s, t, hq, hk, d,
                                             causal, win):
    """Both bf16 entry points (tensor-core prefill, split-key decode) over
    arange positions, causal, windowed and non-causal, GQA 1-7."""
    q, k, v = (x.bfloat16() for x in _attn_inputs(dev, b, s, t, hq, hk, d))
    q_pos = torch.arange(s, dtype=torch.int32, device=dev)
    k_pos = torch.arange(t, dtype=torch.int32, device=dev)
    kind = "decode" if fa_ops.uses_decode(s, hq, hk) else "prefill"
    before = dict(_lib.LAUNCHES)
    runs = [fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                 causal=causal, window=win)
            for _ in range(2)]
    assert _lib.LAUNCHES[f"flash_attention_bf16_{kind}"] \
        == before[f"flash_attention_bf16_{kind}"] + 2
    assert _lib.LAUNCHES["flash_attention"] == before["flash_attention"]
    assert torch.equal(*runs)
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                        window=win)
    _assert_bf16_rows_close(runs[0], exp)


@pytest.mark.parametrize("t_max,first,last,empty,s,hq,hk,d,window", [
    (1024, 0, 543, list(range(544, 1024)), 1, 56, 8, 128, None),
    (1024, 600, 1299, [5, 77, 700, 1023], 1, 9, 3, 64, 256),
    (256, 100, 611, list(range(64, 128)), 1, 8, 1, 16, None),
    (300, 0, 299, [], 2, 8, 1, 128, None),
    (70, 0, 69, [0, 1], 17, 2, 2, 64, 30)])
def test_bf16_attention_over_rolled_caches(dev, t_max, first, last, empty, s,
                                           hq, hk, d, window):
    """bf16 decode (and a 17-row prefill) over rolled, partly empty caches,
    yi-34b's GQA 7 at head dim 128 among them; against the plain version
    and the plain split-key algebra."""
    q, k, v = (x.bfloat16() for x in _attn_inputs(dev, 2, s, t_max, hq, hk,
                                                  d))
    k_pos = torch.from_numpy(rolled_pos_tab(t_max, first, last, empty)
                             ).to(dev)
    q_pos = torch.arange(last + 1 - s, last + 1, dtype=torch.int32,
                         device=dev)
    runs = [fa_ops.gqa_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                 window=window) for _ in range(2)]
    assert torch.equal(*runs)
    _assert_bf16_rows_close(runs[0], attention_ref(
        q, k, v, q_pos=q_pos, k_pos=k_pos, window=window))
    _assert_bf16_rows_close(runs[0].cpu(), split_attention_ref(
        q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(), k_pos=k_pos.cpu(),
        window=window))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 32, 2, 16, 32), (2, 100, 8, 64, 2, 128, 16),
    (1, 130, 2, 72, 1, 70, 128), (2, 300, 16, 64, 8, 128, 128)])
def test_bf16_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk):
    """K4 in bf16 (x, b, c; dt, a and the state f32) against the plain
    version in bf16: y within the bf16 rows' ulps, the f32 state at 2e-4,
    two runs bit-identical."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s + chunk)
    args = (x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16())
    for init in (None, s0):
        before = dict(_lib.LAUNCHES)
        runs = [ssd_ops.ssd(*args, chunk=chunk, init_state=init)
                for _ in range(2)]
        assert _lib.LAUNCHES["ssd_scan_bf16"] == before["ssd_scan_bf16"] + 2
        assert _lib.LAUNCHES["ssd_scan"] == before["ssd_scan"]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        yp, sp = ssd_ref(*args, chunk=chunk, init_state=init)
        _assert_bf16_rows_close(runs[0][0], yp)
        torch.testing.assert_close(runs[0][1], sp, atol=2e-4, rtol=2e-4)


def test_bf16_kernels_raise_on_mixed_types_and_gradients(dev):
    q, k, v = _attn_inputs(dev, 1, 8, 8, 2, 2, 64)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="share one type"):
        fa_ops.gqa_attention(q.bfloat16(), k, v, q_pos=pos, k_pos=pos)
    qb, kb, vb = (x.bfloat16().requires_grad_() for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="f32"):
        fa_ops.gqa_attention(qb, kb, vb, q_pos=pos, k_pos=pos)
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, 1, 40, 4, 16, 2, 8, 0)
    with pytest.raises(ValueError, match="b must be"):
        ssd_ops.ssd(x.bfloat16(), dt, a, bm, cm.bfloat16(), chunk=16)
    with pytest.raises(NotImplementedError, match="f32"):
        ssd_ops.ssd(x.bfloat16().requires_grad_(), dt, a, bm.bfloat16(),
                    cm.bfloat16(), chunk=16)


# ---------------------------------------------------------------------------
# head dims that are no tile width
# ---------------------------------------------------------------------------

#: The entry points of K3, each held at head dims 8, 24 and 120.
K3_ENTRIES = ("prefill", "prefill_lse", "decode", "backward", "bf16_prefill",
              "bf16_decode")


@pytest.mark.parametrize("entry", K3_ENTRIES)
@pytest.mark.parametrize("d", [8, 24, 120])
def test_attention_entry_points_at_head_dims_off_the_tile(dev, d, entry):
    """Each entry point at a head dim the kernels run at a wider tile
    (``padded_head_dim``): GQA 4 at 120 (danube's 32 over 8), 4 elsewhere
    (8 over 2); prefills causal with a window and non-causal with S ≠ T,
    decodes over a rolled cache with empty slots, without and with a
    window; against the plain version, two runs bit-identical."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    hq, hk = (32, 8) if d == 120 else (8, 2)
    bf16 = entry.startswith("bf16")
    if entry.endswith("decode"):
        k_pos = torch.from_numpy(rolled_pos_tab(300, 40, 339, [3, 70, 71,
                                                                200])).to(dev)
        shapes = [(2, 1, 300, None, True, k_pos, torch.tensor(
            [339], dtype=torch.int32, device=dev))]
        shapes.append((2, 1, 300, 100, True, k_pos, shapes[0][-1]))
    else:
        shapes = [(2, 150, 150, 50, True, None, None),
                  (1, 100, 160, None, False, None, None)]
    for b, s, t, win, causal, k_pos, q_pos in shapes:
        q, k, v = _attn_inputs(dev, b, s, t, hq, hk, d)
        if bf16:
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        if k_pos is None:
            q_pos = torch.arange(t - s, t, dtype=torch.int32, device=dev)
            k_pos = torch.arange(t, dtype=torch.int32, device=dev)
        pos = dict(q_pos=q_pos, k_pos=k_pos, causal=causal, window=win)
        if entry == "backward":
            dout = _attn_inputs(dev, b, s, s, hq, hk, d)[0]
            got = [_bwd_grads(q, k, v, dout, fa_ops.gqa_attention, **pos)
                   for _ in range(2)]
            exp = _bwd_grads(q, k, v, dout, attention_ref, **pos)
            for g, g2, e in zip(*got, exp):
                assert torch.equal(g, g2)
                assert float((g - e).abs().max()) \
                    <= 1e-4 * float(e.abs().max())
            continue
        kind = "decode" if entry.endswith("decode") else "prefill"
        key = f"flash_attention{'_bf16' if bf16 else ''}_{kind}"
        before = _lib.LAUNCHES[key]
        if entry == "prefill_lse":
            runs = [fa_ops._prefill(q, k, v, **pos) for _ in range(2)]
            assert torch.equal(runs[0][1], runs[1][1])
            torch.testing.assert_close(runs[0][1], attention_lse_ref(
                q, k, **pos), atol=2e-5, rtol=2e-5)
            assert torch.equal(runs[0][0], fa_ops.flash_attention_cuda(
                q, k, v, **pos))
            runs = [r[0] for r in runs]
        else:
            runs = [fa_ops.gqa_attention(q, k, v, **pos) for _ in range(2)]
            assert _lib.LAUNCHES[key] == before + 2
        assert torch.equal(*runs)
        exp = attention_ref(q, k, v, **pos)
        if bf16:
            _assert_bf16_rows_close(runs[0], exp)
        else:
            torch.testing.assert_close(runs[0], exp, atol=2e-5, rtol=2e-5)


def _serve_smoke_twice(cfg, arch, monkeypatch):
    """``launch.serve.main`` on ``cfg`` on the card, twice: the requests'
    tokens, and K3's launches, with the plain attention refused."""
    from repro_torch.launch import serve

    def refuse(*a, **kw):
        raise AssertionError("attention reached its plain version")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--prompt-len",
            "40", "--max-new", "4", "--device", "cuda:0"]
    runs = []
    for _ in range(2):
        _lib.reset_launches()
        done, stats = serve.main(argv, cfg=cfg)
        runs.append([r.out_tokens for r in done])
        assert stats["tokens"] == 20
        assert _lib.LAUNCHES["flash_attention_prefill"] == 2 * cfg.n_layers
        assert _lib.LAUNCHES["flash_attention_decode"] \
            == 2 * 4 * cfg.n_layers
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab for r in runs[0] for t in r)


def test_yi_34b_smoke_serves_at_head_dim_8(dev, monkeypatch):
    """yi-34b's smoke config (d 64 over 8 heads: head dim 8, GQA 8) served
    on the card through K3 alone, twice with equal tokens."""
    from repro_torch.configs import get_config
    cfg = get_config("yi-34b", smoke=True)
    assert cfg.d_model // cfg.n_heads == 8
    _serve_smoke_twice(cfg, "yi-34b", monkeypatch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_danube_smoke_serves_at_head_dim_120(dev, dtype, monkeypatch):
    """h2o-danube-3-4b's smoke config widened to d 480 over its 4 heads
    (head dim 120, danube's own, GQA 2, window 16) served on the card
    through K3 alone: by the launcher in f32, twice with equal tokens, and
    by ``ServeEngine`` in bf16, only bf16 launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b", smoke=True),
                              d_model=480)
    assert cfg.d_model // cfg.n_heads == 120
    if dtype == torch.float32:
        _serve_smoke_twice(cfg, "h2o-danube-3-4b", monkeypatch)
        return
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    engine = ServeEngine(cfg, model, EngineConfig(
        batch=4, cache_len=64, dtype=torch.bfloat16, device=dev))
    for req in serve.make_requests(cfg, 5, 40, 4, 0):
        engine.submit(req)
    _lib.reset_launches()
    done = engine.run()
    assert [len(r.out_tokens) for r in done] == [4] * 5
    assert _lib.LAUNCHES["flash_attention_bf16_prefill"] == 2 * cfg.n_layers
    assert _lib.LAUNCHES["flash_attention_bf16_decode"] \
        == 2 * 4 * cfg.n_layers
    assert _lib.LAUNCHES["flash_attention"] == 0

