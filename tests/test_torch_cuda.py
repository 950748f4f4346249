"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The file imports neither ``jax`` nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The sketch kernel must equal the plain version exactly (integer state,
drain and float statistics: both round each float operation alone, the
kernel being built with ``-fmad=false``, but for the one fused
multiply-add both take), also from a carried state and
with two sketches of different geometry in one launch, and must raise for
a state that breaks its Stage-2 precondition; its device-memory variant
(geometries past one block's shared memory: d=8 at m=8,192, L=8,192 with
Stage 1, the index and the rows in device memory) equals the plain
version too, the default geometry forced into the variant equals the
shared-memory kernel bit for bit, and a launch that mixes the two paths
runs each once.  The FailRank step's L' must
equal the plain version's exactly, its s' within 1e-5 (the plain version's
matrix-vector product sums in another order); the whole iteration in one
launch must stop at the reference's Pallas step count
(``chip_smoke.REFERENCE``; within one step of the plain loop on the two
paths ROADMAP Queue 3 lists), with s and L within 1e-5 (same count as the
plain loop) or 1e-4, the L1 tolerance (one step apart).  Flash
attention is held at the reference's f32 tolerance,
2e-5, and the SSD scan at 2e-4 (both sum in another order than the plain
versions' einsums).  On the campaign path: the streaming recorder
launches the sketch kernel once per chunk from the carried state and its
output equals one-shot recording and the CPU's plain path bit for bit;
the ``--tiny`` campaign on the card equals the CPU port's (scores within
``rel=1e-5``), and its thread executor equals serial exactly.  On the
train path: K3's backward (3xTF32 on tensor cores) within 1e-4 of each
gradient's largest entry against torch autograd through the plain
attention, bit-identical over two runs, at smollm-135m's shape, GQA 3 and
4, a window, head dims 16, 120 and 128 and a cut of whisper's
cross-attention (non-causal, S != T); the log-sum-exp output leaves the
prefill's output unchanged;
K4's backward (3xTF32 on tensor cores) through its autograd function
within 1e-4 of each gradient's largest entry against its plain mirror and
torch autograd through the plain scan, bit-identical over two runs, also
at P and N off the 64-wide tiles and chunks 16, 24 and 128 with ragged
tails; a full-size
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
and K4's forward (tensor cores) in bf16 against their plain versions in
bf16, within four
bf16 ulps of each output row's largest entry (the kernel and the plain
version sum in other orders and may round P, or y, on either side of a
boundary), bit-identical over two runs; mixed types raise.  bf16
training: K3's bf16 backward (``BF16_BWD_CASES``: GQA 1 to 8, causal,
windowed, non-causal with S != T, head dims 8 to 128, and the edges of its
ordered adds: a window of 16, a block of empty slots wider than a key
tile, GQA 8 over 16 key tiles, a single key tile; also against the mirror
of its order of sums, dead rows and keys exactly 0; 20 calls on one
stream and on two bit-identical to one call; its scratch the sizes of
``bwd_bf16_scratch``) and K4's (off-tile
shapes, chunks 16, 24 and 128, with and without a state and a final-state
cotangent) against their plain mirrors in bf16, within ``BF16_BWD_ULPS``
of each gradient's largest entry, bit-identical over two runs, the bf16
prefill's output unchanged by its log-sum-exp; a full-size smollm-135m
and mamba2-1.3b bf16 train step through the bf16 kernels alone (with
remat, the default plan: each forward kernel twice a layer); two bf16
steps of h2o-danube-3-4b and mamba2-1.3b at full width with 2 layers
with and without remat, bit-equal; three
bf16 smoke train steps of smollm, mamba2, mixtral and whisper twice with
the same bits; the global norm by groups keeps the f32 bits.  The bf16
decode (one cluster launch) at its
edges: T about a split's end, one live key, every split dead but one, a
row with no live key (0), whisper's R = 1 over 1,500 frames, R = 7 and
16, head dims 8, 24 and 120 with windows over rolled caches; also against
the plain split-key algebra at the kernel's own splits, and one device
kernel a call in a profiler trace.
Head dims that are no tile width (8, 24, 120):
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
from repro_torch.kernels.failrank_step.ref import (failrank_iterate_ordered,
                                                   failrank_iterate_ref,
                                                   failrank_step_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     live_mask,
                                                     rolled_pos_tab,
                                                     split_attention_ref)
from repro_torch.kernels.sketch_update import layout as sk_layout
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


def _variant_case(dev, p, seed, n, n_keys, force=False):
    """The kernel's state and drain (one launch, counted by path) beside
    the plain version's; ``force`` runs the device-memory variant also
    where the sketch fits shared memory."""
    args = tuple(torch.from_numpy(x).to(dev) for x in _runs(seed, n, n_keys))
    job = (sk_ref.make_state(p, dev), sk_ref.make_drain(n, dev), args, p)
    before = dict(_lib.LAUNCHES)
    got, status = sk_ops._launch(
        [job], [sk_layout.placement(p.d, p.m, p.L, force=force)])
    sk_ops.raise_on_status(status)
    launched = {k: _lib.LAUNCHES[k] - before[k]
                for k in ("sketch_insert_runs", "sketch_insert_runs_device")}
    exp = sk_ref.insert_runs_plain(job[0], job[1], *args, H=p.H)
    return got[0], exp, launched


def test_sketch_kernel_past_shared_memory_equals_plain(dev):
    """d=8, m=8,192 (16·d·m = 1 MB of Stage 1, past a block's 232,448 B):
    the device-memory variant, Stage 1 in device memory, equals the plain
    version."""
    p = SketchParams(d=8, m=8192, L=64)
    assert sk_layout.moved(sk_layout.placement(8, 8192, 64)) == ("t1",)
    (st, dr), (st_p, dr_p), launched = _variant_case(dev, p, 0, 600, 300)
    assert launched == {"sketch_insert_runs": 0,
                        "sketch_insert_runs_device": 1}
    _assert_equal(st, st_p)
    _assert_equal(dr, dr_p)
    assert int(dr["d_n"]) > 0


def test_sketch_kernel_variant_past_4096_rows_equals_plain(dev):
    """L = 8,192 (32-bit slots) at d=8, m=65,536: Stage 1, the key index
    and the rows in device memory; enough keys to fill Stage 2 and evict."""
    p = SketchParams(d=8, m=65536, H=2, L=8192)
    assert sk_layout.moved(sk_layout.placement(8, 65536, 8192)) \
        == ("idx", "t1", "s2")
    (st, dr), (st_p, dr_p), launched = _variant_case(dev, p, 22, 20000,
                                                     30000)
    assert launched["sketch_insert_runs_device"] == 1
    _assert_equal(st, st_p)
    _assert_equal(dr, dr_p)
    assert int(dr["d_n"]) > 0 and int(st["counter"]) > p.L


@pytest.mark.parametrize("d,m,H,L", [(2, 1024, 8, 1024), (2, 1024, 4, 2048),
                                     (2, 64, 2, 8)])
def test_sketch_kernel_forced_variant_equals_shared_path(dev, d, m, H, L):
    """The default and pod geometries (and a small evicting one) forced
    into the device-memory variant give the shared-memory kernel's bits."""
    p = SketchParams(d=d, m=m, H=H, L=L)
    n, keys = (3000, 2600) if L >= 1024 else (400, 80)
    (st_v, dr_v), exp, launched = _variant_case(dev, p, 23, n, keys,
                                                force=True)
    assert launched == {"sketch_insert_runs": 0,
                        "sketch_insert_runs_device": 1}
    (st_s, dr_s), _, launched = _variant_case(dev, p, 23, n, keys)
    assert launched == {"sketch_insert_runs": 1,
                        "sketch_insert_runs_device": 0}
    _assert_equal(st_v, st_s)
    _assert_equal(dr_v, dr_s)
    _assert_equal(st_s, exp[0])


def test_sketch_kernel_mixed_batch_launches_each_path_once(dev):
    """Sketches on both paths in one call: one launch of each, each with
    its own shared-memory size, every sketch equal to the plain version."""
    jobs = []
    for p, (seed, n, keys) in ((SketchParams(), (24, 600, 300)),
                               (SketchParams(d=4, m=4096, H=8, L=1024),
                                (25, 700, 400)),
                               (SketchParams(d=3, m=64, H=2, L=8),
                                (26, 400, 80))):
        jobs.append((sk_ref.make_state(p, dev), sk_ref.make_drain(n, dev),
                     tuple(torch.from_numpy(x).to(dev)
                           for x in _runs(seed, n, keys)), p))
    before = dict(_lib.LAUNCHES)
    got = sk_ops.insert_runs_many(jobs)
    assert _lib.LAUNCHES["sketch_insert_runs"] \
        == before["sketch_insert_runs"] + 1
    assert _lib.LAUNCHES["sketch_insert_runs_device"] \
        == before["sketch_insert_runs_device"] + 1
    for (st_k, dr_k), (st0, dr0, args, p) in zip(got, jobs):
        st_p, dr_p = sk_ref.insert_runs_plain(st0, dr0, *args, H=p.H)
        _assert_equal(st_k, st_p)
        _assert_equal(dr_k, dr_p)


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


def _chip_smoke():
    """``chip_smoke.py`` as a module: it holds the reference's pinned
    numbers (it imports neither JAX nor the reference)."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)


def _assert_failrank_steps(n, path, it_k, it_p):
    """K2's step count: the reference's Pallas count at n
    (``chip_smoke.REFERENCE``) on either path."""
    assert it_k == _chip_smoke().REFERENCE[("failrank_loop", n)], path


@pytest.mark.parametrize("n", [68, 260, 1028])
def test_failrank_loop_matches_plain_loop(dev, n):
    """The whole iteration in one launch (W and L in shared memory at 68
    and 260, in device memory at 1,028) against the plain loop: as many
    steps as the reference's Pallas step takes on these inputs."""
    x = _failrank_inputs(dev, n)
    before = _lib.LAUNCHES["failrank_step"]
    s_k, l_k, it_k = fr_ops.failrank_iterate(*x)
    assert _lib.LAUNCHES["failrank_step"] == before + 1
    s_p, l_p, it_p = failrank_iterate_ref(*x)
    _assert_failrank_steps(n, "shared" if n <= 473 else "device",
                           int(it_k), int(it_p))
    tol = 1e-5 if int(it_k) == int(it_p) else 1e-4
    torch.testing.assert_close(s_k, s_p, atol=tol, rtol=0)
    torch.testing.assert_close(l_k, l_p, atol=tol, rtol=0)


@pytest.mark.parametrize("n", [68, 260])
def test_failrank_loop_in_device_memory_matches_plain_loop(dev, n):
    """The device-memory path at the sizes the shared-memory path takes."""
    x = _failrank_inputs(dev, n)
    s_k, l_k, it_k = fr_ops.failrank_iterate_cuda(*x, stripes="device")
    s_p, l_p, it_p = failrank_iterate_ref(*x)
    _assert_failrank_steps(n, "device", int(it_k), int(it_p))
    tol = 1e-5 if int(it_k) == int(it_p) else 1e-4
    torch.testing.assert_close(s_k, s_p, atol=tol, rtol=0)
    torch.testing.assert_close(l_k, l_p, atol=tol, rtol=0)


@pytest.mark.parametrize("n,stripes", [(68, "device"), (260, "shared"),
                                       (1028, "device")])
def test_failrank_residual_matches_its_order_mirror(dev, n, stripes):
    """The kernel's steps and last residual equal those of its order of
    sums mirrored on the CPU (``failrank_iterate_ordered`` at the path's
    ``row_classes``), bit for bit, and so do s and L."""
    x = _failrank_inputs(dev, n)
    s_k, l_k, it_k, res_k = fr_ops.failrank_iterate_cuda(
        *x, stripes=stripes, with_residual=True)
    classes, threads = fr_ops.row_classes(n, on_chip=stripes == "shared")
    s_m, l_m, it_m, res_m = failrank_iterate_ordered(
        *(t.cpu() for t in x), classes=classes, threads=threads)
    assert int(it_k) == it_m and float(res_k) == res_m[-1]
    assert torch.equal(s_k.cpu(), s_m) and torch.equal(l_k.cpu(), l_m)


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
    # more chunks x heads than a grid's y extent (32,769 x 2) and more
    # batches than its z extent (65,536): every grid runs its axes along
    # x, so the forward and the backward take both
    steps = ssd_ops.MAX_GRID_YZ // 2 + 1
    for bsz, s in ((1, steps), (ssd_ops.MAX_GRID_YZ + 1, 1)):
        *args, _ = _ssd_inputs(dev, bsz, s, 2, 4, 1, 4, 0)
        y, state, saved = ssd_ops.ssd_fwd_cuda(*args, chunk=1)
        assert y.shape == args[0].shape and bool(torch.isfinite(y).all())
        assert bool(torch.isfinite(state).all())
        grads = ssd_ops.ssd_bwd_cuda(*args, y, None, saved=saved, chunk=1)
        for g_, t in zip(grads, args):
            assert g_.shape == t.shape and bool(torch.isfinite(g_).all())
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


#: K3's backward cases: smollm-135m's train shape (GQA 3), GQA 4 with a
#: window, head dims 16, 128 and 120 (GQA 4, a window), non-causal S != T,
#: three queries at the end of their keys, and a cut of whisper's cross
#: attention (256 queries over 1,500 frames, non-causal).
BWD_CASES = [
    (4, 512, 512, 9, 3, 64, True, None), (2, 300, 300, 8, 2, 32, True, 100),
    (2, 200, 200, 6, 2, 16, True, None), (2, 130, 130, 8, 2, 128, True, None),
    (1, 100, 160, 4, 4, 64, False, None), (2, 3, 70, 6, 1, 32, True, 20),
    (2, 150, 150, 8, 2, 120, True, 50), (1, 256, 1500, 4, 4, 64, False, None)]


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", BWD_CASES)
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


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win", BWD_CASES)
def test_attention_backward_two_runs_bit_identical(dev, b, s, t, hq, hk, d,
                                                   causal, win):
    q, k, v = _attn_inputs(dev, b, s, t, hq, hk, d)
    dout = _attn_inputs(dev, b, s, s, hq, hk, d)[0]
    pos = dict(q_pos=torch.arange(t - s, t, dtype=torch.int32, device=dev),
               k_pos=torch.arange(t, dtype=torch.int32, device=dev),
               causal=causal, window=win)
    a, b = (_bwd_grads(q, k, v, dout, fa_ops.gqa_attention, **pos)
            for _ in range(2))
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
    (1, 130, 2, 72, 1, 70, 128), (4, 512, 64, 64, 8, 128, 128),
    (2, 100, 8, 64, 2, 128, 16), (1, 100, 4, 32, 4, 64, 24),
    (2, 300, 16, 64, 8, 128, 128), (3, 77, 6, 16, 3, 16, 24),
    (1, 300, 4, 16, 2, 16, 16)])
def test_ssd_backward_matches_plain_and_autograd(dev, b, s, h, p, g, n,
                                                 chunk):
    """K4's backward through ``ssd`` (``SSDScan``) against its plain
    mirror and torch autograd through the plain scan, from a zero and a
    non-zero state, with and without a final-state cotangent: within 1e-4
    of each gradient's largest entry; one forward and one backward launch
    a call; two calls give the same bits.  Chunks 16, 24 and 128 with a
    ragged last chunk, P and N off the 64-wide tiles (P 72, N 70), more
    chunks than the state pass keeps in flight."""
    *args, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s + chunk)
    dy, ds_rand = _ssd_cotangents(dev, b, s, h, p, n, s + chunk)
    for init in (None, s0):
        for ds in (None, ds_rand):
            before = dict(_lib.LAUNCHES)
            got = ssd_plain.autograd_grads(ssd_ops.ssd, args, init, dy, ds,
                                           chunk=chunk)
            assert _lib.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
            assert _lib.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
            again = ssd_plain.autograd_grads(ssd_ops.ssd, args, init, dy,
                                             ds, chunk=chunk)
            assert all(u is None or torch.equal(u, v)
                       for u, v in zip(got, again))
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
    state, loss, gnorm = S.make_train_step(
        cfg, S.CellPlan(remat=False, param_dtype=torch.float32), opt_cfg)(
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
    state, loss, gnorm = S.make_train_step(
        cfg, S.CellPlan(remat=False, param_dtype=torch.float32), opt_cfg)(
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
        step = S.make_train_step(
            cfg, S.CellPlan(param_dtype=torch.float32), opt_cfg)
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
    split = fa_ops.decode_splits(2, t_max, hk, fa_ops._sm_count(dev))[1] \
        if fa_ops.uses_decode(s, hq, hk) else 64
    _assert_bf16_rows_close(runs[0].cpu(), split_attention_ref(
        q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(), k_pos=k_pos.cpu(),
        window=window, split=split))


def _device_kernels(fn, calls=5):
    """The names of the device kernels that ``calls`` calls of ``fn``
    launch, from a profiler trace.  The profiler drops records, late in a
    long process every record of a trace, so a trace that recorded no
    device kernel is followed by up to two more (as ``chip_smoke.
    launch_breakdown`` does); a kernel that ``fn`` does not launch can
    never appear."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


#: (label, B, query positions, Hq, Hkv, D, T, rolled_pos_tab arguments or
#: None for positions 0..T-1, causal, window) of the bf16 decode's edge
#: cases: T about a split's end (the split length comes from the shapes),
#: one live key, every split dead but one, a row with no live key (0),
#: whisper's R = 1 over 1,500 frames, yi-34b's R = 7, 16 rows, head dims
#: 8, 24 and 120 with windows over rolled caches.
BF16_DECODE_CASES = [
    ("T 511", 2, [510], 8, 2, 64, 511, None, True, None),
    ("T 512", 2, [511], 8, 2, 64, 512, None, True, None),
    ("T 513", 2, [512], 8, 2, 64, 513, None, True, None),
    ("T 1023", 2, [1022], 8, 2, 64, 1023, None, True, None),
    ("T 1025", 2, [1024], 8, 2, 64, 1025, None, True, None),
    ("one live key", 2, [300], 8, 1, 32, 512, (512, 300, 300), True, None),
    ("every split dead but one", 2, [230], 7, 1, 16, 512, (512, 200, 230),
     True, None),
    ("a row with no live key", 1, [-5, 299], 6, 3, 24, 300, None, True,
     None),
    ("whisper R 1", 4, [543], 20, 20, 64, 1500, None, False, None),
    ("yi-34b R 7", 4, [543], 56, 8, 128, 1024, (1024, 0, 543), True, None),
    ("16 rows", 2, [298, 299], 16, 2, 128, 300, None, True, None),
    ("head dim 8, window", 2, [1299], 16, 1, 8, 1024,
     (1024, 600, 1299, [5, 77, 700, 1023]), True, 256),
    ("head dim 24, window", 2, [1299], 8, 2, 24, 1024,
     (1024, 600, 1299, [5, 77, 700, 1023]), True, 100),
    ("head dim 120, window", 2, [1299], 32, 8, 120, 1024,
     (1024, 600, 1299, [5, 77, 700, 1023]), True, 256)]


@pytest.mark.parametrize("label,b,qps,hq,hk,d,t,tab,causal,win",
                         BF16_DECODE_CASES)
def test_bf16_decode_edge_cases(dev, label, b, qps, hq, hk, d, t, tab,
                                causal, win):
    """The bf16 decode (one cluster launch, tensor cores) against the plain
    version in bf16 and the plain split-key algebra at the kernel's splits,
    within four bf16 ulps of each row's largest entry; a row with no live
    key is 0; two runs bit-identical; one launch counted and one device
    kernel a call."""
    q, k, v = (x.bfloat16() for x in _attn_inputs(dev, b, len(qps), t, hq,
                                                  hk, d))
    q_pos = torch.tensor(qps, dtype=torch.int32, device=dev)
    k_pos = (torch.arange(t, dtype=torch.int32, device=dev) if tab is None
             else torch.from_numpy(rolled_pos_tab(*tab)).to(dev))
    pos = dict(q_pos=q_pos, k_pos=k_pos, causal=causal, window=win)
    assert fa_ops.uses_decode(len(qps), hq, hk)
    before = dict(_lib.LAUNCHES)
    runs = [fa_ops.gqa_attention(q, k, v, **pos) for _ in range(2)]
    assert _lib.LAUNCHES["flash_attention_bf16_decode"] \
        == before["flash_attention_bf16_decode"] + 2
    assert torch.equal(*runs)
    got = runs[0]
    has_key = live_mask(q_pos, k_pos, causal, win).any(-1)   # [S]
    assert bool((got[:, ~has_key] == 0).all())
    if bool(has_key.any()):
        exp = attention_ref(q, k, v, **pos)
        _assert_bf16_rows_close(got[:, has_key], exp[:, has_key])
    split = fa_ops.decode_splits(b, t, hk, fa_ops._sm_count(dev))[1]
    _assert_bf16_rows_close(got.cpu(), split_attention_ref(
        q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(), k_pos=k_pos.cpu(),
        causal=causal, window=win, split=split))
    names = _device_kernels(lambda: fa_ops.gqa_attention(q, k, v, **pos))
    assert 1 <= len(names) <= 5
    assert all(n.startswith("void flash_decode_bf16_kernel<") for n in names)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 32, 2, 16, 32), (2, 100, 8, 64, 2, 128, 16),
    (1, 130, 2, 72, 1, 70, 128), (2, 300, 16, 64, 8, 128, 128),
    (1, 100, 4, 32, 4, 64, 24), (3, 77, 6, 16, 3, 16, 24),
    (1, 300, 4, 16, 2, 16, 16), (4, 512, 64, 64, 8, 128, 128)])
def test_bf16_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk):
    """K4 in bf16 (x, b, c; dt, a and the state f32; tensor cores) against
    the plain version in bf16: y within the bf16 rows' ulps, the f32 state
    at 2e-4, two runs bit-identical.  The off-tile shapes of
    ``test_ssd_kernel_chunk_parallel_phases`` and mamba2-1.3b's prefill."""
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
    """Mixed types raise; a bf16 call that needs a gradient goes through
    the bf16 kernels (the prefill with its log-sum-exp, the bf16 forward)
    and gets bf16 gradients from the bf16 backwards."""
    q, k, v = _attn_inputs(dev, 1, 8, 8, 2, 2, 64)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="share one type"):
        fa_ops.gqa_attention(q.bfloat16(), k, v, q_pos=pos, k_pos=pos)
    qb, kb, vb = (x.bfloat16().requires_grad_() for x in (q, k, v))
    before = dict(_lib.LAUNCHES)
    fa_ops.gqa_attention(qb, kb, vb, q_pos=pos, k_pos=pos).sum().backward()
    assert _lib.LAUNCHES["flash_attention_bf16_prefill"] \
        == before["flash_attention_bf16_prefill"] + 1
    assert _lib.LAUNCHES["flash_attention_bf16_bwd"] \
        == before["flash_attention_bf16_bwd"] + 1
    assert qb.grad.dtype == kb.grad.dtype == torch.bfloat16
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, 1, 40, 4, 16, 2, 8, 0)
    with pytest.raises(ValueError, match="b must be"):
        ssd_ops.ssd(x.bfloat16(), dt, a, bm, cm.bfloat16(), chunk=16)
    xb = x.bfloat16().requires_grad_()
    before = dict(_lib.LAUNCHES)
    ssd_ops.ssd(xb, dt, a, bm.bfloat16(), cm.bfloat16(),
                chunk=16)[0].float().sum().backward()
    assert _lib.LAUNCHES["ssd_scan_bf16"] == before["ssd_scan_bf16"] + 1
    assert _lib.LAUNCHES["ssd_scan_bf16_bwd"] \
        == before["ssd_scan_bf16_bwd"] + 1
    assert xb.grad.dtype == torch.bfloat16


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



# ---------------------------------------------------------------------------
# bf16 training: K3's and K4's bf16 backwards
# ---------------------------------------------------------------------------

#: The bf16 backwards against their plain mirrors in bf16 (the kernels'
#: rounding: bf16 operands, f32 sums, each gradient rounded once): within
#: this many bf16 ulps of each gradient's largest |entry|.  Not of each
#: row's: the rows of dq and dk are differences that cancel (D =
#: rowsum(dO∘O)), so a row's own largest entry is no scale of its error.
BF16_BWD_ULPS = 4

#: K3's bf16 backward cases, ``(b, s, t, hq, hk, d, causal, window,
#: empty)`` with ``empty`` a range of cache slots set to -1: ``BWD_CASES``
#: (GQA 1, 3, 4 and 6; causal, windowed, non-causal with S != T; head dims
#: 16 to 128), head dims 8 (GQA 8) and 24 off the tile, and the edges of
#: the kernel's ordered adds: a window of 16 (most query tiles meet one key
#: tile), slots 100..299 empty under a window of 64 (a key tile with no
#: live key, a query tile that meets no key tile, rows with no live key),
#: GQA 8 at T = 2,048 (16 key tiles, 8 heads in turn), one key tile.
BF16_BWD_CASES = [c + (None,) for c in BWD_CASES] + [
    (2, 100, 100, 8, 1, 8, True, None, None),
    (1, 150, 150, 6, 2, 24, True, 50, None),
    (2, 300, 300, 4, 2, 64, True, 16, None),
    (2, 512, 512, 4, 1, 32, True, 64, (100, 300)),
    (1, 2048, 2048, 8, 1, 64, True, None, None),
    (1, 100, 120, 3, 1, 16, False, None, None)]


def _bf16_bwd_inputs(dev, b, s, t, hq, hk, d, causal, win, empty):
    q, k, v = (x.bfloat16() for x in _attn_inputs(dev, b, s, t, hq, hk, d))
    dout = _attn_inputs(dev, b, s, s, hq, hk, d)[0].bfloat16()
    k_pos = torch.arange(t, dtype=torch.int32, device=dev)
    if empty:
        k_pos[empty[0]:empty[1]] = -1
    pos = dict(q_pos=torch.arange(t - s, t, dtype=torch.int32, device=dev),
               k_pos=k_pos, causal=causal, window=win)
    return q, k, v, dout, pos


def _assert_bf16_grad_close(got, exp, ulps=BF16_BWD_ULPS):
    assert got.dtype == exp.dtype == torch.bfloat16
    assert got.shape == exp.shape
    top = exp.float().abs().max().clamp_min(2.0 ** -100)
    ulp = float(torch.exp2(torch.floor(torch.log2(top)) - 7))
    gap = float((got.float() - exp.float()).abs().max())
    assert gap <= ulps * ulp, gap / ulp


@pytest.mark.parametrize("b,s,t,hq,hk,d,causal,win,empty", BF16_BWD_CASES)
def test_bf16_attention_backward_matches_plain(dev, b, s, t, hq, hk, d,
                                               causal, win, empty):
    """K3's bf16 backward through ``gqa_attention`` (``FlashAttention``: the
    bf16 prefill with its log-sum-exp, then ``flash_attention_backward_bf16``)
    against its plain mirror ``attention_bwd_ref`` in bf16 and the mirror of
    its order of sums ``attention_bwd_tiled_ref``, on the forward's own
    ``out`` and ``lse``: within ``BF16_BWD_ULPS``, bf16 gradients, dq of
    rows with no live key and dk, dv of keys with no live query exactly 0,
    one bf16 prefill and one bf16 backward launch a call and no f32 one, two
    runs bit-identical."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref, attention_bwd_tiled_ref, live_mask)
    q, k, v, dout, pos = _bf16_bwd_inputs(dev, b, s, t, hq, hk, d, causal,
                                          win, empty)
    before = dict(_lib.LAUNCHES)
    got = [_bwd_grads(q, k, v, dout, fa_ops.gqa_attention, **pos)
           for _ in range(2)]
    assert _lib.LAUNCHES["flash_attention_bf16_bwd"] \
        == before["flash_attention_bf16_bwd"] + 2
    assert _lib.LAUNCHES["flash_attention_bf16_prefill"] \
        == before["flash_attention_bf16_prefill"] + 2
    assert _lib.LAUNCHES["flash_attention_bwd"] \
        == before["flash_attention_bwd"]
    out, lse = fa_ops._prefill(q, k, v, **pos)
    exp = attention_bwd_ref(q, k, v, out, dout, lse, **pos)
    tiled = attention_bwd_tiled_ref(q, k, v, out, dout, lse, **pos)
    for g, g2, e, e2 in zip(*got, exp, tiled):
        assert torch.equal(g, g2)
        _assert_bf16_grad_close(g, e)
        _assert_bf16_grad_close(g, e2)
    live = live_mask(pos["q_pos"], pos["k_pos"], causal, win).expand(s, t)
    dq, dk, dv = got[0]
    assert (dq[:, ~live.any(1)] == 0).all()
    assert (dk[:, ~live.any(0)] == 0).all()
    assert (dv[:, ~live.any(0)] == 0).all()


def _bf16_bwd_call(q, k, v, dout, pos):
    out, lse = fa_ops._prefill(q, k, v, **pos)
    return lambda: fa_ops.flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                                   **pos)


@pytest.mark.parametrize("case", [BF16_BWD_CASES[0], BF16_BWD_CASES[-3]])
def test_bf16_attention_backward_calls_carry_nothing_over(dev, case):
    """20 calls back to back on one stream, then 20 alternating between two
    streams, each bit-identical to a single call: the D launch zeroes the
    ticket and the turn counters of each call's own scratch."""
    call = _bf16_bwd_call(*_bf16_bwd_inputs(dev, *case))
    one = call()
    torch.cuda.synchronize()
    same = [call() for _ in range(20)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for n in range(20):
        with torch.cuda.stream(streams[n % 2]):
            same.append(call())
    torch.cuda.synchronize()
    for grads in same:
        assert all(torch.equal(a, b) for a, b in zip(grads, one))


@pytest.mark.parametrize("case", [BF16_BWD_CASES[0], BF16_BWD_CASES[4],
                                  BF16_BWD_CASES[-1]])
def test_bf16_attention_backward_scratch_is_bwd_bf16_scratch(dev, case,
                                                             monkeypatch):
    """The scratch the wrapper allocates (``torch.empty``; the gradients are
    ``torch.empty_like``) is ``bwd_bf16_scratch``'s, buffer for buffer: the
    f32 delta and dQ sums, the f32 dK/dV sums only with grouped heads, and
    the int32 ticket, turn counters and tile ranges."""
    b, s, t, hq, hk, d = case[:6]
    call = _bf16_bwd_call(*_bf16_bwd_inputs(dev, *case))
    real, made = torch.empty, []

    def spy(*args, **kw):
        x = real(*args, **kw)
        made.append((x.numel(), x.dtype))
        return x
    monkeypatch.setattr(torch, "empty", spy)
    call()
    monkeypatch.undo()
    n = fa_ops.bwd_bf16_scratch(b, s, t, hq, hk, d)
    want = [(n["delta"], torch.float32), (n["ws"], torch.int32),
            (n["dq_acc"], torch.float32)]
    if hq != hk:
        want.append((n["dkv_acc"], torch.float32))
    assert n["dkv_acc"] == (0 if hq == hk else 2 * b * t * hk * d)
    assert made == want


def test_bf16_attention_lse_output_leaves_the_prefill_unchanged(dev):
    """The bf16 prefill with a null ``lse`` writes what it writes with one,
    bit for bit, and the log-sum-exp is the plain one (f32, from the bf16
    inputs)."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref
    for case in BF16_BWD_CASES:
        q, k, v, _, pos = _bf16_bwd_inputs(dev, *case)
        s, hq, hk = q.shape[1], q.shape[2], k.shape[2]
        out, lse = fa_ops._prefill(q, k, v, **pos)
        if not fa_ops.uses_decode(s, hq, hk):
            assert torch.equal(out, fa_ops.flash_attention_cuda(q, k, v,
                                                                **pos))
        torch.testing.assert_close(lse, attention_lse_ref(q, k, **pos),
                                   atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (2, 96, 4, 32, 2, 16, 32), (1, 200, 2, 16, 1, 8, 64),
    (2, 64, 8, 8, 4, 8, 16), (2, 80, 4, 16, 2, 8, 32),
    (1, 300, 16, 64, 2, 128, 128), (2, 24, 4, 32, 2, 16, 24),
    (1, 130, 2, 72, 1, 70, 128), (4, 512, 64, 64, 8, 128, 128),
    (3, 77, 6, 16, 3, 16, 24), (1, 300, 4, 16, 2, 16, 16),
    # the Hopper design's edges: chunks 16 and 24 with a ragged last
    # chunk and one head a group (G = H), a last chunk of 72 rows at 128
    # (a second row tile of 8), whole row tiles at 64
    (2, 100, 8, 64, 8, 128, 16), (1, 130, 4, 64, 4, 128, 24),
    (1, 200, 16, 64, 8, 128, 128), (2, 192, 8, 32, 2, 64, 64)])
def test_bf16_ssd_backward_matches_plain(dev, b, s, h, p, g, n, chunk):
    """K4's bf16 backward through ``ssd`` (``SSDScan``: the bf16 forward,
    then ``ssd_scan_backward_bf16`` on its scratch) against its plain mirror
    ``ssd_bwd_ref`` in bf16, from a zero and a non-zero state, with and
    without a final-state cotangent: dx, db and dc in bf16 within
    ``BF16_BWD_ULPS``, ddt, da and dinit in f32 within 1e-4 of each
    gradient's largest entry; one bf16 forward and one bf16 backward launch
    a call; two calls give the same bits."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(dev, b, s, h, p, g, n, s + chunk)
    args = [x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16()]
    dy, ds_rand = _ssd_cotangents(dev, b, s, h, p, n, s + chunk)
    dy = dy.bfloat16()
    for init in (None, s0):
        for ds in (None, ds_rand):
            before = dict(_lib.LAUNCHES)
            got = ssd_plain.autograd_grads(ssd_ops.ssd, args, init, dy, ds,
                                           chunk=chunk)
            assert _lib.LAUNCHES["ssd_scan_bf16"] \
                == before["ssd_scan_bf16"] + 1
            assert _lib.LAUNCHES["ssd_scan_bf16_bwd"] \
                == before["ssd_scan_bf16_bwd"] + 1
            assert _lib.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"]
            again = ssd_plain.autograd_grads(ssd_ops.ssd, args, init, dy,
                                             ds, chunk=chunk)
            assert all(u is None or torch.equal(u, w)
                       for u, w in zip(got, again))
            mirror = ssd_bwd_ref(*args, dy, ds, chunk=chunk, init_state=init)
            for name, g_, m_ in zip(("dx", "ddt", "da", "db", "dc", "dinit"),
                                    got, mirror):
                if m_ is None:
                    assert g_ is None, name
                elif name in ("dx", "db", "dc"):
                    _assert_bf16_grad_close(g_, m_)
                else:
                    assert g_.dtype == torch.float32, name
                    assert float((g_ - m_).abs().max()) \
                        <= 1e-4 * float(m_.abs().max()), name


def test_bf16_ssd_backward_hopper_kernels_add_without_atomics():
    """The Hopper design's four kernels (``ssd_bwd_*_hopper_kernel`` and
    what they call, from the section's first line to the host code) hold no
    atomic operation: every sum runs in a fixed order."""
    from pathlib import Path
    src = (Path(ssd_ops.__file__).resolve().parents[2] / "csrc"
           / "ssd_scan.cu").read_text()
    start = src.index("#define HC 128")
    end = src.index("typedef CUresult (*EncodeTiledFn)")
    body = src[start:end]
    assert "ssd_bwd_dcdb_hopper_kernel" in body
    assert not any(op in body for op in ("atomicAdd", "atomicExch",
                                         "atom.", "red.global",
                                         "red.shared"))


def _bf16_train_step(dev, arch, batch, seq, steps=1, seed=0, smoke=False,
                     n_layers=None, remat=True):
    """``steps`` bf16 train steps (the reference's plan, ``remat`` as
    given) of ``arch`` (cut to ``n_layers``) on random
    ``init_model(dtype=bf16)`` weights (an encoder-decoder over seeded
    bf16 frames): the losses, grad norms and parameters after, and the
    launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = T.init_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = adamw.init_state(list(model.parameters()), opt_cfg)
    step = S.make_train_step(cfg, S.CellPlan(remat=remat), opt_cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    frames = (torch.randn(batch, cfg.n_frames, cfg.d_model, device=dev,
                          generator=gen) * 0.02).bfloat16() \
        if cfg.enc_dec else None
    _lib.reset_launches()
    out = []
    for _ in range(steps):
        toks = torch.randint(0, cfg.vocab, (batch, seq), device=dev,
                             dtype=torch.int32, generator=gen)
        state, loss, gnorm = step(model, state, toks, frames)
        out += [loss.detach(), gnorm.detach()]
    return out, [p.detach().clone() for p in model.parameters()], \
        dict(_lib.LAUNCHES)


def test_full_size_bf16_train_step_goes_through_the_kernels(dev,
                                                            monkeypatch):
    """One smollm-135m and one mamba2-1.3b train step at full size in bf16
    with the default plan, remat (batch 2 × 128, and 2 × 256: two
    chunks): 60 K3 bf16 prefills (each layer's forward and its recompute)
    and 30 backwards, 96 K4 bf16 forwards and 48 backwards, no f32
    launch, no call of a plain version or mirror, finite losses and grad
    norms."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel's plain version ran")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_ref", refuse)
    monkeypatch.setattr(ssd_plain, "ssd_bwd_ref", refuse)
    (loss, gnorm), _, n = _bf16_train_step(dev, "smollm-135m", 2, 128)
    assert n["flash_attention_bf16_prefill"] == 60
    assert n["flash_attention_bf16_bwd"] == 30
    assert n["flash_attention_bf16_decode"] == 0
    assert n["flash_attention"] == n["flash_attention_bwd"] == 0
    assert np.isfinite(loss.item()) and np.isfinite(gnorm.item())
    (loss, gnorm), _, n = _bf16_train_step(dev, "mamba2-1.3b", 2, 256)
    assert n["ssd_scan_bf16"] == 96 and n["ssd_scan_bf16_bwd"] == 48
    assert n["ssd_scan"] == n["ssd_scan_bwd"] == 0
    assert n["flash_attention_bf16"] == 0
    assert np.isfinite(loss.item()) and np.isfinite(gnorm.item())


@pytest.mark.parametrize("arch,fwd,bwd", [
    ("h2o-danube-3-4b", "flash_attention_bf16_prefill",
     "flash_attention_bf16_bwd"),
    ("mamba2-1.3b", "ssd_scan_bf16", "ssd_scan_bf16_bwd")])
def test_bf16_remat_train_steps_equal_no_remat(dev, arch, fwd, bwd,
                                               monkeypatch):
    """Two bf16 train steps at full width with 2 layers, batch 4 × 512,
    with ``CellPlan(remat=True)`` and with ``remat=False`` from one seed:
    the same losses, grad norms and parameters, bit for bit (the
    recompute launches the same kernels on the same inputs).  The forward
    kernel (K3's bf16 prefill, K4's bf16 forward) twice per layer a step
    under remat and once without, the backward once either way; no plain
    version."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel's plain version ran")
    monkeypatch.setattr(fa_ops, "attention_ref", refuse)
    monkeypatch.setattr(ssd_ops, "ssd_ref", refuse)
    monkeypatch.setattr(ssd_plain, "ssd_bwd_ref", refuse)
    (out_on, par_on, n_on), (out_off, par_off, n_off) = (
        _bf16_train_step(dev, arch, 4, 512, steps=2, n_layers=2, remat=r)
        for r in (True, False))
    assert all(torch.equal(x, y) for x, y in zip(out_on + par_on,
                                                 out_off + par_off))
    assert all(bool(torch.isfinite(x).all()) for x in out_on)
    assert (n_on[fwd], n_on[bwd]) == (8, 4)
    assert (n_off[fwd], n_off[bwd]) == (4, 4)
    for n in (n_on, n_off):
        assert n["flash_attention"] == n["ssd_scan"] == 0
        assert n["flash_attention_bwd"] == n["ssd_scan_bwd"] == 0


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b",
                                  "mixtral-8x7b", "whisper-large-v3"])
def test_bf16_smoke_train_steps_are_bit_identical(dev, arch):
    """Three bf16 train steps of a smoke config on the card, twice from one
    seed: the same losses, grad norms and parameters, bit for bit, all
    finite, through the bf16 kernels alone."""
    runs = [_bf16_train_step(dev, arch, 2, 64, steps=3, smoke=True)
            for _ in range(2)]
    for (out_a, par_a, n), (out_b, par_b, _) in zip(runs, runs[1:]):
        assert all(torch.equal(x, y) for x, y in zip(out_a + par_a,
                                                     out_b + par_b))
        assert all(bool(torch.isfinite(x).all()) for x in out_a + par_a)
        assert n["flash_attention"] == n["ssd_scan"] == 0
        assert n["flash_attention_bwd"] == n["ssd_scan_bwd"] == 0
        assert n["flash_attention_bf16_bwd"] + n["ssd_scan_bf16_bwd"] > 0


def test_global_norm_by_groups_keeps_the_f32_bits(dev, monkeypatch):
    """On the card, the global norm taken a group of ``apply``'s at a time
    gives each f32 leaf's norm the bits of one multi-tensor call over every
    leaf (leaves of several 64 Ki-element chunks among them), whatever the
    groups; bf16 leaves give their f32 copies' norms."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(21)
    leaves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .to(dev) for n in (300_000, 7, 1 << 18, 65_537, 1000)]
    want = torch._foreach_norm(leaves)
    whole = adamw.global_norm(leaves)
    for elems in (1 << 28, 300_000, 70_000, 1):
        monkeypatch.setattr(adamw, "GROUP_ELEMS", elems)
        got = adamw._group_norms(leaves)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(adamw.global_norm(leaves), whole)
        bf16 = [x.bfloat16() for x in leaves]
        got = adamw._group_norms(bf16)
        assert all(torch.equal(a, torch._foreach_norm([x.float()])[0])
                   for a, x in zip(got, bf16))


def test_k1_smem_model_equals_the_library(dev):
    """``analysis.memory_model.hopper_smem_bytes`` is the built K1 library's
    ``sketch_insert_smem_bytes`` at every swept geometry (the same sweep as
    ``chip_smoke.py``'s analysis phase) and at the default and pod ones."""
    from repro_torch.analysis import memory_model
    cs = _chip_smoke()
    lib = sk_ops._load()
    geometries = [SketchParams(d=d, m=m, H=4, L=L) for d in cs.SMEM_D
                  for m in cs.SMEM_M for L in cs.SMEM_L]
    geometries += [SketchParams(), SketchParams(d=2, m=1024, H=4, L=2048)]
    for p in geometries:
        assert memory_model.hopper_smem_bytes(p) \
            == lib.sketch_insert_smem_bytes(p.d, p.m, p.L), p
        # the variant's layout: every placement the rule can take here
        for place in {sk_layout.placement(p.d, p.m, p.L, force=True),
                      sk_layout.placement(p.d, p.m, p.L) or 0, 63}:
            assert sk_layout.bytes_placed(p.d, p.m, p.L, True, place) == (
                lib.sketch_insert_variant_smem_bytes(p.d, p.m, p.L, place),
                lib.sketch_insert_scratch_bytes(p.d, p.m, p.L, place)), p
    assert lib.sketch_insert_smem_bytes(2, 1024, 2048) == 228_992


def test_sass_has_no_float_atomics_and_only_the_declared_int_ones(dev):
    """In ``cuobjdump -sass`` of all four libraries no kernel has a float
    atomic, and the kernels with integer atomics are those each
    ``ops.AUDIT["int_atomics"]`` lists."""
    from repro_torch.analysis import kernel_audit
    _lib.build_all()
    atomics = _chip_smoke().sass_atomics(_lib)
    contracts = kernel_audit.contracts()
    assert set(atomics) == set(contracts)
    for stem, kernels in atomics.items():
        assert all(c["float"] == 0 for c in kernels.values()), kernels
        assert set(kernels) == set(contracts[stem]["int_atomics"]), stem
    assert atomics["sketch_insert"]["sketch_insert_runs_kernel"]["int"] > 0


def test_straggler_drill_twin_on_the_card(dev):
    """``examples/torch_straggler_drill.py`` on the card prints the CPU
    run's lines (which are the reference example's,
    ``tests/test_torch_example_drill.py``)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src")}
    drill = str(repo / "examples" / "torch_straggler_drill.py")
    procs = [subprocess.Popen([sys.executable, drill, *extra], cwd=repo,
                              env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for extra in ([], ["--device", "cpu"])]
    (card, _), (cpu, _) = (p.communicate(timeout=600) for p in procs)
    assert [p.returncode for p in procs] == [0, 0], card + cpu
    assert card == cpu
    assert "loc=126 (injected chip 126)" in card


# ---------------------------------------------------------------------------
# the reference's serving cells: K3's bounded walk, K4 past 2^31
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_bounded_walk_equals_full_walk_at_prefill_32k(dev, dtype):
    """h2o-danube-3-4b's ``prefill_32k`` shape, q [4, 32,768, 32, 120] over
    8 KV heads with its 4,096 window: the prefill told its keys are sorted
    (``sorted_keys``, each block walking only the tiles that can be live)
    gives the full walk's output bit for bit, in bf16 and in f32; the last
    query tile holds the plain version over every key."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(4, 32768, h, 120, device=dev, generator=gen)
               .to(dtype) for h in (32, 8, 8))
    pos = torch.arange(32768, dtype=torch.int32, device=dev)
    bounded, full = (fa_ops.flash_attention_cuda(
        q, k, v, q_pos=pos, k_pos=pos, causal=True, window=4096,
        sorted_keys=sk) for sk in (True, False))
    assert torch.equal(bounded, full)
    tail = slice(32768 - 128, 32768)
    exp = attention_ref(q[:1, tail], k[:1], v[:1], q_pos=pos[tail],
                        k_pos=pos, causal=True, window=4096)
    if dtype == torch.bfloat16:
        _assert_bf16_rows_close(bounded[:1, tail], exp)
    else:
        torch.testing.assert_close(bounded[:1, tail], exp, atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("b,hq,hk,d,slots,pos,window", [
    (64, 9, 3, 64, 32768, 32767, None),      # smollm decode_32k
    (128, 32, 8, 120, 4096, 32767, 4096),    # danube decode_32k, ring
    (1, 32, 8, 120, 4096, 524287, 4096),     # danube long_500k, ring
    (64, 12, 2, 128, 32768, 32767, None),    # qwen2-vl decode_32k, GQA 6
    (8, 32, 32, 64, 32768, 32767, None),     # stablelm decode_32k, MHA
    (8, 20, 20, 64, 32768, 32767, None),     # whisper decode_32k, self
    (32, 56, 8, 128, 32768, 32767, None),    # yi decode_32k, GQA 7
    (128, 32, 8, 128, 4096, 32767, 4096),    # mixtral decode_32k, ring
    (64, 48, 8, 128, 32768, 32767, None),    # dbrx decode_32k, GQA 6
])
def test_bf16_decode_at_the_serving_cells(dev, b, hq, hk, d, slots, pos,
                                          window):
    """K3's bf16 decode at the serving cells' last step: smollm-135m's 64
    rows over 32,768 slots in order (8 splits of 64 tiles at 132
    multiprocessors), and h2o-danube-3-4b's 4,096-slot ring wrapped at
    positions 32,767 (128 rows) and 524,287 (1 row), the table as the
    cache holds it; then the other decode cells' (qwen2-vl-2b, stablelm-1.6b,
    whisper-large-v3's self-attention, yi-34b, mixtral-8x7b's ring,
    dbrx-132b); within ``BF16_ULPS`` of the plain version over every
    slot."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn(b, t, h, d, device=dev, generator=gen).bfloat16()
               for t, h in ((1, hq), (slots, hk), (slots, hk)))
    k_pos = torch.from_numpy(rolled_pos_tab(slots, 0, pos)).to(dev)
    q_pos = torch.tensor([pos], dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention_bf16_decode"]
    got = fa_ops.flash_attention_cuda(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                      causal=True, window=window)
    assert _lib.LAUNCHES["flash_attention_bf16_decode"] == before + 1
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True,
                        window=window)
    _assert_bf16_rows_close(got, exp)


def test_bf16_cross_decode_at_the_whisper_cell(dev):
    """K3's bf16 decode of whisper-large-v3's ``decode_32k`` cell's
    cross-attention: 8 rows of 20 heads at position 32,767 over the 1,500
    frames, non-causal (every frame live), one decode launch, within
    ``BF16_ULPS`` of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn(8, t, 20, 64, device=dev, generator=gen)
               .bfloat16() for t in (1, 1500, 1500))
    k_pos = torch.arange(1500, dtype=torch.int32, device=dev)
    q_pos = torch.tensor([32767], dtype=torch.int32, device=dev)
    before = _lib.LAUNCHES["flash_attention_bf16_decode"]
    got = fa_ops.flash_attention_cuda(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                      causal=False)
    assert _lib.LAUNCHES["flash_attention_bf16_decode"] == before + 1
    exp = attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=False)
    _assert_bf16_rows_close(got, exp)


@pytest.mark.parametrize("s", [512, 1024, 2048, 4096])
def test_prefill_search_equals_full_walk_at_every_length(dev, s):
    """The search for each block's live tiles, forced also at lengths where
    the wrapper walks from key 0 (``SEARCH_MIN_KEYS`` set to 0), gives the
    full walk's output bit for bit, in bf16 and in f32 (danube's heads and
    window)."""
    gen = torch.Generator(device=dev).manual_seed(s)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(2, s, h, 120, device=dev, generator=gen)
                   .to(dtype) for h in (32, 8, 8))
        full = fa_ops.flash_attention_cuda(q, k, v, q_pos=pos, k_pos=pos,
                                           causal=True, window=1000)
        keep = fa_ops.SEARCH_MIN_KEYS
        fa_ops.SEARCH_MIN_KEYS = 0
        try:
            searched = fa_ops.flash_attention_cuda(
                q, k, v, q_pos=pos, k_pos=pos, causal=True, window=1000,
                sorted_keys=True)
        finally:
            fa_ops.SEARCH_MIN_KEYS = keep
        assert torch.equal(searched, full)


@pytest.mark.parametrize("bf16,chunk", [(False, 4), (True, 4), (True, 2)])
def test_ssd_batch_past_a_grid_s_z_extent_equals_its_halves(dev, bf16,
                                                            chunk):
    """A batch of 65,536 (past a grid's z extent) in one launch each way,
    f32, bf16 on the Hopper design (chunk 4) and on the ``mma.sync`` one
    (chunk 2): its forward and its per-row gradients bit-equal to two
    launches over the halves (rows are independent), ``da`` (a sum over
    the rows and chunks, 131,072 terms in f32 in another order than the
    halves' sum) within 1e-4 of its largest entry, K4's backward
    tolerance."""
    bsz = ssd_ops.MAX_GRID_YZ + 1
    x, dt, a, bm, cm, _ = _ssd_inputs(dev, bsz, 8, 2, 8, 1, 8, 9)
    dy, _ = _ssd_cotangents(dev, bsz, 8, 2, 8, 8, 9)
    if bf16:
        x, bm, cm, dy = (t.bfloat16() for t in (x, bm, cm, dy))

    def run(rows):
        args = [t[rows].contiguous() for t in (x, dt)] + [a] + [
            t[rows].contiguous() for t in (bm, cm)]
        y, st, saved = ssd_ops.ssd_fwd_cuda(*args, chunk=chunk)
        return (y, st), ssd_ops.ssd_bwd_cuda(
            *args, dy[rows].contiguous(), None, saved=saved, chunk=chunk)
    whole = run(slice(None))
    half = bsz // 2
    lo, hi = run(slice(0, half)), run(slice(half, None))
    for i in range(2):
        assert torch.equal(whole[0][i], torch.cat([lo[0][i], hi[0][i]]))
    for i in (0, 1, 3, 4):
        assert torch.equal(whole[1][i], torch.cat([lo[1][i], hi[1][i]]))
    da = lo[1][2] + hi[1][2]
    assert float((whole[1][2] - da).abs().max()) \
        <= 1e-4 * float(da.abs().max())


#: K4's backward past 65,535 (chunk, head) rows: (bf16, B, S, H, P, G, N,
#: chunk, segment of the plain backward).  mamba2-1.3b's heads, groups and
#: state over 139,264 tokens (1,088 chunks of 128 x 64 heads = 69,632 rows) in
#: f32 and in bf16 (the Hopper design), and a chunk of 18, which the
#: Hopper design does not take (2,223 chunks x 32 heads = 71,136 rows).
SSD_PAST_ROWS = [(False, 1, 139264, 64, 64, 8, 128, 128, 34816),
                 (True, 1, 139264, 64, 64, 8, 128, 128, 34816),
                 (True, 1, 40000, 32, 8, 2, 8, 18, 10080)]


@pytest.mark.parametrize("bf16,b,s,h,p,g,n,chunk,segment", SSD_PAST_ROWS)
def test_ssd_backward_past_65535_chunk_head_rows(dev, bf16, b, s, h, p, g,
                                                 n, chunk, segment):
    """K4's backward past a grid's y extent of 65,535 (chunk, head) rows,
    from a non-zero state with a final-state cotangent, against the plain
    backward over segments (``ssd_bwd_ref_segments``): dx, db and dc
    within 1e-4 (f32) or ``BF16_BWD_ULPS`` (bf16) of each gradient's
    largest entry, ddt, da and dinit within 1e-4 of theirs."""
    assert -(-s // chunk) * h > ssd_ops.MAX_GRID_YZ
    x, dt, a, bm, cm, s0 = _ssd_inputs(dev, b, s, h, p, g, n, 12)
    dy, ds = _ssd_cotangents(dev, b, s, h, p, n, 12)
    if bf16:
        x, bm, cm, dy = (t.bfloat16() for t in (x, bm, cm, dy))
    y, _, saved = ssd_ops.ssd_fwd_cuda(x, dt, a, bm, cm, chunk=chunk,
                                       init_state=s0)
    got = ssd_ops.ssd_bwd_cuda(x, dt, a, bm, cm, dy, ds, saved=saved,
                               chunk=chunk, init_state=s0)
    del y, saved
    exp = ssd_plain.ssd_bwd_ref_segments(x, dt, a, bm, cm, dy, ds,
                                         segment=segment, chunk=chunk,
                                         init_state=s0)
    for name, g_, e in zip(("dx", "ddt", "da", "db", "dc", "dinit"), got,
                           exp):
        if bf16 and name in ("dx", "db", "dc"):
            _assert_bf16_grad_close(g_, e)
        else:
            assert g_.dtype == torch.float32, name
            assert float((g_.float() - e.float()).abs().max()) \
                <= 1e-4 * float(e.float().abs().max()), name


def test_ssd_bf16_forward_past_2_31_elements(dev):
    """K4's bf16 forward on x [2, 524,288, 64, 64] (2^32 elements, 8.6 GB;
    mamba2-1.3b's heads, 8,192 chunks x 64 heads in its grids) against the
    plain version run over segments of 32,768 tokens with the state
    carried: the final state within 2e-4 and the last chunk's outputs
    within ``BF16_ULPS``."""
    b, s, h, p, n = 2, 524288, 64, 64, 128
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale):
        return torch.randn(*shape, device=dev, generator=gen) * scale
    x = randn(b, s, h, p, scale=0.5).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, h, scale=1.0)) * 0.3
    a = -torch.exp(randn(h, scale=0.3))
    bm, cm = (randn(b, s, 1, n, scale=0.4).bfloat16() for _ in range(2))
    assert x.numel() > 2 ** 31
    y, state = ssd_ops.ssd_cuda(x, dt, a, bm, cm, chunk=128)
    st = None
    for i in range(0, s, 32768):
        seg = slice(i, i + 32768)
        yp, st = ssd_ref(x[:, seg].contiguous(), dt[:, seg].contiguous(), a,
                         bm[:, seg].contiguous(), cm[:, seg].contiguous(),
                         chunk=128, init_state=st)
    _assert_bf16_rows_close(y[:, -128:], yp[:, -128:])
    torch.testing.assert_close(state, st, atol=2e-4, rtol=2e-4)
