"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The file imports neither ``jax`` nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The sketch kernel must equal the plain version exactly (integer state,
drain and float statistics: both round each float operation alone, the
kernel being built with ``-fmad=false``); the FailRank step's L' exactly,
its s' within 1e-5 (the plain version's matrix-vector product sums in
another order).  Flash attention is held at the reference's f32 tolerance,
2e-5, and the SSD scan at 2e-4 (both sum in another order than the plain
versions' einsums).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sketch import SketchParams, split_key
from repro_torch.kernels import _lib
from repro_torch.kernels.failrank_step import ops as fr_ops
from repro_torch.kernels.failrank_step.ref import failrank_step_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     rolled_pos_tab)
from repro_torch.kernels.sketch_update import ops as sk_ops
from repro_torch.kernels.sketch_update import ref as sk_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import random_inputs, ssd_ref

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
    (3, 2, 1024, 8, 1024, 200)])
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


@pytest.mark.parametrize("n", [68, 260])
def test_failrank_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    x = [torch.from_numpy(a).to(dev) for a in
         (w, rng.random((n, n)).astype(np.float32),
          rng.random(n).astype(np.float32), rng.random(n).astype(np.float32))]
    s_k, l_k = fr_ops.failrank_step(*x)
    s_p, l_p = failrank_step_ref(*x)
    torch.testing.assert_close(s_k, s_p, atol=1e-5, rtol=0)
    assert torch.equal(l_k, l_p)


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
        fa_ops.gqa_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             q_pos=pos, k_pos=pos)
    with pytest.raises(ValueError, match="int32"):
        fa_ops.gqa_attention(q, k, v, q_pos=pos.long(), k_pos=pos)
    q, k, v = _attn_inputs(dev, 1, 8, 8, 2, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
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
    *args, _ = _ssd_inputs(dev, 1, 8, 2, 256, 1, 256, 0)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd(*args, chunk=128)
