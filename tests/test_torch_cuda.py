"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode).  The file imports neither ``jax`` nor the
reference package, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The sketch kernel must equal the plain version exactly (integer state,
drain and float statistics: both round each float operation alone, the
kernel being built with ``-fmad=false``); the FailRank step's L' exactly,
its s' within 1e-5 (the plain version's matrix-vector product sums in
another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.sketch import SketchParams, split_key
from repro_torch.kernels import _lib
from repro_torch.kernels.failrank_step import ops as fr_ops
from repro_torch.kernels.failrank_step.ref import failrank_step_ref
from repro_torch.kernels.sketch_update import ops as sk_ops
from repro_torch.kernels.sketch_update import ref as sk_ref

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
