"""The port's recorder against the JAX reference on one instrumented trace.

The trace is the reference simulator's (darknet19, 4×4 mesh, core 5 at
10×), converted with ``sim_result_from_numpy`` so both recorders see the
same ``SimResult``.  Mirrors ``test_recorder.py:83-129``: keys, counts and
arrival order exact, statistics to float32 tolerance, compression
accounting identical, for both impls, at the default geometry and under
forced Stage-2 eviction.
"""

import numpy as np
import pytest

from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.recorder import record as j_record
from repro.core.routing import Mesh2D
from repro.core.sketch import SketchParams
from repro.core.sloth import Sloth
from repro_torch.convert import sim_result_from_numpy
from repro_torch.core import probes as P
from repro_torch.core.recorder import RECORDER_IMPLS, record
from repro_torch.core.sketch import SketchParams as TSketchParams
from repro_torch.kernels import _lib

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

GEOMETRIES = {"default": SketchParams(),
              "evicting": SketchParams(d=2, m=256, H=4, L=8)}


@pytest.fixture(scope="module")
def trace():
    sloth = Sloth(build_workload("darknet19"), Mesh2D(4))
    sim = sloth.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)
    return sim, sloth.sim_cfg.hop_latency


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("impl", RECORDER_IMPLS)
def test_record_matches_reference(trace, impl, geometry):
    sim, hop = trace
    p = GEOMETRIES[geometry]
    exp = j_record(sim, p, hop_latency=hop, impl=impl)
    before = dict(_lib.LAUNCHES)
    got = record(sim_result_from_numpy(sim),
                 TSketchParams(d=p.d, m=p.m, H=p.H, L=p.L), hop_latency=hop,
                 impl=impl, device="cpu")
    assert _lib.LAUNCHES == before          # the CPU never launches
    assert got.impl == impl
    for side in ("comp", "comm"):
        g = getattr(got, side + "_patterns")
        e = getattr(exp, side + "_patterns")
        assert [q.key for q in g] == [q.key for q in e], side
        for a, b in zip(g, e):
            assert (a.count, a.arrival) == (b.count, b.arrival), side
            for f in ("sum_dur", "sum_sq_dur", "sum_val", "t_first",
                      "t_last", "min_dur"):
                assert getattr(a, f) == pytest.approx(getattr(b, f),
                                                      rel=1e-5), (side, f)
    assert all(q.key & P.COMP_KEY_TAG for q in got.comp_patterns)
    assert all(q.key & P.COMM_KEY_TAG for q in got.comm_patterns)
    for f in ("sketch_comp_bytes", "sketch_comm_bytes", "n_comp_drained",
              "n_comm_drained", "n_comp_records", "n_comm_records",
              "raw_comp_bytes", "raw_comm_bytes"):
        assert getattr(got, f) == getattr(exp, f), f
    assert got.compression_ratio == exp.compression_ratio
    assert got.onchip_bytes() == exp.onchip_bytes()
    if geometry == "evicting":
        assert got.n_comp_drained > 0 and got.n_comm_drained > 0


def test_record_unknown_impl_rejected(trace):
    sim, _ = trace
    with pytest.raises(ValueError, match="unknown recorder impl"):
        record(sim_result_from_numpy(sim), TSketchParams(),
               impl="vectorised")


def test_record_batched_needs_a_device_without_a_card(trace):
    """``device=None`` means the card; without one the batched recorder
    raises instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sim, _ = trace
    with pytest.raises(RuntimeError, match="no CUDA device"):
        record(sim_result_from_numpy(sim), TSketchParams(), impl="batched")
