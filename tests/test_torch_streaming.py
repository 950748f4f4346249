"""The port's streaming recorder and ``SlothStream`` against the JAX
reference, on the CPU.

Mirrors ``test_streaming.py``: ``split_sim`` partitions a trace exactly as
the reference does; for both recorder impls a chunked recording equals the
one-shot recording bit for bit (1, 3 and 7 chunks, and 40 chunks, which
leaves some empty, under forced eviction; 4 chunks at the default
geometry); the port's streamed ``RecorderOutput`` equals the
reference's (keys, counts, arrivals and accounting exact, statistics at the
port recorder test's ``rel=1e-5``); ``SlothStream`` gives the reference's
per-window verdicts and ``first_flag_time``.  darknet19 and resnet50 on a
4×4 mesh, a 10× core fault.
"""

import numpy as np
import pytest

from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import Mesh2D
from repro.core.sketch import SketchParams
from repro.core.sloth import Sloth, SlothConfig
from repro.core.streaming import StreamingRecorder as JStreamingRecorder
from repro.core.streaming import split_sim as j_split_sim
from repro_torch.convert import sim_result_from_numpy
from repro_torch.core import graph as TG
from repro_torch.core import routing as TRt
from repro_torch.core import sloth as TS
from repro_torch.core.recorder import RECORDER_IMPLS, record
from repro_torch.core.sketch import SketchParams as TSketchParams
from repro_torch.core.streaming import StreamingRecorder, split_sim
from repro_torch.kernels import _lib

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

WORKLOADS = ("darknet19", "resnet50")
EVICTING = SketchParams(d=2, m=256, H=4, L=8)


@pytest.fixture(scope="module")
def traces():
    """workload → (reference trace, the same trace as the port's
    SimResult, hop latency)."""
    out = {}
    for wl in WORKLOADS:
        sloth = Sloth(build_workload(wl), Mesh2D(4))
        sim = sloth.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)
        out[wl] = (sim, sim_result_from_numpy(sim),
                   sloth.sim_cfg.hop_latency)
    return out


def _tp(p: SketchParams) -> TSketchParams:
    return TSketchParams(d=p.d, m=p.m, H=p.H, L=p.L)


def _stream(rec, chunks):
    for c in chunks:
        rec.observe(c)
    return rec.output()


ACCOUNTING = ("sketch_comp_bytes", "sketch_comm_bytes", "n_comp_drained",
              "n_comm_drained", "n_comp_records", "n_comm_records",
              "raw_comp_bytes", "raw_comm_bytes", "compression_ratio")


@pytest.mark.parametrize("n_chunks", (1, 3, 7, 64))
@pytest.mark.parametrize("wl", WORKLOADS)
def test_split_sim_matches_reference(traces, wl, n_chunks):
    sim_j, sim_t, _ = traces[wl]
    got, exp = split_sim(sim_t, n_chunks), j_split_sim(sim_j, n_chunks)
    assert len(got) == len(exp) == n_chunks
    for a, b in zip(got, exp):
        assert (a.total_time, a.n_raw_records) \
            == (b.total_time, b.n_raw_records)
        for side in ("comp", "comm"):
            x, y = getattr(a, side), getattr(b, side)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype \
                    and np.array_equal(x[k], y[k]), (side, k)
    if n_chunks == 64:
        assert any(not len(c.comp["core"]) for c in got)   # empty chunks


@pytest.mark.parametrize("geometry,n_chunks", [
    ("evicting", 1), ("evicting", 3), ("evicting", 7), ("evicting", 40),
    ("default", 4)])
@pytest.mark.parametrize("impl", RECORDER_IMPLS)
def test_chunked_equals_one_shot(traces, impl, geometry, n_chunks):
    """Same impl, any chunking → bit-identical patterns and accounting,
    at the default geometry and under forced Stage-2 eviction (the
    per-chunk drains must fold into the one-shot eviction stream); on the
    CPU nothing launches."""
    _, sim, hop = traces["darknet19"]
    p = _tp(EVICTING if geometry == "evicting" else SketchParams())
    one = record(sim, p, hop_latency=hop, impl=impl, device="cpu")
    before = dict(_lib.LAUNCHES)
    chunks = split_sim(sim, n_chunks)
    out = _stream(StreamingRecorder(p, hop_latency=hop, impl=impl,
                                    device="cpu"), chunks)
    assert _lib.LAUNCHES == before
    if geometry == "evicting":
        assert one.n_comp_drained > 0 and one.n_comm_drained > 0
    assert out.comp_patterns == one.comp_patterns
    assert out.comm_patterns == one.comm_patterns
    for f in ACCOUNTING:
        assert getattr(out, f) == getattr(one, f), f
    if n_chunks == 40:
        assert any(not len(c.comm["src"]) for c in chunks)


@pytest.mark.parametrize("wl,impl,geometry", [
    ("darknet19", "ref", "default"), ("darknet19", "ref", "evicting"),
    ("darknet19", "batched", "evicting"), ("resnet50", "ref", "evicting"),
    ("resnet50", "batched", "evicting")])
def test_streamed_output_matches_reference(traces, wl, impl, geometry):
    sim_j, sim_t, hop = traces[wl]
    p = SketchParams() if geometry == "default" else EVICTING
    exp = _stream(JStreamingRecorder(p, hop_latency=hop, impl=impl),
                  j_split_sim(sim_j, 3))
    got = _stream(StreamingRecorder(_tp(p), hop_latency=hop, impl=impl,
                                    device="cpu"), split_sim(sim_t, 3))
    for side in ("comp", "comm"):
        g, e = getattr(got, side + "_patterns"), getattr(exp,
                                                         side + "_patterns")
        assert [(q.key, q.count, q.arrival) for q in g] \
            == [(q.key, q.count, q.arrival) for q in e], side
        for a, b in zip(g, e):
            for f in ("sum_dur", "sum_sq_dur", "sum_val", "t_first",
                      "t_last", "min_dur"):
                assert getattr(a, f) == pytest.approx(getattr(b, f),
                                                      rel=1e-5), (side, f)
    for f in ACCOUNTING:
        assert getattr(got, f) == getattr(exp, f), f


def test_unknown_impl_and_default_device_rejected():
    with pytest.raises(ValueError, match="unknown recorder impl"):
        StreamingRecorder(TSketchParams(), impl="vectorised", device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingRecorder(TSketchParams(), impl="batched")


@pytest.mark.parametrize("wl,impl", [("darknet19", "ref"),
                                     ("darknet19", "batched"),
                                     ("resnet50", "ref")])
def test_sloth_stream_matches_reference(traces, wl, impl):
    """Per window: flag, kind, location and ranking order equal, scores
    within ``rel=1e-5``; the same ``first_flag_time``; the last window's
    verdict equals the port's own post-hoc ``analyse`` exactly."""
    sim_j, sim_t, _ = traces[wl]
    ref = Sloth(build_workload(wl), Mesh2D(4),
                SlothConfig(recorder_impl=impl))
    port = TS.Sloth(TG.build_workload(wl), TRt.Mesh2D(4),
                    TS.SlothConfig(recorder_impl=impl), device="cpu")
    sj, st = ref.stream(), port.stream()
    chunks_j, chunks_t = j_split_sim(sim_j, 4), split_sim(sim_t, 4)
    for i, (cj, ct) in enumerate(zip(chunks_j, chunks_t)):
        horizon = sim_j.total_time if i == 3 else None
        vj, vt = sj.observe(cj, total_time=horizon), \
            st.observe(ct, total_time=horizon)
        assert (vt.flagged, vt.kind, vt.location) \
            == (vj.flagged, vj.kind, vj.location), i
        assert [(k, l) for k, l, _ in vt.ranking] \
            == [(k, l) for k, l, _ in vj.ranking], i
        for a, b in zip(vt.ranking, vj.ranking):
            assert a[2] == pytest.approx(b[2], rel=1e-5)
    assert st.first_flag_time == sj.first_flag_time
    assert st.first_flag_time is not None
    assert st.detection_latency(1.0) == sj.detection_latency(1.0)
    post = port.analyse(sim_t)
    assert (vt.flagged, vt.kind, vt.location, vt.ranking) \
        == (post.flagged, post.kind, post.location, post.ranking)


def test_stream_plans_mitigation_once(traces):
    """A stream armed with a policy plans at the first flag, once."""
    _, sim, _ = traces["darknet19"]
    port = TS.Sloth(TG.build_workload("darknet19"), TRt.Mesh2D(4),
                    device="cpu")
    st = port.stream(policy="remap")
    for c in split_sim(sim, 4):
        st.observe(c)
    assert st.mitigation_plan is not None and st.mitigation_plan.acted
    assert st.mitigation_time == st.first_flag_time
    assert st.mitigation_plan.exclude_cores == (5,)
