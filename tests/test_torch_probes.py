"""The port's ``compiler.plan_for_mode`` and ``probes`` helpers against the
JAX reference, on the CPU.

Each test cites the reference test it mirrors.  Equal means equal:
the same ``ProbePlan`` fields, the same ``ValueError``, array for array
the same dtypes and values from the trace expansions (a simulated
darknet19 trace on a 4×4 mesh, and empty traces), the same raw byte
counts, the same decoded keys in both key spaces, and the same simulated
``total_time`` with and without the full probe plan (paper Fig 10's
≤10 % probe overhead).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import compiler as RC
from repro.core import probes as RP
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import Mesh2D
from repro.core.simulator import simulate
from repro.core.sloth import Sloth
from repro_torch.core import compiler as TC
from repro_torch.core import graph as TG
from repro_torch.core import probes as TP
from repro_torch.core import routing as TR
from repro_torch.core import simulator as TSim
from repro_torch.core import sloth as TS

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(scope="module")
def trace():
    """A darknet19 trace on 4×4 with a 10× core fault (the reference's
    simulator; the port's simulates it bit for bit,
    ``test_torch_sloth.py``)."""
    sloth = Sloth(build_workload("darknet19"), Mesh2D(4))
    return sloth.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# mirrors tests/test_sloth_e2e.py::test_probe_overhead_small (the modes)
@pytest.mark.parametrize("mode", ["comm", "comp", "full", "none"])
def test_plan_for_mode_equals_reference(mode):
    ref, port = RC.plan_for_mode(mode), TC.plan_for_mode(mode)
    if mode == "none":
        assert ref is None and port is None
    else:
        assert isinstance(port, TSim.ProbePlan)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.records_per_task() == ref.records_per_task()


def test_plan_for_mode_rejects_an_unknown_mode():
    for plan_for_mode in (RC.plan_for_mode, TC.plan_for_mode):
        with pytest.raises(ValueError, match="stage"):
            plan_for_mode("stage")


# mirrors the reference's trace expansion (src/repro/core/probes.py:77-128)
@pytest.mark.parametrize("k", [1, 64])
def test_expand_comp_trace_equals_reference(trace, k):
    assert len(trace.comp["core"]) > 0
    _same(TP.expand_comp_trace(trace.comp, k),
          RP.expand_comp_trace(trace.comp, k))


@pytest.mark.parametrize("packet_bytes,max_packets",
                         [(TP.PACKET_BYTES, 64), (256, 8)])
def test_expand_comm_trace_equals_reference(trace, packet_bytes,
                                            max_packets):
    assert len(trace.comm["src"]) > 0
    _same(TP.expand_comm_trace(trace.comm, packet_bytes, max_packets),
          RP.expand_comm_trace(trace.comm, packet_bytes, max_packets))


def test_expansions_of_empty_traces_are_copies(trace):
    comp = {k: v[:0] for k, v in trace.comp.items()}
    comm = {k: v[:0] for k, v in trace.comm.items()}
    for port, ref, inp in ((TP.expand_comp_trace(comp),
                            RP.expand_comp_trace(comp), comp),
                           (TP.expand_comm_trace(comm),
                            RP.expand_comm_trace(comm), comm)):
        _same(port, ref)
        assert all(port[k] is not inp[k] for k in inp)


def test_raw_bytes_equals_reference(trace):
    assert TP.COMP_RECORD_BYTES == RP.COMP_RECORD_BYTES
    assert TP.COMM_RECORD_BYTES == RP.COMM_RECORD_BYTES
    assert TP.PACKET_BYTES == RP.PACKET_BYTES
    comp = TP.expand_comp_trace(trace.comp)
    comm = TP.expand_comm_trace(trace.comm)
    for n_comp, n_comm in ((0, 0), (1, 0), (0, 1),
                           (len(comp["core"]), len(comm["src"]))):
        assert TP.raw_bytes(n_comp, n_comm) == RP.raw_bytes(n_comp, n_comm)


# mirrors tests/test_recorder.py::test_decoders_unaffected_by_tag_fix
def test_decoders_equal_reference_on_both_key_spaces(trace):
    rng = np.random.default_rng(7)
    comp_keys = TP.comp_pattern_keys(trace.comp).tolist() \
        + rng.integers(0, 2**62, 200).tolist()
    comm_keys = TP.comm_pattern_keys(trace.comm).tolist() \
        + rng.integers(0, 2**62, 200).tolist()
    for key in comp_keys:
        assert TP.decode_comp_key(key) == RP.decode_comp_key(key)
    for key in comm_keys:
        assert TP.decode_comm_key(key) == RP.decode_comm_key(key)
    comp = {"core": np.array([7]), "stage": np.array([3]),
            "op": np.array([2]), "flops": np.array([1e6])}
    d = TP.decode_comp_key(int(TP.comp_pattern_keys(comp)[0]))
    assert (d["core"], d["stage"], d["op"]) == (7, 3, 2)
    comm = {"src": np.array([4]), "dst": np.array([9]),
            "stage": np.array([5]), "bytes": np.array([4096.0])}
    d = TP.decode_comm_key(int(TP.comm_pattern_keys(comm)[0]))
    assert (d["src"], d["dst"], d["stage"]) == (4, 9, 5)


# mirrors tests/test_sloth_e2e.py::test_probe_overhead_small
def test_probe_overhead_small():
    ref = Sloth(build_workload("resnet50"), Mesh2D(4))
    port = TS.Sloth(TG.build_workload("resnet50"), TR.Mesh2D(4),
                    device="cpu")
    rcfg = dataclasses.replace(ref.sim_cfg, seed=0)
    tcfg = dataclasses.replace(port.sim_cfg, seed=0)
    r_none = simulate(ref.mapped, rcfg, probes=None).total_time
    r_full = simulate(ref.mapped, rcfg,
                      probes=RC.plan_for_mode("full")).total_time
    t_none = TSim.simulate(port.mapped, tcfg, probes=None).total_time
    t_full = TSim.simulate(port.mapped, tcfg,
                           probes=TC.plan_for_mode("full")).total_time
    assert (t_none, t_full) == (r_none, r_full)
    assert (t_full / t_none - 1) < 0.10        # ≤10% (paper Fig 10)
