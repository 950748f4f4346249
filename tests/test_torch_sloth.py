"""The port's ``Sloth.detect`` end to end against the JAX reference.

darknet19 on a 4×4 fabric, on the CPU, seed 0: for 10× core, link and
router faults and no fault with the batched recorder, a core fault with the
numpy-oracle recorder, and a link fault on a torus, the simulated trace is
bit-identical and the verdict equal (flag, kind, location, the order of
``ranking`` and ``flagged_resources``, FailRank iterations), with scores
within ``rel=1e-5``.  Also: the port imports neither ``jax`` nor the
reference package, and its default device is the card, with no fallback.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.memory_model import MemoryBudgetError, packed_state_bytes
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import Mesh2D, build_topology
from repro.core.sketch import SketchParams
from repro.core.sloth import Sloth, SlothConfig
from repro_torch.analysis import memory_model as TM
from repro_torch.core import failures as TF
from repro_torch.core import graph as TG
from repro_torch.core import routing as TRt
from repro_torch.core import sloth as TS
from repro_torch.core.sketch import SketchParams as TSketchParams
from repro_torch.device import resolve_device

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

#: (fabric, recorder impl, fault): the issue's three batched cases on the
#: mesh, a router fault, the numpy-oracle recorder, and a torus fabric
CASES = {
    "core": ("mesh", "batched", ("core", 5)),
    "link": ("mesh", "batched", ("link", 20)),
    "none": ("mesh", "batched", None),
    "router": ("mesh", "batched", ("router", 9)),
    "core-ref-impl": ("mesh", "ref", ("core", 5)),
    "torus-link": ("torus", "batched", ("link", 7)),
}


@pytest.fixture(scope="module")
def pipelines():
    """(reference, port) pipelines per (fabric, impl), built once."""
    cache = {}

    def get(fabric, impl):
        if (fabric, impl) not in cache:
            cache[fabric, impl] = (
                Sloth(build_workload("darknet19"),
                      build_topology(fabric, 4, 4),
                      SlothConfig(recorder_impl=impl)),
                TS.Sloth(TG.build_workload("darknet19"),
                         TRt.build_topology(fabric, 4, 4),
                         TS.SlothConfig(recorder_impl=impl), device="cpu"))
        return cache[fabric, impl]
    return get


def _ranked(items):
    return [(k, l) for k, l, _ in items]


@pytest.mark.parametrize("case", list(CASES))
def test_detect_matches_reference(pipelines, case):
    fabric, impl, spec = CASES[case]
    ref, port = pipelines(fabric, impl)
    jf = [FailSlow(*spec, 1.0, 8.0, 10.0)] if spec else None
    tf = [TF.FailSlow(*spec, 1.0, 8.0, 10.0)] if spec else None
    sim_j, sim_t = ref.run(jf, seed=0), port.run(tf, seed=0)
    assert sim_t.total_time == sim_j.total_time
    assert sim_t.n_raw_records == sim_j.n_raw_records
    for side in ("comp", "comm"):
        a, b = getattr(sim_t, side), getattr(sim_j, side)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    vj, vt = ref.analyse(sim_j), port.analyse(sim_t)
    assert (vt.flagged, vt.kind, vt.location) \
        == (vj.flagged, vj.kind, vj.location)
    assert _ranked(vt.ranking) == _ranked(vj.ranking)
    assert _ranked(vt.flagged_resources) == _ranked(vj.flagged_resources)
    assert vt.failrank.iterations == vj.failrank.iterations
    for a, b in zip(vt.ranking + list(vt.flagged_resources),
                    vj.ranking + list(vj.flagged_resources)):
        assert a[2] == pytest.approx(b[2], rel=1e-5)
    assert vt.score == pytest.approx(vj.score, rel=1e-5)
    assert vt.matches(tf[0] if tf else None) \
        == vj.matches(jf[0] if jf else None)
    assert vt.recorder.compression_ratio == vj.recorder.compression_ratio


def test_port_imports_neither_jax_nor_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; import repro_torch.core.sloth, "
            "repro_torch.convert, repro_torch.kernels.failrank_step.ops, "
            "repro_torch.launch.serve, repro_torch.models.transformer, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.ssd_scan.ops, repro_torch.core.campaign, "
            "repro_torch.kernels.sketch_update.ops, "
            "repro_torch.kernels.sketch_update.layout, "
            "repro_torch.core.streaming, repro_torch.mitigate, "
            "repro_torch.launch.campaign, repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.distributed.telemetry, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.store, repro_torch.core.compiler, "
            "repro_torch.core.probes, repro_torch.analysis, "
            "repro_torch.analysis.__main__, repro_torch.analysis.report, "
            "repro_torch.analysis.memory_model, "
            "repro_torch.analysis.kernel_audit, repro_torch.analysis.lints, "
            "repro_torch.analysis.callgraph, repro_torch.analysis.dataflow; "
            "from repro_torch.analysis import run_checks; run_checks(); "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=src,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.Sloth(TG.build_workload("darknet19"), TRt.Mesh2D(4))
    assert resolve_device("cpu") == torch.device("cpu")


def test_memory_budget_guard_matches_reference():
    for d, m, L in ((2, 1024, 1024), (3, 7, 5), (8, 4096, 2048)):
        assert TM.packed_state_bytes(TSketchParams(d=d, m=m, L=L)) \
            == packed_state_bytes(SketchParams(d=d, m=m, L=L))
    with pytest.raises(TM.MemoryBudgetError, match="over the 256 KiB"):
        TS.Sloth(TG.build_workload("darknet19"), TRt.Mesh2D(4),
                 TS.SlothConfig(sketch=TSketchParams(m=65536),
                                recorder_impl="batched"), device="cpu")
    with pytest.raises(MemoryBudgetError, match="over the 256 KiB"):
        Sloth(build_workload("darknet19"), Mesh2D(4),
              SlothConfig(sketch=SketchParams(m=65536),
                          recorder_impl="batched"))


def test_registry_resolves_sloth(pipelines):
    """The port's registry holds the reference's six built-ins in its order
    (SLOTH, then the five baselines); the SLOTH adapter's verdict equals
    the pipeline's, and a baseline's adapter judges through the same
    protocol and router-aware ``matches``."""
    from repro.core.detectors import DEFAULT_DETECTORS
    from repro_torch.core.detectors import (available_detectors,
                                            instantiate_detector,
                                            prepare_detector)
    # the reference's registry may also hold other test modules' detectors
    assert available_detectors() == DEFAULT_DETECTORS == (
        "sloth", "thres", "mscope", "iaso", "perseus", "adr")
    _, port = pipelines("mesh", "batched")
    det = instantiate_detector("sloth").prepare(
        port.graph, port.mesh, None, port.cfg, device="cpu")
    truth = TF.FailSlow("core", 5, 1.0, 8.0, 10.0)
    sim = port.run([truth], seed=0)
    a, b = det.analyse(sim), port.analyse(sim)
    assert (a.flagged, a.kind, a.location, a.ranking) \
        == (b.flagged, b.kind, b.location, b.ranking)
    assert a.detector == "sloth"
    thres = prepare_detector("thres", port.graph, port.mesh,
                             port.run(None, seed=999), port.cfg)
    v = thres.analyse(sim)
    assert v.detector == "thres" and v.mesh is port.mesh
    assert (v.flagged, v.kind, v.location) == (True, "core", 5)
    assert v.matches(truth) and not v.matches(None)


@pytest.mark.parametrize("case", ["mesh16", "torus16", "random",
                                  "non_finite"])
def test_em_link_inverse_bw_equals_reference_bit_for_bit(case):
    """The port's EM (its sums over events taken over each link's events
    only) returns the reference's dense EM's θ bit for bit: on the 16×16
    pod's mesh and torus path matrices, on random 0/1 matrices, and with a
    non-finite transfer size (where the port takes the dense sum)."""
    from repro.core.detection import em_link_inverse_bw as ref_em
    from repro_torch.core.detection import em_link_inverse_bw as port_em
    rng = np.random.default_rng(["mesh16", "torus16", "random",
                                 "non_finite"].index(case))
    if case in ("mesh16", "torus16"):
        mesh = build_topology(case[:-2], 16, 16)
        pairs = [tuple(map(int, rng.choice(256, 2, replace=False)))
                 for _ in range(3000)]
        mats = [mesh.path_matrix(pairs)]
    else:
        mats = [(rng.random((int(rng.integers(50, 2000)),
                             int(rng.integers(10, 400))))
                 < rng.uniform(0.005, 0.1)).astype(np.float64)
                for _ in range(8)]
    for A in mats:
        n = A.shape[0]
        T = rng.random(n) * 1e-6
        V = rng.random(n) * 1e4
        W = rng.integers(1, 50, n).astype(np.float64)
        if case == "non_finite":
            V[int(rng.integers(n))] = np.inf
        with np.errstate(invalid="ignore"):    # 0·inf in both
            want = ref_em(A, T, V, W, 50e-9, 60)
            got = port_em(A, T, V, W, 50e-9, 60)
        assert np.array_equal(got, want, equal_nan=True)
