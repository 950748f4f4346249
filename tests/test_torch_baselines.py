"""The port's five baseline detectors against the JAX reference's, on the
CPU.

The baselines are host code (numpy) in both packages, so on the same
``SimResult``s they must agree exactly: flag, kind, location, score and the
whole ranking.  darknet19 on a 4×4 mesh and torus, prepared on the healthy
run of seed 999 (as the campaign's deployments are), judged on 10× core,
link and router faults and on a fault-free trace.  Mirrors
``test_detectors.py``'s registry checks: the built-ins resolve in
``DEFAULT_DETECTORS`` order, equal to the reference's.
"""

import pytest

from repro.core.detectors import DEFAULT_DETECTORS as J_DEFAULT
from repro.core.detectors import instantiate_detector as j_instantiate
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.routing import build_topology
from repro.core.sloth import Sloth
from repro_torch.convert import sim_result_from_numpy
from repro_torch.core import baselines as TB
from repro_torch.core import routing as TRt
from repro_torch.core.detectors import (DEFAULT_DETECTORS,
                                        available_detectors,
                                        instantiate_detector)
from repro_torch.core.failures import FailSlow as TFailSlow

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FAULTS = {"core": ("core", 5), "link": ("link", 20), "router": ("router", 9),
          "none": None}


@pytest.fixture(scope="module", params=("mesh", "torus"))
def fabric(request):
    """(fabric, reference pipeline, port topology, healthy profile as
    (reference, port), traces by fault as (reference, port))."""
    name = request.param
    sloth = Sloth(build_workload("darknet19"), build_topology(name, 4, 4))
    healthy = sloth.run(None, seed=999)
    traces = {}
    for label, spec in FAULTS.items():
        sim = sloth.run([FailSlow(*spec, 1.0, 8.0, 10.0)] if spec else None,
                        seed=0)
        traces[label] = (sim, sim_result_from_numpy(sim))
    return (name, sloth, TRt.build_topology(name, 4, 4),
            (healthy, sim_result_from_numpy(healthy)), traces)


def test_registry_order_matches_reference():
    assert DEFAULT_DETECTORS == J_DEFAULT
    assert available_detectors()[:len(J_DEFAULT)] == J_DEFAULT
    assert TB.BASELINE_NAMES == J_DEFAULT[1:]


@pytest.mark.parametrize("name", J_DEFAULT[1:])
def test_baseline_matches_reference(fabric, name):
    _, sloth, mesh_t, (prof_j, prof_t), traces = fabric
    ref = j_instantiate(name).prepare(sloth.graph, sloth.mesh, prof_j)
    port = instantiate_detector(name).prepare(None, mesh_t, prof_t)
    assert type(port).__module__ == "repro_torch.core.baselines"
    for label, (sim_j, sim_t) in traces.items():
        vj, vt = ref.analyse(sim_j), port.analyse(sim_t)
        assert (vt.flagged, vt.kind, vt.location, vt.score) \
            == (vj.flagged, vj.kind, vj.location, vj.score), label
        assert vt.ranking == vj.ranking, label
        assert vt.total_time == vj.total_time
        assert vt.detector == name and vt.mesh is mesh_t
        spec = FAULTS[label]
        assert vt.matches(TFailSlow(*spec, 1.0, 8.0) if spec else None) \
            == vj.matches(FailSlow(*spec, 1.0, 8.0) if spec else None)
    if name == "thres":
        assert port.analyse(traces["core"][1]).flagged
