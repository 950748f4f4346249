"""The port's mitigation layer against the JAX reference's, on the CPU.

Mirrors ``test_mitigate.py``: the policy registry, ``flagged_sites``,
every policy's plan for the same verdicts, ``DetourTopology`` routes and
path matrices, ``clip_failures``, the mitigated deployments and their
``simulate_mitigated`` traces (bit-identical arrays), ``work_done_frac``,
and a mitigated campaign whose ``by_mitigation`` table equals the
reference's, with the ``none`` control recovering exactly 0.0.  All of it
is host code (numpy) in both packages, so everything is compared exactly.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.campaign import CampaignGrid, DeploymentCache, run_campaign
from repro.core.detectors import Verdict
from repro.core.failures import FailSlow
from repro.core.graph import build_workload
from repro.core.mapping import map_graph
from repro.core.routing import DetourTopology, build_topology
from repro.core.simulator import clip_failures, simulate_mitigated
from repro.core.sloth import Sloth
from repro.mitigate import available_policies, flagged_sites, \
    instantiate_policy, work_done_frac
from repro_torch.convert import sim_result_from_numpy
from repro_torch.core import campaign as TC
from repro_torch.core import graph as TG
from repro_torch.core import mapping as TMap
from repro_torch.core import routing as TRt
from repro_torch.core import simulator as TSim
from repro_torch.core import sloth as TS
from repro_torch.core.detectors import Verdict as TVerdict
from repro_torch.core.failures import FailSlow as TFailSlow
from repro_torch import mitigate as TMit

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FABRICS = ("mesh", "torus")


def _verdicts(mesh):
    """(label, flagged, kind, location, flagged_resources) of the verdicts
    every policy is asked to plan against."""
    two = mesh.links_of_router(5)[:2]
    return [("core", True, "core", 5, (("core", 5, 9.0),)),
            ("cores", True, "core", 5, (("core", 5, 9.0), ("core", 9, 8.0))),
            ("link", True, "link", 3, (("link", 3, 9.0),)),
            ("router", True, "link", two[0],
             tuple(("link", l, 9.0) for l in two)),
            ("core+link", True, "core", 6,
             (("core", 6, 9.0), ("link", 3, 4.0), ("core", 6, 8.0))),
            ("top1", True, "link", 7, ()),
            ("unflagged", False, None, None, ())]


def _pair(mesh_j, mesh_t, flagged, kind, loc, res):
    ranking = [(k, l, s) for k, l, s in res] or (
        [(kind, loc, 3.0)] if flagged else [])
    return (Verdict(flagged, kind, loc, 9.0, ranking=ranking,
                    flagged_resources=res, mesh=mesh_j),
            TVerdict(flagged, kind, loc, 9.0, ranking=ranking,
                     flagged_resources=res, mesh=mesh_t))


@pytest.fixture(scope="module", params=FABRICS)
def deployment(request):
    """(reference pipeline, port pipeline) for darknet19 on a 4×4 fabric."""
    name = request.param
    return (Sloth(build_workload("darknet19"), build_topology(name, 4, 4)),
            TS.Sloth(TG.build_workload("darknet19"),
                     TRt.build_topology(name, 4, 4), device="cpu"))


def test_registry_matches_reference():
    assert TMit.available_policies()[:4] == available_policies()[:4] \
        == TMit.DEFAULT_POLICIES
    for name in TMit.DEFAULT_POLICIES:
        pol = TMit.instantiate_policy(name)
        assert pol.name == name and isinstance(pol, TMit.MitigationPolicy)
    with pytest.raises(KeyError):
        TMit.instantiate_policy("gremlin")


@pytest.mark.parametrize("fabric", FABRICS)
@pytest.mark.parametrize("avoid", [(3,), (0, 5, 12, 17), ()])
def test_detour_topology_matches_reference(fabric, avoid):
    ref = DetourTopology(build_topology(fabric, 4, 4), avoid)
    port = TRt.DetourTopology(TRt.build_topology(fabric, 4, 4), avoid)
    assert port.avoid == ref.avoid
    assert port.links == ref.links and port.n_links == ref.n_links
    pairs = [(s, d) for s in range(16) for d in range(16)]
    for s, d in pairs:
        assert port.route(s, d) == ref.route(s, d), (s, d)
    assert np.array_equal(port.path_matrix(pairs), ref.path_matrix(pairs))
    assert TRt.DetourMesh is TRt.DetourTopology
    cut = TRt.DetourTopology(TRt.Mesh2D(2, 1), (0, 1))
    assert cut.route(0, 1) == TRt.Mesh2D(2, 1).route(0, 1)


def test_clip_failures_matches_reference():
    spec = [("core", 5, 2.0, 10.0, 8.0), ("core", 6, 8.0, 4.0, 8.0),
            ("link", 3, 0.0, 4.0, 8.0)]
    fj = [FailSlow(*f) for f in spec]
    ft = [TFailSlow(*f) for f in spec]
    for t in (0.0, 3.9, 4.0, 5.0, 12.0, 20.0):
        assert [dataclasses.astuple(f) for f in TSim.clip_failures(ft, t)] \
            == [dataclasses.astuple(f) for f in clip_failures(fj, t)]
    assert TSim.clip_failures(None, 5.0) == []


def test_plans_match_reference(deployment):
    ref, port = deployment
    for label, *v in _verdicts(ref.mesh):
        vj, vt = _pair(ref.mesh, port.mesh, *v)
        assert TMit.flagged_sites(vt) == flagged_sites(vj), label
        for name in TMit.DEFAULT_POLICIES:
            pj = instantiate_policy(name).plan(vj, ref.mapped, ref.mesh)
            pt = TMit.instantiate_policy(name).plan(vt, port.mapped,
                                                    port.mesh)
            assert dataclasses.astuple(pt) == dataclasses.astuple(pj), \
                (label, name)


@pytest.mark.parametrize("from_time", (0.0, 2.5))
def test_mitigated_simulation_bit_identical(deployment, from_time):
    """Apply each acting plan, re-simulate the remaining window with the
    same seed and probes: placements, detour routes and every trace array
    equal."""
    ref, port = deployment
    spec = ("core", 5, 1.0, 8.0, 10.0)
    fj, ft = [FailSlow(*spec)], [TFailSlow(*spec)]
    for label, *v in _verdicts(ref.mesh):
        vj, vt = _pair(ref.mesh, port.mesh, *v)
        for name in ("remap", "reroute", "quarantine"):
            pol_j, pol_t = (instantiate_policy(name),
                            TMit.instantiate_policy(name))
            pj = pol_j.plan(vj, ref.mapped, ref.mesh)
            if not pj.acted:
                continue
            mj = pol_j.apply(pj, ref.mapped)
            mt = pol_t.apply(pol_t.plan(vt, port.mapped, port.mesh),
                             port.mapped)
            assert [t.core for t in mt.tasks] == [t.core for t in mj.tasks]
            assert type(mt.mesh).__name__ == type(mj.mesh).__name__
            if label not in ("link", "top1", "router"):
                continue               # one trace per kind of edit
            sj = simulate_mitigated(mj, ref.sim_cfg, fj,
                                    probes=ref.plan.sim_plan,
                                    from_time=from_time)
            st = TSim.simulate_mitigated(mt, port.sim_cfg, ft,
                                         probes=port.plan.sim_plan,
                                         from_time=from_time)
            assert st.total_time == sj.total_time, (label, name)
            for side in ("comp", "comm"):
                a, b = getattr(st, side), getattr(sj, side)
                for k in b:
                    assert a[k].dtype == b[k].dtype \
                        and np.array_equal(a[k], b[k]), (label, name, k)


def test_work_done_frac_matches_reference(deployment):
    ref, _ = deployment
    sim = ref.run([FailSlow("core", 5, 1.0, 8.0, 10.0)], seed=0)
    sim_t = sim_result_from_numpy(sim)
    for t in (0.0, 1.0, sim.total_time / 2, sim.total_time, 1e9):
        assert TMit.work_done_frac(sim_t, t) == work_done_frac(sim, t)


def test_map_graph_exclusion_matches_reference():
    g, gt = build_workload("darknet19"), TG.build_workload("darknet19")
    for excl in ((), (5,), (5, 9), (0, 1, 2, 3)):
        a = map_graph(g, build_topology("mesh", 4, 4), exclude_cores=excl)
        b = TMap.map_graph(gt, TRt.Mesh2D(4), exclude_cores=excl)
        assert [t.core for t in b.tasks] == [t.core for t in a.tasks]


def test_mitigated_campaign_matches_reference_and_none_is_zero():
    grid = dict(workloads=("darknet19",), meshes=(4,), kinds=("core", "none"),
                severities=(10.0,), reps=2, campaign_seed=7)
    pols = ("remap", "reroute", "none")
    ref = run_campaign(CampaignGrid(**grid), workers=0,
                       cache=DeploymentCache(), mitigation=pols)
    got = TC.run_campaign(TC.CampaignGrid(**grid), workers=0,
                          cache=TC.DeploymentCache(), mitigation=pols,
                          device="cpu")
    assert got.policies == ref.policies == pols
    assert {k: dataclasses.astuple(v) for k, v in got.mitigation.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref.mitigation.items()}
    for o, r in zip(got.outcomes, ref.outcomes):
        for m, mr in zip(o.mitigation_results, r.mitigation_results):
            assert {f.name: getattr(m, f.name)
                    for f in dataclasses.fields(m) if f.compare} \
                == {f.name: getattr(mr, f.name)
                    for f in dataclasses.fields(mr) if f.compare}
        none = o.mitigation_for("sloth", "none")
        assert not none.acted and none.recovered_frac == 0.0
        assert none.mitigated_time == none.failed_time
    st = got.mitigation[("sloth", "none")]
    assert st.acted.successes == 0 and st.recovered_mean == 0.0
    assert got.mitigation[("sloth", "remap")].recovered_mean >= 0.5
