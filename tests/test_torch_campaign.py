"""The port's campaign path against the JAX reference, on the CPU.

Mirrors ``test_campaign.py`` and ``test_topology.py``'s snapshot test
(the executors and the launcher are in ``test_torch_campaign_exec.py``):

* the default-mesh snapshot ``tests/data/mesh_campaign_baseline.json``
  (darknet19 on 4×4 and 6×3, SLOTH, reroute and remap) is reproduced:
  everything exact, ``score`` within ``rel=1e-5`` (the port's FailRank runs
  in torch; ``test_torch_sloth.py`` holds scores to the same standard);
* on the ``--tiny`` grid with all six detectors, ``streaming=4``, remap and
  reroute, for both recorder impls, the port's outcomes, ``by_detector``,
  ``by_mitigation`` and ``severity_curve`` equal the reference's
  ``run_campaign`` (scores within ``rel=1e-5``, all else exact);
* a deployment is cached per device, and the default device (the card)
  raises without one;
* ``make_dataset`` / ``effective_samples`` draw the reference's samples.

Run as a script, this file prints the reference's campaign pins that
``chip_smoke.py`` holds the card to (resnet50 on 8×8, kinds core, link,
router and none at 10×, all detectors, the batched recorder, 4 streamed
chunks, remap and reroute; about a minute and 1 GB):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_campaign.py
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from repro.core.campaign import CampaignGrid, DeploymentCache, run_campaign
from repro.core.failures import effective_samples, make_dataset
from repro.core.routing import Mesh2D
from repro.core.sloth import SlothConfig
from repro.core.metrics import by_detector, by_mitigation, severity_curve
from repro_torch.core import campaign as TC
from repro_torch.core import failures as TF
from repro_torch.core import metrics as TMx
from repro_torch.core import routing as TRt
from repro_torch.core import sloth as TS
from repro_torch.launch import campaign as launch

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DATA = Path(__file__).resolve().parent / "data"
TINY = dict(workloads=("darknet19",), meshes=(4,),
            kinds=("core", "link", "router", "none"), severities=(8.0,),
            reps=1, campaign_seed=0)
DETECTORS = ("sloth", "thres", "mscope", "iaso", "perseus", "adr")
POLICIES = ("remap", "reroute", "none")
#: the grid ``chip_smoke.py`` drives on the card (its pins come from here)
CHIP_ARGV = ["--tiny", "--workload", "resnet50", "--mesh", "8x8",
             "--severities", "10", "--all-detectors", "--recorder-impl",
             "batched", "--streaming", "4", "--mitigation", "remap",
             "--mitigation", "reroute", "--workers", "0"]


def _fields(obj, skip=()):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.compare and f.name not in skip}


def assert_outcomes_match(got, exp):
    """Port outcomes against reference outcomes: every compared field
    exact, ``score`` within ``rel=1e-5``."""
    assert len(got) == len(exp)
    nested = ("detector_results", "mitigation_results")
    for o, r in zip(got, exp):
        assert _fields(o, nested) == _fields(r, nested), o.scenario_id
        assert len(o.detector_results) == len(r.detector_results)
        for d, dr in zip(o.detector_results, r.detector_results):
            assert _fields(d, ("score",)) == _fields(dr, ("score",)), \
                (o.scenario_id, d.detector)
            assert d.score == pytest.approx(dr.score, rel=1e-5)
        assert [_fields(m) for m in o.mitigation_results] \
            == [_fields(m) for m in r.mitigation_results], o.scenario_id


def campaign_pins(outcomes) -> list:
    """The judged fields of a campaign's outcomes, as ``chip_smoke.py``
    compares them (its ``campaign_record`` builds the same structure)."""
    out = []
    for o in outcomes:
        out.append({
            "id": o.scenario_id, "kind": o.kind, "sim_seed": o.sim_seed,
            "truths": [[k, l, t, d, s] for k, l, t, d, s in zip(
                o.effective_truth_kinds, o.truth_locations, o.truth_t0s,
                o.truth_durations, o.effective_truth_severities)],
            "compression": o.compression_ratio, "total_time": o.total_time,
            "detectors": [[d.detector, d.flagged, d.pred_kind,
                           d.pred_location, d.score, d.matched,
                           d.truth_rank, list(d.truth_ranks),
                           d.detection_latency]
                          for d in o.detector_results],
            "mitigation": [[m.detector, m.policy, m.acted, m.correct,
                            list(m.exclude_cores), list(m.avoid_links),
                            m.healthy_time, m.failed_time,
                            m.mitigated_time, m.switch_time]
                           for m in o.mitigation_results]})
    return out


def _astuples(d):
    return {k: dataclasses.astuple(v) for k, v in d.items()}


def test_default_mesh_campaign_reproduces_snapshot():
    """``test_topology.py``'s snapshot, through the port on the CPU."""
    base = json.loads((DATA / "mesh_campaign_baseline.json").read_text())
    g = base["grid"]
    grid = TC.CampaignGrid(workloads=tuple(g["workloads"]),
                           meshes=tuple(tuple(m) for m in g["meshes"]),
                           kinds=tuple(g["kinds"]),
                           severities=tuple(g["severities"]),
                           n_failures=tuple(g["n_failures"]),
                           reps=g["reps"], campaign_seed=g["campaign_seed"])
    res = TC.run_campaign(grid, workers=0, executor="thread",
                          detectors=("sloth",),
                          mitigation=("reroute", "remap"),
                          cache=TC.DeploymentCache(), device="cpu")
    assert len(res.outcomes) == len(base["outcomes"])
    for o, b in zip(res.outcomes, base["outcomes"]):
        assert o.sim_seed == b["sim_seed"]
        assert list(o.truth_locations) == b["truth_locations"]
        assert list(o.truth_t0s) == b["truth_t0s"]
        assert list(o.truth_durations) == b["truth_durations"]
        assert o.compression_ratio == b["compression_ratio"]
        for r, br in zip(o.detector_results, b["detectors"]):
            assert r.flagged == br["flagged"]
            assert r.pred_kind == br["pred_kind"]
            assert r.pred_location == br["pred_location"]
            assert r.score == pytest.approx(br["score"], rel=1e-5)
            assert r.matched == br["matched"]
            assert r.truth_rank == br["truth_rank"]
            assert list(r.truth_ranks) == br["truth_ranks"]
        assert len(o.mitigation_results) == len(b["mitigation"])
        for m, bm in zip(o.mitigation_results, b["mitigation"]):
            assert m.policy == bm["policy"]
            assert m.acted == bm["acted"]
            assert m.correct == bm["correct"]
            assert list(m.exclude_cores) == bm["exclude_cores"]
            assert list(m.avoid_links) == bm["avoid_links"]
            assert m.healthy_time == bm["healthy_time"]
            assert m.failed_time == bm["failed_time"]
            assert m.mitigated_time == bm["mitigated_time"]


@pytest.mark.parametrize("impl", ("ref", "batched"))
def test_tiny_campaign_matches_reference(impl):
    kw = dict(workers=0, detectors=DETECTORS, streaming=4,
              mitigation=POLICIES)
    exp = run_campaign(CampaignGrid(**TINY), cache=DeploymentCache(),
                       cfg=SlothConfig(recorder_impl=impl), **kw)
    got = TC.run_campaign(TC.CampaignGrid(**TINY),
                          cache=TC.DeploymentCache(),
                          cfg=TS.SlothConfig(recorder_impl=impl),
                          device="cpu", **kw)
    assert got.detectors == exp.detectors and got.policies == exp.policies
    assert_outcomes_match(got.outcomes, exp.outcomes)
    assert any(d.detection_latency not in (None, math.inf)
               for o in got.outcomes for d in o.detector_results)
    assert _astuples(TMx.by_detector(got.outcomes)) \
        == _astuples(by_detector(exp.outcomes))
    assert _astuples(got.detector_metrics) == _astuples(exp.detector_metrics)
    assert _astuples(TMx.by_mitigation(got.outcomes)) \
        == _astuples(by_mitigation(exp.outcomes))
    assert _astuples(got.mitigation) == _astuples(exp.mitigation)
    for det in DETECTORS:
        assert [dataclasses.astuple(p) for p in got.severity_curve(det)] \
            == [dataclasses.astuple(p)
                for p in severity_curve(exp.outcomes, detector=det)]
    assert got.summary().splitlines()[:-8] == exp.summary().splitlines()[:-8]
    # the structure chip_smoke.py pins, scores apart
    for g, e in zip(campaign_pins(got.outcomes), campaign_pins(exp.outcomes)):
        for dg, de in zip(g.pop("detectors"), e.pop("detectors")):
            assert dg[:4] + dg[5:] == de[:4] + de[5:]
        assert g == e


def test_device_keys_the_deployment_cache():
    cache = TC.DeploymentCache()
    a = cache.get("darknet19", 4, 4, device="cpu")
    assert cache.get("darknet19", 4, 4, cfg=TS.SlothConfig(),
                     device=torch.device("cpu")) is a
    assert a.sloth.device == torch.device("cpu")
    assert all(k[-1] == "cpu" for k in cache._hosts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cache.get("darknet19", 4, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.run_campaign(TC.CampaignGrid(**TINY))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.main(["--tiny"])


@pytest.mark.parametrize("router_ratio", (0.0, 0.3))
def test_make_dataset_matches_reference(router_ratio):
    exp = make_dataset(Mesh2D(4), n_failures=40, seed=11,
                       router_ratio=router_ratio)
    got = TF.make_dataset(TRt.Mesh2D(4), n_failures=40, seed=11,
                          router_ratio=router_ratio)
    key = [(s.sample_id, s.failure and dataclasses.astuple(s.failure))
           for s in exp]
    assert [(s.sample_id, s.failure and dataclasses.astuple(s.failure))
            for s in got] == key
    used = {0, 1, 2, 5, 9, 20}
    assert [s.sample_id for s in TF.effective_samples(
        got, 7.0, used_links=used, mesh=TRt.Mesh2D(4))] \
        == [s.sample_id for s in effective_samples(
            exp, 7.0, used_links=used, mesh=Mesh2D(4))]
    with pytest.raises(ValueError):
        TF.make_dataset(TRt.Mesh2D(4), router_ratio=1.5)


if __name__ == "__main__":
    grid = CampaignGrid(workloads=("resnet50",), meshes=("8x8",),
                        kinds=("core", "link", "router", "none"),
                        severities=(10.0,), reps=1, campaign_seed=0)
    res = run_campaign(grid, workers=0, detectors=DETECTORS, streaming=4,
                       mitigation=POLICIES,
                       cfg=SlothConfig(recorder_impl="batched"))
    print(json.dumps({"argv": CHIP_ARGV,
                      "outcomes": campaign_pins(res.outcomes)}))
    sys.exit(0)
