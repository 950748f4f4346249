"""Grids of the reference's CI smokes through the port, on the CPU.

``test_torch_campaign.py`` holds the ``--tiny`` grid and the snapshot to
the reference; these are the other grids the reference's CI runs
(``.github/workflows/ci.yml``), each through the reference's
``run_campaign`` and the port's with ``device="cpu"``, for both recorder
impls: outcomes with ``assert_outcomes_match`` (every compared field
exact, ``score`` within ``rel=1e-5``), ``by_detector`` and
``by_mitigation`` equal.

* ``--kinds mixed --kinds none --n-failures 2 --severities 2.0
  --severities 2.0001 --all-detectors`` (``ci.yml:27-28``);
* ``--topology systolic:8x8 --kinds core --kinds link --kinds none
  --mitigation reroute`` (``ci.yml:35-36``, its systolic half);
* the heterogeneous fabric ``het:4x4:fast2slow1``;
* a ``core+link`` kind tuple (two simultaneous failures of fixed kinds);
* the ``quarantine`` mitigation policy.

This file runs the first two, the grids that ``ci.yml`` names;
``test_torch_campaign_grids_more.py`` runs the other three through
:func:`check_grid` (one file would run past 40 s).
"""

import dataclasses

import pytest

from repro.core.campaign import CampaignGrid, DeploymentCache, run_campaign
from repro.core.metrics import by_detector, by_mitigation
from repro.core.sloth import SlothConfig
from repro_torch.core import campaign as TC
from repro_torch.core import metrics as TMx
from repro_torch.core import sloth as TS
from test_torch_campaign import DETECTORS, assert_outcomes_match

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BASE = dict(workloads=("darknet19",), meshes=(4,), severities=(8.0,),
            reps=1, campaign_seed=0)

#: (grid fields over BASE, run_campaign keywords)
GRIDS = {
    "mixed_near_threshold": (
        dict(kinds=("mixed", "none"), n_failures=(2,),
             severities=(2.0, 2.0001)),
        dict(detectors=DETECTORS)),
    "systolic_8x8": (
        dict(meshes=("systolic:8x8",), kinds=("core", "link", "none")),
        dict(mitigation=("reroute",))),
    "het_4x4_fast2slow1": (
        dict(meshes=("het:4x4:fast2slow1",), kinds=("core", "link", "none")),
        dict()),
    "core_plus_link": (
        dict(kinds=("core+link", "none"), severities=(10.0,)),
        dict(detectors=("sloth", "thres"))),
    "quarantine": (
        dict(kinds=("core", "link", "none"), severities=(10.0,)),
        dict(streaming=4, mitigation=("quarantine", "none"))),
}


def _astuples(d):
    return {k: dataclasses.astuple(v) for k, v in d.items()}


def check_grid(name, impl):
    """The reference's and the port's campaigns on ``GRIDS[name]``."""
    fields, kw = GRIDS[name]
    grid = {**BASE, **fields}
    exp = run_campaign(CampaignGrid(**grid), workers=0,
                       cache=DeploymentCache(),
                       cfg=SlothConfig(recorder_impl=impl), **kw)
    got = TC.run_campaign(TC.CampaignGrid(**grid), workers=0,
                          cache=TC.DeploymentCache(),
                          cfg=TS.SlothConfig(recorder_impl=impl),
                          device="cpu", **kw)
    assert got.detectors == exp.detectors and got.policies == exp.policies
    assert len(got.outcomes) > 0
    assert_outcomes_match(got.outcomes, exp.outcomes)
    assert _astuples(TMx.by_detector(got.outcomes)) \
        == _astuples(by_detector(exp.outcomes))
    assert _astuples(TMx.by_mitigation(got.outcomes)) \
        == _astuples(by_mitigation(exp.outcomes))


@pytest.mark.parametrize("impl", ("ref", "batched"))
@pytest.mark.parametrize("name", ["mixed_near_threshold", "systolic_8x8"])
def test_ci_grid_matches_reference(name, impl):
    check_grid(name, impl)
