"""The port's campaign executors and launcher, on the CPU.

Mirrors ``test_mitigate.py``'s executor test and the campaign smokes of the
reference's CI (``.github/workflows/ci.yml``):

* serial, thread and process executors give ``==`` outcomes (wall times are
  ``compare=False``), with the batched recorder, streaming and mitigation;
* ``launch.campaign.main`` passes its gates for the recorder-parity,
  streaming, mitigation and topology smokes, with ``--device cpu``.
"""

import pytest

from repro_torch.core import campaign as TC
from repro_torch.core import sloth as TS
from repro_torch.launch import campaign as launch


def test_executors_bit_identical():
    """serial == thread == process (``==`` on the outcome dataclasses:
    wall times are ``compare=False``), on a 2-scenario grid."""
    grid = TC.CampaignGrid(workloads=("darknet19",), meshes=(4,),
                           kinds=("core", "link"), severities=(10.0,),
                           campaign_seed=3)
    kw = dict(detectors=("sloth", "thres"), streaming=3,
              mitigation=("reroute", "none"), device="cpu",
              cfg=TS.SlothConfig(recorder_impl="batched"))
    serial = TC.run_campaign(grid, workers=0, cache=TC.DeploymentCache(),
                             **kw)
    thread = TC.run_campaign(grid, workers=2, executor="thread",
                             cache=TC.DeploymentCache(), **kw)
    process = TC.run_campaign(grid, workers=2, executor="process", **kw)
    assert len(serial.outcomes) == 2
    for other in (thread, process):
        assert other.outcomes == serial.outcomes
        assert other.mitigation == serial.mitigation
        assert other.detector_metrics == serial.detector_metrics


@pytest.mark.parametrize("argv", [
    ["--recorder-impl", "both"],
    ["--streaming", "4", "--severities", "10", "--recorder-impl", "both"],
    ["--kinds", "core", "--kinds", "none", "--severities", "10",
     "--streaming", "4", "--mitigation", "remap"],
    ["--topology", "torus:4x4", "--kinds", "core", "--kinds", "link",
     "--kinds", "none", "--mitigation", "reroute"]],
    ids=["recorder-both", "streaming", "mitigation", "topology"])
def test_launcher_smokes_pass_their_gates(argv, capsys):
    out = launch.main(["--tiny", "--device", "cpu", "--workers", "2"] + argv)
    text = capsys.readouterr().out
    res = out["campaign"]
    assert res.outcomes and "== campaign aggregate ==" in text
    if "--streaming" in argv:
        assert "streaming equivalence" in text and "posthoc" in out
    if "--mitigation" in argv:
        assert "none" in res.policies
        assert all(m.recovered_frac == 0.0 for o in res.outcomes
                   for m in o.mitigation_results if m.policy == "none")
    if "both" in argv:
        assert "recorder parity: ref == batched" in text
        assert set(out) >= {"campaign", "batched"}
