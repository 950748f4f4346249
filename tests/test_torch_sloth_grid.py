"""SLOTH's own evaluation grid: the port against the JAX reference.

The grid is the reference's evaluation of SLOTH (``benchmarks/paper.py``):

* **A**, workloads × fabrics: darknet19, googlenet, vgg16, resnet50 and
  binary_tree on the 8×8 mesh, torus, systolic array and heterogeneous
  mesh (``het``, its default ``fast1slow1`` pattern), fault kinds core,
  link, router and none at 10×, one replicate, campaign seed 3: 80
  scenarios;
* **B**, the Fig 16/17 meshes not in A (``bench_scalability``): resnet50
  and darknet19 on 4×4, 6×6 and 8×4, core and link at 10×, two
  replicates, seed 3: 24 scenarios;
* **C**, Fig 13's sketch geometries (``bench_sketch_params``): d ∈ {1, 2,
  4} × m ∈ {256, 1,024, 4,096} at H = 8, L = 1,024, and L ∈ {128, 512,
  2,048} × H ∈ {2, 8, 32} at d = 2, m = 1,024, recording the healthy
  darknet19 4×4 run (seed 0) with the batched recorder; and one
  ``Sloth.detect`` of a darknet19 4×4 core fault at d = 4, m = 4,096
  (``DETECT``).

Fault locations are those the campaign's RNG draws.  Every scenario runs
SLOTH with ``recorder_impl="batched"``, serially, through one shared
``DeploymentCache``.  ``tests/data/sloth_grid_pins.json`` holds the
reference's results; ``chip_smoke.py`` (phase 6b) holds the port on the
card to it, reading it as data.  Regenerate it (two to three minutes on
the CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_sloth_grid.py

Held per scenario (``chip_smoke.grid_outcome_gaps``, which phase 6b
uses too): the truths, flagged, kind, location, matched, truth rank and
truth ranks, FailRank's iterations, the compression ratio and the
makespan exactly; the score and every ranking score within ``rel=1e-5``
(FailRank adds in another order in torch), the ranking's entries in
order but for swaps between scores within that tolerance of each other.  Per recording (``compare_recording``): the
compression ratio and every decoded pattern (key, count, sum, sum of
squares, value, first and last time, arrival, minimum) exactly.

This file holds the pins' layout, Fig 13's d × m geometries and the
``DETECT`` verdict; ``test_torch_sloth_grid_*.py`` recompute the rest of
the pins from the reference and run the port on the CPU (its kernels'
plain versions) on at least one scenario of each workload, fabric and
Fig 16/17 mesh, and on every Fig 13 geometry.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import pytest

import repro.core.campaign as RC
import repro.core.sloth as RS
import repro_torch.core.campaign as TC
import repro_torch.core.sloth as TS
from repro.core.failures import FailSlow as RFailSlow
from repro.core.recorder import record as r_record
from repro.core.sketch import SketchParams as RSketchParams
from repro_torch.core.failures import FailSlow as TFailSlow
from repro_torch.core.recorder import record as t_record
from repro_torch.core.sketch import SketchParams as TSketchParams

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports neither JAX nor the
    reference): the card's phase 6b and these tests hold the grid by the
    same functions."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.pop(0)


CS = _chip_smoke()
PINS_PATH = CS.SLOTH_GRID_PINS

GRIDS = {
    "A": {"workloads": ["darknet19", "googlenet", "vgg16", "resnet50",
                        "binary_tree"],
          "meshes": ["8x8", "torus:8x8", "systolic:8x8", "het:8x8"],
          "kinds": ["core", "link", "router", "none"],
          "severities": [10.0], "reps": 1, "campaign_seed": 3},
    "B": {"workloads": ["resnet50", "darknet19"],
          "meshes": ["4x4", "6x6", "8x4"],
          "kinds": ["core", "link"],
          "severities": [10.0], "reps": 2, "campaign_seed": 3},
}

#: Fig 13's geometries, (d, m, H, L), in ``bench_sketch_params``'s order.
FIG13 = ([(d, m, 8, 1024) for d in (1, 2, 4) for m in (256, 1024, 4096)]
         + [(2, 1024, H, L) for L in (128, 512, 2048) for H in (2, 8, 32)])
FIG13_INPUT = {"workload": "darknet19", "mesh": "4x4", "seed": 0}

#: One detect past K1's shared memory (the device-memory variant on the
#: card): darknet19 on 4×4, core 5 at 10× from 1 s for 8 s, seed 0.
DETECT = {"workload": "darknet19", "mesh": 4, "sketch": [4, 4096, 8, 1024],
          "fault": ["core", 5, 1.0, 8.0, 10.0], "seed": 0}

PKG = {"reference": (RC, RS, RFailSlow, RSketchParams, r_record),
       "port": (TC, TS, TFailSlow, TSketchParams, t_record)}


def campaign_grid(pkg: str, g: dict, workloads=None, meshes=None,
                  kinds=None):
    """A grid's ``CampaignGrid`` in one package, or a sub-grid of it: the
    scenario RNG is keyed on coordinates, so a sub-grid draws the full
    grid's faults."""
    C = PKG[pkg][0]
    return C.CampaignGrid(workloads=tuple(workloads or g["workloads"]),
                          meshes=tuple(meshes or g["meshes"]),
                          kinds=tuple(kinds or g["kinds"]),
                          severities=tuple(g["severities"]),
                          reps=g["reps"], campaign_seed=g["campaign_seed"])


def run_grid(pkg: str, g: dict, device=None, **sub) -> list[dict]:
    """Every scenario of ``g`` (or of a sub-grid) through the package's
    ``run_campaign``: SLOTH alone, the batched recorder, serial."""
    C, S = PKG[pkg][:2]
    cfg = S.SlothConfig(recorder_impl="batched")
    kw = {"device": device} if pkg == "port" else {}
    with CS.VerdictTap(S.Sloth) as tap:
        res = C.run_campaign(campaign_grid(pkg, g, **sub), workers=0,
                             cfg=cfg, cache=C.DeploymentCache(), **kw)
    assert len(tap.seen) == len(res.outcomes)
    return [CS.grid_record(o, v) for o, (_, v) in zip(res.outcomes,
                                                      tap.seen)]


def fig13_records(pkg: str, geometries, device=None) -> list[dict]:
    """Fig 13's recordings of the healthy darknet19 4×4 run."""
    C, S, _, SP, rec = PKG[pkg]
    kw = {"device": device} if pkg == "port" else {}
    dep = C.DeploymentCache().get(
        FIG13_INPUT["workload"], 4, 4,
        cfg=S.SlothConfig(recorder_impl="batched"), **kw)
    sim = dep.sloth.run(None, seed=FIG13_INPUT["seed"])
    out = []
    for d, m, H, L in geometries:
        r = rec(sim, SP(d=d, m=m, H=H, L=L),
                hop_latency=dep.sloth.sim_cfg.hop_latency, impl="batched",
                **kw)
        out.append({"params": [d, m, H, L], **CS.recording_record(r)})
    return out


def detect_record(pkg: str, device=None) -> dict:
    """``DETECT``'s verdict in one package."""
    from repro.core.graph import build_workload as r_build
    from repro.core.routing import Mesh2D as RMesh
    from repro_torch.core.graph import build_workload as t_build
    from repro_torch.core.routing import Mesh2D as TMesh
    C, S, FS, SP, _ = PKG[pkg]
    build, Mesh = (r_build, RMesh) if pkg == "reference" \
        else (t_build, TMesh)
    d, m, H, L = DETECT["sketch"]
    cfg = S.SlothConfig(sketch=SP(d=d, m=m, H=H, L=L), budget_kb=None,
                        recorder_impl="batched")
    kw = {"device": device} if pkg == "port" else {}
    sloth = S.Sloth(build(DETECT["workload"]), Mesh(DETECT["mesh"]), cfg,
                    **kw)
    v = sloth.detect([FS(*DETECT["fault"])], seed=DETECT["seed"])
    return json.loads(json.dumps({
        "flagged": v.flagged, "kind": v.kind, "location": v.location,
        "score": v.score, "ranking": [[k, l, s] for k, l, s in v.ranking],
        "iterations": v.failrank.iterations,
        "compression": v.recorder.compression_ratio}))


def compare_recording(got: dict, exp: dict) -> list[str]:
    return [f for f in ("params", "compression", "comp", "comm")
            if got[f] != exp[f]]


def load_pins() -> dict:
    return json.loads(PINS_PATH.read_text())


def pinned(name: str, workloads=None, meshes=None, kinds=None) -> list:
    """The pins of a sub-grid of grid ``name``, in its enumeration order
    (a mesh as the campaign spells it, ``"8x8"`` or ``"torus:8x8"``)."""
    g = GRIDS[name]
    want = [f"{RC.parse_topology_spec(m)[0]}:{m.rsplit(':', 1)[-1]}"
            for m in meshes or g["meshes"]]
    rows = [o for o in load_pins()["outcomes"][name]
            if o["workload"] in (workloads or g["workloads"])
            and o["mesh"] in want and o["kind"] in (kinds or g["kinds"])]
    order = {(w, m, k): i for i, (w, m, k) in enumerate(
        (w, m, k) for w in (workloads or g["workloads"]) for m in want
        for k in (kinds or g["kinds"]))}
    return sorted(rows, key=lambda o: (order[(o["workload"], o["mesh"],
                                              o["kind"])], o["rep"]))


def check_sub_grid(pkg: str, name: str, workloads, meshes, kinds=None,
                   device=None) -> None:
    """A sub-grid run in ``pkg`` equals its pins (scenario ids aside: a
    sub-grid numbers its scenarios anew)."""
    exp = pinned(name, workloads, meshes, kinds)
    got = run_grid(pkg, GRIDS[name], device=device, workloads=workloads,
                   meshes=meshes, kinds=kinds)
    assert len(got) == len(exp) > 0
    for g, e in zip(got, exp):
        assert CS.grid_outcome_gaps({**g, "id": e["id"]}, e) == [], \
            (pkg, e)


def reference_build() -> dict:
    """What the pins were computed with: jax and jaxlib's versions, the
    backend, ``XLA_FLAGS``, and whether XLA rounds a run's start ``t0 +
    dt·k`` once, as one fused multiply-add (the probe 4,097 · (1 + 2^-12)
    − 4,098 is 2^-12 fused, 0 rounded twice).  The Fig 13 recordings'
    first and last starts round as that probe does, and so does the
    port (``sketch_update.ref.fma_f32``, the kernel's ``__fmaf_rn``): a
    regenerated pin file whose probe differs explains its new starts."""
    import os

    import jax
    import jax.numpy as jnp
    import jaxlib
    probe = jax.jit(lambda t0, dt, k: t0 + dt * k)(
        jnp.float32(-4098.0), jnp.float32(1 + 2.0 ** -12), jnp.float32(4097.0))
    return {"jax": jax.__version__, "jaxlib": jaxlib.__version__,
            "backend": jax.default_backend(),
            "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
            "start_fused": float(probe) == 2.0 ** -12}


def write_pins() -> dict:
    """The reference's pins of the whole grid (the ``__main__`` below)."""
    pins = {"made_with": reference_build(),
            "grids": GRIDS,
            "outcomes": {k: run_grid("reference", g)
                         for k, g in GRIDS.items()},
            "fig13": {"input": FIG13_INPUT,
                      "recordings": fig13_records("reference", FIG13)},
            "detect": {**DETECT, "verdict": detect_record("reference")}}
    PINS_PATH.write_text(json.dumps(pins, separators=(",", ":")) + "\n")
    return pins


# ---------------------------------------------------------------------------
# tests: the pins' layout, Fig 13's d × m geometries, DETECT
# ---------------------------------------------------------------------------

def test_pins_hold_the_grid():
    """80 + 24 scenarios in enumeration order, 18 Fig 13 recordings and the
    detect verdict, over the grids this file defines."""
    pins = load_pins()
    assert pins["grids"] == GRIDS
    assert [len(pins["outcomes"][k]) for k in ("A", "B")] == [80, 24]
    for k, g in GRIDS.items():
        scenarios = RC.enumerate_scenarios(campaign_grid("reference", g))
        assert [(o["id"], o["workload"], o["mesh"], o["kind"], o["rep"])
                for o in pins["outcomes"][k]] \
            == [(s.scenario_id, s.workload,
                 f"{s.topology}:{s.mesh_w}x{s.mesh_h}", s.kind, s.rep)
                for s in scenarios]
    assert [r["params"] for r in pins["fig13"]["recordings"]] \
        == [list(p) for p in FIG13]
    assert pins["fig13"]["input"] == FIG13_INPUT
    assert {k: v for k, v in pins["detect"].items() if k != "verdict"} \
        == DETECT
    # the port rounds a run's start once, as the reference did for the pins
    assert set(pins["made_with"]) == {"jax", "jaxlib", "backend",
                                      "XLA_FLAGS", "start_fused"}
    assert pins["made_with"]["start_fused"] \
        == reference_build()["start_fused"] is True
    # every positive scenario has one truth; none has none
    for o in pins["outcomes"]["A"] + pins["outcomes"]["B"]:
        assert len(o["truths"]) == (o["kind"] != "none")


def test_the_grid_flags_and_localises():
    """The reference's own aggregate: SLOTH localises most faults, flags
    no clean run (what Fig 16/17 and the accuracy bench report)."""
    pins = load_pins()
    rows = pins["outcomes"]["A"] + pins["outcomes"]["B"]
    pos = [o for o in rows if o["kind"] != "none"]
    assert sum(o["matched"] for o in pos) >= 0.7 * len(pos)
    assert not any(o["flagged"] for o in rows if o["kind"] == "none")


@pytest.mark.parametrize("index", range(9))
def test_fig13_d_by_m_recording_equals_reference(index):
    """Fig 13's d × m geometries (d=2 and 4 at m=4,096 past K1's shared
    memory on the card): the pin recomputed from the reference, and the
    port's recording on the CPU equal to it."""
    geometry = FIG13[index]
    exp = load_pins()["fig13"]["recordings"][index]
    assert compare_recording(fig13_records("reference", [geometry])[0],
                             exp) == []
    assert compare_recording(fig13_records("port", [geometry], "cpu")[0],
                             exp) == []


def test_detect_past_shared_memory_equals_reference():
    exp = load_pins()["detect"]["verdict"]
    for pkg, kw in (("reference", {}), ("port", {"device": "cpu"})):
        got = detect_record(pkg, **kw)
        assert {k: v for k, v in got.items() if k not in ("score",
                                                          "ranking")} \
            == {k: v for k, v in exp.items() if k not in ("score",
                                                          "ranking")}, pkg
        assert CS.rel_gap(got["score"], exp["score"]) <= CS.GRID_SCORE_REL
        assert CS.same_ranking(got["ranking"], exp["ranking"]), pkg
    assert exp["flagged"] and (exp["kind"], exp["location"]) == ("core", 5)


def test_same_ranking_allows_only_near_tied_swaps():
    a = [["core", 1, 1.0], ["link", 2, 0.5], ["core", 3, 0.5000001]]
    assert CS.same_ranking(a, a)
    assert CS.same_ranking([a[0], a[2], a[1]], a)
    assert not CS.same_ranking([a[1], a[0], a[2]], a)
    assert not CS.same_ranking(a[:2] + [["core", 4, 0.5000001]], a)


if __name__ == "__main__":
    p = write_pins()
    print(f"wrote {PINS_PATH}: "
          + ", ".join(f"{k} {len(v)} scenarios"
                      for k, v in p["outcomes"].items())
          + f", {len(p['fig13']['recordings'])} recordings, detect "
            f"{p['detect']['verdict']}")
