"""The port's pod telemetry against the JAX reference, on the CPU.

Mirrors ``test_system.py`` (mitigation actions, a pod link failure) and
``test_streaming.py:237-320`` (the step gap, the recorder impl plumbing,
live windows, ``StepTelemetry``):

* ``PodSimulator`` traces are bit-identical to the reference's (numpy
  draws), with faults and with ``StepTelemetry``'s overrides, on the mesh
  and the torus;
* ``PodDetector.analyse`` and ``observe`` give the reference's verdicts
  (flag, kind, location, severity within rel 1e-9, action) for both
  recorder impls, on the mesh and the torus;
* ``StepTelemetry`` gives the reference's verdicts and plans window by
  window, with a slow burst, on a clean loop and through its warmup; it
  departs from the reference in one way, pinned on step times from the
  card: its verdicts name only the measured host, never a synthetic peer
  (``PodDetector(measured=...)``);
* ``PodMitigationPolicy`` plans the reference's actions;
* the reference's CI smoke (``launch.train --telemetry ...
  --expect-flagged``) and ``launch.serve --telemetry`` run with
  ``--device cpu``.

Run as a script, this file prints the reference's ``POD_PINS`` that
``chip_smoke.py`` holds the card to: ``PodDetector.observe`` on the
default 16×16 pod, three windows of 16 steps, for a core and a link fault
on the mesh and a link fault on the torus (about a minute):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_telemetry.py
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

from repro.core.failures import FailSlow as JFailSlow
from repro.core.streaming import split_sim as j_split_sim
from repro.distributed import telemetry as JT
from repro_torch.core.failures import FailSlow
from repro_torch.core.streaming import split_sim
from repro_torch.distributed import telemetry as T
from repro_torch.launch import serve, train

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

#: The pod runs of ``chip_smoke.py``'s pins: (topology, fault kind,
#: location) on the default 16×16 pod, seed 1, step_flops 5e12,
#: collective_bytes 4e9, slowdown 10× (core) or 8× (link) from t = 0.
POD_PIN_CASES = (("mesh", "core", 37), ("mesh", "link", 100),
                 ("torus", "link", 300))
POD_PIN_WINDOWS, POD_PIN_WINDOW_STEPS = 3, 16


def _verdict(v):
    return (v.flagged, v.kind, v.location, v.action)


def _same_verdict(got, exp):
    assert _verdict(got) == _verdict(exp)
    assert got.severity == pytest.approx(exp.severity, rel=1e-9)


def _pods(topology, fault, **cfg_kw):
    kind, loc, slow = fault
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4, topology=topology,
                               **cfg_kw)
    jcfg = JT.PodTelemetryConfig(mesh_w=4, mesh_h=4, topology=topology,
                                 **cfg_kw)
    pod = T.PodSimulator(cfg, step_flops=5e12, collective_bytes=4e9, seed=1)
    jpod = JT.PodSimulator(jcfg, step_flops=5e12, collective_bytes=4e9,
                           seed=1)
    if kind is not None:
        pod.inject(FailSlow(kind, loc, 0.0, 1e9, slow))
        jpod.inject(JFailSlow(kind, loc, 0.0, 1e9, slow))
    return cfg, jcfg, pod, jpod


def _same_sim(a, b):
    assert a.total_time == b.total_time
    assert a.n_raw_records == b.n_raw_records
    for side in ("comp", "comm"):
        pa, pb = getattr(a, side), getattr(b, side)
        assert pa.keys() == pb.keys()
        for k in pb:
            assert pa[k].dtype == np.asarray(pb[k]).dtype, (side, k)
            assert np.array_equal(pa[k], pb[k]), (side, k)


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_pod_simulator_matches_reference(topology):
    _, _, pod, jpod = _pods(topology, ("core", 5, 10.0))
    _same_sim(pod.run_steps(8), jpod.run_steps(8))
    durs = np.linspace(0.01, 0.02, 6)
    _same_sim(pod.run_steps(6, t0=3.0, step0=8, chip0_durs=durs, base=0.012,
                            jitter=0.05),
              jpod.run_steps(6, t0=3.0, step0=8, chip0_durs=durs, base=0.012,
                             jitter=0.05))
    assert np.array_equal(pod.chip_speed, jpod.chip_speed)


def test_pod_step_gap_uses_slowest_link():
    """``test_streaming.py``: the all-reduce barrier waits on the slowest
    link, not the last enumerated one."""
    cfg = T.PodTelemetryConfig(mesh_w=2, mesh_h=2, window_steps=4)
    pod = T.PodSimulator(cfg, step_flops=1e12, collective_bytes=1e8, seed=0)
    pod.inject(FailSlow("link", 0, 0.0, 1e9, 100.0))   # NOT the last link
    sim = pod.run_steps(2)
    nl, nc = pod.mesh.n_links, pod.mesh.n_cores
    arrive0 = float(np.max(sim.comm["t_arrive"][:nl]))
    start1 = float(np.min(sim.comp["t_start"][nc:]))
    assert start1 >= arrive0 - 1e-12


@pytest.mark.parametrize("topology,fault", [
    ("mesh", ("core", 5, 10.0)), ("mesh", ("link", 11, 8.0)),
    ("torus", ("link", 20, 8.0)), ("mesh", (None, None, None))])
@pytest.mark.parametrize("impl", ["ref", "batched"])
def test_pod_detector_matches_reference(topology, fault, impl):
    """``analyse`` over 16 steps and ``observe`` over them in two windows:
    the reference's verdicts for either impl."""
    cfg, jcfg, pod, jpod = _pods(topology, fault, window_steps=8,
                                 recorder_impl=impl)
    sim, jsim = pod.run_steps(16), jpod.run_steps(16)
    _same_verdict(T.PodDetector(cfg, device="cpu").analyse(sim),
                  JT.PodDetector(jcfg).analyse(jsim))
    det, jdet = T.PodDetector(cfg, device="cpu"), JT.PodDetector(jcfg)
    for w, jw in zip(split_sim(sim, 2), j_split_sim(jsim, 2)):
        _same_verdict(det.observe(w), jdet.observe(jw))


def test_pod_detector_observe_streams_windows():
    """``test_streaming.py``: streaming window by window reaches the
    post-hoc localisation, and flags in the first window."""
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8,
                               recorder_impl="batched")
    pod = T.PodSimulator(cfg, step_flops=5e12, collective_bytes=4e9, seed=1)
    pod.inject(FailSlow("core", 5, 0.0, 1e9, 10.0))
    sim = pod.run_steps(24)
    post = T.PodDetector(cfg, device="cpu").analyse(sim)
    det = T.PodDetector(cfg, device="cpu")
    verdicts = [det.observe(c) for c in split_sim(sim, 3)]
    assert _verdict(verdicts[-1])[:3] == _verdict(post)[:3] \
        == (True, "core", 5)
    assert verdicts[0].flagged


def test_pod_link_failure_detected():
    """``test_system.py``: a degraded link on a 4×4 pod."""
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4)
    pod = T.PodSimulator(cfg, step_flops=5e12, collective_bytes=4e9, seed=1)
    pod.inject(FailSlow("link", 11, 0.0, 1e9, 8.0))
    v = T.PodDetector(cfg, device="cpu").analyse(pod.run_steps(48))
    assert v.flagged and v.kind == "link" and v.location == 11


def _plans_equal(got, exp):
    assert got.keys() == exp.keys()
    for k, want in exp.items():
        if k == "shard_weights":
            assert np.array_equal(got[k], want)
        elif k == "plan":
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want)
        else:
            assert got[k] == want, k


def _step_times(kind):
    rng = np.random.default_rng(0 if kind == "burst" else 1)
    out = [30.0] if kind == "warmup" else []
    for step in range(25):
        dt = 0.05 * (1 + 0.01 * abs(rng.standard_normal()))
        if kind == "burst" and 10 <= step < 18:
            dt *= 10.0
        out.append(dt)
    return out


@pytest.mark.parametrize("kind", ["burst", "clean", "warmup"])
@pytest.mark.parametrize("impl", ["ref", "batched"])
def test_step_telemetry_matches_reference(kind, impl):
    """The live bridge on the same measured step times: the reference's
    verdict and plan after every step, and at the flush.  A 10× burst
    flags chip 0; a clean loop and a loop behind one 30 s warmup step stay
    silent (``test_streaming.py``)."""
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8,
                               recorder_impl=impl)
    jcfg = JT.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8,
                                 recorder_impl=impl)
    tel = T.StepTelemetry(cfg, seed=0, device="cpu")
    jtel = JT.StepTelemetry(jcfg, seed=0)
    for dt in _step_times(kind):
        got, exp = tel.record_step(dt), jtel.record_step(dt)
        assert (got is None) == (exp is None)
        if got is not None:
            _same_verdict(got, exp)
    got, exp = tel.flush(), jtel.flush()
    assert (got is None) == (exp is None)
    assert len(tel.verdicts) == len(jtel.verdicts) > 0
    for g, e in zip(tel.verdicts, jtel.verdicts):
        _same_verdict(g, e)
    for g, e in zip(tel.plans, jtel.plans):
        _plans_equal(g, e)
    assert tel.flagged == (kind == "burst")
    if kind == "burst":
        assert all((v.kind, v.location) == ("core", 0)
                   for v in tel.verdicts if v.flagged)


#: Step times (ms) of full-size smollm-135m train runs on an H100 (24 steps
#: of 4 × 512 tokens, ``chip_smoke.py`` phases 11 and 12): a clean run, and
#: a run whose steps 10-15 the launcher reports 10× slower.  And a noisier
#: series whose measured noise reaches ``StepTelemetry``'s 10 % cap.
CLEAN_CARD_STEP_MS = [231.1, 239.5, 209.9, 278.0, 237.3, 226.7, 231.7, 221.0,
                      213.4, 241.8, 232.8, 211.6, 243.3, 256.3, 259.4, 243.8,
                      238.8, 258.9, 196.1, 251.1, 228.8, 235.4, 229.3, 218.9]
INJECTED_CARD_STEP_MS = [
    303.0, 146.5, 123.3, 135.7, 137.7, 114.6, 143.5, 147.7, 106.2, 96.1,
    *(10 * x for x in (96.2, 99.3, 99.9, 103.2, 99.3, 100.0)),
    96.6, 98.3, 96.7, 128.7, 138.2, 116.1, 114.0, 95.7]
#: Another injected run on an H100 whose host-noise pattern lets the peer
#: win the burst's window and the next: the host (z 41.5) is never named.
INJECTED_MISSED_STEP_MS = [
    283.578, 114.859, 119.693, 105.416, 96.564, 104.866, 100.256, 111.905,
    100.537, 109.39,
    *(10 * x for x in (98.885, 105.148, 124.539, 103.531, 106.137, 160.465)),
    126.615, 135.894, 120.461, 114.96, 101.366, 98.976, 105.616, 102.908]
NOISY_STEP_MS = list(100 * (1 + 0.3 * np.abs(
    np.random.default_rng(5).standard_normal(24))))
PEER, HOST = (True, "core", 14), (True, "core", 0)
NONE = (False, None, None)


@pytest.mark.parametrize("step_ms,expected,z,port,host_z", [
    (CLEAN_CARD_STEP_MS, [PEER, PEER], (6.0, 7.0), [NONE, NONE], None),
    (NOISY_STEP_MS, [PEER, PEER], (9.7, 9.9), [NONE, NONE], None),
    (INJECTED_CARD_STEP_MS, [PEER, HOST], (9.7, 9.9), [HOST, HOST],
     (37.7, 37.9)),
    (INJECTED_MISSED_STEP_MS, [PEER, PEER], (10.1, 10.3), [HOST, HOST],
     (41.4, 41.6))])
def test_step_telemetry_flags_a_peer_on_noisy_clean_steps(step_ms, expected,
                                                          z, port, host_z):
    """A false flag that is the reference's behaviour, pinned there and
    fixed in the port: on step times with a few per cent of noise the
    reference's second window flags a synthetic peer, core 14 (the slowest
    of the simulated chips, speed 0.978 at seed 0); at the noise cap its z
    is 9.8 whatever the times.  With a 10× slowdown of this host in steps
    10-15, that window names the peer all the same, and only the next one
    names the host (core 0), or, on another run's noise, neither does: the
    host's z is 41.5 there, but FailRank's weighting favours the peer.
    The port's ``StepTelemetry`` names only the host, whose times are the
    only measured ones: the clean series flag nothing, and the burst's own
    window names the host at the reference's z for it."""
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8)
    jcfg = JT.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8)
    tel = T.StepTelemetry(cfg, seed=0, device="cpu")
    jtel = JT.StepTelemetry(jcfg, seed=0)
    for ms in step_ms:
        tel.record_step(ms / 1e3)
        jtel.record_step(ms / 1e3)
    tel.flush()
    jtel.flush()
    assert [_verdict(v)[:3] for v in jtel.verdicts] == [NONE, *expected]
    assert z[0] < jtel.verdicts[1].severity < z[1]
    assert [_verdict(v)[:3] for v in tel.verdicts] == [NONE, *port]
    for v in tel.verdicts[1:]:
        if host_z is None:
            assert v.severity == 0.0 and v.action == "none"
        else:
            assert host_z[0] < v.severity < host_z[1]
    assert int(np.argmin(tel.pod.chip_speed)) == 14


@pytest.mark.parametrize("step_ms", [CLEAN_CARD_STEP_MS, NOISY_STEP_MS,
                                     INJECTED_CARD_STEP_MS,
                                     INJECTED_MISSED_STEP_MS])
def test_step_telemetry_names_only_the_measured_host(step_ms):
    """The port's one departure from the reference's ``StepTelemetry``:
    its detector reads the same windows (the synthetic traces equal the
    reference's) and names a resource exactly when the reference's
    detector, restricted to the measured host (core 0), would; a window
    the reference gives to the host is the port's too, at the same
    severity."""
    cfg = T.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8)
    jcfg = JT.PodTelemetryConfig(mesh_w=4, mesh_h=4, window_steps=8)
    tel = T.StepTelemetry(cfg, seed=0, device="cpu")
    jtel = JT.StepTelemetry(jcfg, seed=0)
    assert tel.detector.measured == {("core", 0)}
    for ms in step_ms:
        tel.record_step(ms / 1e3)
        jtel.record_step(ms / 1e3)
    tel.flush()
    jtel.flush()
    assert len(tel.verdicts) == len(jtel.verdicts) == 3
    for g, e in zip(tel.verdicts, jtel.verdicts):
        assert g.kind in (None, "core") and g.location in (None, 0)
        if (e.kind, e.location) == ("core", 0):
            _same_verdict(g, e)


@pytest.mark.parametrize("topology,fault", [
    ("mesh", ("core", 5, 10.0)), ("mesh", ("link", 11, 8.0)),
    ("torus", ("core", 9, 10.0))])
def test_pod_detector_measured_set(topology, fault):
    """``PodDetector(measured=...)``: with every resource measured, the
    reference's verdicts; with the faulty one left out, no flag from it;
    with only it, the reference's verdict."""
    cfg, jcfg, pod, jpod = _pods(topology, fault)
    sim, jsim = pod.run_steps(48), jpod.run_steps(48)
    exp = JT.PodDetector(jcfg).analyse(jsim)
    assert _verdict(exp)[:3] == (True, fault[0], fault[1])
    mesh = T.PodDetector(cfg, device="cpu").mesh
    every = [("core", c) for c in range(mesh.n_cores)] + \
        [("link", lid) for lid in range(mesh.n_links)]
    _same_verdict(T.PodDetector(cfg, device="cpu", measured=every)
                  .analyse(sim), exp)
    _same_verdict(T.PodDetector(cfg, device="cpu", measured=[fault[:2]])
                  .analyse(sim), exp)
    rest = [r for r in every if r != fault[:2]]
    got = T.PodDetector(cfg, device="cpu", measured=rest).analyse(sim)
    assert (got.kind, got.location) != fault[:2]


def test_mitigation_policy_actions():
    """``test_system.py``: the legacy alias and its three actions."""
    pol = T.MitigationPolicy(n_shards=4)
    assert pol.plan(T.PodVerdict(False, None, None, 0, "none"))["action"] \
        == "none"
    plan = pol.plan(T.PodVerdict(True, "core", 5, 4.0, "rebalance"))
    assert plan["action"] == "rebalance"
    w = plan["shard_weights"]
    assert w.sum() == pytest.approx(1.0) and w[1] < w[0]
    plan = pol.plan(T.PodVerdict(True, "core", 5, 12.0,
                                 "exclude_and_restart"))
    assert plan["action"] == "exclude_and_restart"
    assert plan["exclude"] == ("core", 5)


@pytest.mark.parametrize("verdict", [
    (True, "core", 5, 12.0, "exclude_and_restart"),
    (True, "link", 7, 9.0, "reroute_or_restart"),
    (True, "core", 2, 4.0, "rebalance"), (False, None, None, 0.0, "none")])
def test_mitigation_plans_match_reference(verdict):
    """With the pod mesh, severe plans carry the registry policy's edits
    (remap for a chip, reroute for a link), as the reference's do."""
    det = T.PodDetector(T.PodTelemetryConfig(mesh_w=4, mesh_h=4),
                        device="cpu")
    jdet = JT.PodDetector(JT.PodTelemetryConfig(mesh_w=4, mesh_h=4))
    got = T.PodMitigationPolicy(n_shards=4, mesh=det.mesh).plan(
        T.PodVerdict(*verdict))
    exp = JT.PodMitigationPolicy(n_shards=4, mesh=jdet.mesh).plan(
        JT.PodVerdict(*verdict))
    _plans_equal(got, exp)


def test_train_telemetry_ci_smoke_on_cpu(capsys):
    """The reference's CI smoke (``ci.yml:37``) with ``--device cpu``: the
    injected 10× window is flagged, so ``--expect-flagged`` passes."""
    losses = train.main([
        "--arch", "smollm-135m", "--smoke", "--steps", "24", "--batch", "2",
        "--seq", "32", "--telemetry", "--telemetry-window", "8",
        "--inject-slow-at", "10", "--inject-slow-steps", "6",
        "--inject-slow-factor", "10", "--expect-flagged", "--log-every",
        "100", "--device", "cpu"])
    assert len(losses) == 24 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    # the gate is the CI's: some window flagged (real step times are
    # noisy, so which chip the verdict names is not pinned here)
    assert "FLAGGED" in out and "windows," in out


def test_serve_telemetry_on_cpu():
    """``launch.serve --telemetry``: decode steps stream into the pod
    detector, one verdict per window; prefills are not samples."""
    seen = []
    done, stats = serve.main(
        ["--arch", "smollm-135m", "--smoke", "--requests", "8",
         "--max-new", "8", "--telemetry", "--telemetry-window", "4",
         "--device", "cpu"], step_hook=lambda kind, dt: seen.append(kind))
    assert len(done) == 8
    n_decode = seen.count("decode")
    assert n_decode == 16 and seen.count("prefill") == 2
    # one warmup step, then windows of 4; the flush takes the tail
    assert stats["telemetry_windows"] == -(-(n_decode - 1) // 4)
    assert stats["telemetry_flagged"] >= 0


def reference_pod_pins() -> list:
    """The reference's verdicts on the pin runs (the ``"ref"`` recorder;
    the batched one gives the same verdicts)."""
    out = []
    for topology, kind, loc in POD_PIN_CASES:
        cfg = JT.PodTelemetryConfig(topology=topology,
                                    window_steps=POD_PIN_WINDOW_STEPS)
        pod = JT.PodSimulator(cfg, step_flops=5e12, collective_bytes=4e9,
                              seed=1)
        pod.inject(JFailSlow(kind, loc, 0.0, 1e9,
                             10.0 if kind == "core" else 8.0))
        det = JT.PodDetector(cfg)
        verdicts, t = [], 0.0
        for w in range(POD_PIN_WINDOWS):
            sim = pod.run_steps(POD_PIN_WINDOW_STEPS, t0=t,
                                step0=w * POD_PIN_WINDOW_STEPS)
            t += sim.total_time
            v = det.observe(sim)
            verdicts.append([v.flagged, v.kind, v.location, v.severity,
                             v.action])
        out.append({"topology": topology, "fault": [kind, loc],
                    "links": pod.mesh.n_links, "verdicts": verdicts})
    return out


if __name__ == "__main__":
    print(json.dumps(reference_pod_pins()), flush=True)
    sys.exit(0)
