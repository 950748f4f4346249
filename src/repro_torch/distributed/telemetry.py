"""Pod-level fail-slow detection: SLOTH one level up.

A port of the reference's ``distributed/telemetry.py``.  A pod of
accelerator chips is a many-core accelerator: chips are cores, the
chip-to-chip links are NoC links.  This module adapts the SLOTH pipeline
to per-step training telemetry:

  * every step, each chip reports its step compute time (the per-chip
    portion before the gradient all-reduce) and per-neighbour collective
    transfer (bytes, time); the ``PodSimulator`` below generates them with
    the paper's statistical model, from the reference's numpy draws, so
    its traces are bit-identical to the reference's;
  * records are compressed through the same Fail-Slow Sketch;
  * SL-Tracer (group outliers + EM + MCG + FailRank) localises slow chips
    or degraded links, folding FailRank mass into the verdict like
    ``Sloth.analyse``;
  * detection runs **live**: ``PodDetector.observe(window)`` holds the
    sketch state across windows (:class:`~repro_torch.core.streaming
    .StreamingRecorder`) and emits one verdict per window, and
    :class:`StepTelemetry` bridges a training or serving loop's measured
    per-step wall times into those windows (``launch/train.py
    --telemetry``, ``launch/serve.py --telemetry``);
  * ``PodMitigationPolicy`` turns verdicts into actions through the
    shared mitigation registry (:mod:`repro_torch.mitigate`).

``PodDetector`` and ``StepTelemetry`` take a ``device`` (the card unless
``"cpu"``), which reaches ``record``, the ``StreamingRecorder`` and the
COO ``failrank``.  With ``recorder_impl="batched"`` the sketch state lives
there, and each ``observe`` is one launch of the sketch kernel resumed
from the carried state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.detection import detect_cores, detect_links
from ..core.detectors import Verdict
from ..core.failrank import FailRankParams, attribute_links, failrank
from ..core.failures import FailSlow
from ..core.mcg import build_mcg
from ..core.recorder import RecorderOutput, record
from ..core.routing import Topology, build_topology
from ..core.simulator import SimResult
from ..core.sketch import SketchParams
from ..core.streaming import StreamingRecorder
from ..device import resolve_device


@dataclasses.dataclass
class PodTelemetryConfig:
    mesh_w: int = 16
    mesh_h: int = 16
    # registry fabric key for the pod ('mesh' | 'torus' | 'systolic' |
    # 'het:fast2slow1' | ...): the simulator and the detector both build
    # their fabric through the topology registry from this one field, so
    # pod telemetry honours the deployment's actual fabric instead of
    # hard-coding a mesh in each class.
    topology: str = "mesh"
    window_steps: int = 32          # steps per analysis window
    sketch: SketchParams = dataclasses.field(
        default_factory=lambda: SketchParams(d=2, m=1024, H=4, L=2048))
    detect_threshold: float = 0.55
    # SL-Recorder sketch path for the pod detector ("ref" | "batched"),
    # plumbed through record()/StreamingRecorder exactly like
    # SlothConfig.recorder_impl
    recorder_impl: str = "ref"


class PodSimulator:
    """Synthetic per-step telemetry with the paper's statistical model:
    chip compute time ~ Normal, link transfer ~ Gamma, plus injected
    fail-slow windows."""

    def __init__(self, cfg: PodTelemetryConfig, *, step_flops: float,
                 collective_bytes: float, seed: int = 0,
                 host: int = 0):
        self.cfg = cfg
        self.mesh = build_topology(cfg.topology, cfg.mesh_w, cfg.mesh_h)
        # Host identity and mesh shape are folded into the stream key
        # the same way campaign.py keys scenarios — two hosts sharing a
        # base seed must not draw identical telemetry noise.
        self.rng = np.random.default_rng(
            [seed, host, cfg.mesh_w, cfg.mesh_h])
        self.step_flops = step_flops
        self.coll_bytes = collective_bytes
        self.chip_speed = 1.0 + 0.02 * self.rng.standard_normal(
            self.mesh.n_cores)
        self.failures: list[FailSlow] = []

    def inject(self, f: FailSlow):
        self.failures.append(f)

    def _slow(self, kind: str, loc: int, t: float) -> float:
        s = 1.0
        for f in self.failures:
            if f.kind == kind and f.location == loc \
                    and f.t0 <= t < f.t0 + f.duration:
                s *= f.slowdown
        return s

    def run_steps(self, n_steps: int, t0: float = 0.0, *,
                  step0: int = 0, chip0_durs=None,
                  base: float | None = None,
                  jitter: float | None = None) -> SimResult:
        """Telemetry for ``n_steps`` training steps as a SimResult.

        Window-by-window generation (for the streaming detector) uses
        the keyword overrides: ``step0`` continues the absolute step
        index (stage grouping spans windows), ``chip0_durs`` substitutes
        *measured* step durations for chip 0 (the local host feeding
        real timings through :class:`StepTelemetry`), ``base``
        overrides the nominal per-chip step seconds (e.g. the measured
        baseline) and ``jitter`` the peers' relative step-time noise
        (default 1%; :class:`StepTelemetry` passes the host's *measured*
        noise so real timing variance isn't mistaken for a z-outlier)
        — defaults reproduce the historical draws exactly.
        ``total_time`` is relative to ``t0``; record timestamps are
        absolute.
        """
        mesh = self.mesh
        if base is None:
            base = self.step_flops / 197e12  # nominal per-chip step seconds
        if jitter is None:
            jitter = 0.01
        comp = {k: [] for k in ("core", "node", "part", "stage", "op",
                                "flops", "t_start", "t_end")}
        comm = {k: [] for k in ("src", "dst", "stage", "bytes", "t_depart",
                                "t_arrive", "hops", "service")}
        t = t0
        # pattern keys must recur for sketch promotion: group steps into
        # 4-step stages (the sketch's H=4 promotes within one stage, and
        # each analysis window still holds >=3 stages of link evidence)
        stage_of = lambda s: s // 4  # noqa: E731
        for i in range(n_steps):
            s = step0 + i
            durs = np.empty(mesh.n_cores)
            for c in range(mesh.n_cores):
                slow = self._slow("core", c, t)
                jit = 1.0 + jitter * abs(self.rng.standard_normal())
                durs[c] = base * jit * slow / self.chip_speed[c]
            if chip0_durs is not None:
                durs[0] = chip0_durs[i]    # the host's measured step time
            for c in range(mesh.n_cores):
                comp["core"].append(c)
                comp["node"].append(s)
                comp["part"].append(0)
                comp["stage"].append(stage_of(s))
                comp["op"].append(1)
                comp["flops"].append(self.step_flops)
                comp["t_start"].append(t)
                comp["t_end"].append(t + durs[c])
            # ring all-reduce: neighbour transfers on every mesh link
            step_end = t + durs.max()
            per_link = self.coll_bytes / mesh.n_links
            svc_step = []
            for lid, (u, v) in enumerate(mesh.links):
                slow = self._slow("link", lid, t)
                g = self.rng.gamma(16.0, 1 / 16.0)
                svc = per_link * g * slow / 50e9 + 1e-6
                comm["src"].append(u)
                comm["dst"].append(v)
                comm["stage"].append(stage_of(s))
                comm["bytes"].append(per_link)
                comm["t_depart"].append(t + durs[u])
                comm["t_arrive"].append(t + durs[u] + svc)
                comm["hops"].append(1)
                comm["service"].append(svc)
                svc_step.append(svc)
            # the next step starts once the slowest link of THIS step has
            # delivered (the all-reduce barrier).  This used to read
            # ``max(c[-1] for c in [comm["service"]])`` — a max over a
            # one-element list, i.e. the *last* enumerated link's service
            # — so step boundaries (and thus window assignment) drifted
            # whenever the slowest link wasn't the last one.
            t = step_end + max(svc_step)
        return SimResult(
            total_time=t - t0,
            comp={k: np.asarray(v) for k, v in comp.items()},
            comm={k: np.asarray(v) for k, v in comm.items()},
            n_raw_records=n_steps * (self.mesh.n_cores + self.mesh.n_links))


@dataclasses.dataclass
class PodVerdict:
    flagged: bool
    kind: str | None
    location: int | None
    severity: float
    action: str       # 'none' | 'rebalance' | 'exclude_and_restart'


class PodDetector:
    """SLOTH pipeline bound to the pod topology.

    ``analyse(sim)`` is the post-hoc entry point (record the whole
    telemetry trace, then trace it); ``observe(window)`` is the live
    one — sketch state persists across calls in a
    :class:`~repro_torch.core.streaming.StreamingRecorder` and every window
    yields a fresh verdict over the cumulative compressed history, so a
    training loop gets one verdict per ``window_steps`` without ever
    re-recording past steps.

    ``measured`` names the resources, as ``("core" | "link", index)``
    pairs, whose telemetry is measured; the others are synthesised from
    a fault-free model, so a flag on one of them is an artefact of its
    draws and the verdict never names it.  ``None`` (the default) lets
    every core and link be named, as the reference does.
    """

    def __init__(self, cfg: PodTelemetryConfig, device=None, *,
                 measured=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = build_topology(cfg.topology, cfg.mesh_w, cfg.mesh_h)
        self.measured = None if measured is None else frozenset(measured)
        self._stream: StreamingRecorder | None = None

    def _verdict_from(self, rec: RecorderOutput,
                      total_time: float) -> PodVerdict:
        """SL-Tracer over a compressed telemetry trace.

        Folds FailRank mass into the detection probabilities exactly
        like ``Sloth.analyse`` — each candidate's probability is scaled
        by ``0.5 + normalised FailRank mass``, so among correlated
        anomalies the propagation *source* wins the verdict (the
        FailRank result used to be computed and then dropped here).
        """
        cfg = self.cfg
        cores = detect_cores(rec.comp_patterns, total_time, 4,
                             z_flag=6.0)
        links = detect_links(rec.comm_patterns, self.mesh, total_time,
                             4, hop_latency=0.0)
        n_cores = self.mesh.n_cores
        core_ev = np.zeros(n_cores)
        core_z = np.zeros(n_cores)
        for c in cores:
            core_ev[c.core] = max(core_ev[c.core], c.prob)
            core_z[c.core] = max(core_z[c.core], c.z)
        link_ev = np.zeros(self.mesh.n_links)
        link_z = np.zeros(self.mesh.n_links)
        for c in links.candidates:
            link_ev[c.link] = max(link_ev[c.link], c.prob)
            link_z[c.link] = max(link_z[c.link], c.z)
        if self.measured is not None:
            # synthesised resources keep their part in FailRank's graph
            # but can neither raise the flag nor be named
            core_ev *= [("core", c) in self.measured for c in range(n_cores)]
            link_ev *= [("link", lid) in self.measured
                        for lid in range(self.mesh.n_links)]
        max_core = float(core_ev.max()) if n_cores else 0.0
        max_link = float(link_ev.max()) if len(link_ev) else 0.0
        if max(max_core, max_link) < cfg.detect_threshold:
            return PodVerdict(False, None, None, 0.0, "none")

        mcg = build_mcg(rec.comm_patterns, self.mesh, total_time,
                        cores, links, 4)
        fr = failrank(mcg, FailRankParams(), device=self.device)
        core_fr = np.zeros(n_cores)
        core_nodes = fr.raw_node_scores[:mcg.n_windows * n_cores]
        for w in range(mcg.n_windows):
            core_fr = np.maximum(
                core_fr, core_nodes[w * n_cores:(w + 1) * n_cores])
        core_fr /= max(core_fr.max(), 1e-12)
        link_fr = attribute_links(mcg, fr, links.theta)
        link_fr /= max(link_fr.max(), 1e-12)
        core_scores = core_ev * (0.5 + core_fr)
        link_scores = link_ev * (0.5 + link_fr)

        best_core = float(core_scores.max()) if n_cores else 0.0
        best_link = float(link_scores.max()) if len(link_scores) else 0.0
        if best_core >= best_link:
            c = int(np.argmax(core_scores))
            sev = float(core_z[c])
            action = "exclude_and_restart" if sev > 8 else "rebalance"
            return PodVerdict(True, "core", c, sev, action)
        lid = int(np.argmax(link_scores))
        return PodVerdict(True, "link", lid, float(link_z[lid]),
                          "reroute_or_restart")

    def analyse(self, sim: SimResult) -> PodVerdict:
        cfg = self.cfg
        rec = record(sim, cfg.sketch, instr_per_task=1, hop_latency=0.0,
                     impl=cfg.recorder_impl, device=self.device)
        return self._verdict_from(rec, sim.total_time)

    def observe(self, window: SimResult) -> PodVerdict:
        """Absorb one telemetry window into the resident sketch and
        return the verdict over the cumulative stream."""
        if self._stream is None:
            self._stream = StreamingRecorder(
                self.cfg.sketch, instr_per_task=1, hop_latency=0.0,
                impl=self.cfg.recorder_impl, device=self.device)
        self._stream.observe(window)
        return self._verdict_from(self._stream.output(),
                                  self._stream.elapsed)


@dataclasses.dataclass
class PodMitigationPolicy:
    """Turns pod verdicts into launcher actions.

    * rebalance: shrink the slow chip's data shard (returns per-shard
      weights for the pipeline);
    * exclude_and_restart: drop the host from the mesh and restart from the
      last checkpoint with a re-sharded (elastic) configuration.

    Severe plans go through the shared mitigation registry
    (:mod:`repro_torch.mitigate`) when the pod ``mesh`` is known: the pod *is*
    the mitigation mesh (chips ↔ cores, chip links ↔ NoC links), so the
    plan dict also carries the registry policy's resource edits —
    ``exclude_cores`` / ``avoid_links`` plus the raw
    :class:`~repro_torch.mitigate.policy.MitigationPlan` — for the elastic
    re-mesh restart to apply (remap for slow chips, reroute for degraded
    chip links).  ``mesh=None`` (the legacy constructor shape) returns the
    action keys alone.
    """
    n_shards: int
    mesh: Topology | None = None

    def plan(self, verdict: PodVerdict) -> dict:
        if not verdict.flagged:
            return {"action": "none"}
        if verdict.action == "rebalance" and verdict.kind == "core":
            w = np.ones(self.n_shards)
            w[verdict.location % self.n_shards] = 0.5
            return {"action": "rebalance", "shard_weights": w / w.sum()}
        out = {"action": "exclude_and_restart",
               "exclude": (verdict.kind, verdict.location)}
        if self.mesh is not None:
            from ..mitigate.policy import instantiate_policy
            sev = float(verdict.severity)
            shim = Verdict(
                True, verdict.kind, verdict.location, sev,
                flagged_resources=((verdict.kind, verdict.location, sev),))
            name = "remap" if verdict.kind == "core" else "reroute"
            p = instantiate_policy(name).plan(shim, None, self.mesh)
            out.update(policy=p.policy, exclude_cores=p.exclude_cores,
                       avoid_links=p.avoid_links, plan=p)
        return out


#: Back-compat alias: the protocol-level ``MitigationPolicy`` now lives in
#: :mod:`repro_torch.mitigate.policy`; the pod-telemetry policy keeps its old
#: import name here.
MitigationPolicy = PodMitigationPolicy


class StepTelemetry:
    """Live bridge from a real training/serving loop to the streaming
    pod detector.

    The loop calls ``record_step(dt)`` with each step's measured wall
    time (seconds).  The local host is **chip 0** of the pod; every
    ``window_steps`` accepted steps, a telemetry window is synthesised
    (:meth:`PodSimulator.run_steps` with ``chip0_durs`` = the
    median-of-5-smoothed real measurements — isolated stragglers are
    noise, sustained bursts are fail-slow — and peers at the measured
    healthy-median baseline with the measured relative noise), streamed
    into the resident :class:`PodDetector` sketch (``observe``), and the
    window's verdict plus the :class:`PodMitigationPolicy` plan are
    returned/recorded — so a slow host shows up as a flagged ``core 0``
    verdict within one window of onset.

    ``warmup`` initial steps are discarded (the first step of a loop
    builds and loads kernels and warms caches, which would dwarf the
    baseline and false-flag the host immediately).

    Only chip 0 is measured: the detector is built with
    ``measured={("core", 0)}``, so a verdict names this host or nothing.
    The reference lets it name a synthetic peer too; on noisy host times
    its slowest peer (core 14 at seed 0) draws z 6-11 and can win the
    window that holds a real slowdown of the host.
    """

    def __init__(self, cfg: PodTelemetryConfig | None = None, *,
                 n_shards: int = 4, warmup: int = 1, seed: int = 0,
                 host: int = 0, step_flops: float = 1e12,
                 collective_bytes: float = 1e8, device=None):
        self.cfg = cfg or PodTelemetryConfig(mesh_w=4, mesh_h=4,
                                             window_steps=8)
        self.detector = PodDetector(self.cfg, device=device,
                                    measured={("core", 0)})
        self.policy = PodMitigationPolicy(n_shards=n_shards,
                                          mesh=self.detector.mesh)
        self.pod = PodSimulator(self.cfg, step_flops=step_flops,
                                collective_bytes=collective_bytes,
                                seed=seed, host=host)
        self.warmup = warmup
        self._skipped = 0
        self._buf: list[float] = []
        self._dts: list[float] = []    # accepted history (baseline median)
        self._step = 0                 # absolute synthesised step index
        self._t = 0.0                  # absolute stream clock
        self.verdicts: list[PodVerdict] = []
        self.plans: list[dict] = []

    def record_step(self, dt: float) -> PodVerdict | None:
        """Feed one measured step duration; returns the window's verdict
        when this step completes a window, else ``None``."""
        if self._skipped < self.warmup:
            self._skipped += 1
            return None
        self._buf.append(float(dt))
        self._dts.append(float(dt))
        if len(self._buf) < self.cfg.window_steps:
            return None
        return self.flush()

    def flush(self) -> PodVerdict | None:
        """Force-analyse the buffered partial window (e.g. at loop end);
        ``None`` if nothing is buffered."""
        if not self._buf:
            return None
        dts = np.asarray(self._dts)
        # baseline and peer noise describe the *healthy* steady state:
        # steps ≥ 2× the raw median are treated as slowdown candidates
        # and excluded, so a sustained fail-slow burst neither drags the
        # baseline up nor inflates the noise it is judged against
        med0 = float(np.median(dts))
        healthy = dts[dts < 2.0 * med0]
        if not len(healthy):
            healthy = dts
        baseline = float(np.median(healthy))
        # peers carry the *measured* relative noise (robust MAD
        # estimate): real wall-time jitter — e.g. millisecond-scale
        # decode steps at ±20% — would otherwise z-flag the host
        # against unrealistically tight synthetic peers.  Floored at
        # the model's nominal 1%, capped at 10% so extreme measurement
        # noise cannot drown a decisive (≥ 2×, i.e. excluded-above)
        # slowdown
        mad = float(np.median(np.abs(healthy - baseline)))
        noise = min(max(0.01, 1.4826 * mad / max(baseline, 1e-12)), 0.1)
        # fail-slow is *sustained* degradation (seconds-to-minutes in
        # the paper, i.e. many steps): a rolling median-of-5 removes
        # isolated straggler steps and pairs (GC pauses, scheduler
        # hiccups — the dominant false-flag source in real step
        # timings) while a burst of ≥ 3 consecutive slow steps passes
        # through.  The left edge borrows real predecessor steps; the
        # right edge pads with the healthy baseline (a burst still in
        # flight at the window edge is confirmed one window later)
        buf = np.asarray(self._buf)
        n = len(buf)
        lead = dts[max(len(dts) - n - 2, 0):len(dts) - n]
        padded = np.concatenate([
            np.full(2 - len(lead), baseline), lead, buf,
            [baseline, baseline]])
        chip0 = np.array([np.median(padded[i:i + 5]) for i in range(n)])
        window = self.pod.run_steps(
            len(self._buf), t0=self._t, step0=self._step,
            chip0_durs=chip0, base=baseline, jitter=noise)
        self._step += len(self._buf)
        self._t += float(window.total_time)
        self._buf = []
        v = self.detector.observe(window)
        self.verdicts.append(v)
        self.plans.append(self.policy.plan(v))
        return v

    @property
    def flagged(self) -> bool:
        """Whether any window so far produced a flagged verdict."""
        return any(v.flagged for v in self.verdicts)
