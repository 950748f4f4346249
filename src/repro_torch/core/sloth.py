"""SLOTH, as a registered :class:`~repro_torch.core.detectors.Detector`.

End-to-end pipeline (Figure 4):

    workload + arch config + probe config + failure model
        → SL-Compiler (probe plan)
        → simulate (instrumented run)
        → SL-Recorder (Fail-Slow Sketch compression)
        → SL-Tracer (core/link detection → MCG → FailRank)
        → ranked root causes + storage/overhead accounting

* :class:`Sloth` — the full pipeline bound to one (workload graph, mesh)
  deployment and one torch ``device`` (the card unless ``"cpu"`` is
  asked for).  It both *generates* instrumented traces (``run``) and
  *analyses* them (``analyse → Verdict``).  With
  ``SlothConfig(recorder_impl="batched")`` the recorder runs the
  Fail-Slow Sketch CUDA kernel on the card; FailRank runs on ``device``.
* :class:`SlothDetector` — the registry adapter implementing the unified
  detector protocol (``prepare(graph, mesh, profile, cfg)`` /
  ``analyse(sim)``), registered under ``"sloth"``.

Both entry points also run *streaming*: ``Sloth.stream()`` returns an
always-on :class:`~repro_torch.core.streaming.SlothStream` (one
incremental Verdict per observed chunk, the sketch state carried on the
pipeline's device), and ``stream_analyse(sim, n_chunks)`` /
``SlothDetector.stream_analyse`` replay a finished trace through it — the
final streamed verdict equals post-hoc ``analyse`` exactly on both
recorder impls, and the first flagged window's stream time feeds the
campaign's detection-latency metric.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..analysis.memory_model import validate_config
from ..device import resolve_device
from .compiler import plan_probes
from .detection import detect_cores, detect_links
from .detectors import Verdict, _register_builtin
from .failrank import FailRankParams, FailRankResult, attribute_links, \
    failrank
from .failures import FailSlow
from .graph import CompGraph
from .mapping import MappedGraph, map_graph
from .mcg import MCG, build_mcg
from .recorder import RecorderOutput, record
from .routing import Topology, mesh_mean_degree
from .simulator import SimConfig, SimResult, calibrate, simulate
from .sketch import SketchParams

__all__ = ["SlothConfig", "Verdict", "Sloth", "SlothDetector"]


@dataclasses.dataclass
class SlothConfig:
    sketch: SketchParams = dataclasses.field(default_factory=SketchParams)
    failrank: FailRankParams = dataclasses.field(
        default_factory=FailRankParams)
    n_windows: int = 4
    core_z_flag: float = 6.0
    link_ratio_flag: float = 3.0
    detect_threshold: float = 0.55   # min initial prob to report a failure
    instr_per_task: int = 64
    # Recorder sketch implementation: "ref" (per-run numpy oracle on the
    # host) or "batched" (the packed-state path with the drained-eviction
    # stream, on the pipeline's device: the CUDA kernel on the card — the
    # deployable path).  Flows through record(..., impl=...).
    recorder_impl: str = "ref"
    # Per-chip on-chip memory budget for the recorder, in KiB (the
    # paper's "within kilobytes" regime).  Checked *statically* at
    # pipeline construction by repro_torch.analysis.memory_model.
    # validate_config(): the comp + comm sketch footprint — paper
    # accounting for impl="ref", the larger of accounting and the packed
    # state for impl="batched" — must fit, or Sloth.__init__ raises
    # MemoryBudgetError before anything runs.  Set to None to disable
    # (benchmark sweeps deliberately explore over-budget geometries).
    budget_kb: float | None = 256.0
    # -- mesh-size-aware flag scaling --------------------------------------
    # The flag thresholds are calibrated on the paper's 4×4 chip (16 cores,
    # 48 links).  The expected extreme of a *healthy* population grows with
    # the number of resources examined (≈ √(2·ln N) for the core z-scores,
    # and empirically ≈ log-linear for the link slowdown ratios), so fixed
    # thresholds false-flag on large meshes — the 12×12 ``none`` cell
    # famously flagged a healthy link at the defaults.  Scaling the flags
    # by ln(resources / reference) keeps the healthy extreme below the
    # flag at every mesh size while 10× failures stay far above it.  Set
    # the per-log coefficients to 0 to recover fixed thresholds.
    ref_cores: int = 16
    ref_links: int = 48
    core_z_per_log: float = 0.75
    link_ratio_per_log: float = 2.2
    # -- degree-aware flag scaling (non-mesh fabrics) ----------------------
    # The resource-count terms above transfer across topology classes, but
    # the link-EM's conditioning does not: wrap links (torus) and
    # unidirectional dataflow links (systolic) change how many routes each
    # link shares, smearing the per-link inverse-bandwidth estimates on
    # healthy fabrics.  The skew grows with how far the fabric's mean
    # router incidence sits from the same-dims reference mesh it was
    # calibrated on, so the link flag is padded per unit of |degree
    # difference|.  Exactly zero on every plain W×H mesh (the reference
    # class itself), keeping historical mesh thresholds bit-identical.
    link_ratio_per_degree: float = 0.45

    def flag_thresholds(self, topo) -> tuple[float, float]:
        """Resource-count + degree-aware ``(core_z, link_ratio)`` flags
        for one fabric (any registered :class:`~repro_torch.core.routing.
        Topology`)."""
        core_z = self.effective_core_z(topo.n_cores)
        link_ratio = self.effective_link_ratio(topo.n_links)
        skew = abs(topo.mean_degree()
                   - mesh_mean_degree(topo.width, topo.height))
        return core_z, link_ratio + self.link_ratio_per_degree * skew

    def effective_core_z(self, n_cores: int) -> float:
        """Core z flag scaled for a mesh of ``n_cores`` cores."""
        excess = math.log(max(n_cores, 1) / self.ref_cores)
        return self.core_z_flag + self.core_z_per_log * max(0.0, excess)

    def effective_link_ratio(self, n_links: int) -> float:
        """Link slowdown-ratio flag scaled for a mesh of ``n_links``
        links."""
        excess = math.log(max(n_links, 1) / self.ref_links)
        return (self.link_ratio_flag
                + self.link_ratio_per_log * max(0.0, excess))


class Sloth:
    """SLOTH pipeline bound to one (workload graph, mesh) deployment."""

    name = "sloth"

    def __init__(self, graph: CompGraph, mesh: Topology,
                 cfg: SlothConfig | None = None,
                 sim_cfg: SimConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.mesh = mesh
        self.cfg = cfg or SlothConfig()
        # static guard: reject sketch geometries that cannot fit the
        # on-chip budget before any simulation or recording happens
        validate_config(self.cfg)
        self.mapped: MappedGraph = map_graph(graph, mesh)
        self.sim_cfg = sim_cfg or SimConfig(
            mu_c=calibrate(graph.total_flops(), mesh.n_cores))
        self.plan = plan_probes(graph, self.mapped)

    # -- data collection -----------------------------------------------------
    def run(self, failures: list[FailSlow] | None = None,
            seed: int = 0) -> SimResult:
        sim_cfg = dataclasses.replace(self.sim_cfg, seed=seed)
        return simulate(self.mapped, sim_cfg, failures=failures,
                        probes=self.plan.sim_plan)

    # -- analysis --------------------------------------------------------------
    def analyse(self, sim: SimResult) -> Verdict:
        """Post-hoc analysis: record the whole trace, then trace it."""
        cfg = self.cfg
        rec = record(sim, cfg.sketch, instr_per_task=cfg.instr_per_task,
                     hop_latency=self.sim_cfg.hop_latency,
                     impl=cfg.recorder_impl, device=self.device)
        return self.analyse_recorded(rec, sim.total_time)

    def analyse_recorded(self, rec: RecorderOutput,
                         total_time: float) -> Verdict:
        """SL-Tracer over an already-compressed trace.

        The detection half of :meth:`analyse`, split out so the
        streaming service (:class:`~repro_torch.core.streaming.SlothStream`)
        can re-analyse a :class:`StreamingRecorder`'s cumulative output
        per window without re-recording; ``total_time`` is the analysis
        horizon (the trace's total time post-hoc, the stream's elapsed
        clock mid-stream)."""
        cfg = self.cfg
        core_z, link_ratio = cfg.flag_thresholds(self.mesh)
        core_cands = detect_cores(rec.comp_patterns, total_time,
                                  cfg.n_windows, core_z,
                                  rate_scale=getattr(self.mesh,
                                                     "rate_class", None))
        link_inf = detect_links(rec.comm_patterns, self.mesh, total_time,
                                cfg.n_windows, self.sim_cfg.hop_latency,
                                link_ratio)
        mcg = build_mcg(rec.comm_patterns, self.mesh, total_time,
                        core_cands, link_inf, cfg.n_windows)
        fr = failrank(mcg, cfg.failrank, device=self.device)

        # ---- combine detection evidence with FailRank refinement ---------
        # FailRank's fixed point forgets l0 geometrically (γ^k), so the
        # final verdict multiplies each candidate's detection probability by
        # its (normalised) FailRank mass: detection says *what looks slow*,
        # FailRank arbitrates *which of the correlated anomalies is the
        # propagation source*.
        n_cores = self.mesh.n_cores
        core_ev = np.zeros(n_cores)
        for c in core_cands:
            core_ev[c.core] = max(core_ev[c.core], c.prob)
        link_ev = np.zeros(self.mesh.n_links)
        for c in link_inf.candidates:
            link_ev[c.link] = max(link_ev[c.link], c.prob)

        core_fr = np.zeros(n_cores)
        core_nodes = fr.raw_node_scores[:mcg.n_windows * n_cores]
        for w in range(mcg.n_windows):
            core_fr = np.maximum(core_fr,
                                 core_nodes[w * n_cores:(w + 1) * n_cores])
        core_fr /= max(core_fr.max(), 1e-12)
        link_fr = attribute_links(mcg, fr, link_inf.theta)
        link_fr /= max(link_fr.max(), 1e-12)

        core_scores = core_ev * (0.5 + core_fr)
        link_scores = link_ev * (0.5 + link_fr)

        max_core_p = float(core_ev.max()) if n_cores else 0.0
        max_link_p = float(link_ev.max()) if len(link_ev) else 0.0
        flagged = max(max_core_p, max_link_p) >= cfg.detect_threshold

        # every resource whose detection probability independently clears
        # the threshold — with k simultaneous failures there can be several
        flagged_res = (
            [("core", int(c), float(core_ev[c]))
             for c in range(n_cores)
             if core_ev[c] >= cfg.detect_threshold]
            + [("link", int(l), float(link_ev[l]))
               for l in range(len(link_ev))
               if link_ev[l] >= cfg.detect_threshold])
        flagged_res.sort(key=lambda x: (-x[2], x[0], x[1]))

        ranking = (
            [("core", int(c), float(core_scores[c]))
             for c in np.argsort(-core_scores)[:5] if core_scores[c] > 0]
            + [("link", int(l), float(link_scores[l]))
               for l in np.argsort(-link_scores)[:5] if link_scores[l] > 0])
        ranking.sort(key=lambda x: -x[2])

        kind = loc = None
        score = 0.0
        if flagged and ranking:
            kind, loc, score = ranking[0]
        return Verdict(flagged=flagged, kind=kind, location=loc, score=score,
                       ranking=ranking, recorder=rec, failrank=fr, mcg=mcg,
                       total_time=total_time,
                       flagged_resources=tuple(flagged_res),
                       mesh=self.mesh, detector=self.name)

    def detect(self, failures: list[FailSlow] | None = None,
               seed: int = 0) -> Verdict:
        return self.analyse(self.run(failures=failures, seed=seed))

    # -- streaming -----------------------------------------------------------
    def stream(self, policy=None):
        """A fresh :class:`~repro_torch.core.streaming.SlothStream` bound
        to this pipeline (one incremental Verdict per observed chunk).
        ``policy`` — a registered mitigation-policy name or instance —
        arms the stream to plan a mitigation at the first flag."""
        from .streaming import SlothStream
        return SlothStream(self, policy=policy)

    def stream_analyse(self, sim: SimResult, n_chunks: int = 4,
                       policy=None) -> tuple[Verdict, float | None]:
        """Replay a finished trace through the streaming service.

        Splits ``sim`` into ``n_chunks`` time-ordered chunks
        (:func:`~repro_torch.core.streaming.split_sim`), observes them in
        order and returns ``(final verdict, first_flag_time)``.  The
        last chunk is analysed at ``sim.total_time``, so the final
        verdict equals post-hoc :meth:`analyse` of the same trace
        exactly (same impl, same cumulative sketch state);
        ``first_flag_time`` is the stream time of the earliest flagged
        window (``None`` if no window flagged).  ``policy`` arms
        mid-stream mitigation planning (see :meth:`stream`) without
        changing the return shape."""
        from .streaming import split_sim
        st = self.stream(policy=policy)
        chunks = split_sim(sim, n_chunks)
        v = None
        for i, chunk in enumerate(chunks):
            horizon = sim.total_time if i == len(chunks) - 1 else None
            v = st.observe(chunk, total_time=horizon)
        return v, st.first_flag_time


class SlothDetector:
    """Registry adapter: SLOTH under the unified detector protocol.

    ``prepare`` builds the full pipeline for the deployment (``profile`` is
    unused — SLOTH calibrates from the workload's FLOP volume, not from a
    profiling run); ``analyse`` delegates to the pipeline.
    """

    name = "sloth"

    def __init__(self):
        self.pipeline: Sloth | None = None

    def prepare(self, graph: CompGraph, mesh: Topology,
                profile: SimResult | None = None,
                cfg: SlothConfig | None = None,
                device=None) -> "SlothDetector":
        self.pipeline = Sloth(graph, mesh, cfg=cfg, device=device)
        return self

    def analyse(self, sim: SimResult) -> Verdict:
        if self.pipeline is None:
            raise RuntimeError("SlothDetector.analyse before prepare()")
        return self.pipeline.analyse(sim)

    def stream_analyse(self, sim: SimResult, n_chunks: int = 4,
                       policy=None) -> tuple[Verdict, float | None]:
        """Streaming protocol hook: detectors exposing this method are
        driven chunk-by-chunk on the campaign's ``streaming=`` axis and
        report detection latency (see ``campaign.run_scenario``)."""
        if self.pipeline is None:
            raise RuntimeError("SlothDetector.stream_analyse before "
                               "prepare()")
        return self.pipeline.stream_analyse(sim, n_chunks=n_chunks,
                                            policy=policy)


_register_builtin("sloth", SlothDetector)
