"""Streaming recorder + incremental detection service.

The paper's pitch is *live, on-chip* fail-slow detection: the sketch is
resident state that absorbs records as they happen, and verdicts are
emitted while the workload runs — not computed post-hoc over a finished
trace.  This module supplies that always-on shape:

* :class:`StreamingRecorder` — holds sketch state (a live
  :class:`~repro_torch.core.sketch.FailSlowSketch` for ``impl="ref"``,
  the packed ``kernels/sketch_update`` state dict on the recorder's device
  plus an accumulated drained-eviction stream for ``impl="batched"``)
  across repeated ``observe(sim_chunk)`` calls, instead of rebuilding a
  fresh sketch per :func:`~repro_torch.core.recorder.record`.  On the
  batched path each ``observe`` inserts both sides with one
  ``insert_runs_many`` call — one launch of the sketch kernel on the card,
  resumed from the state the previous chunk left.  ``output()``
  materialises a :class:`~repro_torch.core.recorder.RecorderOutput` with
  the same accounting ``record`` produces — for any chunking of a trace
  the result is bit-identical to one-shot recording on the same impl,
  because the chunks feed the exact same record sequence through the same
  run builders (:func:`~repro_torch.core.recorder.comp_runs` /
  :func:`~repro_torch.core.recorder.comm_runs`) and partial-pattern
  merging is associative
  (:func:`~repro_torch.core.sketch.accumulate_pattern`).
* :class:`SlothStream` — wraps a prepared
  :class:`~repro_torch.core.sloth.Sloth` pipeline and emits an incremental
  :class:`~repro_torch.core.detectors.Verdict` per observed window,
  tracking ``first_flag_time`` so **detection latency** (time-to-detect
  after failure onset) is measurable as a first-class metric next to
  accuracy (see ``metrics.detection_latency_stats`` and the campaign's
  ``streaming=`` axis).
* :func:`split_sim` — splits a finished :class:`SimResult` into
  time-ordered chunks for replaying a trace through the streaming path
  (the parity harness and the campaign's streaming axis both use it).

On-chip budget: streaming holds exactly one sketch state per side
(``SketchParams.total_bytes()``, a few hundred KiB) regardless of how
many chunks are observed — evicted Stage-2 rows drain off-chip per
chunk (``ops.drain_patterns``) just as the deployment writes them to
DRAM, so observing forever never grows the resident state.
"""

from __future__ import annotations

import math

import numpy as np

from ..device import resolve_device
from . import probes as P
from .recorder import (RECORDER_IMPLS, RecorderOutput, batched_job,
                       comm_runs, comp_runs)
from .simulator import SimResult
from .sketch import (FailSlowSketch, Pattern, SketchParams,
                     accumulate_pattern)

__all__ = ["StreamingRecorder", "SlothStream", "split_sim"]


def split_sim(sim: SimResult, n_chunks: int) -> list[SimResult]:
    """Split a finished trace into ``n_chunks`` time-ordered chunks.

    Rows are bucketed by completion time (comp ``t_end`` / comm
    ``t_arrive``) into ``n_chunks`` equal spans of the trace, then the
    bucket sequence is made monotone along each trace's row order
    (``np.maximum.accumulate``): the sketch is order-sensitive (Stage-1
    majority counters, Stage-2 FIFO arrival), so chunk concatenation
    must reproduce the original record order *exactly* — the monotone
    guard keeps it exact even where the simulator's row order and
    completion times disagree locally, while boundaries stay
    approximately time-aligned.  Empty chunks are legal (and preserved,
    so chunk ``i`` always covers span ``i``).  Each chunk's
    ``total_time`` is the running maximum completion time — the stream's
    elapsed clock at that point.
    """
    n = max(int(n_chunks), 1)
    total = max(float(sim.total_time), 1e-300)

    def buckets(ts) -> np.ndarray:
        ts = np.asarray(ts, dtype=np.float64)
        if not len(ts):
            return np.zeros(0, dtype=np.int64)
        b = np.clip((ts / total * n).astype(np.int64), 0, n - 1)
        return np.maximum.accumulate(b)

    bc = buckets(sim.comp["t_end"]) if len(sim.comp["core"]) \
        else np.zeros(0, dtype=np.int64)
    bm = buckets(sim.comm["t_arrive"]) if len(sim.comm["src"]) \
        else np.zeros(0, dtype=np.int64)
    chunks: list[SimResult] = []
    elapsed = 0.0
    for i in range(n):
        comp = {k: np.asarray(v)[bc == i] for k, v in sim.comp.items()}
        comm = {k: np.asarray(v)[bm == i] for k, v in sim.comm.items()}
        if len(comp["core"]):
            elapsed = max(elapsed, float(np.max(comp["t_end"])))
        if len(comm["src"]):
            elapsed = max(elapsed, float(np.max(comm["t_arrive"])))
        chunks.append(SimResult(
            total_time=elapsed, comp=comp, comm=comm,
            n_raw_records=len(comp["core"]) + len(comm["src"])))
    return chunks


class _SketchStream:
    """One side (comp or comm) of the streaming recorder: persistent
    sketch state + accumulated drained partials + record accounting."""

    def __init__(self, params: SketchParams, impl: str, key_tag: int):
        self.params = params
        self.impl = impl
        self.key_tag = key_tag
        self.n_records = 0
        if impl == "ref":
            self.sk = FailSlowSketch(params)
        else:
            self.state = None               # packed state, built lazily
            self.drained: dict[int, Pattern] = {}
            self.n_drained = 0

    def absorb(self, state, drain) -> None:
        """Keep a launch's new state and fold its drain (sized to the
        chunk, then discarded) into the host-side accumulator — the
        off-chip compressed stream; on-chip state stays one sketch."""
        from ..kernels.sketch_update import ops as sketch_ops
        self.state = state
        for pat in sketch_ops.drain_patterns(drain, key_tag=self.key_tag):
            accumulate_pattern(self.drained, pat)
        self.n_drained += int(drain["d_n"])

    def patterns(self) -> list[Pattern]:
        if self.impl == "ref":
            return self.sk.patterns()
        if self.state is None:
            return []
        from ..kernels.sketch_update import ops as sketch_ops

        # drained partials accumulated first (global eviction order),
        # then the live Stage-2 rows — the same merge order the one-shot
        # ops.patterns(state, drain) decode uses, so float accumulation
        # is bit-identical to post-hoc recording.
        merged: dict[int, Pattern] = {}
        for pat in self.drained.values():
            accumulate_pattern(merged, pat)
        for pat in sketch_ops.patterns(self.state, key_tag=self.key_tag):
            accumulate_pattern(merged, pat)
        return sorted(merged.values(), key=lambda p: p.arrival)

    def drained_count(self) -> int:
        return self.sk.n_evicted if self.impl == "ref" else self.n_drained

    def compressed_bytes(self) -> int:
        if self.impl == "ref":
            return self.sk.compressed_bytes()
        # one exact Stage-2 slot per drained pattern, matching
        # FailSlowSketch.compressed_bytes and recorder._sketch_runs_batched
        return (self.params.total_bytes()
                + self.n_drained * self.params.stage2_slot_bytes())


class StreamingRecorder:
    """Always-on SL-Recorder: sketch state held across ``observe`` calls.

    The constructor mirrors :func:`~repro_torch.core.recorder.record`'s
    keyword surface; ``observe(sim_chunk)`` absorbs one chunk of trace
    (either side may be empty) and ``output()`` materialises the
    cumulative :class:`~repro_torch.core.recorder.RecorderOutput`.  For
    any chunking of a trace, ``output()`` after observing every chunk is
    bit-identical to ``record()`` over the whole trace on the same impl.

    ``device`` is resolved by :func:`repro_torch.device.resolve_device`
    (the card unless ``"cpu"`` is asked for); the batched state lives
    there.  ``elapsed`` tracks the stream clock: the maximum record
    completion time observed so far (chunk ``total_time`` fields are
    deliberately ignored — pod telemetry windows report window-relative
    durations).
    """

    def __init__(self, params: SketchParams,
                 comm_params: SketchParams | None = None, *,
                 instr_per_task: int = 64,
                 packet_bytes: int = P.PACKET_BYTES,
                 max_packets: int = 64,
                 hop_latency: float = 50e-9,
                 impl: str = "ref",
                 budget_kb: float | None = 256.0,
                 device=None):
        if impl not in RECORDER_IMPLS:
            raise ValueError(f"unknown recorder impl {impl!r}; "
                             f"options: {RECORDER_IMPLS}")
        # static on-chip budget guard (KiB; None disables) — the
        # always-on recorder holds exactly this state forever, so an
        # over-budget geometry is rejected before the first observe()
        from ..analysis.memory_model import validate_params
        validate_params(params, comm_params, impl, budget_kb)
        self.device = resolve_device(device)
        self.impl = impl
        self.instr_per_task = instr_per_task
        self.packet_bytes = packet_bytes
        self.max_packets = max_packets
        self.hop_latency = hop_latency
        self._comp = _SketchStream(params, impl, P.COMP_KEY_TAG)
        self._comm = _SketchStream(comm_params or params, impl,
                                   P.COMM_KEY_TAG)
        self.elapsed = 0.0
        self.n_chunks = 0

    def observe(self, chunk: SimResult) -> None:
        """Absorb one trace chunk into the resident sketches."""
        self.n_chunks += 1
        sides = []
        comp = chunk.comp
        if len(comp["core"]):
            runs = comp_runs(comp, self.instr_per_task)
            sides.append((self._comp, runs))
            self._comp.n_records += len(runs[0]) * self.instr_per_task
            self.elapsed = max(self.elapsed, float(np.max(comp["t_end"])))
        comm = chunk.comm
        if len(comm["src"]):
            runs = comm_runs(comm, self.packet_bytes, self.max_packets,
                             self.hop_latency)
            sides.append((self._comm, runs))
            self._comm.n_records += int(runs[1].sum())
            self.elapsed = max(self.elapsed,
                               float(np.max(comm["t_arrive"])))
        if self.impl == "ref":
            for side, runs in sides:
                side.sk.insert_runs(*runs)
        elif sides:
            # both sides in one call: one launch of the sketch kernel,
            # resumed from the state each side carries
            from ..kernels.sketch_update import ops as sketch_ops
            got = sketch_ops.insert_runs_many(
                [batched_job(side.params, runs, self.device, side.state)
                 for side, runs in sides])
            for (side, _), (state, drain) in zip(sides, got):
                side.absorb(state, drain)

    def output(self) -> RecorderOutput:
        """Cumulative recorder output (same accounting as ``record``)."""
        return RecorderOutput(
            comp_patterns=self._comp.patterns(),
            comm_patterns=self._comm.patterns(),
            raw_comp_bytes=self._comp.n_records * P.COMP_RECORD_BYTES,
            raw_comm_bytes=self._comm.n_records * P.COMM_RECORD_BYTES,
            sketch_comp_bytes=self._comp.compressed_bytes(),
            sketch_comm_bytes=self._comm.compressed_bytes(),
            n_comp_records=self._comp.n_records,
            n_comm_records=self._comm.n_records,
            n_comp_drained=self._comp.drained_count(),
            n_comm_drained=self._comm.drained_count(),
            impl=self.impl,
        )


class SlothStream:
    """Incremental SLOTH: one verdict per observed window.

    Binds a :class:`StreamingRecorder` (on the pipeline's device) to a
    prepared :class:`~repro_torch.core.sloth.Sloth` pipeline; every
    ``observe`` call re-analyses the cumulative compressed state
    (``Sloth.analyse_recorded``) at the stream's elapsed clock and returns
    the window's :class:`~repro_torch.core.detectors.Verdict`.
    ``first_flag_time`` records the stream time of the first flagged
    verdict (``None`` until one fires) — subtracting the failure onset
    gives the detection latency.

    ``policy`` (a registered mitigation-policy name or a
    :class:`~repro_torch.mitigate.policy.MitigationPolicy` instance)
    closes the detect → mitigate loop mid-stream: at the first flagged
    verdict the policy plans against it, and the plan plus its stream
    time land in ``mitigation_plan`` / ``mitigation_time`` for the
    operator (or the campaign's mid-stream re-simulation) to act on.
    Planning happens exactly once — later flags never revise the plan,
    mirroring a real restart-once deployment.
    """

    def __init__(self, pipeline, policy=None):
        cfg = pipeline.cfg
        self.pipeline = pipeline
        self.recorder = StreamingRecorder(
            cfg.sketch, instr_per_task=cfg.instr_per_task,
            hop_latency=pipeline.sim_cfg.hop_latency,
            impl=cfg.recorder_impl,
            budget_kb=getattr(cfg, "budget_kb", 256.0),
            device=pipeline.device)
        if isinstance(policy, str):
            # deferred import: mitigate imports core, not the reverse
            from ..mitigate.policy import instantiate_policy
            policy = instantiate_policy(policy)
        self.policy = policy
        self.mitigation_plan = None
        self.mitigation_time: float | None = None
        self.verdicts: list = []
        self.first_flag_time: float | None = None

    def observe(self, chunk: SimResult, total_time: float | None = None):
        """Absorb a chunk, analyse, return this window's Verdict.

        ``total_time`` overrides the analysis horizon (pass the trace's
        final ``total_time`` on the last chunk so the verdict matches
        post-hoc ``analyse`` exactly; default: the stream's elapsed
        clock)."""
        self.recorder.observe(chunk)
        t = self.recorder.elapsed if total_time is None else total_time
        v = self.pipeline.analyse_recorded(self.recorder.output(), t)
        if v.flagged and self.first_flag_time is None:
            self.first_flag_time = t
            if self.policy is not None:
                self.mitigation_plan = self.policy.plan(
                    v, self.pipeline.mapped, self.pipeline.mesh,
                    self.pipeline.cfg)
                if self.mitigation_plan.acted:
                    self.mitigation_time = t
        self.verdicts.append(v)
        return v

    def detection_latency(self, onset: float) -> float:
        """Stream time from ``onset`` to the first flagged verdict
        (``math.inf`` if nothing has been flagged)."""
        if self.first_flag_time is None:
            return math.inf
        return self.first_flag_time - onset
