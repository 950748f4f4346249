"""Recorder driver: simulator traces → probes → Fail-Slow Sketch patterns.

Separate sketches are kept for computation and communication traces (the
paper reports their storage separately, Figs 11/12).  Instruction expansion
is fed to the sketch as exact run-length runs (`insert_run`).

Two interchangeable sketch implementations (``record(..., impl=...)``):

* ``impl="ref"`` (default) — the per-run numpy oracle
  (:class:`~repro_torch.core.sketch.FailSlowSketch.insert_run`), one
  Python call per run, on the host.
* ``impl="batched"`` — the packed-state path
  (:func:`repro_torch.kernels.sketch_update.ops.insert_runs_many`) on
  ``device``: both sketches in one launch of the CUDA kernel on the card,
  its plain torch version once per sketch on the CPU, with Stage-2 FIFO
  evictions preserved in the drained-eviction stream.  It never runs the
  numpy oracle.

Both paths produce the same merged (live + drained) pattern lists —
bit-identical keys / counts / arrival order and float statistics to f32
tolerance — and byte-identical compression accounting.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from . import probes as P
from .sketch import (STAGE2_SLOT_BYTES, FailSlowSketch, Pattern,
                     SketchParams, split_key)
from .simulator import SimResult

#: Valid ``record(..., impl=)`` spellings.
RECORDER_IMPLS = ("ref", "batched")


@dataclasses.dataclass
class RecorderOutput:
    comp_patterns: list[Pattern]
    comm_patterns: list[Pattern]
    raw_comp_bytes: int
    raw_comm_bytes: int
    sketch_comp_bytes: int
    sketch_comm_bytes: int
    n_comp_records: int
    n_comm_records: int
    # drained-eviction stream depth (Stage-2 FIFO victims written off-chip;
    # included in sketch_*_bytes at one STAGE2_SLOT_BYTES each)
    n_comp_drained: int = 0
    n_comm_drained: int = 0
    impl: str = "ref"

    @property
    def raw_bytes(self) -> int:
        return self.raw_comp_bytes + self.raw_comm_bytes

    @property
    def sketch_bytes(self) -> int:
        return self.sketch_comp_bytes + self.sketch_comm_bytes

    def onchip_bytes(self) -> int:
        """SRAM-resident bytes only: ``sketch_bytes`` minus the off-chip
        drained-pattern stream (each drained row costs exactly one
        Stage-2 slot).  This is the quantity the static memory model
        (:mod:`repro_torch.analysis.memory_model`) predicts without running
        anything, for both impls."""
        return (self.sketch_bytes
                - (self.n_comp_drained + self.n_comm_drained)
                * STAGE2_SLOT_BYTES)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.sketch_bytes, 1)


def comp_runs(comp, instr_per_task: int):
    """Computation trace rows → run-compressed sketch input
    ``(keys, reps, durs, vals, t0s, dts)``.  Each task expands to
    ``instr_per_task`` instruction records of equal duration; the run
    algebra (``insert_run``) makes that expansion exact without
    materialising it."""
    keys = P.comp_pattern_keys(comp)
    r = instr_per_task
    durs = (comp["t_end"] - comp["t_start"]) / r
    return (keys, np.full(len(keys), r), durs, comp["flops"] / r,
            comp["t_start"], durs)


def comm_runs(comm, packet_bytes: int, max_packets: int,
              hop_latency: float):
    """Communication trace rows → per-packet run-compressed sketch input
    ``(keys, reps, durs, vals, t0s, dts)``.

    Per-packet duration uses the queue-free service time: the min over
    a pattern's packets estimates link bandwidth, not congestion (the
    detector's EM needs the former; backpressure is a symptom).  Each
    packet pays the full per-hop router latency (store-and-forward),
    while the serialisation time divides across packets."""
    keys = P.comm_pattern_keys(comm)
    pk = np.clip(np.ceil(comm["bytes"] / packet_bytes).astype(np.int64),
                 1, max_packets)
    lat = comm["hops"] * hop_latency
    per = np.maximum(comm["service"] - lat, 0.0) / pk + lat
    wall = (comm["t_arrive"] - comm["t_depart"]) / pk
    return keys, pk, per, comm["bytes"] / pk, comm["t_depart"], wall


def _sketch_runs_ref(params: SketchParams, keys, reps, durs, vals, t0s,
                     dts):
    """Per-run numpy oracle path."""
    sk = FailSlowSketch(params)
    sk.insert_runs(keys, reps, durs, vals, t0s, dts)
    return sk.patterns(), sk.compressed_bytes(), sk.n_evicted


def batched_job(params: SketchParams, runs, device, state=None):
    """One sketch's job for
    :func:`repro_torch.kernels.sketch_update.ops.insert_runs_many`: the
    run-compressed input ``runs = (keys, reps, durs, vals, t0s, dts)`` as
    tensors on ``device``, a drain sized to hold one eviction per run (one
    run evicts at most one Stage-2 row), and ``state`` (a fresh sketch when
    ``None``)."""
    from ..kernels.sketch_update import ops as sketch_ops
    keys, reps, durs, vals, t0s, dts = runs

    def on(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
            device)

    lo, hi = split_key(np.asarray(keys, dtype=np.int64))
    if state is None:
        state = sketch_ops.make_state(params, device=device)
    return (state, sketch_ops.make_drain(len(keys), device=device),
            (on(lo, np.int32), on(hi, np.int32), on(reps, np.int32),
             on(durs, np.float32), on(vals, np.float32),
             on(t0s, np.float32), on(dts, np.float32)), params)


def _sketch_runs_batched(sides, device):
    """Packed-state path on ``device``: one insertion call for every
    sketch (one kernel launch on the card), drained evictions preserved,
    keys rebuilt with the sketch-truncated tag bit restored (see
    :func:`repro_torch.kernels.sketch_update.ops.patterns`).  ``sides``
    holds ``(params, runs, key_tag)``."""
    from ..kernels.sketch_update import ops as sketch_ops
    if not sides:
        return []
    device = resolve_device(device)
    jobs = [batched_job(params, runs, device) for params, runs, _ in sides]
    out = []
    for (params, _, key_tag), (state, drain) in zip(
            sides, sketch_ops.insert_runs_many(jobs)):
        n_drained = int(drain["d_n"])
        # byte-identical to FailSlowSketch.compressed_bytes(): on-chip state
        # plus one exact Stage-2 slot per drained pattern
        out.append((sketch_ops.patterns(state, drain, key_tag=key_tag),
                    params.total_bytes()
                    + n_drained * params.stage2_slot_bytes(), n_drained))
    return out


def record(sim: SimResult, params: SketchParams,
           comm_params: SketchParams | None = None,
           instr_per_task: int = 64,
           packet_bytes: int = P.PACKET_BYTES,
           max_packets: int = 64,
           hop_latency: float = 50e-9,
           impl: str = "ref", device=None) -> RecorderOutput:
    """Compress one simulated trace into comp/comm pattern lists.

    ``impl`` selects the sketch implementation (see the module
    docstring): ``"ref"`` runs the per-run numpy oracle on host;
    ``"batched"`` runs the packed-state path on ``device`` (resolved by
    :func:`repro_torch.device.resolve_device`: the card unless ``"cpu"``
    is asked for), both sketches in one call.  Pattern lists
    always merge live Stage-2 entries with FIFO-drained partials —
    analysis sees every promoted pattern regardless of eviction pressure
    — and ``sketch_*_bytes`` accounts the drained rows at one Stage-2
    slot each (on-chip state + the off-chip compressed stream), so the
    compression ratio is the deployable end-to-end figure on both paths.
    """
    if impl not in RECORDER_IMPLS:
        raise ValueError(f"unknown recorder impl {impl!r}; "
                         f"options: {RECORDER_IMPLS}")
    comm_params = comm_params or params

    comp, comm = sim.comp, sim.comm
    sides = {}
    n_comp = n_comm = 0
    if len(comp["core"]):
        runs = comp_runs(comp, instr_per_task)
        sides["comp"] = (params, runs, P.COMP_KEY_TAG)
        n_comp = len(runs[0]) * instr_per_task
    if len(comm["src"]):
        runs = comm_runs(comm, packet_bytes, max_packets, hop_latency)
        sides["comm"] = (comm_params, runs, P.COMM_KEY_TAG)
        n_comm = int(runs[1].sum())
    if impl == "batched":
        got = dict(zip(sides, _sketch_runs_batched(list(sides.values()),
                                                   device)))
    else:
        got = {side: _sketch_runs_ref(p, *runs)
               for side, (p, runs, _) in sides.items()}
    comp_patterns, comp_bytes, n_comp_drained = got.get(
        "comp", ([], params.total_bytes(), 0))
    comm_patterns, comm_bytes, n_comm_drained = got.get(
        "comm", ([], comm_params.total_bytes(), 0))

    return RecorderOutput(
        comp_patterns=comp_patterns,
        comm_patterns=comm_patterns,
        raw_comp_bytes=n_comp * P.COMP_RECORD_BYTES,
        raw_comm_bytes=n_comm * P.COMM_RECORD_BYTES,
        sketch_comp_bytes=comp_bytes,
        sketch_comm_bytes=comm_bytes,
        n_comp_records=n_comp,
        n_comm_records=n_comm,
        n_comp_drained=n_comp_drained,
        n_comm_drained=n_comm_drained,
        impl=impl,
    )
