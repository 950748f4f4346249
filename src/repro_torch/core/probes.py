"""Probe abstraction (paper Table II), record sizes and pattern keys.

A probe is a five-tuple (Fragment, Type, Location, Level, Structure):

  Fragment:  Exec | Route | Mem      — what to record
  Type:      Comp | Comm | IO        — which instructions to match
  Location:  Pre | Post | Surround   — where relative to the instruction
  Level:     Inst | Stage            — aggregation granularity
  Structure: List | Sketch           — storage backend

The simulator emits task/flow-level records; real probes fire per
*instruction* (per sample in the batch, per packet on a link).  The
``expand_*`` helpers perform that expansion record by record; the recorder
feeds the same expansion to the sketch as exact runs
(``core/recorder.py``), and the raw-format storage accounting below is
the paper's instruction-level log size.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Fragment(enum.Enum):
    EXEC = "exec"
    ROUTE = "route"
    MEM = "mem"


class InstrType(enum.Enum):
    COMP = "comp"
    COMM = "comm"
    IO = "io"


class Location(enum.Enum):
    PRE = "pre"
    POST = "post"
    SURROUND = "surround"


class Level(enum.Enum):
    INST = "inst"
    STAGE = "stage"


class Structure(enum.Enum):
    LIST = "list"
    SKETCH = "sketch"


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    fragment: Fragment
    type: InstrType
    location: Location
    level: Level
    structure: Structure
    target_ops: tuple[str, ...] = ()   # op types to match; () = all

    def as_tuple(self):
        return (self.fragment.value, self.type.value, self.location.value,
                self.level.value, self.structure.value)

    def __repr__(self):
        return "[" + ", ".join(v.capitalize() for v in self.as_tuple()) + "]"


# -- record sizes for the raw 'List' format (paper Fig 2a / §IV-D) ----------
COMP_RECORD_BYTES = 48   # index, core, stage, op, flops, t_start, t_end
COMM_RECORD_BYTES = 56   # index, src, dst, stage, bytes, t_depart, t_arrive
PACKET_BYTES = 1024      # NoC packetisation for per-packet Route probes


def expand_comp_trace(comp: dict[str, np.ndarray],
                      instr_per_task: int = 64) -> dict[str, np.ndarray]:
    """Expand task-level compute records to per-instruction records.

    Each mapped task executes ``instr_per_task`` volume-equivalent
    instructions (one per batch sample in the throughput-inference setting);
    they share a pattern key and split the task's duration and FLOPs.
    """
    n = len(comp["core"])
    if n == 0:
        return {k: v.copy() for k, v in comp.items()}
    k = instr_per_task
    rep = {key: np.repeat(v, k) for key, v in comp.items()}
    frac = np.tile(np.arange(k, dtype=np.float64), n)
    dur = np.repeat((comp["t_end"] - comp["t_start"]) / k, k)
    rep["t_start"] = rep["t_start"] + frac * dur
    rep["t_end"] = rep["t_start"] + dur
    rep["flops"] = rep["flops"] / k
    return rep


def expand_comm_trace(comm: dict[str, np.ndarray],
                      packet_bytes: int = PACKET_BYTES,
                      max_packets: int = 64) -> dict[str, np.ndarray]:
    """Expand flow-level records to per-packet records (capped per flow)."""
    n = len(comm["src"])
    if n == 0:
        return {k: v.copy() for k, v in comm.items()}
    pk = np.clip(np.ceil(comm["bytes"] / packet_bytes).astype(np.int64),
                 1, max_packets)
    rep = {key: np.repeat(v, pk) for key, v in comm.items()}
    idx = np.concatenate([np.arange(p) for p in pk]).astype(np.float64)
    per = np.repeat((comm["t_arrive"] - comm["t_depart"]) / pk, pk)
    rep["t_depart"] = rep["t_depart"] + idx * per
    rep["t_arrive"] = rep["t_depart"] + per
    rep["bytes"] = np.repeat(comm["bytes"] / pk, pk)
    return rep


def raw_bytes(comp_records: int, comm_records: int) -> int:
    return comp_records * COMP_RECORD_BYTES + comm_records * COMM_RECORD_BYTES


# -- pattern keys ------------------------------------------------------------
# A pattern identifies traces "with similar execution behaviours" (§III-C):
# compute: (core, stage, op-type, flops bucket); comm: (src, dst, volume
# bucket).  Keys are packed into int64 for the sketch.
#
# Each key space carries a distinct high type-disambiguation tag bit so a
# comp key can never alias a comm key bit-for-bit.  (Historical bug: the
# comm tag was written ``2 << 61``, which equals ``1 << 62`` — the comp
# tag — so e.g. comp(core=5, stage=1, op=0, fb=0) and comm(src=5, dst=1,
# stage=0, vb=0) collided exactly.  The spaces only meet inside shared
# decoding / FailRank consumers, so the recorder's separate sketches
# masked the aliasing.)  The comm tag sits at bit 61, inside the 62 bits
# the sketch's (lo, hi) int32 halves preserve; the comp tag at bit 62 is
# outside them and is restored from the key space by the batched recorder
# path when it rebuilds keys from sketch state.

COMP_KEY_TAG = 1 << 62
COMM_KEY_TAG = 1 << 61


def comp_pattern_keys(comp: dict[str, np.ndarray]) -> np.ndarray:
    fb = np.clip(np.log2(np.maximum(comp["flops"], 1.0)).astype(np.int64),
                 0, 63)
    return (comp["core"].astype(np.int64)
            + (comp["stage"].astype(np.int64) << 12)
            + (comp["op"].astype(np.int64) << 28)
            + (fb << 34) + COMP_KEY_TAG)


def comm_pattern_keys(comm: dict[str, np.ndarray]) -> np.ndarray:
    vb = np.clip(np.log2(np.maximum(comm["bytes"], 1.0)).astype(np.int64),
                 0, 63)
    return (comm["src"].astype(np.int64)
            + (comm["dst"].astype(np.int64) << 12)
            + (comm["stage"].astype(np.int64) << 24)
            + (vb << 40) + COMM_KEY_TAG)


def decode_comp_key(key: int) -> dict:
    return {"core": int(key & 0xFFF), "stage": int((key >> 12) & 0xFFFF),
            "op": int((key >> 28) & 0x3F)}


def decode_comm_key(key: int) -> dict:
    return {"src": int(key & 0xFFF), "dst": int((key >> 12) & 0xFFF),
            "stage": int((key >> 24) & 0xFFFF)}
