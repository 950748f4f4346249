"""Public API of the sketch-update kernel.

``insert_runs_many`` inserts run streams into several sketches at once,
each with its own state, drain and :class:`SketchParams`: CUDA tensors
launch ``csrc/sketch_insert.cu`` once for all of them (one block per
sketch), CPU tensors run the plain torch version in :mod:`.ref` once per
sketch.  A sketch that fits one block's shared memory runs the
shared-memory kernel; any other geometry runs its device-memory variant,
with the sections :func:`.layout.placement` names in a scratch allocated
here (a launch whose sketches take both paths is two launches, counted
under ``sketch_insert_runs`` and ``sketch_insert_runs_device``).  ``insert_runs`` (the one-sketch case) and ``insert`` (per record)
are built on it.  On either device a state that breaks the kernel's
Stage-2 precondition (``ref.PRECONDITION``) raises ``ValueError``.
``patterns`` / ``drain_patterns`` decode Stage-2 and the drained-eviction
stream into the same :class:`~repro_torch.core.sketch.Pattern` records the
numpy oracle produces.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.sketch import Pattern, SketchParams, accumulate_pattern
from .. import _lib
from . import layout as LY
from . import ref as R

#: What ``analysis/kernel_audit.py`` (and, on the card, ``chip_smoke.py``
#: in the SASS) holds ``csrc/sketch_insert.cu`` to: no float atomics; the
#: integer atomics of the Stage-2 build (the live-row count, the ring and
#: index slots claimed by CAS, the precondition bits); one block per
#: sketch, so the grid is the launch's sketch count ``count`` and no
#: sketch's runs are split across blocks (their order is semantic).  The
#: device-memory variant is an instance of the same kernel: its atomics on
#: the index and ring slots in device memory are the same CAS.
AUDIT = {"float_atomics": 0,
         "int_atomics": {"sketch_insert_runs_kernel": ("atomicAdd",
                                                       "atomicCAS",
                                                       "atomicOr")},
         "one_block_per": {"sketch_insert_runs_kernel": "count"}}

make_state = R.make_state
make_drain = R.make_drain

_RUN_FIELDS = ("lo", "hi", "reps", "dur", "val", "t0", "dt")
_INT_FIELDS = ("n", "d", "m", "H", "L", "cap")


class SketchArgs(ctypes.Structure):
    """Mirror of ``struct SketchArgs`` in ``csrc/sketch_insert.cu``."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _RUN_FIELDS]
                + [(k, ctypes.c_void_p) for k in R.STATE_KEYS]
                + [(k, ctypes.c_void_p) for k in R.DRAIN_KEYS]
                + [("status", ctypes.c_void_p)]
                + [(k, ctypes.c_int) for k in _INT_FIELDS])


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"sketch_insert_runs: {name} must be a contiguous {dtype} "
            f"tensor of shape {shape} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")


def _check_job(state, drain, runs, device):
    d, m = state["keys_lo"].shape
    L = state["s2_lo"].shape[0]
    cap = drain["d_lo"].shape[0]
    n = runs[0].shape[0]
    for k, x in zip(_RUN_FIELDS, runs):
        _check(k, x, torch.int32 if k in ("lo", "hi", "reps")
               else torch.float32, (n,), device)
    if set(state) != set(R.STATE_KEYS) or set(drain) != set(R.DRAIN_KEYS):
        raise ValueError("sketch_insert_runs: state / drain must have the "
                         "keys of make_state / make_drain")
    for k in R.STATE_KEYS:
        shape = (d, m) if k in R.S1_KEYS else () if k == "counter" else (L,)
        _check(k, state[k], torch.float32 if k in R.S2F_KEYS
               else torch.int32, shape, device)
    for k in R.DRAIN_KEYS:
        _check(k, drain[k], torch.float32 if k in R.DF_KEYS
               else torch.int32, () if k == "d_n" else (cap,), device)
    return n, d, m, L, cap


def _load():
    lib = _lib.load("sketch_insert")
    lib.sketch_insert_smem_bytes.restype = ctypes.c_longlong
    lib.sketch_insert_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sketch_insert_variant_smem_bytes.restype = ctypes.c_longlong
    lib.sketch_insert_variant_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sketch_insert_scratch_bytes.restype = ctypes.c_longlong
    lib.sketch_insert_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.sketch_insert_runs.restype = ctypes.c_int
    lib.sketch_insert_runs.argtypes = [ctypes.POINTER(SketchArgs),
                                       ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_int, ctypes.c_void_p]
    return lib


def launch_insert_runs(jobs):
    """Launch the kernel for ``jobs`` (``(state, drain, runs, params)``,
    ``runs = (lo, hi, reps, dur, val, t0, dt)``, all on one CUDA device;
    the kernel refuses more than ``MAX_SKETCHES`` of them) on copies of
    each state and drain, without waiting for it: one launch of each path
    the sketches take, as :func:`.layout.placement` chooses it from each
    geometry.  Returns the new ``[(state, drain)]`` and an int32 status
    per sketch (its precondition code, read by :func:`raise_on_status`)."""
    return _launch(jobs, [LY.placement(*state["keys_lo"].shape,
                                       state["s2_lo"].shape[0])
                          for state, *_ in jobs])


def _launch(jobs, places):
    """:func:`launch_insert_runs` with each sketch's placement given:
    ``None`` runs it in the shared-memory kernel, a mask of
    :data:`.layout.SECTIONS` in the device-memory variant with those
    sections in its scratch (checks run a sketch that fits shared memory
    in the variant this way)."""
    dev = jobs[0][0]["keys_lo"].device
    lib = _load()
    out, args, masks, scratch = [], [], [], []
    status = torch.full((len(jobs),), -1, dtype=torch.int32, device=dev)
    for k, ((state, drain, runs, params), place) in enumerate(
            zip(jobs, places, strict=True)):
        n, d, m, L, cap = _check_job(state, drain, runs, dev)
        masks.append(-1 if place is None else place)
        # the variant's sections in device memory; the stream orders the
        # allocator's reuse of this block after the launch
        scratch.append(None if place is None else torch.empty(
            LY.bytes_placed(d, m, L, True, place)[1], dtype=torch.uint8,
            device=dev))
        st = {key: v.clone() for key, v in state.items()}
        dr = {key: v.clone() for key, v in drain.items()}
        out.append((st, dr))
        args.append(SketchArgs(
            *[x.data_ptr() for x in runs],
            *[st[key].data_ptr() for key in R.STATE_KEYS],
            *[dr[key].data_ptr() for key in R.DRAIN_KEYS],
            status[k:].data_ptr(), n, d, m, params.H, L, cap))
    ptrs = [0 if x is None or x.numel() == 0 else x.data_ptr()
            for x in scratch]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(lib.sketch_insert_runs(
            (SketchArgs * len(args))(*args),
            (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(masks))(*masks), len(args), stream),
            "sketch_insert_runs")
    if any(p < 0 for p in masks):
        _lib.count("sketch_insert_runs")
    if any(p >= 0 for p in masks):
        _lib.count("sketch_insert_runs_device")
    return out, status


def raise_on_status(status) -> None:
    """Wait for the launch and raise ``ValueError`` if a sketch's state
    broke the precondition (no such sketch's result may be used)."""
    for code in status.tolist():
        if code < 0:
            raise RuntimeError("sketch_insert_runs: a block wrote no status")
        R.raise_on_violations(code)


def insert_runs_many(jobs):
    """Insert each job's runs into its sketch: ``jobs`` is a sequence of
    ``(state, drain, runs, params)`` with ``runs = (lo, hi, reps, dur,
    val, t0, dt)``; on the card one launch.  Returns ``[(state, drain)]``
    in job order; the inputs are not modified."""
    jobs = list(jobs)
    if not jobs:
        return []
    if jobs[0][0]["keys_lo"].device.type == "cuda":
        out, status = launch_insert_runs(jobs)
        raise_on_status(status)
        return out
    out = []
    for state, drain, runs, params in jobs:
        R.raise_on_violations(R.stage2_violations(state))
        out.append(R.insert_runs_plain(state, drain, *runs, H=params.H))
    return out


def insert_runs(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                params: SketchParams):
    """Run-compressed insertion: run ``i`` stands for ``reps[i]``
    consecutive records of key ``(lo[i], hi[i])`` starting at ``t0[i]``
    with stride ``dt[i]``.  Returns ``(state, drain)``."""
    return insert_runs_many(
        [(state, drain, (lo, hi, reps, dur, val, t0, dt), params)])[0]


def insert(state, lo, hi, dur, val, t, *, params: SketchParams,
           drain=None):
    """Per-record insertion, each record a run of one.  With ``drain``
    FIFO-evicted Stage-2 rows are kept and ``(state, drain)`` returns;
    without it evictions are discarded and only ``state`` returns."""
    want_drain = drain is not None
    if not want_drain:
        drain = make_drain(1, device=state["keys_lo"].device)
    reps = torch.ones_like(lo, dtype=torch.int32)
    state, drain = insert_runs(state, drain, lo, hi, reps, dur, val, t,
                               torch.zeros_like(dur), params=params)
    return (state, drain) if want_drain else state


_PAT_COLS = ("count", "sum", "sumsq", "val", "tmin", "tmax", "arrival",
             "min")


def _bulk_rows(merged: dict[int, Pattern], arr, pre: str, idx,
               key_tag: int):
    """Decode rows ``idx`` of a state/drain dict (field prefix ``pre``)
    into Patterns, accumulating into ``merged`` (one host copy per
    column)."""
    if len(idx) == 0:
        return

    def col(c):
        return arr[pre + c].cpu().numpy()[idx]

    keys = col("lo").astype(np.int64) + (col("hi").astype(np.int64) << 31)
    cols = [keys.tolist()] + [col(c).tolist() for c in _PAT_COLS]
    for key, cnt, s, sq, v, tmin, tmax, arrival, mind in zip(*cols):
        accumulate_pattern(merged, Pattern(key | key_tag, cnt, s, sq, v,
                                           tmin, tmax, arrival, mind))


def drain_patterns(drain, key_tag: int = 0) -> list[Pattern]:
    """Decode only a drained-eviction buffer into (partial) Patterns,
    merged per key, in eviction order."""
    merged: dict[int, Pattern] = {}
    _bulk_rows(merged, drain, "d_", np.arange(int(drain["d_n"])), key_tag)
    return sorted(merged.values(), key=lambda p: p.arrival)


def patterns(state, drain=None, key_tag: int = 0) -> list[Pattern]:
    """Decode Stage-2 (and, when given, the drained-eviction stream) into
    Pattern records merged per key, like the numpy oracle's
    ``patterns(include_drained=True)``.  ``key_tag`` is OR-ed into every
    key: the (lo, hi) halves keep key bits 0–61, so the comp space's tag
    at bit 62 is restored by the caller."""
    merged: dict[int, Pattern] = {}
    if drain is not None:
        _bulk_rows(merged, drain, "d_", np.arange(int(drain["d_n"])),
                   key_tag)
    _bulk_rows(merged, state, "s2_",
               np.nonzero(state["s2_valid"].cpu().numpy())[0], key_tag)
    return sorted(merged.values(), key=lambda p: p.arrival)
