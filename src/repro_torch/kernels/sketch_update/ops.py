"""Public API of the sketch-update kernel.

``insert_runs`` (the recorder's run-compressed entry point) and
``insert`` (per-record) take packed state on one device: CPU tensors go to
the plain torch version in :mod:`.ref`, CUDA tensors launch the CUDA
kernel ``csrc/sketch_insert.cu`` (one block for the sketch) or raise.
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
from . import ref as R

make_state = R.make_state
make_drain = R.make_drain

_RUN_FIELDS = ("lo", "hi", "reps", "dur", "val", "t0", "dt")
_INT_FIELDS = ("n", "d", "m", "H", "L", "cap")


class SketchArgs(ctypes.Structure):
    """Mirror of ``struct SketchArgs`` in ``csrc/sketch_insert.cu``."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _RUN_FIELDS]
                + [(k, ctypes.c_void_p) for k in R.STATE_KEYS]
                + [(k, ctypes.c_void_p) for k in R.DRAIN_KEYS]
                + [(k, ctypes.c_int) for k in _INT_FIELDS])


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"sketch_insert_runs: {name} must be a contiguous {dtype} "
            f"tensor of shape {shape} on {device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")


def _load():
    lib = _lib.load("sketch_insert")
    lib.sketch_insert_smem_bytes.restype = ctypes.c_longlong
    lib.sketch_insert_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sketch_insert_runs.restype = ctypes.c_int
    lib.sketch_insert_runs.argtypes = [ctypes.POINTER(SketchArgs),
                                       ctypes.c_void_p]
    return lib


def insert_runs_cuda(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                     H: int):
    """Launch the CUDA kernel on copies of ``state`` / ``drain`` (the
    inputs are not modified); returns the new ``(state, drain)``."""
    dev = state["keys_lo"].device
    d, m = state["keys_lo"].shape
    L = state["s2_lo"].shape[0]
    cap = drain["d_lo"].shape[0]
    n = lo.shape[0]
    runs = dict(zip(_RUN_FIELDS, (lo, hi, reps, dur, val, t0, dt)))
    for k, x in runs.items():
        _check(k, x, torch.int32 if k in ("lo", "hi", "reps")
               else torch.float32, (n,), dev)
    if set(state) != set(R.STATE_KEYS) or set(drain) != set(R.DRAIN_KEYS):
        raise ValueError("sketch_insert_runs: state / drain must have the "
                         "keys of make_state / make_drain")
    for k in R.STATE_KEYS:
        shape = (d, m) if k in R.S1_KEYS else () if k == "counter" else (L,)
        _check(k, state[k], torch.float32 if k in R.S2F_KEYS
               else torch.int32, shape, dev)
    for k in R.DRAIN_KEYS:
        _check(k, drain[k], torch.float32 if k in R.DF_KEYS
               else torch.int32, () if k == "d_n" else (cap,), dev)

    lib = _load()
    smem = lib.sketch_insert_smem_bytes(d, m, L)
    if smem > _lib.MAX_SMEM_BYTES:
        raise ValueError(
            f"sketch state needs {smem} B of shared memory (d={d}, m={m}, "
            f"L={L}); one block holds at most {_lib.MAX_SMEM_BYTES} B")
    st = {k: v.clone() for k, v in state.items()}
    dr = {k: v.clone() for k, v in drain.items()}
    args = SketchArgs(
        *[x.data_ptr() for x in runs.values()],
        *[st[k].data_ptr() for k in R.STATE_KEYS],
        *[dr[k].data_ptr() for k in R.DRAIN_KEYS],
        n, d, m, H, L, cap)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check(lib.sketch_insert_runs(ctypes.byref(args), stream),
                   "sketch_insert_runs")
    _lib.LAUNCHES["sketch_insert_runs"] += 1
    return st, dr


def insert_runs(state, drain, lo, hi, reps, dur, val, t0, dt, *,
                params: SketchParams):
    """Run-compressed insertion: run ``i`` stands for ``reps[i]``
    consecutive records of key ``(lo[i], hi[i])`` starting at ``t0[i]``
    with stride ``dt[i]``.  Returns ``(state, drain)``."""
    if state["keys_lo"].device.type == "cuda":
        return insert_runs_cuda(state, drain, lo, hi, reps, dur, val, t0,
                                dt, H=params.H)
    return R.insert_runs_plain(state, drain, lo, hi, reps, dur, val, t0, dt,
                               H=params.H)


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
