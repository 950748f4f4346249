"""Build and load the CUDA sources in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` into ``build/lib<name>-<hash>.so`` at the repository root
(the hash is of the source and its flags, so an edited kernel or a changed
flag is rebuilt), then loaded with ``ctypes``.  Nothing is built or loaded
when this module is imported: the first launch builds what it needs, and
:func:`build_all` builds every source at once, one ``nvcc`` process each,
started together.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one with
:func:`count` where it launches its kernel and nowhere else.  Loading and
counting are thread-safe: the campaign's thread executor launches from
several threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Flags of single sources.  The sketch insert (K1) and the FailRank step
#: (K2) keep every float multiply and add separately rounded (no FMA
#: contraction): K1's statistics are checked bit-equal to the plain torch
#: version and K2's L' exactly equal.  Flash attention (K3) and the SSD scan
#: (K4) are checked at a tolerance against plain versions that run on
#: cuBLAS, which contracts anyway, so they build with FMA (twice the f32
#: rate of a separate multiply and add).
SOURCE_FLAGS = {"sketch_insert": ("-fmad=false",),
                "failrank_step": ("-fmad=false",)}

#: Largest dynamic shared memory one block may use on Hopper.
MAX_SMEM_BYTES = 232_448

#: ``sketch_insert_runs`` counts launches of K1's shared-memory kernel,
#: ``sketch_insert_runs_device`` of its device-memory variant (a batch that
#: mixes the two paths is one launch of each).
#: ``flash_attention`` counts calls of K3's forward wrapper on f32 inputs;
#: each call launches one of its two forward entry points, counted again
#: under its own name.  ``flash_attention_bf16`` and its ``_prefill`` /
#: ``_decode`` keys count the same for bf16 inputs.
#: ``flash_attention_bwd`` and ``flash_attention_bf16_bwd`` count calls of
#: K3's backward entry points on f32 inputs (three kernels a call, four
#: with grouped heads) and on bf16 inputs (two).  ``ssd_scan``,
#: ``ssd_scan_bf16``, ``ssd_scan_bwd`` and ``ssd_scan_bf16_bwd`` count calls
#: of K4's forward (four kernels) and of its backward (seven kernels) on f32
#: and on bf16 inputs.
LAUNCHES: dict[str, int] = {"sketch_insert_runs": 0,
                             "sketch_insert_runs_device": 0,
                             "failrank_step": 0,
                             "flash_attention": 0,
                             "flash_attention_prefill": 0,
                             "flash_attention_decode": 0,
                             "flash_attention_bf16": 0,
                             "flash_attention_bf16_prefill": 0,
                             "flash_attention_bf16_decode": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bf16_bwd": 0, "ssd_scan": 0,
                             "ssd_scan_bf16": 0, "ssd_scan_bwd": 0,
                             "ssd_scan_bf16_bwd": 0}

_libs: dict[str, ctypes.CDLL] = {}
# one thread builds and loads a library while the others wait for it (two
# builds of one source would write the same temporary file: one pid)
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def count(name: str) -> None:
    """Add one launch of ``name`` to ``LAUNCHES``."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def flags(name: str) -> tuple[str, ...]:
    """``nvcc`` flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(flags(name)).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library is built; returns
    ``(target, (process, temporary output) or None)``."""
    out = _target(name)
    if out.exists():
        return out, None
    cmd = [_nvcc(), *flags(name)]
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(BUILD / f"{name}.log", "w") as log:
        proc = subprocess.Popen(
            [*cmd, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {rc}):\n"
                           + build_log(name))
    os.replace(tmp, out)


def build_all() -> dict[str, float]:
    """Compile every ``csrc/*.cu`` in parallel; returns seconds per name
    (0.0 for a library that was already built).  Waits for every
    ``nvcc`` before it raises the first failure."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()  # lint: allow-wallclock (build seconds)
    jobs = {n: _start(n) for n in names}
    secs, errors = {}, []
    for n, (out, job) in jobs.items():
        try:
            _finish(n, out, job)
        except RuntimeError as e:
            errors.append(e)
        secs[n] = 0.0 if job is None \
            else time.perf_counter() - t0  # lint: allow-wallclock
    if errors:
        raise errors[0]
    return secs


def build_log(name: str) -> str:
    p = BUILD / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = _libs[name] = ctypes.CDLL(str(out))
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code
    (``cudaError_t``)."""
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")
