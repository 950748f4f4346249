"""Static (execution-free) model of the recorder's on-chip footprint.

SLOTH's headline claim is that on-chip detection is practical because the
Fail-Slow Sketch fits in kilobytes of on-chip memory.  This module makes
that claim *checkable at construction time*: closed-form byte counts for
every resident structure, derived only from :class:`~repro_torch.core
.sketch.SketchParams` / ``SlothConfig`` — nothing is allocated, no torch
tensor is made.

Four layers of accounting, each matching a measured quantity exactly
(tested in ``tests/test_torch_analysis.py``, the last on the card by
``chip_smoke.py``):

* **Paper accounting** (``accounting_bytes`` = ``SketchParams
  .total_bytes()``): Stage-1 ``d×m`` (lo, hi, freq) entries at 12 B plus
  ``L`` Stage-2 slots at ``STAGE2_SLOT_BYTES`` each — the figure every
  compression ratio in the campaign uses, and what ``RecorderOutput
  .onchip_bytes()`` reports.
* **Ref-impl arrays** (``ref_stage1_nbytes``): the numpy oracle's actual
  Stage-1 array ``nbytes`` (int32 lo + int32 hi + bool valid + int64
  freq = 17 B/bucket).
* **Batched-impl tensors** (``packed_state_bytes`` / ``drain_bytes``):
  the packed state of ``kernels/sketch_update/ref.make_state`` (4 int32
  ``[d, m]`` tables, 11 ``[L]`` vectors (5 int32, 6 f32) and the scalar
  arrival counter) and the drained-eviction buffer of ``make_drain`` (10
  ``[cap]`` vectors and a scalar).
* **K1's shared memory on Hopper** (``hopper_smem_bytes``): the dynamic
  shared memory one block of ``csrc/sketch_insert.cu`` takes for the whole
  call, ``layout(d, m, L).total`` in closed form
  (``kernels/sketch_update/layout``, which the wrapper places sections
  by) — its ``SketchArgs``, the barriers, the Stage-2 key index, Stage 1
  and Stage 2, the index slot of each row, the FIFO ring, the free bitmap
  and two ring stages of staged runs — against ``MAX_SMEM_BYTES``, what
  one block may have.  It takes the place of the reference's Pallas VMEM
  term; the card holds it equal to the library's own
  ``sketch_insert_smem_bytes``.  A geometry past it runs K1's
  device-memory variant, and ``memory_report`` names the path each side
  takes.

The budget check (:func:`validate_config` / :func:`validate_params`)
gates the *persistent* per-chip footprint: for each side (comp + comm)
the larger of the accounting bytes and — on ``impl="batched"`` — the
packed-state bytes, summed, against ``budget_kb`` KiB.  It is wired into
``Sloth.__init__`` and ``StreamingRecorder.__init__`` so an over-budget
geometry is rejected before any trace is recorded.  The shared-memory term
is reported and checked by the pass (``smem-over-limit``), not guarded:
any geometry runs, and the pass keeps the shipped ones on the faster
shared-memory path.
"""

from __future__ import annotations

from ..core.sketch import STAGE2_SLOT_BYTES, SketchParams
from ..kernels._lib import MAX_SMEM_BYTES
from ..kernels.sketch_update import layout as k1_layout
from .report import Finding

#: Default per-chip budget, KiB (1 KiB = 1024 B).  The paper's recorder
#: operates in the hundreds-of-KiB SRAM regime; the default geometry
#: (d=2, m=1024, L=1024, both sides) uses 128 KiB accounting / ~152 KiB
#: packed — comfortably inside, while leaving headroom for the pod
#: telemetry geometry (L=2048, ~240 KiB packed).
DEFAULT_BUDGET_KB = 256.0

#: Bytes per Stage-1 bucket in the paper accounting (lo + hi + freq).
STAGE1_ENTRY_BYTES = 4 + 4 + 4

#: Bytes per Stage-1 bucket in the numpy oracle's actual arrays
#: (int32 lo + int32 hi + bool valid + int64 freq).
REF_STAGE1_ENTRY_BYTES = 4 + 4 + 1 + 8

#: Bytes per Stage-1 bucket in the packed state (4 int32 tables).
PACKED_STAGE1_ENTRY_BYTES = 4 * 4

#: Bytes per Stage-2 slot in the packed state (5 int32 + 6 f32 vectors:
#: lo, hi, valid, count, arrival / sum, sumsq, val, tmin, tmax, min).
PACKED_STAGE2_SLOT_BYTES = 5 * 4 + 6 * 4

#: Bytes per drained-eviction row (10 × 4 B vectors in ``make_drain``).
DRAIN_ROW_BYTES = 10 * 4

#: ``sizeof(SketchArgs)`` in ``csrc/sketch_insert.cu`` (35 pointers, 6
#: ints), at the head of K1's shared memory.
SKETCH_ARGS_BYTES = k1_layout.ARGS_BYTES


class MemoryBudgetError(ValueError):
    """A sketch geometry exceeds the configured on-chip byte budget."""


# -- closed forms ------------------------------------------------------------

def accounting_bytes(p: SketchParams) -> int:
    """Paper accounting for one side: Stage-1 + Stage-2
    (= ``p.total_bytes()``, restated here as the model's ground truth)."""
    return p.d * p.m * STAGE1_ENTRY_BYTES + p.L * STAGE2_SLOT_BYTES


def ref_stage1_nbytes(p: SketchParams) -> int:
    """Summed ``nbytes`` of the numpy oracle's Stage-1 arrays
    (``FailSlowSketch.keys_lo/keys_hi/valid/freq``)."""
    return p.d * p.m * REF_STAGE1_ENTRY_BYTES


def packed_state_bytes(p: SketchParams) -> int:
    """Summed ``nbytes`` of ``ref.make_state(p)``: 4 Stage-1 tables,
    11 Stage-2 vectors, the scalar arrival counter."""
    return (p.d * p.m * PACKED_STAGE1_ENTRY_BYTES
            + p.L * PACKED_STAGE2_SLOT_BYTES + 4)


def drain_bytes(capacity: int) -> int:
    """Summed ``nbytes`` of ``ref.make_drain``: 10 per-row vectors
    (capacity floored at 1) plus the scalar ``d_n``."""
    return max(int(capacity), 1) * DRAIN_ROW_BYTES + 4


def hopper_smem_bytes(p: SketchParams) -> int:
    """Dynamic shared memory of one block of K1's shared-memory kernel,
    ``layout(d, m, L, false, 0).total`` in ``csrc/sketch_insert.cu``, as
    the wrapper's ``kernels/sketch_update/layout`` reckons it (the card
    holds the two equal)."""
    return k1_layout.bytes_placed(p.d, p.m, p.L)[0]


def side_budget_bytes(p: SketchParams, impl: str) -> int:
    """Persistent on-chip bytes one side of the recorder must hold:
    the paper accounting, or the packed state when that is larger
    (``impl="batched"`` keeps the packed layout resident)."""
    b = accounting_bytes(p)
    if impl == "batched":
        b = max(b, packed_state_bytes(p))
    return b


# -- reporting ---------------------------------------------------------------

def k1_path(p: SketchParams) -> str:
    """The kernel K1 runs for a geometry: ``"shared"`` (the whole sketch in
    one block's shared memory) or ``"device:<sections>"`` (the
    device-memory variant, with the sections ``layout.placement`` moves)."""
    place = k1_layout.placement(p.d, p.m, p.L)
    return "shared" if place is None \
        else "device:" + ",".join(k1_layout.moved(place))


def memory_report(params: SketchParams,
                  comm_params: SketchParams | None = None,
                  impl: str = "ref") -> dict:
    """Full per-chip footprint breakdown for one recorder geometry, with
    K1's shared memory per side beside ``max_smem_bytes`` and the path K1
    takes for it (``k1_path``).  Pure arithmetic."""
    comm_params = comm_params or params
    sides = {"comp": params, "comm": comm_params}
    rep: dict = {"impl": impl, "sides": {}, "max_smem_bytes": MAX_SMEM_BYTES}
    for name, p in sides.items():
        rep["sides"][name] = {
            "params": {"d": p.d, "m": p.m, "H": p.H, "L": p.L},
            "accounting_bytes": accounting_bytes(p),
            "stage1_bytes": p.stage1_bytes(),
            "stage2_bytes": p.stage2_bytes(),
            "ref_stage1_nbytes": ref_stage1_nbytes(p),
            "packed_state_bytes": packed_state_bytes(p),
            "hopper_smem_bytes": hopper_smem_bytes(p),
            "k1_path": k1_path(p),
            "budget_bytes": side_budget_bytes(p, impl),
        }
    rep["total_budget_bytes"] = sum(
        s["budget_bytes"] for s in rep["sides"].values())
    return rep


def _over_budget_message(rep: dict, budget_kb: float) -> str | None:
    total = rep["total_budget_bytes"]
    if total <= budget_kb * 1024:
        return None
    parts = ", ".join(
        f"{name}: d={s['params']['d']} m={s['params']['m']} "
        f"L={s['params']['L']} → {s['budget_bytes']} B"
        for name, s in rep["sides"].items())
    return (f"sketch geometry needs {total} B "
            f"({total / 1024:.1f} KiB) on-chip for impl="
            f"{rep['impl']!r}, over the {budget_kb:g} KiB budget "
            f"({parts}); shrink d/m/L or raise budget_kb")


def _over_smem_message(p: SketchParams) -> str | None:
    need = hopper_smem_bytes(p)
    if need <= MAX_SMEM_BYTES:
        return None
    return (f"d={p.d} m={p.m} L={p.L} needs {need} B of shared memory, "
            f"over the {MAX_SMEM_BYTES} B a block may have on Hopper: "
            f"impl='batched' runs it in K1's device-memory variant "
            f"({k1_path(p)}), slower than the shared-memory kernel a "
            f"shipped geometry must keep")


# -- construction-time guards ------------------------------------------------

def validate_params(params: SketchParams,
                    comm_params: SketchParams | None = None,
                    impl: str = "ref",
                    budget_kb: float | None = DEFAULT_BUDGET_KB) -> None:
    """Raise :class:`MemoryBudgetError` if the comp+comm sketch geometry
    cannot fit the per-chip ``budget_kb`` KiB budget under ``impl``.
    ``budget_kb=None`` disables the check."""
    if budget_kb is None:
        return
    rep = memory_report(params, comm_params, impl)
    msg = _over_budget_message(rep, budget_kb)
    if msg is not None:
        raise MemoryBudgetError(msg)


def validate_config(cfg) -> None:
    """Construction guard for ``SlothConfig``-shaped configs: check
    ``cfg.sketch`` (both sides) against ``cfg.budget_kb`` under
    ``cfg.recorder_impl`` (duck-typed, so ``PodTelemetryConfig``
    validates through the same door); ``budget_kb=None`` is exempt."""
    validate_params(cfg.sketch,
                    impl=getattr(cfg, "recorder_impl", "ref"),
                    budget_kb=getattr(cfg, "budget_kb", DEFAULT_BUDGET_KB))


# -- CLI pass ----------------------------------------------------------------

def geometry_findings(label: str, path: str, params: SketchParams,
                      impl: str, budget_kb: float) -> list[Finding]:
    """``over-budget`` if one geometry (both sides) does not fit
    ``budget_kb`` under ``impl``; ``smem-over-limit`` if, under
    ``impl="batched"``, one K1 block cannot hold it (it then runs K1's
    device-memory variant: a finding for a shipped geometry)."""
    out = []
    msg = _over_budget_message(memory_report(params, impl=impl), budget_kb)
    if msg is not None:
        out.append(Finding("memory", "over-budget", path, 0,
                           f"{label}: {msg}"))
    msg = _over_smem_message(params)
    if impl == "batched" and msg is not None:
        out.append(Finding("memory", "smem-over-limit", path, 0,
                           f"{label}: {msg}"))
    return out


def check(root=None, budget_kb: float | None = None) -> list[Finding]:
    """Static memory pass over the port's shipped geometries: the default
    ``SlothConfig`` (both impls) and the pod-telemetry config must fit
    their budgets, each geometry's K1 block must fit Hopper's shared
    memory (so that they keep K1's shared-memory kernel), and the closed
    forms must agree with the authoritative
    ``SketchParams`` byte methods (drift in either is a finding).
    ``root`` is accepted for pass-signature uniformity and unused."""
    findings: list[Finding] = []
    for p in (SketchParams(), SketchParams(d=3, m=7, H=2, L=5)):
        if accounting_bytes(p) != p.total_bytes():
            findings.append(Finding(
                "memory", "model-drift", "src/repro_torch/core/sketch.py",
                0, f"accounting_bytes({p}) = {accounting_bytes(p)} != "
                   f"SketchParams.total_bytes() = {p.total_bytes()}"))
        if p.stage2_bytes() != p.L * STAGE2_SLOT_BYTES:
            findings.append(Finding(
                "memory", "model-drift", "src/repro_torch/core/sketch.py",
                0, f"stage2_bytes({p}) is not L * STAGE2_SLOT_BYTES "
                   f"({p.stage2_bytes()} != {p.L * STAGE2_SLOT_BYTES})"))

    from ..core.sloth import SlothConfig
    from ..distributed.telemetry import PodTelemetryConfig
    cfg = SlothConfig()
    kb = budget_kb if budget_kb is not None else cfg.budget_kb
    for impl in ("ref", "batched"):
        findings += geometry_findings(
            f"default SlothConfig (impl={impl})",
            "src/repro_torch/core/sloth.py", cfg.sketch, impl, kb)
    pod = PodTelemetryConfig()
    pod_kb = budget_kb if budget_kb is not None \
        else getattr(pod, "budget_kb", DEFAULT_BUDGET_KB)
    # the pod runs either impl (``recorder_impl`` is a field of its own)
    for impl in ("ref", "batched"):
        findings += geometry_findings(
            f"PodTelemetryConfig (impl={impl})",
            "src/repro_torch/distributed/telemetry.py", pod.sketch, impl,
            pod_kb)
    return findings


def self_test() -> None:
    """Plant synthetic violations and assert the pass catches them."""
    assert check() == [], f"clean-tree memory findings: {check()}"
    # the closed form at the pod geometry, as csrc/sketch_insert.cu lays
    # it out (the card holds it to the library's own figure)
    pod = SketchParams(d=2, m=1024, H=4, L=2048)
    assert hopper_smem_bytes(pod) == 228_992, hopper_smem_bytes(pod)
    # a 64k-bucket Stage-1 blows the default budget
    big = SketchParams(m=65536)
    rep = memory_report(big, impl="batched")
    assert _over_budget_message(rep, DEFAULT_BUDGET_KB) is not None, \
        "over-budget geometry not flagged"
    try:
        validate_params(big, budget_kb=DEFAULT_BUDGET_KB)
    except MemoryBudgetError:
        pass
    else:
        raise AssertionError("validate_params accepted an over-budget "
                             "geometry")
    validate_params(big, budget_kb=None)
    planted = check(budget_kb=1.0)
    assert any(f.rule == "over-budget" for f in planted), \
        "check(budget_kb=1.0) produced no over-budget finding"
    # a Stage 2 of 4,096 rows fits the budget at m=64 but not one block
    wide = SketchParams(d=2, m=64, H=4, L=4096)
    planted = geometry_findings("planted", "<synthetic>", wide, "batched",
                                1e6)
    assert [f.rule for f in planted] == ["smem-over-limit"], \
        f"smem-over-limit geometry not flagged: {planted}"
    assert geometry_findings("planted", "<synthetic>", wide, "ref",
                             1e6) == [], "smem checked under impl='ref'"
