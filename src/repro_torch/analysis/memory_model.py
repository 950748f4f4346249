"""Closed-form on-chip footprint of the recorder, checked at construction.

The memory half of the reference's ``analysis/memory_model.py``: byte
counts derived from :class:`~repro_torch.core.sketch.SketchParams` alone
(nothing is allocated), and the guard ``validate_config`` that
``Sloth.__init__`` calls so an over-budget sketch geometry is rejected
before anything runs.

* **Paper accounting** (``accounting_bytes`` = ``SketchParams
  .total_bytes()``): Stage-1 ``d×m`` (lo, hi, freq) entries at 12 B plus
  ``L`` Stage-2 slots at ``STAGE2_SLOT_BYTES``.
* **Packed state** (``packed_state_bytes``): the tensors of
  ``kernels/sketch_update/ref.make_state`` — 4 int32 ``[d, m]`` tables,
  11 ``[L]`` vectors (5 int32, 6 f32) and the scalar arrival counter.
  The CUDA kernel holds exactly this in shared memory for the whole call.

The budget covers both sides (comp + comm): per side the accounting
bytes, or the packed bytes when ``impl="batched"`` and they are larger.
"""

from __future__ import annotations

from ..core.sketch import STAGE2_SLOT_BYTES, SketchParams

#: Default per-chip budget, KiB.
DEFAULT_BUDGET_KB = 256.0

#: Bytes per Stage-1 bucket in the paper accounting (lo + hi + freq).
STAGE1_ENTRY_BYTES = 4 + 4 + 4

#: Bytes per Stage-1 bucket in the packed state (4 int32 tables).
PACKED_STAGE1_ENTRY_BYTES = 4 * 4

#: Bytes per Stage-2 slot in the packed state (5 int32 + 6 f32).
PACKED_STAGE2_SLOT_BYTES = 5 * 4 + 6 * 4


class MemoryBudgetError(ValueError):
    """A sketch geometry exceeds the configured on-chip byte budget."""


def accounting_bytes(p: SketchParams) -> int:
    """Paper accounting for one side (= ``p.total_bytes()``)."""
    return p.d * p.m * STAGE1_ENTRY_BYTES + p.L * STAGE2_SLOT_BYTES


def packed_state_bytes(p: SketchParams) -> int:
    """Summed ``nbytes`` of ``ref.make_state(p)``."""
    return (p.d * p.m * PACKED_STAGE1_ENTRY_BYTES
            + p.L * PACKED_STAGE2_SLOT_BYTES + 4)


def side_budget_bytes(p: SketchParams, impl: str) -> int:
    """Persistent on-chip bytes one side of the recorder must hold."""
    b = accounting_bytes(p)
    if impl == "batched":
        b = max(b, packed_state_bytes(p))
    return b


def validate_params(params: SketchParams,
                    comm_params: SketchParams | None = None,
                    impl: str = "ref",
                    budget_kb: float | None = DEFAULT_BUDGET_KB) -> None:
    """Raise :class:`MemoryBudgetError` if the comp + comm geometry does
    not fit ``budget_kb`` KiB under ``impl``; ``None`` disables the
    check."""
    if budget_kb is None:
        return
    sides = {"comp": params, "comm": comm_params or params}
    need = {name: side_budget_bytes(p, impl) for name, p in sides.items()}
    total = sum(need.values())
    if total <= budget_kb * 1024:
        return
    parts = ", ".join(
        f"{name}: d={p.d} m={p.m} L={p.L} → {need[name]} B"
        for name, p in sides.items())
    raise MemoryBudgetError(
        f"sketch geometry needs {total} B ({total / 1024:.1f} KiB) "
        f"on-chip for impl={impl!r}, over the {budget_kb:g} KiB budget "
        f"({parts}); shrink d/m/L or raise budget_kb")


def validate_config(cfg) -> None:
    """Construction guard for ``SlothConfig``-shaped configs (duck-typed
    on ``sketch``, ``recorder_impl`` and ``budget_kb``)."""
    validate_params(cfg.sketch,
                    impl=getattr(cfg, "recorder_impl", "ref"),
                    budget_kb=getattr(cfg, "budget_kb", DEFAULT_BUDGET_KB))
