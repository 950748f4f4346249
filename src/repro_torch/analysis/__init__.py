"""Static verification of the port's deployment and determinism claims.

Four execution-free passes, one CLI (``python -m repro_torch.analysis
--check all [--json] [--baseline FILE]``; exit 0 iff no finding
outside the baseline):

* :mod:`.memory_model` — closed-form per-chip footprint of the recorder
  (Stage-1 tables, Stage-2 slots, drain buffer, packed layout, and K1's
  Hopper shared memory) checked against ``budget_kb`` and the 232,448 B
  a block may have; also the construction-time guards
  ``validate_config`` / ``validate_params`` wired into ``Sloth`` and
  ``StreamingRecorder``.
* :mod:`.kernel_audit` — lexical audit of every ``csrc/*.cu`` against
  the ``AUDIT`` contract of the ``kernels/*/ops.py`` that binds it: no
  float atomics, integer atomics only where declared, the ctypes
  bindings equal to the ``extern "C"`` signatures, K1's grid one block
  per sketch, a plain version beside every kernel.
* :mod:`.lints` — determinism lints over ``core/``, ``kernels/``,
  ``mitigate/``, ``distributed/``, ``launch/``, ``serving/`` and
  ``data/``: unseeded RNG (numpy's, the stdlib's and torch's global
  generators), wall-clock reads, unregistered detector classes,
  order-sensitive set iteration, and atomic scatters (float
  ``index_add_`` / ``scatter_add_`` and kin, also over ``models/`` and
  ``optim/``).
* :mod:`.dataflow` — interprocedural analysis over the call graph
  (:mod:`.callgraph`): seed-provenance taint for every RNG construction
  (``default_rng``, ``SeedSequence``, ``torch.Generator().manual_seed``),
  cross-module f32→bf16/f16 narrowing, and order-sensitive float
  reductions.

Each pass exposes ``check() -> list[Finding]`` and a ``self_test()``
that plants synthetic violations and asserts they are caught (run via
``python -m repro_torch.analysis --self-test``; also covered by
``tests/test_torch_analysis.py``).  Accepted pre-existing findings live
in the committed ``analysis/baseline.json`` keyed by line-independent
fingerprints (see :mod:`.report`); ``--baseline`` makes only
*new*-fingerprint findings fail, ``--update-baseline`` re-accepts the
current set.
"""

from .memory_model import (DEFAULT_BUDGET_KB,  # noqa: F401
                           MemoryBudgetError, memory_report,
                           validate_config, validate_params)
from .report import (Finding, findings_to_json,  # noqa: F401
                     load_baseline, new_findings, render_findings,
                     write_baseline)

__all__ = [
    "DEFAULT_BUDGET_KB", "MemoryBudgetError", "memory_report",
    "validate_config", "validate_params", "Finding",
    "findings_to_json", "render_findings", "load_baseline",
    "write_baseline", "new_findings", "run_checks", "run_self_tests",
    "CHECKS",
]

#: Check name → module path; ``--check all`` runs them in this order.
CHECKS = ("memory", "kernels", "lints", "dataflow")


def _pass_module(name: str):
    if name == "memory":
        from . import memory_model
        return memory_model
    if name == "kernels":
        from . import kernel_audit
        return kernel_audit
    if name == "lints":
        from . import lints
        return lints
    if name == "dataflow":
        from . import dataflow
        return dataflow
    raise ValueError(f"unknown check {name!r}; options: "
                     f"{CHECKS + ('all',)}")


def run_checks(which: str = "all", root=None,
               budget_kb: float | None = None,
               timings: dict | None = None) -> list[Finding]:
    """Run one pass (or all) and return the combined findings.  Pass a
    dict as ``timings`` to receive per-pass wall seconds (the CLI's
    ``--json`` cost tracking)."""
    import time
    names = CHECKS if which == "all" else (which,)
    findings: list[Finding] = []
    for name in names:
        mod = _pass_module(name)
        t0 = time.perf_counter()  # lint: allow-wallclock
        if name == "memory":
            findings.extend(mod.check(root, budget_kb=budget_kb))
        else:
            findings.extend(mod.check(root))
        if timings is not None:
            timings[name] = round(time.perf_counter() - t0, 4)  # lint: allow-wallclock
    return findings


def run_self_tests(which: str = "all") -> None:
    """Run each pass's planted-violation self-test (raises
    AssertionError on the first failure)."""
    names = CHECKS if which == "all" else (which,)
    for name in names:
        _pass_module(name).self_test()
