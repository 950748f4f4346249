"""CLI for the static-analysis passes.

Usage::

    python -m repro_torch.analysis --check all             # for humans
    python -m repro_torch.analysis --check memory --json   # for machines
    python -m repro_torch.analysis --self-test             # planted
    python -m repro_torch.analysis --check all \\
        --baseline analysis/baseline.json                  # the gate
    python -m repro_torch.analysis --check all \\
        --update-baseline analysis/baseline.json           # accept all

Exit status: 0 iff the selected checks produced no finding outside the
baseline (no ``--baseline`` means an empty baseline: every finding
fails) — and, with ``--self-test``, every planted synthetic violation
was caught.  ``chip_smoke.py``'s ``analysis`` phase runs ``--check all
--baseline analysis/baseline.json`` and ``--self-test`` on the card's
machine, and ``tests/test_torch_analysis.py`` runs them here.

``--baseline`` accepts either a real path or a path relative to the
``repro_torch`` package (so ``analysis/baseline.json`` works from the
repo root without knowing the src layout).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import (CHECKS, findings_to_json, load_baseline, new_findings,
               render_findings, run_checks, run_self_tests,
               write_baseline)


def _resolve_baseline_path(spec: str) -> Path:
    """Literal path if it exists, else fall back to the package tree
    (``analysis/baseline.json`` →
    ``.../src/repro_torch/analysis/baseline.json``)."""
    p = Path(spec)
    if p.exists():
        return p
    fallback = Path(__file__).resolve().parents[1] / spec
    return fallback if fallback.exists() else p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verification of the port: memory budget and "
                    "K1's shared memory, CUDA kernel contracts, "
                    "determinism invariants, interprocedural determinism "
                    "dataflow.")
    ap.add_argument("--check", default="all",
                    choices=("all",) + CHECKS,
                    help="which pass to run (default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON (includes fingerprints "
                         "and per-pass timings)")
    ap.add_argument("--budget-kb", type=float, default=None,
                    help="override the memory pass's per-chip budget "
                         "(KiB; default: each config's own budget_kb); "
                         "only valid with --check memory or all")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help="accepted-findings file: only findings whose "
                         "fingerprint is absent from FILE fail")
    ap.add_argument("--update-baseline", default=None, metavar="FILE",
                    help="write the current finding set to FILE as the "
                         "new baseline and exit 0")
    ap.add_argument("--self-test", action="store_true",
                    help="run each pass's planted-violation self-test "
                         "instead of checking the tree")
    args = ap.parse_args(argv)

    if args.budget_kb is not None and args.check not in ("memory",
                                                         "all"):
        ap.error(f"--budget-kb only applies to the memory pass; "
                 f"--check {args.check} would silently ignore it")

    if args.self_test:
        try:
            run_self_tests(args.check)
        except AssertionError as e:
            print(f"self-test FAILED: {e}", file=sys.stderr)
            return 1
        print(f"self-test OK ({args.check})")
        return 0

    timings: dict[str, float] = {}
    findings = run_checks(args.check, budget_kb=args.budget_kb,
                          timings=timings)

    if args.update_baseline:
        write_baseline(args.update_baseline, findings)
        print(f"baseline written: {len(findings)} finding"
              f"{'s' if len(findings) != 1 else ''} -> "
              f"{args.update_baseline}")
        return 0

    baseline = {}
    if args.baseline:
        baseline = load_baseline(_resolve_baseline_path(args.baseline))
    new = new_findings(findings, baseline)

    if args.json:
        print(findings_to_json(findings, baseline=baseline,
                               extra={"check": args.check,
                                      "timings": timings}))
    else:
        print(render_findings(findings))
        if baseline:
            print(f"{len(findings) - len(new)} baselined, "
                  f"{len(new)} new")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
