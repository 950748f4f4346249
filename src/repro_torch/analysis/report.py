"""Shared finding/report types for the static-analysis passes.

Every pass (:mod:`.memory_model`, :mod:`.kernel_audit`, :mod:`.lints`,
:mod:`.dataflow`) reduces to a list of :class:`Finding` records; the
CLI (``python -m repro_torch.analysis``) renders them for humans (one
``path:line: [pass/rule] message`` per finding) or as JSON, and exits
nonzero iff any finding survived the baseline.  Keeping the record
type dumb and shared means a new pass only has to produce findings —
reporting, JSON, fingerprints and the exit-code contract come for
free.

JSON schema (``--json``)::

    {
      "findings": [
        {
          "check":       "dataflow",          # pass name
          "rule":        "unordered-sum",     # stable kebab-case rule
          "path":        "src/repro_torch/...py",  # repo-relative path
          "line":        515,                 # 0 = no source anchor
          "symbol":      "Metrics.summary",   # enclosing def/class
                                              # qualname, "" if none
          "message":     "...",
          "fingerprint": "9f3a1c...",         # 16-hex stable id
          "baselined":   false                # carried by --baseline?
        }, ...
      ],
      "count":  3,        # total findings
      "new":    1,        # findings NOT in the baseline (drive exit 1)
      "ok":     false,    # new == 0
      "timings": {"memory": 0.01, ...}        # per-pass seconds
    }

Fingerprints hash ``check | rule | path | symbol`` (falling back to the
message when no enclosing symbol exists, e.g. whole-config memory
findings) — deliberately **not** the line number, so a finding survives
unrelated edits that shift lines, and a baseline entry keeps matching
until the offending symbol itself is touched.

Baseline files (``--baseline`` / ``--update-baseline``) are JSON::

    {"version": 1, "fingerprints": {"<fp>": "<path>: [pass/rule] ..."}}

The value is human context only; matching keys on fingerprints alone.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
from pathlib import Path

BASELINE_VERSION = 1

#: The committed repo baseline, resolved relative to this package so it
#: works regardless of the CLI's working directory.
SHIPPED_BASELINE = Path(__file__).resolve().parent / "baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis violation.

    ``check`` names the pass (``memory`` | ``kernels`` | ``lints`` |
    ``dataflow``), ``rule`` the specific invariant within it (stable
    kebab-case identifiers — CI logs and allowlists key on them),
    ``path``/``line`` the location (``line == 0`` for whole-config
    findings with no source anchor, e.g. a memory-budget overrun),
    ``symbol`` the innermost enclosing function/class qualname (used by
    :attr:`fingerprint` so findings survive line shifts).
    """
    check: str
    rule: str
    path: str
    line: int
    message: str
    symbol: str = ""

    @property
    def fingerprint(self) -> str:
        """Stable 16-hex id: hash of pass + rule + path + enclosing
        symbol (message as fallback anchor) — line-independent."""
        anchor = self.symbol or self.message
        raw = f"{self.check}|{self.rule}|{self.path}|{anchor}"
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.check}/{self.rule}] {self.message}"


def render_findings(findings: list[Finding]) -> str:
    """Human-readable report: one line per finding plus a tally."""
    lines = [f.render() for f in findings]
    n = len(findings)
    lines.append(f"{n} finding{'s' if n != 1 else ''}")
    return "\n".join(lines)


def findings_to_json(findings: list[Finding], *, extra=None,
                     baseline: dict | None = None) -> str:
    """Machine-readable report (the CLI's ``--json`` output); schema in
    the module docstring."""
    baseline = baseline or {}
    rows = []
    for f in findings:
        row = dataclasses.asdict(f)
        row["fingerprint"] = f.fingerprint
        row["baselined"] = f.fingerprint in baseline
        rows.append(row)
    new = sum(1 for r in rows if not r["baselined"])
    doc = {
        "findings": rows,
        "count": len(findings),
        "new": new,
        "ok": new == 0,
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# symbol attribution (drives fingerprint stability)
# ---------------------------------------------------------------------------

def symbol_table(tree: ast.Module) -> list[tuple[int, int, str]]:
    """(start, end, qualname) spans for every def/class, innermost
    last so :func:`symbol_at` can take the tightest match."""
    spans: list[tuple[int, int, str]] = []

    def visit(stmts, prefix):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                q = f"{prefix}.{stmt.name}" if prefix else stmt.name
                spans.append((stmt.lineno,
                              stmt.end_lineno or stmt.lineno, q))
                visit(stmt.body, q)

    visit(tree.body, "")
    return spans


def symbol_at(spans: list[tuple[int, int, str]], line: int) -> str:
    """Innermost enclosing def/class qualname for a line ('' at module
    level)."""
    best = ""
    best_width = None
    for start, end, name in spans:
        if start <= line <= end:
            width = end - start
            if best_width is None or width <= best_width:
                best, best_width = name, width
    return best


def attach_symbols(findings: list[Finding],
                   trees: dict[str, ast.Module]) -> list[Finding]:
    """Fill in ``symbol`` for findings whose path has a parsed tree
    (no-op for findings that already carry one or have no anchor)."""
    tables = {p: symbol_table(t) for p, t in trees.items()}
    out = []
    for f in findings:
        if not f.symbol and f.line and f.path in tables:
            f = dataclasses.replace(
                f, symbol=symbol_at(tables[f.path], f.line))
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# baseline workflow
# ---------------------------------------------------------------------------

def load_baseline(path=None) -> dict[str, str]:
    """fingerprint → context from a baseline file.  ``path=None`` loads
    the committed repo baseline; a missing file is an empty baseline."""
    p = Path(path) if path is not None else SHIPPED_BASELINE
    if not p.is_file():
        return {}
    doc = json.loads(p.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"unsupported baseline version {doc.get('version')!r} "
            f"in {p} (expected {BASELINE_VERSION})")
    return dict(doc.get("fingerprints", {}))


def write_baseline(path, findings: list[Finding]) -> None:
    """Accept the current finding set wholesale (``--update-baseline``)."""
    doc = {
        "version": BASELINE_VERSION,
        "fingerprints": {
            f.fingerprint: f"{f.path}: [{f.check}/{f.rule}] "
                           f"{f.symbol or f.message}"
            for f in sorted(findings,
                            key=lambda f: (f.path, f.line, f.rule))
        },
    }
    Path(path).write_text(json.dumps(doc, indent=2, sort_keys=True)
                          + "\n")


def new_findings(findings: list[Finding],
                 baseline: dict[str, str]) -> list[Finding]:
    """Findings whose fingerprint the baseline does not carry — the
    only ones that fail CI."""
    return [f for f in findings if f.fingerprint not in baseline]
