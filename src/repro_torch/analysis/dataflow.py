"""Interprocedural determinism dataflow over the repro_torch package.

The lints (:mod:`.lints`) are file-local pattern matchers; this pass sees
*across* function and module boundaries via the AST call graph
(:mod:`.callgraph`).  Three rule families, all execution-free:

* **seed provenance** — every ``np.random.default_rng(...)`` /
  ``np.random.SeedSequence(...)`` / ``torch.Generator(...).manual_seed(...)``
  argument (also ``g.manual_seed(...)`` on a local ``g = torch
  .Generator(...)``) must be statically traceable to a scenario seed, a
  config field, or the CLI ``--seed`` (identifiers containing ``seed``,
  ``key`` or ``rng``; composites count as seeded if any component is).  A
  bare literal (``manual_seed(0)``) in library code is a ``literal-seed``
  finding — literals of convenience belong in ``examples/`` (which this
  pass does not scan) or behind a reviewed marker/baseline entry.  An
  argument whose provenance cannot be traced — including a function
  parameter whose in-package call sites all pass untraceable values —
  is an ``unseeded-provenance`` finding: one unseeded draw silently
  corrupts resumed campaign shards.
* **dtype narrowing** — a literal f32→bf16/f16 narrowing
  (``.to(torch.bfloat16)`` / ``.to(torch.float16)``, ``.bfloat16()``,
  ``.half()``, ``dtype=torch.bfloat16`` kwargs, numpy's ``astype``)
  that crosses a module boundary into or out of the parity-critical
  dirs (``core/``, ``kernels/``, ``mitigate/``, ``distributed/``) is a
  ``cross-module-narrowing`` finding — a value narrowed in one module
  and consumed in another is invisible file by file, and ref↔batched
  verdict parity is asserted against an f32 oracle.  Dynamic dtypes
  (``.to(dtype)`` with a parameter) are never flagged: dtype *policy*
  lives in ``models/``/``launch/`` and is not this rule's business.
* **reduction order** — order-sensitive float reductions on
  campaign-visible paths: ``sum()`` over ``dict.values()`` or a set
  (``unordered-sum`` — wrap in ``sorted()`` or use the order-free exact
  ``math.fsum``), and ``+=``-style accumulation onto a float inside a
  ``for`` loop over ``.values()``/``.items()``/a set
  (``unsorted-accumulation``).  This is the exact bug class that breaks
  serial == thread == process bit-identity and will break shard-resume
  merges.  Integer accumulators are exact/commutative and not flagged.

Any line can carry ``# lint: allow-<rule>`` to record a reviewed
exception; findings accepted wholesale live in the committed
``analysis/baseline.json``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .callgraph import (CallGraph, FunctionInfo, ModuleInfo,
                        argument_for)
from .report import Finding, attach_symbols

#: Package directories the pass does NOT scan: the analyzer itself (its
#: sources embed planted violations) — everything else in
#: src/repro_torch/ is a campaign-visible path.
EXCLUDE_DIRS = ("analysis",)

#: Caller directories where a cross-module literal narrowing breaks the
#: f32 oracle parity contract.
PARITY_DIRS = ("core", "kernels", "mitigate", "distributed")

#: Fully-dotted RNG constructors whose argument must carry seed
#: provenance.
RNG_CTORS = {
    "numpy.random.default_rng",
    "numpy.random.SeedSequence",
    "torch.Generator.manual_seed",
}

_SEEDISH = re.compile(r"seed|key|rng", re.IGNORECASE)
_NARROW_DTYPES = {"bfloat16", "float16", "half"}
_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)")

_MAX_TRACE_DEPTH = 6


# ---------------------------------------------------------------------------
# module discovery
# ---------------------------------------------------------------------------

def _package_root(root) -> Path:
    if root is None:
        return Path(__file__).resolve().parents[1]
    root = Path(root)
    for sub in ("src/repro_torch", "repro_torch"):
        if (root / sub).is_dir():
            return root / sub
    return root


def _rel(path: Path) -> str:
    s = str(path)
    i = s.find("src/repro_torch/")
    return s[i:] if i >= 0 else s


def modules_from_disk(root=None) -> dict[str, tuple[str, str]]:
    """Dotted module name → (source, display path) for every scanned
    module under the package root."""
    pkg = _package_root(root)
    out: dict[str, tuple[str, str]] = {}
    for f in sorted(pkg.rglob("*.py")):
        rel = f.relative_to(pkg)
        if rel.parts and rel.parts[0] in EXCLUDE_DIRS:
            continue
        if "__pycache__" in rel.parts:
            continue
        dotted = "repro_torch." + ".".join(rel.with_suffix("").parts)
        if dotted.endswith(".__init__"):
            dotted = dotted[:-len(".__init__")]
        out[dotted] = (f.read_text(), _rel(f))
    return out


def _scope_dir(path: str) -> str:
    """First package directory of a display path
    (``src/repro_torch/core/x.py`` → ``core``; top-level modules →
    ``""``)."""
    parts = Path(path).parts
    for i, p in enumerate(parts):
        if p == "repro_torch" and i + 2 < len(parts):
            return parts[i + 1]
    return ""


def _allowed_lines(source: str) -> dict[int, set[str]]:
    allowed: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _ALLOW_RE.finditer(line):
            allowed.setdefault(i, set()).add(m.group(1))
    return allowed


# ---------------------------------------------------------------------------
# rule family 1: seed provenance
# ---------------------------------------------------------------------------

SEEDED, LITERAL, UNKNOWN = "seeded", "literal", "unknown"


def _seedish(name: str) -> bool:
    return bool(_SEEDISH.search(name))


class _SeedTaint:
    """Classifies seed-argument expressions as SEEDED / LITERAL /
    UNKNOWN, tracing function parameters interprocedurally through the
    call graph (bounded depth, cycle-safe)."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self._param_cache: dict[tuple[str, str], str] = {}

    def classify(self, expr: ast.expr, func: FunctionInfo | None,
                 depth: int = 0) -> str:
        if depth > _MAX_TRACE_DEPTH:
            return UNKNOWN
        if isinstance(expr, ast.Constant):
            return LITERAL
        if isinstance(expr, ast.Name):
            return self._classify_name(expr.id, func, depth)
        if isinstance(expr, ast.Attribute):
            parts = []
            node = expr
            while isinstance(node, ast.Attribute):
                parts.append(node.attr)
                node = node.value
            if isinstance(node, ast.Name):
                parts.append(node.id)
            if any(_seedish(p) for p in parts):
                return SEEDED
            return UNKNOWN
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            return self._combine(
                [self.classify(e, func, depth) for e in expr.elts])
        if isinstance(expr, ast.BinOp):
            return self._combine([self.classify(expr.left, func, depth),
                                  self.classify(expr.right, func,
                                                depth)])
        if isinstance(expr, ast.UnaryOp):
            return self.classify(expr.operand, func, depth)
        if isinstance(expr, ast.Subscript):
            return self.classify(expr.value, func, depth)
        if isinstance(expr, ast.Call):
            name = expr.func.attr if isinstance(expr.func,
                                                ast.Attribute) else (
                expr.func.id if isinstance(expr.func, ast.Name) else "")
            if _seedish(name):
                return SEEDED
            args = list(expr.args) + [kw.value for kw in expr.keywords]
            if not args:
                return UNKNOWN
            return self._combine(
                [self.classify(a, func, depth) for a in args])
        if isinstance(expr, (ast.GeneratorExp, ast.ListComp)):
            return self.classify(expr.elt, func, depth)
        if isinstance(expr, ast.IfExp):
            return self._combine([self.classify(expr.body, func, depth),
                                  self.classify(expr.orelse, func,
                                                depth)])
        return UNKNOWN

    @staticmethod
    def _combine(kinds: list[str]) -> str:
        """Entropy keying: one seeded component seeds the whole
        composite (the rest are salts); all-literal stays literal;
        anything else is untraceable."""
        if SEEDED in kinds:
            return SEEDED
        if kinds and all(k == LITERAL for k in kinds):
            return LITERAL
        return UNKNOWN

    def _classify_name(self, name: str, func: FunctionInfo | None,
                       depth: int) -> str:
        if _seedish(name):
            return SEEDED
        if func is not None:
            if name in func.params:
                return self._classify_param(func, name, depth)
            local = self._local_assignment(func, name)
            if local is not None:
                return self.classify(local, func, depth + 1)
        return UNKNOWN

    @staticmethod
    def _local_assignment(func: FunctionInfo,
                          name: str) -> ast.expr | None:
        found = None
        for node in ast.walk(func.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name:
                found = node.value
        return found

    def _classify_param(self, func: FunctionInfo, param: str,
                        depth: int) -> str:
        key = (func.qualname, param)
        if key in self._param_cache:
            return self._param_cache[key]
        self._param_cache[key] = UNKNOWN    # cycle guard
        default = self._param_default(func, param)
        sites = self.graph.sites_for(func.qualname)
        kinds: list[str] = []
        for site in sites:
            arg = argument_for(site.call, func, param)
            if arg is None:
                if default is not None:
                    kinds.append(self.classify(default, site.caller,
                                               depth + 1))
                else:
                    kinds.append(UNKNOWN)
            else:
                kinds.append(self.classify(arg, site.caller, depth + 1))
        if not kinds:
            # no visible in-package call site: an exported entry point.
            # The parameter's own name is the only contract we can hold
            # it to, and non-seedish names were already screened above.
            result = UNKNOWN
        elif all(k == SEEDED for k in kinds):
            result = SEEDED
        elif LITERAL in kinds:
            result = LITERAL
        else:
            result = UNKNOWN
        self._param_cache[key] = result
        return result

    @staticmethod
    def _param_default(func: FunctionInfo,
                       param: str) -> ast.expr | None:
        args = func.node.args
        names = [a.arg for a in args.posonlyargs + args.args]
        defaults = list(args.defaults)
        if defaults:
            for name, d in zip(names[-len(defaults):], defaults):
                if name == param:
                    return d
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if a.arg == param and d is not None:
                return d
        return None


def _rule_seed_provenance(graph: CallGraph) -> list[Finding]:
    taint = _SeedTaint(graph)
    findings: list[Finding] = []
    for mod in graph.modules.values():
        allowed = _allowed_lines(mod.source)
        for func, call in _calls_with_context(graph, mod):
            target = _rng_target(graph, mod, func, call)
            if target not in RNG_CTORS:
                continue
            args = list(call.args) + [kw.value for kw in call.keywords]
            if not args:
                continue    # zero-arg default_rng() is the lints' rule
            kind = taint._combine(
                [taint.classify(a, func) for a in args])
            short = target.removeprefix("numpy.random.") \
                .removeprefix("torch.")
            if kind == LITERAL \
                    and "literal-seed" not in allowed.get(call.lineno,
                                                          ()):
                findings.append(Finding(
                    "dataflow", "literal-seed", mod.path, call.lineno,
                    f"{short}() seeded with a bare literal — literals "
                    f"of convenience belong in examples/; library code "
                    f"derives from a scenario seed, config field or "
                    f"CLI --seed"))
            elif kind == UNKNOWN \
                    and "unseeded-provenance" not in allowed.get(
                        call.lineno, ()):
                findings.append(Finding(
                    "dataflow", "unseeded-provenance", mod.path,
                    call.lineno,
                    f"{short}() argument is not statically traceable "
                    f"to a scenario seed, config field or CLI --seed "
                    f"(checked every in-package call site) — one "
                    f"unseeded draw breaks campaign bit-identity and "
                    f"shard resume"))
    return findings


def _rng_target(graph: CallGraph, mod: ModuleInfo,
                func: FunctionInfo | None, call: ast.Call) -> str | None:
    """Fully-dotted RNG constructor a call stands for: the call's own
    target, or ``torch.Generator.manual_seed`` for ``.manual_seed(x)`` on
    a ``torch.Generator(...)`` made in place or bound to a local name."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "manual_seed"):
        return graph.full_target(mod, call)
    made = f.value
    if isinstance(made, ast.Name) and func is not None:
        made = _SeedTaint._local_assignment(func, made.id)
    if isinstance(made, ast.Call) \
            and graph.full_target(mod, made) == "torch.Generator":
        return "torch.Generator.manual_seed"
    return graph.full_target(mod, call)


def _calls_with_context(graph: CallGraph, mod: ModuleInfo):
    """(enclosing FunctionInfo | None, ast.Call) pairs, mirroring the
    call-site attribution the graph uses."""
    out: list[tuple[FunctionInfo | None, ast.Call]] = []

    def handle(stmts, caller, cls):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{mod.name}." + \
                    (f"{cls}.{stmt.name}" if cls else stmt.name)
                handle(stmt.body, graph.functions.get(q, caller), cls)
            elif isinstance(stmt, ast.ClassDef):
                handle(stmt.body, caller, stmt.name)
            else:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        out.append((caller, node))

    handle(mod.tree.body, None, None)
    return out


# ---------------------------------------------------------------------------
# rule family 2: cross-module dtype narrowing
# ---------------------------------------------------------------------------

def _narrows(node: ast.AST) -> int | None:
    """Line of a literal f32→bf16/f16 narrowing anywhere inside
    ``node`` (``x.to(torch.bfloat16)`` with the type in any position,
    ``x.bfloat16()`` / ``x.half()``, ``dtype=torch.float16`` kwargs,
    numpy's ``astype("float16")``)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Attribute) and f.attr == "astype" \
                    and sub.args and _is_narrow_dtype(sub.args[0]):
                return sub.lineno
            if isinstance(f, ast.Attribute) and f.attr == "to" \
                    and any(_is_narrow_dtype(a) for a in sub.args):
                return sub.lineno
            if isinstance(f, ast.Attribute) \
                    and f.attr in _NARROW_DTYPES:
                return sub.lineno
            for kw in sub.keywords:
                if kw.arg == "dtype" and _is_narrow_dtype(kw.value):
                    return sub.lineno
    return None


def _is_narrow_dtype(node: ast.expr) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in _NARROW_DTYPES:
        return True
    return isinstance(node, ast.Constant) \
        and node.value in _NARROW_DTYPES


def _narrow_returning(func: FunctionInfo) -> bool:
    """Does this function return a literally-narrowed value (directly
    or via a single-assignment local)?"""
    narrowed_names: set[str] = set()
    for node in ast.walk(func.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _narrows(node.value) is not None:
            narrowed_names.add(node.targets[0].id)
    for node in ast.walk(func.node):
        if isinstance(node, ast.Return) and node.value is not None:
            if _narrows(node.value) is not None:
                return True
            if isinstance(node.value, ast.Name) \
                    and node.value.id in narrowed_names:
                return True
    return False


def _rule_cross_module_narrowing(graph: CallGraph) -> list[Finding]:
    findings: list[Finding] = []
    narrow_fns = {q for q, fi in graph.functions.items()
                  if _narrow_returning(fi)}
    for mod in graph.modules.values():
        if _scope_dir(mod.path) not in PARITY_DIRS:
            continue
        allowed = _allowed_lines(mod.source)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = graph.resolve_call(mod, node)
            if callee is None:
                continue
            callee_fi = graph.functions[callee]
            if callee_fi.module == mod.name:
                continue    # file-local narrowing is the kernel audit
            if "cross-module-narrowing" in allowed.get(node.lineno, ()):
                continue
            if callee in narrow_fns:
                findings.append(Finding(
                    "dataflow", "cross-module-narrowing", mod.path,
                    node.lineno,
                    f"call to {callee}() returns a value literally "
                    f"narrowed to bf16/f16 in another module — the "
                    f"f32 oracle parity contract breaks across this "
                    f"boundary"))
            arg_line = next(
                (ln for ln in
                 [_narrows(a) for a in list(node.args)
                  + [kw.value for kw in node.keywords]]
                 if ln is not None), None)
            if arg_line is not None:
                findings.append(Finding(
                    "dataflow", "cross-module-narrowing", mod.path,
                    arg_line,
                    f"argument to {callee}() is literally narrowed to "
                    f"bf16/f16 before crossing the module boundary — "
                    f"a parity hazard the file-local kernel audit "
                    f"cannot see"))
    return findings


# ---------------------------------------------------------------------------
# rule family 3: reduction order
# ---------------------------------------------------------------------------

def _is_values_call(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr in ("values", "items") and not node.args


def _is_set_literal(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Name) \
        and node.func.id in ("set", "frozenset")


def _is_sorted_wrapped(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Name) \
        and node.func.id in ("sorted", "min", "max", "len")


def _unordered_iter(node: ast.expr) -> str | None:
    """Human tag if ``node`` iterates in container-dependent order."""
    if _is_sorted_wrapped(node):
        return None
    if _is_values_call(node):
        return f"dict .{node.func.attr}()"
    if _is_set_literal(node):
        return "a set"
    return None


def _sum_source(call: ast.Call) -> ast.expr | None:
    """The iterable a builtin ``sum()`` call reduces over, unwrapping
    one generator/comprehension level."""
    if not (isinstance(call.func, ast.Name)
            and call.func.id == "sum" and call.args):
        return None
    arg = call.args[0]
    if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
        return arg.generators[0].iter if arg.generators else None
    return arg


def _float_accumulators(body: list[ast.stmt]) -> set[str]:
    """Names assigned a float literal in this statement list — the
    accumulator shapes whose in-loop ``+=`` is order-sensitive."""
    out: set[str] = set()
    for stmt in body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, float):
            out.add(stmt.targets[0].id)
    return out


def _rule_reduction_order(graph: CallGraph) -> list[Finding]:
    findings: list[Finding] = []
    for mod in graph.modules.values():
        allowed = _allowed_lines(mod.source)

        def scope_bodies():
            yield mod.tree.body
            for n in ast.walk(mod.tree):
                if isinstance(n, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                    yield n.body

        for body in scope_bodies():
            accs = _float_accumulators(body)
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        src = _sum_source(node)
                        tag = _unordered_iter(src) \
                            if src is not None else None
                        if tag and "unordered-sum" not in \
                                allowed.get(node.lineno, ()):
                            findings.append(Finding(
                                "dataflow", "unordered-sum", mod.path,
                                node.lineno,
                                f"sum() over {tag} reduces floats in "
                                f"container order — shard merges "
                                f"reorder it; wrap in sorted() or use "
                                f"math.fsum"))
                    if isinstance(node, ast.For):
                        tag = _unordered_iter(node.iter)
                        if not tag:
                            continue
                        for sub in ast.walk(node):
                            if (isinstance(sub, ast.AugAssign)
                                    and isinstance(sub.op,
                                                   (ast.Add, ast.Sub,
                                                    ast.Mult))
                                    and isinstance(sub.target,
                                                   ast.Name)
                                    and sub.target.id in accs
                                    and "unsorted-accumulation" not in
                                    allowed.get(sub.lineno, ())):
                                findings.append(Finding(
                                    "dataflow", "unsorted-accumulation",
                                    mod.path, sub.lineno,
                                    f"float accumulation over {tag} "
                                    f"depends on iteration order — "
                                    f"sort the iterable or reduce with "
                                    f"math.fsum so shard-resumed "
                                    f"merges stay bit-identical"))
    return _dedupe(findings)


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        k = (f.rule, f.path, f.line, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def analyze_modules(modules: dict[str, tuple[str, str]]) \
        -> list[Finding]:
    """Run all dataflow rules over a module set (the unit the
    self-test drives with synthetic multi-module packages)."""
    graph = CallGraph.build(modules)
    findings = (_rule_seed_provenance(graph)
                + _rule_cross_module_narrowing(graph)
                + _rule_reduction_order(graph))
    for name, (source, path) in sorted(modules.items()):
        if name not in graph.modules:       # the graph skips what fails
            try:
                ast.parse(source)
            except SyntaxError as e:
                findings.append(Finding(
                    "dataflow", "syntax-error", path, e.lineno or 0,
                    f"unparsable module: {e.msg}"))
    by_path: dict[str, ast.Module] = {
        m.path: m.tree for m in graph.modules.values()}
    return _dedupe(attach_symbols(findings, by_path))


def check(root=None) -> list[Finding]:
    """Dataflow-check the port (everything under ``src/repro_torch/``
    except the analyzer itself)."""
    return analyze_modules(modules_from_disk(root))


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

#: Synthetic multi-module package planting one violation per rule (the
#: torch forms among them); the self-test asserts each is caught and the
#: benign shapes stay clean.
_SYNTHETIC_BAD = {
    "syn.core.rngsrc": (
        "import numpy as np\n"
        "import torch\n"
        "def make_stream(x):\n"
        "    return np.random.default_rng(x)\n"        # traced to caller
        "def shape_gen(dev):\n"
        "    return torch.Generator(device=dev).manual_seed(0)\n"  # literal
        "def local_gen():\n"
        "    g = torch.Generator()\n"
        "    g.manual_seed(7)\n"                      # literal-seed
        "    return g\n",
        "src/repro_torch/core/rngsrc.py"),
    "syn.core.rnguse": (
        "import torch\n"
        "from .rngsrc import make_stream\n"
        "def draw(values):\n"
        "    n = len(values)\n"
        "    g = make_stream(n)\n"                     # unseeded-provenance
        "    return g.normal()\n"
        "def torch_draw(values):\n"
        "    return torch.Generator().manual_seed(len(values))\n",
        "src/repro_torch/core/rnguse.py"),
    "syn.core.packer": (
        "import torch\n"
        "def pack(x):\n"
        "    y = x.to(torch.bfloat16)\n"
        "    return y\n"
        "def halve(x):\n"
        "    return x.half()\n"
        "def brain(x):\n"
        "    return x.bfloat16()\n"
        "def zeros(n):\n"
        "    return torch.zeros(n, dtype=torch.float16)\n"
        "def ident(x):\n"
        "    return x\n",
        "src/repro_torch/core/packer.py"),
    "syn.core.consumer": (
        "import torch\n"
        "from .packer import brain, halve, ident, pack, zeros\n"
        "def fold(x):\n"
        "    a = pack(x) + 1\n"                       # cross-module-narrowing
        "    b = halve(x)\n"                          # cross-module-narrowing
        "    c = brain(x)\n"                          # cross-module-narrowing
        "    d = zeros(4)\n"                          # cross-module-narrowing
        "    e = ident(x.to('cuda', torch.float16))\n"  # narrowed argument
        "    return a, b, c, d, e\n",
        "src/repro_torch/core/consumer.py"),
    "syn.core.merge": (
        "def total(parts):\n"
        "    return sum(parts.values())\n"             # unordered-sum
        "def accumulate(parts):\n"
        "    acc = 0.0\n"
        "    for v in parts.values():\n"
        "        acc += v\n"                           # unsorted-accumulation
        "    return acc\n",
        "src/repro_torch/core/merge.py"),
}

#: Every shape the rules must NOT flag.
_SYNTHETIC_CLEAN = {
    "syn.core.fine": (
        "import numpy as np\n"
        "import torch\n"
        "import math\n"
        "from .finelib import seeded_stream\n"
        "def scenario_rng(grid, s):\n"
        "    return np.random.default_rng(\n"
        "        [grid.campaign_seed, s.mesh_w, s.rep])\n"
        "def cli_rng(args):\n"
        "    return np.random.default_rng(args.seed)\n"
        "def model_gen(seed, dev):\n"
        "    return torch.Generator(device=dev).manual_seed(seed)\n"
        "def local_gen(cfg):\n"
        "    g = torch.Generator()\n"
        "    g.manual_seed(cfg.seed)\n"
        "    return g\n"
        "def threaded(cfg):\n"
        "    return seeded_stream(cfg.seed)\n"
        "def widen(x):\n"
        "    return x.to(torch.float32)\n"
        "def dynamic(x, dtype):\n"
        "    return x.to(dtype)\n"
        "def moved(x, dev):\n"
        "    return x.to(dev)\n"
        "def total(parts):\n"
        "    return sum(sorted(parts.values()))\n"
        "def exact(parts):\n"
        "    return math.fsum(parts.values())\n"
        "def count(parts):\n"
        "    n = 0\n"
        "    for v in parts.values():\n"
        "        n += 1\n"
        "    return n\n",
        "src/repro_torch/core/fine.py"),
    "syn.core.finelib": (
        "import numpy as np\n"
        "def seeded_stream(x):\n"
        "    return np.random.default_rng(x)\n",       # all callers seeded
        "src/repro_torch/core/finelib.py"),
    "syn.core.usefine": (
        "from .fine import dynamic, moved, widen\n"
        "def use(x, dev):\n"
        "    return widen(x), dynamic(x, x.dtype), moved(x, dev)\n",
        "src/repro_torch/core/usefine.py"),
}


def self_test() -> None:
    """Plant one synthetic violation per rule and assert each is
    caught, the benign shapes stay clean, and every real-tree finding
    is carried by the shipped baseline (no un-reviewed drift)."""
    bad = analyze_modules(dict(_SYNTHETIC_BAD))
    got = {f.rule for f in bad}
    expect = {"literal-seed", "unseeded-provenance",
              "cross-module-narrowing", "unordered-sum",
              "unsorted-accumulation"}
    missing = expect - got
    assert not missing, \
        f"dataflow rules not triggered by synthetic: {sorted(missing)}"
    prov = [f for f in bad if f.rule == "unseeded-provenance"]
    assert any("rngsrc" in f.path for f in prov), \
        "interprocedural trace must land the finding at the rng " \
        "constructor, not (only) the call site"
    assert any("rnguse" in f.path for f in prov), \
        "an untraceable torch.Generator seed was not flagged"
    literal = {f.symbol for f in bad if f.rule == "literal-seed"}
    assert literal == {"shape_gen", "local_gen"}, \
        f"both torch.Generator literal seeds must be caught ({literal})"
    narrowed = {f.line for f in bad if f.rule == "cross-module-narrowing"}
    assert narrowed == {4, 5, 6, 7, 8}, \
        f"each torch narrowing form must be caught (lines {narrowed})"
    broken = analyze_modules({"syn.core.bad": (
        "def f(:\n", "src/repro_torch/core/bad.py")})
    assert [f.rule for f in broken] == ["syntax-error"], \
        "an unparsable module was not reported"
    clean = analyze_modules(dict(_SYNTHETIC_CLEAN))
    assert clean == [], \
        "false positives on benign shapes:\n" + "\n".join(
            f.render() for f in clean)

    from .report import load_baseline
    baseline = load_baseline()
    real = check()
    new = [f for f in real if f.fingerprint not in baseline]
    assert new == [], \
        "real-tree dataflow findings missing from analysis/" \
        "baseline.json (fix, allowlist, or --update-baseline):\n" \
        + "\n".join(f"{f.render()}  fp={f.fingerprint}" for f in new)
