"""AST lints encoding the ROADMAP's standing determinism invariants,
over the ``repro_torch`` package.

The campaign's bit-identity contract (serial == thread == process, and
seed → scenario derivation) survives only if nothing inside the core
pipeline consults ambient nondeterminism.  These lints make the
contract machine-checked over ``core/``, ``kernels/``, ``mitigate/``,
``distributed/``, ``launch/``, ``serving/`` and ``data/`` (the
reference's scopes; ``atomic-scatter`` also over ``models/`` and
``optim/``, whose tensors live on the card):

* ``unseeded-rng`` — module-level ``np.random.*`` calls (the legacy
  global generator), zero-argument ``np.random.default_rng()``, and
  stdlib ``random.*`` calls; and torch's global generator:
  ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed(_all)``,
  the samplers ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``normal`` / ``bernoulli`` / ``multinomial`` / ``poisson`` and the
  in-place ``x.uniform_()`` / ``normal_()`` / ... called without
  ``generator=``, every ``*_like`` sampler (they take no generator), and
  a ``torch.Generator(...)`` that is never given a ``manual_seed``.  All
  randomness must flow from an explicitly seeded ``Generator``.
* ``wallclock`` — ``time.time/perf_counter/monotonic/process_time``
  and ``datetime.now/utcnow``: wall-clock reads inside the pipeline
  make outputs run-dependent.  Telemetry that *reports* wall time (and
  never feeds results) is allowlisted with a ``# lint: allow-wallclock``
  marker on the offending line — ``campaign._wall_clock`` is the one
  blessed reader.
* ``unregistered-detector`` — a public detector-shaped class (a ``name``
  string attribute plus both ``prepare`` and ``analyse`` methods) or
  mitigation-policy-shaped class (``name`` plus both ``plan`` and
  ``apply``) that never reaches its registry
  (``register_detector`` / ``_register_builtin`` for detectors,
  ``register_policy`` / ``_register_builtin_policy`` for policies)
  or topology-shaped class (concrete ``route`` + ``hops`` methods —
  the fabric surface ``core.routing`` registers behind
  ``register_topology`` / ``_register_builtin_topology``, alongside
  ``links_of_router``/``n_cores`` from the shared base) that never
  reaches its registry grows a side API the campaign can't see; the
  resolver follows both direct registration calls and the
  ``ALL_BASELINES``-style pattern (a module list of classes swept by a
  ``for`` loop that registers each).  Abstract fabric shells (``route``
  and ``hops`` both just ``raise NotImplementedError``) and delegating
  wrappers (``route`` without ``hops``, like ``DetourTopology``) are
  not registrable fabrics and stay exempt.
* ``set-iteration`` — materialising a ``set`` in an order-sensitive
  position (``list()``/``tuple()``/``enumerate()``, a ``for`` loop, or
  a list/generator comprehension).  Python set order varies with hash
  seeding across processes, so any ranking or aggregation fed this way
  breaks process-pool bit-identity; wrap in ``sorted()`` (or reduce
  with an order-free ``min``/``max``/``sum``/``len``/``any``/``all``)
  instead.  Dict iteration is insertion-ordered and deterministic, so
  it is not flagged.
* ``atomic-scatter`` — ``index_add(_)``, ``scatter_add(_)``,
  ``scatter_reduce(_)`` and ``index_put(_)``/``put_(..., accumulate=True)``.
  On a CUDA tensor these add by atomics, so a float result depends on the
  order the threads land in (ROADMAP "Determinism on the GPU"): a segment
  sum goes through a fixed-order table instead.  A reviewed use carries
  ``# lint: allow-atomic-scatter`` with its reason — integer operands
  (exact in any order), or a call under
  ``torch.use_deterministic_algorithms(True)``.

Any line can carry ``# lint: allow-<rule>`` to record a reviewed,
deliberate exception (see ROADMAP "Machine-enforced invariants");
findings accepted wholesale live in the committed
``analysis/baseline.json`` instead.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .report import Finding

#: Directories (relative to the repro_torch package) each lint sweeps:
#: the reference's.  ``mitigate`` is in every scope: policies feed
#: re-simulated campaign outcomes, so they carry the same determinism
#: contract as ``core``; telemetry streams and serving traces feed
#: campaign-comparable verdicts, so the launch/serving/data surface does
#: too.  Atomic scatters matter wherever a tensor lives on the card, so
#: that rule also sweeps the model and the optimizer.
_FULL_SCOPE = ("core", "kernels", "mitigate", "distributed", "launch",
               "serving", "data")
RNG_SCOPE = _FULL_SCOPE
WALLCLOCK_SCOPE = _FULL_SCOPE
DETECTOR_SCOPE = _FULL_SCOPE
SET_SCOPE = _FULL_SCOPE
ATOMIC_SCOPE = _FULL_SCOPE + ("models", "optim")

_WALLCLOCK_TIME_FNS = {"time", "perf_counter", "monotonic",
                       "process_time"}
_WALLCLOCK_DT_FNS = {"now", "utcnow", "today"}
_LEGACY_NP_RANDOM_OK = {"Generator", "default_rng", "SeedSequence",
                        "PCG64", "Philox", "BitGenerator"}
#: torch calls that (re)seed the global generator.
_TORCH_GLOBAL_SEEDERS = {"manual_seed", "seed", "cuda.manual_seed",
                         "cuda.manual_seed_all", "cuda.seed", "cuda.seed_all",
                         "random.manual_seed", "random.seed"}
#: torch samplers that draw from the global generator unless given
#: ``generator=``.
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "poisson"}
#: ``*_like`` samplers take no generator at all.
_TORCH_LIKE_SAMPLERS = {"rand_like", "randn_like", "randint_like"}
#: In-place samplers, called on any tensor (or through ``nn.init``).
_INPLACE_SAMPLERS = {"uniform_", "normal_", "bernoulli_", "random_",
                     "exponential_", "geometric_", "cauchy_",
                     "log_normal_"}
_SCATTER_FNS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_"}
_ACCUMULATE_FNS = {"index_put", "index_put_", "put_"}
_REGISTER_FNS = {"register_detector", "_register_builtin",
                 "register_policy", "_register_builtin_policy",
                 "register_topology", "_register_builtin_topology"}
_ORDER_FREE = {"sorted", "min", "max", "sum", "len", "any", "all",
               "set", "frozenset"}
_ORDERED_CONSUMERS = {"list", "tuple", "enumerate"}

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)")


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


def _files(pkg: Path, scopes: tuple[str, ...]) -> list[Path]:
    out: list[Path] = []
    for scope in scopes:
        d = pkg / scope
        if d.is_dir():
            out.extend(sorted(d.rglob("*.py")))
    return out


def _allowed_lines(source: str) -> dict[int, set[str]]:
    """Line → set of rules allowlisted by ``# lint: allow-<rule>``."""
    allowed: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        for m in _ALLOW_RE.finditer(line):
            allowed.setdefault(i, set()).add(m.group(1))
    return allowed


def _suppressed(allowed: dict[int, set[str]], line: int,
                rule: str) -> bool:
    return rule in allowed.get(line, ())


def _dotted(node: ast.expr) -> str | None:
    """``a.b.c`` attribute chains → "a.b.c" (None for anything else)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _imported_names(tree: ast.Module) -> dict[str, str]:
    """Local alias → imported module/name ("np" → "numpy")."""
    imp: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imp[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                imp[a.asname or a.name] = f"{node.module}.{a.name}"
    return imp


# -- rule: unseeded-rng ------------------------------------------------------

def _lint_rng(tree: ast.Module, source: str, path: str) \
        -> list[Finding]:
    findings: list[Finding] = []
    allowed = _allowed_lines(source)
    imports = _imported_names(tree)
    np_aliases = {a for a, mod in imports.items() if mod == "numpy"}
    random_aliases = {a for a, mod in imports.items() if mod == "random"}
    torch_aliases = {a for a, mod in imports.items() if mod == "torch"}
    generators = {a for a, mod in imports.items()
                  if mod == "torch.Generator"}
    seeded = _seeded_generators(tree) if torch_aliases or generators \
        else set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _torch_rng_hit(node, torch_aliases, generators, seeded)
        if hit and not _suppressed(allowed, node.lineno, "rng"):
            findings.append(Finding(
                "lints", "unseeded-rng", path, node.lineno,
                hit + " — draw from a seeded torch.Generator"))
            continue
        dotted = _dotted(node.func)
        if dotted is None:
            continue
        head, _, rest = dotted.partition(".")
        hit = None
        if head in np_aliases and rest.startswith("random."):
            fn = rest.split(".", 1)[1]
            if fn == "default_rng":
                if not node.args and not node.keywords:
                    hit = (f"{dotted}() without a seed draws OS "
                           f"entropy")
            elif fn not in _LEGACY_NP_RANDOM_OK:
                hit = (f"{dotted} uses the unseeded global numpy "
                       f"generator")
        elif head in random_aliases and rest:
            if rest != "Random" and not rest.startswith("Random."):
                hit = f"{dotted} uses the unseeded stdlib generator"
        if hit and not _suppressed(allowed, node.lineno, "rng"):
            findings.append(Finding(
                "lints", "unseeded-rng", path, node.lineno,
                hit + " — derive from a seeded np.random.Generator"))
    return findings


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _torch_rng_hit(node: ast.Call, torch_aliases: set, generators: set,
                   seeded: set[int]) -> str | None:
    """Why ``node`` draws from (or seeds) torch's global generator, or
    builds a ``torch.Generator`` never given a ``manual_seed``."""
    dotted = _dotted(node.func) or ""
    head, _, rest = dotted.partition(".")
    if head in torch_aliases and rest in _TORCH_GLOBAL_SEEDERS:
        return f"{dotted}() seeds torch's global generator"
    if head in torch_aliases and rest in _TORCH_LIKE_SAMPLERS:
        return (f"{dotted}() draws from torch's global generator (it takes "
                f"no generator)")
    if head in torch_aliases and rest in _TORCH_SAMPLERS \
            and not _has_generator(node):
        return f"{dotted}() without generator= draws from the global one"
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _INPLACE_SAMPLERS \
            and not _has_generator(node):
        return (f".{node.func.attr}() without generator= draws from "
                f"torch's global generator")
    if (head in torch_aliases and rest == "Generator") \
            or (not rest and head in generators):
        if id(node) not in seeded:
            return f"{dotted}() is never given a manual_seed"
    return None


def _seeded_generators(tree: ast.Module) -> set[int]:
    """``id`` of every call seeded where it is made: the receiver of a
    ``.manual_seed(...)``, or the value of ``g = ...`` with a
    ``g.manual_seed(...)`` call in the module."""
    seeded, names, assigns = set(), set(), []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "manual_seed":
            if isinstance(n.func.value, ast.Call):
                seeded.add(id(n.func.value))
            elif isinstance(n.func.value, ast.Name):
                names.add(n.func.value.id)
        elif isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            assigns.append(n)
    seeded.update(id(a.value) for a in assigns if a.targets[0].id in names)
    return seeded


# -- rule: wallclock ---------------------------------------------------------

def _lint_wallclock(tree: ast.Module, source: str, path: str) \
        -> list[Finding]:
    findings: list[Finding] = []
    allowed = _allowed_lines(source)
    imports = _imported_names(tree)
    time_aliases = {a for a, mod in imports.items() if mod == "time"}
    dt_aliases = {a for a, mod in imports.items()
                  if mod in ("datetime", "datetime.datetime")}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is None or "." not in dotted:
            continue
        head, _, rest = dotted.partition(".")
        fn = rest.split(".")[-1]
        hit = (head in time_aliases and fn in _WALLCLOCK_TIME_FNS) or \
            (head in dt_aliases and fn in _WALLCLOCK_DT_FNS)
        if hit and not _suppressed(allowed, node.lineno, "wallclock"):
            findings.append(Finding(
                "lints", "wallclock", path, node.lineno,
                f"{dotted}() reads the wall clock inside the pipeline "
                f"— outputs become run-dependent; telemetry-only "
                f"readers get '# lint: allow-wallclock'"))
    return findings


# -- rule: unregistered-detector ---------------------------------------------

def _detector_classes(tree: ast.Module) \
        -> list[tuple[ast.ClassDef, str]]:
    """Public classes matching a registry duck type, tagged with which:
    a string ``name`` attribute plus ``prepare`` + ``analyse``
    (``"detector"``, the shape ``core.detectors`` registers), or plus
    ``plan`` + ``apply`` (``"policy"``, the shape ``mitigate.policy``
    registers), or concrete ``route`` + ``hops`` methods
    (``"topology"``, the fabric shape ``core.routing`` registers —
    no ``name`` attribute required).  Abstract fabric shells (both
    methods just ``raise NotImplementedError``) are base classes, not
    registrable fabrics, and are skipped."""
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef) or \
                node.name.startswith("_"):
            continue
        has_name = any(
            isinstance(s, ast.Assign) and len(s.targets) == 1
            and isinstance(s.targets[0], ast.Name)
            and s.targets[0].id == "name"
            and isinstance(s.value, ast.Constant)
            and isinstance(s.value.value, str)
            for s in node.body)
        defs = {s.name: s for s in node.body
                if isinstance(s, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))}
        methods = set(defs)
        if has_name and {"prepare", "analyse"} <= methods:
            out.append((node, "detector"))
        elif has_name and {"plan", "apply"} <= methods:
            out.append((node, "policy"))
        elif {"route", "hops"} <= methods and not all(
                _is_abstract_stub(defs[m]) for m in ("route", "hops")):
            out.append((node, "topology"))
    return out


def _is_abstract_stub(fn: ast.FunctionDef) -> bool:
    """True when a method body is nothing but ``raise
    NotImplementedError`` (after an optional docstring)."""
    body = fn.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    if len(body) != 1 or not isinstance(body[0], ast.Raise):
        return False
    exc = body[0].exc
    if isinstance(exc, ast.Call):
        exc = exc.func
    return isinstance(exc, ast.Name) and exc.id == "NotImplementedError"


def _registered_names(tree: ast.Module) -> set[str]:
    """Names that reach a registration call: direct arguments, plus
    names inside list/tuple literals that a ``for`` loop sweeps into a
    registration call (the ``ALL_BASELINES`` pattern)."""
    module_lists: dict[str, list[str]] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, (ast.List, ast.Tuple)):
            module_lists[stmt.targets[0].id] = [
                e.id for e in stmt.value.elts
                if isinstance(e, ast.Name)]

    registered: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = node.func.attr \
                if isinstance(node.func, ast.Attribute) else (
                    node.func.id if isinstance(node.func, ast.Name)
                    else None)
            if fname in _REGISTER_FNS:
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name):
                            registered.add(sub.id)
        if isinstance(node, ast.For):
            body_regs = any(
                isinstance(c, ast.Call) and (
                    (isinstance(c.func, ast.Attribute)
                     and c.func.attr in _REGISTER_FNS)
                    or (isinstance(c.func, ast.Name)
                        and c.func.id in _REGISTER_FNS))
                for b in node.body for c in ast.walk(b))
            if not body_regs:
                continue
            it = node.iter
            if isinstance(it, ast.Name) and it.id in module_lists:
                registered.update(module_lists[it.id])
            elif isinstance(it, (ast.List, ast.Tuple)):
                registered.update(e.id for e in it.elts
                                  if isinstance(e, ast.Name))
    return registered


def _lint_detectors(tree: ast.Module, source: str, path: str) \
        -> list[Finding]:
    classes = _detector_classes(tree)
    if not classes:
        return []
    registered = _registered_names(tree)
    allowed = _allowed_lines(source)
    shapes = {
        "detector": ("detector-shaped (name + prepare + analyse)",
                     "register_detector / _register_builtin"),
        "policy": ("mitigation-policy-shaped (name + plan + apply)",
                   "register_policy / _register_builtin_policy"),
        "topology": ("topology-shaped (concrete route + hops)",
                     "register_topology / _register_builtin_topology"),
    }
    findings = []
    for cls, kind in classes:
        if cls.name in registered:
            continue
        if _suppressed(allowed, cls.lineno, "unregistered-detector"):
            continue
        shape, fns = shapes[kind]
        findings.append(Finding(
            "lints", "unregistered-detector", path, cls.lineno,
            f"class {cls.name} is {shape} but never reaches {fns} — "
            f"side APIs bypass the campaign"))
    return findings


# -- rule: set-iteration -----------------------------------------------------

def _lint_set_iteration(tree: ast.Module, source: str, path: str) \
        -> list[Finding]:
    findings: list[Finding] = []
    allowed = _allowed_lines(source)

    def scope_bodies():
        yield tree.body
        for n in ast.walk(tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield n.body

    for body in scope_bodies():
        set_names: set[str] = set()
        for stmt in body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name) \
                    and _is_set_expr(stmt.value, set()):
                set_names.add(stmt.targets[0].id)
        if not set_names and not any(
                _is_set_expr(n, set()) for s in body
                for n in ast.walk(s)):
            continue
        for stmt in body:
            for node in ast.walk(stmt):
                line, why = _ordered_set_use(node, set_names)
                if why and not _suppressed(allowed, line,
                                           "set-iteration"):
                    findings.append(Finding(
                        "lints", "set-iteration", path, line,
                        why + " — set order varies with hash seeding "
                        "across processes; wrap in sorted() or reduce "
                        "order-free"))
    return _dedupe(findings)


def _is_set_expr(node: ast.expr, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return isinstance(node, ast.Name) and node.id in set_names


def _ordered_set_use(node: ast.AST, set_names: set[str]) \
        -> tuple[int, str | None]:
    """(line, message) if ``node`` consumes a set in an order-sensitive
    way; (0, None) otherwise."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in _ORDERED_CONSUMERS and node.args \
            and _is_set_expr(node.args[0], set_names):
        return (node.lineno,
                f"{node.func.id}() over a set materialises arbitrary "
                f"order")
    if isinstance(node, ast.For) and _is_set_expr(node.iter,
                                                  set_names):
        return (node.lineno, "for-loop iterates a set directly")
    if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
        for gen in node.generators:
            if _is_set_expr(gen.iter, set_names):
                return (node.lineno,
                        "comprehension iterates a set into an ordered "
                        "result")
    return (0, None)


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        k = (f.rule, f.path, f.line)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


# -- rule: atomic-scatter ----------------------------------------------------

def _accumulates(call: ast.Call) -> bool:
    """``accumulate=True``, by keyword or as ``index_put_``'s third
    positional argument."""
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    return len(call.args) >= 3 and isinstance(call.args[2], ast.Constant) \
        and call.args[2].value is True


def _lint_atomic_scatter(tree: ast.Module, source: str, path: str) \
        -> list[Finding]:
    findings: list[Finding] = []
    allowed = _allowed_lines(source)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            continue
        fn = node.func.attr
        hit = fn in _SCATTER_FNS or (fn in _ACCUMULATE_FNS
                                     and _accumulates(node))
        if hit and not _suppressed(allowed, node.lineno, "atomic-scatter"):
            findings.append(Finding(
                "lints", "atomic-scatter", path, node.lineno,
                f"{fn}() adds by atomics on a CUDA tensor — a float result "
                f"depends on thread order; sum through a fixed-order table, "
                f"or mark '# lint: allow-atomic-scatter' with the reason "
                f"(integer operands, deterministic algorithms)"))
    return findings


# -- driver ------------------------------------------------------------------

_RULES = (
    (_lint_rng, RNG_SCOPE),
    (_lint_wallclock, WALLCLOCK_SCOPE),
    (_lint_detectors, DETECTOR_SCOPE),
    (_lint_set_iteration, SET_SCOPE),
    (_lint_atomic_scatter, ATOMIC_SCOPE),
)


def lint_source(source: str, path: str) -> list[Finding]:
    """Run every rule on one module's source (scope-independent; the
    unit the self-test drives)."""
    tree = ast.parse(source)
    findings: list[Finding] = []
    for rule, _scope in _RULES:
        findings.extend(rule(tree, source, path))
    return findings


def check(root=None) -> list[Finding]:
    """Lint the repo: each file parsed once, every in-scope rule run on
    it, enclosing symbols attached for stable fingerprints."""
    pkg = _package_root(root)
    findings: list[Finding] = []
    trees: dict[str, ast.Module] = {}
    all_files: dict[Path, set[int]] = {}
    for i, (_rule, scopes) in enumerate(_RULES):
        for f in _files(pkg, scopes):
            all_files.setdefault(f, set()).add(i)
    for f in sorted(all_files):
        src = f.read_text()
        rel = _rel(f)
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            findings.append(Finding(
                "lints", "syntax-error", rel, e.lineno or 0,
                f"unparsable module: {e.msg}"))
            continue
        trees[rel] = tree
        for i in sorted(all_files[f]):
            findings.extend(_RULES[i][0](tree, src, rel))
    from .report import attach_symbols
    return attach_symbols(_dedupe_all(findings), trees)


def _dedupe_all(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple] = set()
    out = []
    for f in findings:
        k = (f.rule, f.path, f.line, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


# -- self-test ---------------------------------------------------------------

_SYNTHETIC = {
    "unseeded-rng": (
        "import numpy as np\nimport random\n"
        "x = np.random.rand(4)\n"
        "g = np.random.default_rng()\n"
        "y = random.random()\n"),
    "wallclock": (
        "import time\n"
        "def f():\n"
        "    return time.perf_counter()\n"),
    "unregistered-detector": (
        "class Rogue:\n"
        "    name = 'rogue'\n"
        "    def prepare(self, graph, mesh, profile=None, cfg=None):\n"
        "        return self\n"
        "    def analyse(self, sim):\n"
        "        return None\n"
        "class RoguePolicy:\n"
        "    name = 'roguepol'\n"
        "    def plan(self, verdict, mapped, mesh, cfg=None):\n"
        "        return None\n"
        "    def apply(self, plan, mapped, cfg=None):\n"
        "        return mapped\n"
        "class RogueTopo:\n"
        "    def route(self, src, dst):\n"
        "        return []\n"
        "    def hops(self, src, dst):\n"
        "        return 0\n"),
    "set-iteration": (
        "def f(xs):\n"
        "    used = set(xs)\n"
        "    return list(used)\n"),
    "atomic-scatter": (
        "import torch\n"
        "def f(out, idx, src):\n"
        "    out.index_add_(0, idx, src)\n"
        "    torch.scatter_add(out, 0, idx[:, None], src)\n"
        "    out.scatter_reduce_(0, idx, src, 'sum')\n"
        "    out.index_put_((idx,), src, accumulate=True)\n"
        "    return out.index_put((idx,), src, True)\n"),
}

#: Every form of torch's global generator, one a line (lines 2-11): the
#: self-test requires each line flagged.
_SYNTHETIC_TORCH_RNG = (
    "import torch\n"
    "torch.manual_seed(0)\n"
    "torch.cuda.manual_seed_all(0)\n"
    "a = torch.randn(4)\n"
    "b = torch.randint(0, 9, (4,))\n"
    "c = torch.rand_like(a)\n"
    "d = torch.multinomial(a.abs(), 2)\n"
    "a.normal_()\n"
    "torch.nn.init.uniform_(a)\n"
    "g = torch.Generator()\n"
    "e = torch.randn(4, generator=torch.Generator(device='cpu'))\n")

_SYNTHETIC_CLEAN = (
    # every shape the rules must NOT flag
    "import time\nimport numpy as np\n"
    "from .detectors import _register_builtin\n"
    "def now():\n"
    "    return time.perf_counter()  # lint: allow-wallclock\n"
    "def noise(rng):\n"
    "    return rng.normal() + np.random.default_rng(7).normal()\n"
    "class Fine:\n"
    "    name = 'fine'\n"
    "    def prepare(self, *a, **k):\n"
    "        return self\n"
    "    def analyse(self, sim):\n"
    "        return None\n"
    "ALL = [Fine]\n"
    "for _cls in ALL:\n"
    "    _register_builtin(_cls.name, _cls)\n"
    "class FinePolicy:\n"
    "    name = 'finepol'\n"
    "    def plan(self, verdict, mapped, mesh, cfg=None):\n"
    "        return None\n"
    "    def apply(self, plan, mapped, cfg=None):\n"
    "        return mapped\n"
    "register_policy('finepol', FinePolicy)\n"
    "class FineTopo:\n"
    "    def route(self, src, dst):\n"
    "        return []\n"
    "    def hops(self, src, dst):\n"
    "        return 0\n"
    "register_topology('finetopo', FineTopo)\n"
    "class AbstractFabric:\n"
    "    def route(self, src, dst):\n"
    "        raise NotImplementedError\n"
    "    def hops(self, src, dst):\n"
    "        raise NotImplementedError\n"
    "class DetourWrapper:\n"
    "    def route(self, src, dst):\n"
    "        return list(self.base.route(src, dst))\n"
    "def g(xs, links):\n"
    "    used = set(xs)\n"
    "    routers = {c for lid in used for c in links[lid]}\n"
    "    return tuple(sorted(used)), tuple(sorted(routers))\n"
    "import torch\n"
    "def draws(seed, dev, x, idx, counts):\n"
    "    gen = torch.Generator(device=dev).manual_seed(seed)\n"
    "    g2 = torch.Generator()\n"
    "    g2.manual_seed(seed + 1)\n"
    "    x.normal_(generator=gen)\n"
    "    counts.index_add_(0, idx, idx)  # lint: allow-atomic-scatter (int)\n"
    "    x.index_put_((idx,), x[idx])\n"
    "    return torch.randn(3, generator=gen) + torch.rand(3, generator=g2)\n")


def self_test() -> None:
    """Plant one synthetic violation per rule and assert it is caught;
    assert the allowlisted/registered/sorted shapes stay clean and
    every real-tree finding is carried by the shipped baseline."""
    from .report import load_baseline
    baseline = load_baseline()
    new = [f for f in check() if f.fingerprint not in baseline]
    assert new == [], \
        "lint findings missing from analysis/baseline.json (fix, " \
        "allowlist, or --update-baseline):\n" + "\n".join(
            f"{f.render()}  fp={f.fingerprint}" for f in new)
    for rule, src in _SYNTHETIC.items():
        got = {f.rule for f in lint_source(src, "<synthetic>")}
        assert rule in got, \
            f"rule {rule} not triggered (got {got or 'nothing'})"
    torch_rng = lint_source(_SYNTHETIC_TORCH_RNG, "<synthetic>")
    lines = {f.line for f in torch_rng if f.rule == "unseeded-rng"}
    assert lines == set(range(2, 12)), \
        f"torch RNG forms missed on lines {set(range(2, 12)) - lines}"
    scatter = lint_source(_SYNTHETIC["atomic-scatter"], "<synthetic>")
    lines = {f.line for f in scatter if f.rule == "atomic-scatter"}
    assert lines == set(range(3, 8)), \
        f"atomic scatters missed on lines {set(range(3, 8)) - lines}"
    planted = lint_source(_SYNTHETIC["unregistered-detector"],
                          "<synthetic>")
    caught = {f.message.split()[1] for f in planted}
    assert {"Rogue", "RoguePolicy", "RogueTopo"} <= caught, \
        f"all three registry duck types must be caught (got {caught})"
    benign = lint_source(_SYNTHETIC_CLEAN, "<synthetic-clean>")
    assert benign == [], \
        "false positives on benign shapes:\n" + "\n".join(
            f.render() for f in benign)
