"""Lexical auditor of the port's CUDA kernels against their contracts.

The counterpart of the reference's Pallas audit: each
``kernels/<name>/ops.py`` binds one ``csrc/<source>.cu`` (its
``_lib.load("<source>")``) and declares a module-level contract,

    AUDIT = {"float_atomics": 0,
             "int_atomics": {"<kernel>": ("atomicAdd", ...), ...},
             "one_block_per": {"<kernel>": "<grid expression>", ...}}

which this pass holds the ``.cu`` to without compiling it (comments,
string contents and preprocessor lines are blanked, then functions, their
bodies, ``extern "C"`` entry points and ``<<<...>>>`` launches are found
by brace matching).  ``chip_smoke.py`` holds the same contracts to the
card's SASS.  Findings:

* ``missing-audit-contract`` — an ``ops.py`` without a literal ``AUDIT``
  of the keys and types above, or a ``.cu`` that no ``ops.py`` loads.
* ``missing-plain-version`` — no ``ref.py`` beside ``ops.py`` (every
  kernel ships the plain torch version it is tested against).
* ``float-atomic`` — an ``atomic*(`` call on a float operand (its pointer
  declared ``float``, ``double``, ``half``, ``bf16`` and their vector
  forms, or a float literal added), or inline ``atom.`` / ``red.`` PTX on
  an ``f16``, ``bf16``, ``f32`` or ``f64`` operand; also a count that
  differs from ``AUDIT["float_atomics"]``.  Float atomics add in the order
  threads land, which the ROADMAP's "Determinism on the GPU" rule
  forbids: every contract declares 0.
* ``undeclared-atomic`` — an integer atomic in a ``__global__`` kernel
  (or a ``__device__`` function it calls) that ``AUDIT["int_atomics"]``
  does not list for it, or a listed one the kernel no longer has.
* ``binding-drift`` — an ``extern "C"`` function whose parameter count
  differs from its ctypes ``argtypes``, one exported but never bound, or
  one bound but not exported.
* ``grid-drift`` — a kernel in ``AUDIT["one_block_per"]`` launched with
  another grid than the one declared (K1: one block per sketch, the
  launch's sketch count ``count``, so no sketch's run order is split
  across blocks), or never launched.
* ``unparsable-source`` — a file this pass cannot read (unbalanced
  braces or a Python syntax error): reported, never skipped.

Pure text and ``ast`` — no torch import, no ``nvcc``.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from .report import Finding, attach_symbols

#: Required keys (and value types) of an ``ops.py``'s AUDIT contract.
AUDIT_KEYS = {"float_atomics": int, "int_atomics": dict,
              "one_block_per": dict}

FLOAT_TYPES = {"float", "double", "half", "__half", "bf16",
               "__nv_bfloat16", "nv_bfloat16", "float2", "float4",
               "double2", "half2", "__half2", "bf162", "__nv_bfloat162"}
_PTX_FLOAT = re.compile(r"\.(?:b?f16(?:x2)?|f32|f64)\b")
_PTX_ATOMIC = re.compile(r"\b(?:atom|red)(?:\.[\w:]+)+")
_ATOMIC_CALL = re.compile(r"\b(atomic[A-Z]\w*)\s*\(")
_LAUNCH = re.compile(r"\b(\w+)\s*(?:<[^;{}()]*?>)?\s*<<<")
_IDENT = re.compile(r"[A-Za-z_]\w*")
_INT_TYPE = re.compile(r"u?int\d*(_t)?|uint\d|u?longlong\d?|unsigned|long|"
                       r"short|char|size_t|bool|u?short\d|u?char\d")


# ---------------------------------------------------------------------------
# lexing
# ---------------------------------------------------------------------------

_LEXEME = re.compile(
    r"(?P<pre>^[ \t]*#(?:[^\n]*\\\n)*[^\n]*)"    # preprocessor line(s)
    r"|(?P<com>//[^\n]*|/\*.*?\*/)"                # comments
    r"|(?P<str>\"(?:\\.|[^\"\\\n])*\"|'(?:\\.|[^'\\\n])*')",
    re.M | re.S)


def _spaces(text: str) -> str:
    return re.sub(r"[^\n]", " ", text)


def blank(source: str) -> tuple[str, str]:
    """``(code, bare)``, both as long as ``source`` with every newline
    kept: ``code`` without comments, ``bare`` also without string and
    character contents and preprocessor lines (continuations included)."""
    code, bare, at = [], [], 0
    for m in _LEXEME.finditer(source):
        code.append(source[at:m.start()])
        bare.append(source[at:m.start()])
        text = m.group(0)
        if m.lastgroup == "com":
            code.append(_spaces(text))
            bare.append(_spaces(text))
        elif m.lastgroup == "pre":
            code.append(text)
            bare.append(_spaces(text))
        else:
            code.append(text)
            bare.append(text[0] + _spaces(text[1:-1]) + text[-1])
        at = m.end()
    code.append(source[at:])
    bare.append(source[at:])
    return "".join(code), "".join(bare)


def _match(bare: str, i: int, open_: str, close: str) -> int:
    """Index of the bracket closing the one at ``i`` (ValueError if
    none)."""
    depth = 0
    for j in range(i, len(bare)):
        if bare[j] == open_:
            depth += 1
        elif bare[j] == close:
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced {open_!r} at offset {i}")


def split_top(text: str) -> list[str]:
    """Comma-separated parts of ``text`` at bracket depth 0."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


@dataclasses.dataclass
class CudaFunction:
    """A function defined at namespace scope of a ``.cu`` file."""
    name: str
    header: str           # text from the previous declaration to '{'
    params: str           # the parameter list's text
    start: int            # offset of the body's '{'
    end: int              # offset of the body's '}'
    line: int
    extern_c: bool

    @property
    def is_kernel(self) -> bool:
        return "__global__" in self.header

    @property
    def n_params(self) -> int:
        parts = split_top(self.params)
        return 0 if parts in ([], ["void"]) else len(parts)


def functions(code: str, bare: str) -> list[CudaFunction]:
    """Every function defined at namespace scope (``extern "C"`` and
    ``namespace`` blocks are entered; struct, class and initializer
    bodies are skipped)."""
    out: list[CudaFunction] = []
    extern_c: list[tuple[int, int]] = []
    i, seg, n = 0, 0, len(bare)
    stack: list[int] = []      # ends of the blocks entered
    while i < n:
        if stack and i == stack[-1]:
            stack.pop()
            i += 1
            seg = i
            continue
        ch = bare[i]
        if ch == ";":
            seg = i + 1
        elif ch == "}":
            raise ValueError(f"unbalanced '}}' at offset {i}")
        elif ch == "{":
            end = _match(bare, i, "{", "}")
            header = bare[seg:i]
            head = header.strip()
            if re.fullmatch(r"extern\s+\"\s*\"", head) \
                    and re.search(r'extern\s+"C"\s*$', code[seg:i]):
                extern_c.append((i, end))
                stack.append(end)
                i += 1
                seg = i
                continue
            if re.match(r"namespace\b", head):
                stack.append(end)
                i += 1
                seg = i
                continue
            fn = _function_of(header, i, end, bare)
            if fn is not None:
                fn.extern_c = any(a < i < b for a, b in extern_c)
                out.append(fn)
            i = end + 1
            seg = i
            continue
        i += 1
    if stack:
        raise ValueError("unterminated block")
    return out


def _function_of(header: str, start: int, end: int,
                 bare: str) -> CudaFunction | None:
    head = " ".join(header.split())
    outer = head
    while True:                     # drop every parenthesised group
        shorter = re.sub(r"\([^()]*\)", "", outer)
        if shorter == outer:
            break
        outer = shorter
    if "=" in outer or (re.search(r"\b(struct|class|union|enum)\b", outer)
                        and not head.endswith(")")):
        return None
    head = re.sub(r"\s*\b(const|noexcept|override)$", "", head)
    if not head.endswith(")"):
        return None
    close = len(head) - 1
    depth = 0
    for j in range(close, -1, -1):
        if head[j] == ")":
            depth += 1
        elif head[j] == "(":
            depth -= 1
            if depth == 0:
                break
    else:
        return None
    m = re.search(r"(\w+)\s*$", head[:j])
    if m is None or m.group(1) in ("if", "for", "while", "switch"):
        return None
    at = start - len(header) + header.rfind(m.group(1) + "(") \
        if m.group(1) + "(" in header else start
    return CudaFunction(m.group(1), header, head[j + 1:close], start, end,
                        bare.count("\n", 0, at) + 1, False)


def _line(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _enclosing(fns: list[CudaFunction], pos: int) -> CudaFunction | None:
    return next((f for f in fns if f.start < pos < f.end), None)


# ---------------------------------------------------------------------------
# atomics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AtomicSite:
    name: str             # atomicAdd, ..., or the PTX instruction
    line: int
    function: str
    is_float: bool
    why: str


def _declared_type(text: str, name: str) -> str | None:
    """Base type of the last declaration of ``name`` in ``text``
    (``T* name``, ``T name[...]``, ``T name =``, a parameter), for a
    float or integer scalar or vector type T; None if there is none."""
    decl = re.compile(
        r"\b([A-Za-z_][\w:]*)\s*(?:const\s*)?\*?\s*(?:const\s+)?"
        r"(?:__restrict__\s+)?\b" + re.escape(name) + r"\s*[\[=;,)]")
    hits = [m.group(1) for m in decl.finditer(text)
            if m.group(1) in FLOAT_TYPES or _INT_TYPE.fullmatch(m.group(1))]
    return hits[-1] if hits else None


def atomic_sites(code: str, bare: str,
                 fns: list[CudaFunction]) -> list[AtomicSite]:
    """Every atomic call and inline atomic PTX instruction inside a
    function, with whether its operand is a float."""
    sites = []
    for m in _ATOMIC_CALL.finditer(bare):
        fn = _enclosing(fns, m.start())
        if fn is None:
            continue
        close = _match(bare, m.end() - 1, "(", ")")
        args = split_top(bare[m.end():close])
        first = args[0] if args else ""
        is_float, why = False, "integer operand"
        if any(re.search(rf"\b{t}\s*\*", first) for t in FLOAT_TYPES):
            is_float, why = True, "cast to a float pointer"
        elif len(args) > 1 and re.fullmatch(
                r"[-+]?(\d+\.\d*|\.\d+|\d+\.?\d*[eE][-+]?\d+)[fF]?",
                args[1]):
            is_float, why = True, f"float value {args[1]}"
        else:
            ident = _IDENT.search(first.lstrip("&*( "))
            t = _declared_type(bare[:m.start()], ident.group(0)) \
                if ident else None
            if t is None:
                is_float, why = True, "operand type not found"
            elif t in FLOAT_TYPES:
                is_float, why = True, f"{ident.group(0)} is {t}"
        sites.append(AtomicSite(m.group(1), _line(bare, m.start()),
                                fn.name, is_float, why))
    for m in _PTX_ATOMIC.finditer(code):
        if bare[m.start()] != " ":
            continue                      # not inside a string literal
        fn = _enclosing(fns, m.start())
        if fn is None:
            continue
        flt = _PTX_FLOAT.search(m.group(0))
        sites.append(AtomicSite(
            m.group(0).split(".")[0], _line(code, m.start()), fn.name,
            flt is not None,
            f"inline {m.group(0)}" if flt else "inline integer PTX"))
    return sites


def _reach(fns: list[CudaFunction], bare: str) -> dict[str, set[str]]:
    """Kernel name → names of the functions it runs (itself included),
    following calls by name through ``__device__`` functions."""
    by_name: dict[str, list[CudaFunction]] = {}
    for f in fns:
        by_name.setdefault(f.name, []).append(f)
    calls: dict[str, set[str]] = {}
    for f in fns:
        named = set(re.findall(r"\b(\w+)\s*[<(]", bare[f.start:f.end]))
        calls.setdefault(f.name, set()).update(
            g for g in named if g in by_name and g != f.name)
    out = {}
    for k in fns:
        if not k.is_kernel:
            continue
        seen, todo = {k.name}, [k.name]
        while todo:
            for g in calls.get(todo.pop(), ()):
                if g not in seen:
                    seen.add(g)
                    todo.append(g)
        out[k.name] = seen
    return out


# ---------------------------------------------------------------------------
# the Python side: AUDIT and the ctypes bindings
# ---------------------------------------------------------------------------

def _audit_contract(tree: ast.Module, path: str,
                    findings: list[Finding]) -> tuple[dict | None, int]:
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and stmt.targets[0].id == "AUDIT":
            try:
                audit = ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                findings.append(Finding(
                    "kernels", "missing-audit-contract", path, stmt.lineno,
                    "AUDIT must be a literal dict"))
                return None, stmt.lineno
            bad = [k for k, t in AUDIT_KEYS.items()
                   if not isinstance(audit.get(k) if isinstance(audit, dict)
                                     else None, t)
                   or isinstance(audit.get(k), bool)]
            if not bad:
                bad = [k for k, v in audit["int_atomics"].items()
                       if not isinstance(v, (tuple, list))
                       or not all(isinstance(a, str) for a in v)]
                bad += [k for k, v in audit["one_block_per"].items()
                        if not isinstance(v, str)]
            if bad:
                findings.append(Finding(
                    "kernels", "missing-audit-contract", path, stmt.lineno,
                    f"AUDIT missing/ill-typed entries: {bad} (need "
                    f"{sorted(AUDIT_KEYS)}: float_atomics an int, "
                    f"int_atomics kernel -> atomic names, one_block_per "
                    f"kernel -> grid expression)"))
                return None, stmt.lineno
            return audit, stmt.lineno
    findings.append(Finding(
        "kernels", "missing-audit-contract", path, 1,
        "ops.py declares no AUDIT contract (AUDIT = {'float_atomics': "
        "0, 'int_atomics': {...}, 'one_block_per': {...}})"))
    return None, 1


def loaded_source(tree: ast.Module) -> str | None:
    """The ``csrc`` stem an ``ops.py`` loads (``_lib.load("<stem>")``)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "load" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            return node.args[0].value
    return None


def _length(node: ast.expr, env: dict, bound: dict) -> int | None:
    """Static length of an ``argtypes`` expression (None: opaque)."""
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _length(node.left, env, bound), _length(node.right, env,
                                                          bound)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, k in ((node.left, node.right), (node.right, node.left)):
            n, times = _length(seq, env, bound), _int(k, env)
            if n is not None and times is not None:
                return n * times
        return None
    if isinstance(node, ast.Attribute) and node.attr == "argtypes":
        name = _bound_name(node.value, env)
        return bound.get(name)
    return None


def _int(node: ast.expr, env: dict) -> int | None:
    node = env.get(node.id, node) if isinstance(node, ast.Name) else node
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _bound_name(node: ast.expr, env: dict) -> str | None:
    """``lib.NAME`` (or a loop variable standing for one) → NAME."""
    if isinstance(node, ast.Name) and node.id in env:
        node = env[node.id]
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return node.attr
    return None


def bindings(tree: ast.Module) -> dict[str, tuple[int | None, int]]:
    """Entry point → (``argtypes`` length or None, line) for every
    ``lib.NAME.argtypes = ...`` in the module, following ``for`` loops
    over literal tuples and ``argtypes`` copied from another entry."""
    bound: dict[str, int | None] = {}
    lines: dict[str, int] = {}

    def assign(stmt, env):
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Attribute) \
                and stmt.targets[0].attr == "argtypes":
            name = _bound_name(stmt.targets[0].value, env)
            if name is not None:
                bound[name] = _length(stmt.value, env, bound)
                lines[name] = stmt.lineno

    def visit(stmts, env):
        for stmt in stmts:
            if isinstance(stmt, ast.For) \
                    and isinstance(stmt.iter, (ast.Tuple, ast.List)):
                for item in stmt.iter.elts:
                    sub = dict(env)
                    if isinstance(stmt.target, ast.Tuple) \
                            and isinstance(item, ast.Tuple) \
                            and len(item.elts) == len(stmt.target.elts):
                        for t, v in zip(stmt.target.elts, item.elts):
                            if isinstance(t, ast.Name):
                                sub[t.id] = v
                    elif isinstance(stmt.target, ast.Name):
                        sub[stmt.target.id] = item
                    visit(stmt.body, sub)
            elif isinstance(stmt, (ast.FunctionDef, ast.If, ast.With)):
                visit(stmt.body, env)
            else:
                assign(stmt, env)

    visit(tree.body, {})
    return {k: (bound[k], lines[k]) for k in bound}


# ---------------------------------------------------------------------------
# one kernel: its .cu against its ops.py
# ---------------------------------------------------------------------------

def audit_kernel(cu_source: str, cu_path: str, ops_source: str,
                 ops_path: str, *, has_plain: bool = True) \
        -> list[Finding]:
    """Audit one ``.cu`` against the ``ops.py`` that binds it (the unit
    the self-test drives with planted violations)."""
    findings: list[Finding] = []
    try:
        tree = ast.parse(ops_source)
    except SyntaxError as e:
        return [Finding("kernels", "unparsable-source", ops_path,
                        e.lineno or 0, f"unparsable module: {e.msg}")]
    if not has_plain:
        findings.append(Finding(
            "kernels", "missing-plain-version", ops_path, 1,
            "no ref.py beside ops.py: the kernel has no plain torch "
            "version to be held to"))
    audit, audit_line = _audit_contract(tree, ops_path, findings)
    code, bare = blank(cu_source)
    try:
        fns = functions(code, bare)
        sites = atomic_sites(code, bare, fns)
    except ValueError as e:
        findings.append(Finding("kernels", "unparsable-source", cu_path, 0,
                                f"cannot read the source: {e}"))
        return attach_symbols(findings, {ops_path: tree})

    def at(line, fn, rule, msg, path=cu_path):
        findings.append(Finding("kernels", rule, path, line, msg, fn))

    floats = [s for s in sites if s.is_float]
    for s in floats:
        at(s.line, s.function, "float-atomic",
           f"{s.name} on a float operand ({s.why}) adds in the order "
           f"threads land — sum in a fixed order instead")
    if audit is not None and audit["float_atomics"] != len(floats):
        at(audit_line, "", "float-atomic",
           f"AUDIT declares {audit['float_atomics']} float atomics, the "
           f"source has {len(floats)}", ops_path)

    reach = _reach(fns, bare)
    if audit is not None:
        declared = {k: set(v) for k, v in audit["int_atomics"].items()}
        used: dict[str, set[str]] = {}
        for kernel, runs in reach.items():
            for s in sites:
                if not s.is_float and s.function in runs:
                    used.setdefault(kernel, set()).add(s.name)
                    if s.name not in declared.get(kernel, set()):
                        at(s.line, s.function, "undeclared-atomic",
                           f"{s.name} runs in kernel {kernel}, which "
                           f"AUDIT['int_atomics'] does not list it for")
        for kernel, names in sorted(declared.items()):
            for name in sorted(names - used.get(kernel, set())):
                at(audit_line, "", "undeclared-atomic",
                   f"AUDIT lists {name} in kernel {kernel}, which does "
                   f"not run it", ops_path)

        launches = [(m.group(1), m.end()) for m in _LAUNCH.finditer(bare)]
        kernels = {f.name for f in fns if f.is_kernel}
        for kernel, grid in sorted(audit["one_block_per"].items()):
            mine = [end for name, end in launches if name == kernel]
            if kernel not in kernels or not mine:
                at(audit_line, "", "grid-drift",
                   f"AUDIT declares one block per unit of {grid!r} for "
                   f"kernel {kernel}, which the source never launches",
                   ops_path)
            for end in mine:
                close = bare.index(">>>", end)
                got = " ".join(split_top(bare[end:close])[0].split())
                if got != " ".join(grid.split()):
                    fn = _enclosing(fns, end)
                    at(_line(bare, end), fn.name if fn else "",
                       "grid-drift",
                       f"{kernel} launched on a grid of {got!r}, not "
                       f"{grid!r}: one block per unit, or the order within "
                       f"a unit is split across blocks")

    exported = {f.name: f for f in fns if f.extern_c}
    bound = bindings(tree)
    for name, f in sorted(exported.items()):
        if name not in bound:
            at(f.line, name, "binding-drift",
               f"extern \"C\" {name} is exported but ops.py never binds "
               f"its argtypes")
        elif bound[name][0] is None:
            at(bound[name][1], "", "binding-drift",
               f"argtypes of {name} cannot be counted statically",
               ops_path)
        elif bound[name][0] != f.n_params:
            at(bound[name][1], "", "binding-drift",
               f"{name} takes {f.n_params} parameters in C, its argtypes "
               f"{bound[name][0]}", ops_path)
    for name, (_, line) in sorted(bound.items()):
        if name not in exported:
            at(line, "", "binding-drift",
               f"ops.py binds {name}, which the source does not export",
               ops_path)
    return attach_symbols(_dedupe(findings), {ops_path: tree})


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
# the package
# ---------------------------------------------------------------------------

def _package_root(root) -> Path:
    if root is None:
        return Path(__file__).resolve().parents[1]
    root = Path(root)
    for sub in ("src/repro_torch", "repro_torch"):
        if (root / sub / "kernels").is_dir():
            return root / sub
    return root


def _rel(path: Path) -> str:
    s = str(path)
    i = s.find("src/repro_torch/")
    return s[i:] if i >= 0 else s


def contracts(root=None) -> dict[str, dict]:
    """``csrc`` stem → the AUDIT of the ``ops.py`` that loads it, for the
    card's SASS check (``chip_smoke.py``)."""
    out = {}
    for ops in sorted(_package_root(root).glob("kernels/*/ops.py")):
        tree = ast.parse(ops.read_text())
        audit, _ = _audit_contract(tree, "", [])
        stem = loaded_source(tree)
        if stem is not None and audit is not None:
            out[stem] = audit
    return out


def check(root=None) -> list[Finding]:
    """Audit every ``csrc/*.cu`` against the ``kernels/*/ops.py`` that
    loads it."""
    pkg = _package_root(root)
    findings: list[Finding] = []
    sources = {p.stem: p for p in sorted(pkg.glob("csrc/*.cu"))}
    if not sources:
        return [Finding("kernels", "no-kernels-found", _rel(pkg), 0,
                        "found no csrc/*.cu to audit")]
    claimed = set()
    for ops in sorted(pkg.glob("kernels/*/ops.py")):
        text = ops.read_text()
        try:
            stem = loaded_source(ast.parse(text))
        except SyntaxError as e:
            findings.append(Finding(
                "kernels", "unparsable-source", _rel(ops), e.lineno or 0,
                f"unparsable module: {e.msg}"))
            continue
        if stem is None:
            continue          # a wrapper of Python only
        if stem not in sources:
            findings.append(Finding(
                "kernels", "binding-drift", _rel(ops), 1,
                f"ops.py loads csrc/{stem}.cu, which does not exist"))
            continue
        claimed.add(stem)
        findings.extend(audit_kernel(
            sources[stem].read_text(), _rel(sources[stem]), text,
            _rel(ops), has_plain=(ops.parent / "ref.py").is_file()))
    for stem in sorted(set(sources) - claimed):
        findings.append(Finding(
            "kernels", "missing-audit-contract", _rel(sources[stem]), 1,
            f"csrc/{stem}.cu has no kernels/<name>/ops.py that loads it "
            f"(and declares its AUDIT)"))
    return findings


# ---------------------------------------------------------------------------
# self-test
# ---------------------------------------------------------------------------

#: One source and binding tripping every rule; the self-test asserts each
#: fires where planted and none fires on the real tree.
_SYNTHETIC_CU = r'''
#include <cuda_runtime.h>
#define MACRO(x) { atomicAdd((float*)x, 1.0f); }
// atomicAdd(p, 1.0f) in a comment is no call
__device__ __forceinline__ void bump(int* c) { atomicAdd(c, 1); }
template <int N>
__global__ void __launch_bounds__(128) one_kernel(const float* x,
    float* __restrict__ out, int* c, int n) {
  atomicAdd(out, x[0]);
  bump(c);
  asm volatile("red.global.add.f32 [%0], %1;" :: "l"(out), "f"(x[1]));
  atomicCAS(c, 0, 1);
  asm volatile("atom.global.add.u32 %0, [%1], 1;" : "=r"(n) : "l"(c));
}
extern "C" {
int launch(const float* x, float* out, int* c, int n, int count,
           void* stream) {
  one_kernel<4><<<count * 2, 128, 0, (cudaStream_t)stream>>>(x, out, c, n);
  return 0;
}
int unbound(int a) { return a; }
}
'''

_SYNTHETIC_OPS = '''
import ctypes
from .. import _lib
AUDIT = {"float_atomics": 0, "int_atomics": {"one_kernel": ("atomicOr",)},
         "one_block_per": {"one_kernel": "count"}}
def _load():
    lib = _lib.load("synthetic")
    lib.launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.ghost.argtypes = []
    return lib
'''

#: rule → lines of the ``.cu`` (or, negated, of ``ops.py``) it must fire
#: on.
_SYNTHETIC_EXPECT = {
    "float-atomic": {9, 11, -4},
    "undeclared-atomic": {5, 12, 13, -4},
    "binding-drift": {21, -8, -9},
    "grid-drift": {18},
    "missing-plain-version": {-1},
}


def self_test() -> None:
    """Plant violations and assert every rule catches its own at the
    planted lines; the real tree must stay clean."""
    clean = check()
    assert clean == [], "clean-tree kernel findings:\n" + "\n".join(
        f.render() for f in clean)
    bad = audit_kernel(_SYNTHETIC_CU, "<synthetic.cu>", _SYNTHETIC_OPS,
                       "<synthetic.py>", has_plain=False)
    for rule, lines in _SYNTHETIC_EXPECT.items():
        got = {f.line if f.path == "<synthetic.cu>" else -f.line
               for f in bad if f.rule == rule}
        assert got == lines, f"{rule}: fired on {got}, planted {lines}"
    nocontract = audit_kernel(_SYNTHETIC_CU, "<synthetic.cu>",
                              "import ctypes\n", "<synthetic.py>")
    assert any(f.rule == "missing-audit-contract" for f in nocontract), \
        "missing AUDIT contract not flagged"
    broken = audit_kernel("__global__ void k() {\n", "<synthetic.cu>",
                          _SYNTHETIC_OPS, "<synthetic.py>")
    assert any(f.rule == "unparsable-source" for f in broken), \
        "an unbalanced source was not reported"
