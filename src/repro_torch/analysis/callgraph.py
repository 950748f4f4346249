"""Module-aware call graph over the repro_torch package (pure AST).

The interprocedural dataflow pass (:mod:`.dataflow`) needs to answer
questions no file-local lint can: *who calls this function, and with
what argument expressions?*  This module builds that index without
importing anything — every module is parsed once, imports (including
relative ``from ..core import x`` forms) are resolved to dotted module
paths, and calls whose target statically resolves to another in-package
function or class constructor become edges carrying the original
``ast.Call`` node, so a taint analysis can walk from a formal parameter
back to every actual argument in the package.

Resolution is deliberately conservative: only targets we can name
statically (direct calls, imported names, ``module.attr`` chains,
``self.method`` inside a class, and ``Class(...)`` constructors mapping
to ``Class.__init__``) produce edges.  Dynamic dispatch produces *no*
edge — callers must treat "no edge" as "unknown", never as "safe".
"""

from __future__ import annotations

import ast
import dataclasses


@dataclasses.dataclass
class FunctionInfo:
    """One function or method, addressable by qualified name
    (``pkg.module.fn`` or ``pkg.module.Class.method``)."""
    qualname: str
    module: str
    path: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    class_name: str | None = None

    @property
    def params(self) -> list[str]:
        """Positional parameter names, ``self``/``cls`` stripped for
        methods."""
        names = [a.arg for a in self.node.args.posonlyargs
                 + self.node.args.args]
        if self.class_name and names and names[0] in ("self", "cls"):
            names = names[1:]
        return names


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    source: str
    tree: ast.Module
    imports: dict[str, str]     # local alias -> dotted target


@dataclasses.dataclass
class CallSite:
    """One resolved call: ``call`` appears inside ``caller`` (or at
    module level when ``caller`` is None) and targets ``callee``."""
    callee: str
    call: ast.Call
    module: str
    caller: FunctionInfo | None


def _resolve_import_module(current: str, node: ast.ImportFrom) -> str:
    """Dotted module an ``ImportFrom`` refers to, resolving relative
    levels against the importing module's own dotted name."""
    if node.level == 0:
        return node.module or ""
    parts = current.split(".")
    base = parts[:len(parts) - node.level]
    if node.module:
        base.append(node.module)
    return ".".join(base)


def module_imports(name: str, tree: ast.Module) -> dict[str, str]:
    """Local alias → fully-dotted imported target for one module."""
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            mod = _resolve_import_module(name, node)
            for a in node.names:
                target = f"{mod}.{a.name}" if mod else a.name
                imports[a.asname or a.name] = target
    return imports


def _dotted(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class CallGraph:
    """Functions, classes and resolved call edges over a module set."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self._sites: dict[str, list[CallSite]] = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, modules: dict[str, tuple[str, str]]) -> "CallGraph":
        """``modules`` maps dotted module name → (source, display path).
        Unparsable modules are skipped (the lint pass reports those)."""
        g = cls()
        for name, (source, path) in sorted(modules.items()):
            try:
                tree = ast.parse(source)
            except SyntaxError:
                continue
            g.modules[name] = ModuleInfo(
                name, path, source, tree, module_imports(name, tree))
        for mod in g.modules.values():
            g._collect_functions(mod)
        for mod in g.modules.values():
            g._collect_calls(mod)
        return g

    def _collect_functions(self, mod: ModuleInfo) -> None:
        for stmt in mod.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{mod.name}.{stmt.name}"
                self.functions[q] = FunctionInfo(q, mod.name, mod.path,
                                                 stmt)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        q = f"{mod.name}.{stmt.name}.{sub.name}"
                        self.functions[q] = FunctionInfo(
                            q, mod.name, mod.path, sub,
                            class_name=stmt.name)

    def _collect_calls(self, mod: ModuleInfo) -> None:
        # Attribute every call to its innermost *named* enclosing
        # function (module-level calls get caller=None).  Defs nested
        # inside statement bodies attribute to the outer function —
        # coarse but sound for taint purposes.
        def handle(stmts, caller: FunctionInfo | None,
                   cls: str | None) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    q = f"{mod.name}." + \
                        (f"{cls}.{stmt.name}" if cls else stmt.name)
                    handle(stmt.body, self.functions.get(q, caller),
                           cls)
                elif isinstance(stmt, ast.ClassDef):
                    handle(stmt.body, caller, stmt.name)
                else:
                    for node in ast.walk(stmt):
                        if isinstance(node, ast.Call):
                            callee = self.resolve_call(mod, node, cls)
                            if callee is not None:
                                self._sites.setdefault(callee, [])\
                                    .append(CallSite(callee, node,
                                                     mod.name, caller))

        handle(mod.tree.body, None, None)

    # -- queries -------------------------------------------------------------

    def resolve_call(self, mod: ModuleInfo, call: ast.Call,
                     cls: str | None = None) -> str | None:
        """Qualified name of an in-package function/constructor this
        call targets, or None when the target is dynamic/external."""
        dotted = _dotted(call.func)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        if head == "self" and cls and rest and "." not in rest:
            return self._known(f"{mod.name}.{cls}.{rest}")
        if not rest and f"{mod.name}.{head}" in self.functions:
            return f"{mod.name}.{head}"
        target = mod.imports.get(head)
        if target is None:
            if not rest:
                return self._known_ctor(f"{mod.name}.{head}")
            return None
        full = f"{target}.{rest}" if rest else target
        return self._known(full) or self._known_ctor(full)

    def _known(self, qualname: str) -> str | None:
        return qualname if qualname in self.functions else None

    def _known_ctor(self, qualname: str) -> str | None:
        init = f"{qualname}.__init__"
        return init if init in self.functions else None

    def sites_for(self, qualname: str) -> list[CallSite]:
        return self._sites.get(qualname, [])

    def full_target(self, mod: ModuleInfo, call: ast.Call) -> str | None:
        """Fully-dotted (possibly external) target of a call, with the
        head alias resolved through the module's imports —
        ``np.random.default_rng`` → ``numpy.random.default_rng``."""
        dotted = _dotted(call.func)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        target = mod.imports.get(head, head)
        return f"{target}.{rest}" if rest else target


def argument_for(call: ast.Call, func: FunctionInfo,
                 param: str) -> ast.expr | None:
    """The actual argument expression bound to ``param`` at this call
    site (positional or keyword), or None if unbound/starred."""
    params = func.params
    if param not in params:
        return None
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    idx = params.index(param)
    if idx < len(call.args):
        arg = call.args[idx]
        if not isinstance(arg, ast.Starred):
            return arg
    return None
