"""Shared module-resolution and symbol-table helpers for the passes.

Each analyzed file becomes a :class:`ModuleInfo` (AST + import alias map +
function/class tables); a :class:`Project` holds all of them and resolves

* call/attribute expressions to *dotted names* with import aliases
  unfolded (``rand.split`` -> ``repro_torch.rand.split`` under
  ``from .. import rand`` in a module of ``repro_torch``, or ``R.split``
  under ``from repro_torch import rand as R``), and
* dotted names back to :class:`FunctionDef` nodes across the analyzed
  files (best-effort, for callgraph reachability in the purity pass).

Everything is lexical — no imports are executed.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple


def _module_name(path: str) -> str:
    """Best-effort dotted module name from a repo-relative path
    (``src/repro_torch/core/pool.py`` -> ``repro_torch.core.pool``)."""
    rel = path.replace(os.sep, "/")
    for prefix in ("src/",):
        if rel.startswith(prefix):
            rel = rel[len(prefix):]
    if rel.endswith(".py"):
        rel = rel[:-3]
    if rel.endswith("/__init__"):
        rel = rel[: -len("/__init__")]
    return rel.replace("/", ".")


@dataclasses.dataclass
class FunctionEntry:
    qualname: str            # dotted within the module, e.g. Cls.method
    node: ast.FunctionDef
    module: "ModuleInfo"


class ModuleInfo:
    """One parsed source file + its lexical tables."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.name = _module_name(self.relpath)
        # import alias -> full dotted prefix ("np" -> "numpy",
        # "rand" -> "repro_torch.rand" under `from .. import rand`)
        self.imports: Dict[str, str] = {}
        # local top-level name -> dotted target for `from .mod import fn`
        self.functions: Dict[str, FunctionEntry] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self._index()

    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:  # relative: anchor at this module's package
                    pkg = self.name.split(".")
                    # a package's __init__ is its package: `from . import x`
                    # there names a sibling of the package's own modules
                    up = node.level - (1 if self.relpath.endswith(
                        "/__init__.py") or self.relpath == "__init__.py"
                        else 0)
                    pkg = pkg[: len(pkg) - up]
                    base = ".".join(pkg + ([node.module]
                                           if node.module else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{base}.{a.name}" if base else a.name
                    self.imports[a.asname or a.name] = full
        for node in self.tree.body:
            self._index_def(node, prefix="")

    def _index_def(self, node: ast.AST, prefix: str) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            q = f"{prefix}{node.name}"
            self.functions[q] = FunctionEntry(q, node, self)
        elif isinstance(node, ast.ClassDef):
            self.classes[f"{prefix}{node.name}"] = node
            for sub in node.body:
                self._index_def(sub, prefix=f"{prefix}{node.name}.")

    # -- expression -> dotted name -------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain to an alias-unfolded dotted name
        (None for anything not a plain chain, e.g. a call result)."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.imports.get(node.id, node.id)
        return ".".join([head] + list(reversed(parts)))

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)


class Project:
    """All analyzed modules + cross-module lookup."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules: List[ModuleInfo] = list(modules)
        self.by_name: Dict[str, ModuleInfo] = {m.name: m for m in self.modules}
        # dotted function name -> entry, for callgraph resolution
        self.func_index: Dict[str, FunctionEntry] = {}
        for m in self.modules:
            for q, entry in m.functions.items():
                self.func_index[f"{m.name}.{q}"] = entry

    def resolve_function(self, module: ModuleInfo, dotted: str,
                         ) -> Optional[FunctionEntry]:
        """Find the FunctionDef a dotted name refers to, if it lives in an
        analyzed module.  Tries, in order: a local function of ``module``,
        the fully-qualified name, and the common ``pkg.mod.fn`` /
        ``pkg.mod.Cls.fn`` spellings reachable through the alias map."""
        if dotted in module.functions:
            return module.functions[dotted]
        candidates = [dotted, f"{module.name}.{dotted}"]
        # `from . import x as y` style aliases resolve in .dotted() already;
        # also try treating the first segment as a module alias target.
        head, _, rest = dotted.partition(".")
        target = module.imports.get(head)
        if target and rest:
            candidates.append(f"{target}.{rest}")
        for cand in candidates:
            if cand in self.func_index:
                return self.func_index[cand]
        return None


def load_project(files: List[Tuple[str, str]]) -> Project:
    """Build a project from ``(abs_path, repo_relative_path)`` pairs,
    skipping files with syntax errors (reported by the engine)."""
    mods = []
    for abs_path, rel in files:
        with open(abs_path, encoding="utf-8") as fh:
            source = fh.read()
        mods.append(ModuleInfo(abs_path, rel, source))
    return Project(mods)


# ---------------------------------------------------------------------------
# Small AST conveniences shared by the passes
# ---------------------------------------------------------------------------
def const_str(node: ast.AST) -> Optional[str]:
    return node.value if isinstance(node, ast.Constant) \
        and isinstance(node.value, str) else None


def terminates(body: List[ast.stmt]) -> bool:
    """True when a block always leaves the enclosing suite (so code after
    an ``if`` whose body terminates is effectively the else arm)."""
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))


def unwrap_partial(module: ModuleInfo, node: ast.AST) -> ast.AST:
    """``partial(f, ...)`` / ``functools.partial(f, ...)`` -> ``f``."""
    if isinstance(node, ast.Call):
        name = module.call_name(node)
        if name and name.split(".")[-1] == "partial" and node.args:
            return unwrap_partial(module, node.args[0])
    return node


def iter_functions(module: ModuleInfo):
    """Yield (qualname, FunctionDef) for every def, including methods and
    nested defs (nested get ``outer.<locals>.inner`` style names)."""
    def rec(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from rec(child, f"{q}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)
    yield from rec(module.tree, "")
