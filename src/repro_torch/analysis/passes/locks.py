"""Pass 2 — lock discipline (LCK01 threads, LCK02 asyncio): the
mechanized TOCTOU check, in both concurrency flavors.

LCK01: for every class that owns a ``threading.Lock``/``RLock``
attribute (``self._lock = threading.Lock()`` in ``__init__``), collect
the set of instance attributes that are ever *written* inside a
``with self._lock:`` block in any method.  Those attributes form the
class's locked state; any read or write of them lexically outside a lock
block (in any method other than ``__init__``, which happens-before
publication) is flagged.

This is the bug class the pool server's tests once found the hard way:
a liveness / counter / cursor read outside the lock racing a locked
writer (``kill()``/``revive()`` vs an unlocked ``up`` pre-check).

LCK02 is the same contract for ``asyncio.Lock``/``Condition``/
``Semaphore``/``BoundedSemaphore`` attributes guarded by ``async with``:
once a class elects to guard state with an asyncio lock, touching that
state on a path that does not hold it races across the await points
inside other holders' critical sections.  Note what LCK02 deliberately
does NOT flag: loop-owned state mutated only in await-free sections and
never written under the lock (the single-writer event-loop ownership
pattern — atomic under cooperative scheduling; see docs/invariants.md).
Only attributes the class itself puts under the lock join the contract.

Helper methods that are only ever called with the lock held are
legitimate — mark them with ``# repro-lint: disable=LCK01 -- <why>``
(or ``LCK02``) at the access.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..findings import Finding
from ..symbols import ModuleInfo, Project

THREAD_LOCK_TYPES = {"Lock", "RLock", "Condition"}
ASYNC_LOCK_TYPES = {"Lock", "Condition", "Semaphore", "BoundedSemaphore"}

#: flavor -> (finding code, human label)
_FLAVORS = {
    "thread": ("LCK01", "with self.<lock>"),
    "async": ("LCK02", "async with self.<lock>"),
}


def _lock_attrs(cls: ast.ClassDef, module: ModuleInfo) -> Dict[str, str]:
    """``{attr: flavor}`` for attributes assigned from
    threading.Lock()/RLock() ('thread') or asyncio.Lock()/Semaphore()/...
    ('async') anywhere in the class body (usually __init__).  A bare
    ``Lock()`` (from-imported) counts as a thread lock — the historical
    reading, and asyncio code conventionally keeps the module prefix."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call):
            continue
        name = module.call_name(node.value) or ""
        parts = name.split(".")
        flavor = None
        if parts[0] == "asyncio" and parts[-1] in ASYNC_LOCK_TYPES:
            flavor = "async"
        elif parts[-1] in THREAD_LOCK_TYPES and (len(parts) == 1
                                                 or parts[0] == "threading"):
            flavor = "thread"
        if flavor is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name) and t.value.id == "self":
                out[t.attr] = flavor
    return out


def _self_attr(node: ast.AST) -> str:
    """'attr' for a ``self.attr`` expression, else ''."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


class _MethodScan(ast.NodeVisitor):
    """Record self-attribute accesses split by held-lock flavor."""

    def __init__(self, lock_attrs: Dict[str, str]):
        self.lock_attrs = lock_attrs
        self.depth = {"thread": 0, "async": 0}
        # (attr, line, held_flavors, is_write)
        self.accesses: List[Tuple[str, int, frozenset, bool]] = []

    def _held_flavor(self, node, is_async: bool) -> str:
        """Flavor of the lock this with-statement holds, or ''.
        ``with self._tlock:`` holds a thread lock; ``async with
        self._alock:`` holds an asyncio lock. A mismatched pairing is a
        runtime bug on its own — not silently blessed as held here.
        self._lock.acquire()-style guards are not `with` blocks; only
        the context-manager form (optionally aliased) counts."""
        want = "async" if is_async else "thread"
        for item in node.items:
            a = _self_attr(item.context_expr)
            if a and self.lock_attrs.get(a) == want:
                return want
        return ""

    def _visit_with(self, node, is_async: bool) -> None:
        held = self._held_flavor(node, is_async)
        for item in node.items:
            self.visit(item.context_expr)
        if held:
            self.depth[held] += 1
        for st in node.body:
            self.visit(st)
        if held:
            self.depth[held] -= 1

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node, is_async=False)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node, is_async=True)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr and attr not in self.lock_attrs:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            held = frozenset(f for f, d in self.depth.items() if d > 0)
            self.accesses.append((attr, node.lineno, held, is_write))
        self.generic_visit(node)

    def visit_FunctionDef(self, node):  # nested defs: new method context,
        pass                            # handled separately by the caller

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _scan_class(module: ModuleInfo, cls: ast.ClassDef) -> List[Finding]:
    lock_attrs = _lock_attrs(cls, module)
    if not lock_attrs:
        return []
    per_method: Dict[str, _MethodScan] = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _MethodScan(lock_attrs)
            for st in node.body:
                scan.visit(st)
            per_method[node.name] = scan
            # nested defs inside a method (worker closures) run on their
            # own thread context — scan them as their own pseudo-methods
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub is not node:
                    subscan = _MethodScan(lock_attrs)
                    for st in sub.body:
                        subscan.visit(st)
                    per_method[f"{node.name}.<locals>.{sub.name}"] = subscan

    # per flavor: locked state = attrs ever written while holding a lock
    # of that flavor
    locked_state: Dict[str, Set[str]] = {f: set() for f in _FLAVORS}
    for name, scan in per_method.items():
        if name.split(".")[0] in ("__init__", "__new__"):
            continue
        for attr, _, held, is_write in scan.accesses:
            if is_write:
                for flavor in held:
                    locked_state[flavor].add(attr)

    findings: List[Finding] = []
    for flavor, (code, label) in _FLAVORS.items():
        state = locked_state[flavor]
        if not state:
            continue
        for name, scan in per_method.items():
            if name.split(".")[0] in ("__init__", "__new__"):
                continue
            for attr, line, held, is_write in scan.accesses:
                if attr in state and flavor not in held:
                    verb = "written" if is_write else "read"
                    findings.append(Finding(
                        code, module.relpath, line,
                        f"{cls.name}.{attr} is written under "
                        f"`{label}` elsewhere but {verb} here "
                        f"without the lock (method {name}) — a TOCTOU "
                        f"race"))
    return findings


def run(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for module in project.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_scan_class(module, node))
    return findings
