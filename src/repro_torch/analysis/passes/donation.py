"""Pass 5 — consumed-argument discipline (DON01).

The JAX package's DON01 guards ``jax.jit(..., donate_argnums=...)``: a
donated buffer belongs to XLA after the call.  The port has no
donation; its counterpart is a callable that updates an argument in
place and returns it, whose docstring says that the argument passed in
is consumed.  Reading such a name again after the call reads the *new*
values where the code expects the old ones (a PBT member's payload, a
baseline state kept for comparison, a prefill's caches) — and nothing
warns.

The consuming callables are held in two tables, with their consumed
positions (and the keyword names of those positions), as the JAX
package holds ``JIT_TAILS``:

* :data:`CONSUMING_MAKERS` — builders whose *result* consumes:
  ``launch/steps.py::make_train_step`` builds ``step(state, batch)``,
  which updates the state's tensors in place (the counterpart of the
  JAX package's ``donate_argnums=(0,)`` in ``launch/train.py`` and
  ``launch/dryrun.py``'s train cell), and ``make_decode_step`` builds
  ``decode(inputs)``, which writes the ring caches in ``inputs`` in
  place (``launch/dryrun.py``'s decode cell donates its caches);
* :data:`CONSUMING_FUNCTIONS` — functions that consume directly:
  ``optim/adamw.py::adamw_update(grads, state, params)`` updates
  ``state`` and ``params`` in place.

The JAX package's other donation sites — the fused drivers' segment
scans (``core/evolution.py``, ``core/async_migration.py``, the sharded
drivers) — have no in-place counterpart: the port's ``fused_scan`` and
``fused_scan_async`` build new island, pool and async-state tensors
each epoch, and the caller's keep their values.

Per function scope, lexically: a name bound to an expression that calls
a maker is a consuming callable; at each call of a consuming callable
the names (or attribute chains such as ``state.opt``) passed in consumed
positions become dead after the call line, and a later read of such a
name (or of an attribute chain under it), without an intervening
re-bind of it or of a prefix of it, is flagged.  Re-binding (the
``state, metrics = step(state, batch)`` carry idiom) revalidates
immediately because the call's loads happen before the assignment's
store.  Loops are walked twice, to catch a name consumed in one
iteration and read in the next.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ..findings import Finding
from ..symbols import ModuleInfo, Project, iter_functions

#: maker tail -> {consumed position: keyword name} of the callable it
#: returns
CONSUMING_MAKERS: Dict[str, Dict[int, str]] = {
    "make_train_step": {0: "state"},
    "make_decode_step": {0: "inputs"},
}
#: function tail -> {consumed position: keyword name}
CONSUMING_FUNCTIONS: Dict[str, Dict[int, str]] = {
    "adamw_update": {1: "state", 2: "params"},
}


def _chain(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None (lexical, no
    import resolution: these are local values)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + list(reversed(parts)))


def _made_positions(module: ModuleInfo, expr: ast.AST,
                    ) -> Optional[Dict[int, str]]:
    """The consumed positions of the callable a maker call inside
    ``expr``'s subtree returns."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        tail = (module.call_name(node) or "").split(".")[-1]
        if tail in CONSUMING_MAKERS:
            return CONSUMING_MAKERS[tail]
    return None


class _Scope:
    def __init__(self, module: ModuleInfo, fn: ast.FunctionDef):
        self.m = module
        self.fn = fn
        self.consumers: Dict[str, Dict[int, str]] = {}
        self.dead: Dict[str, Tuple[int, str]] = {}  # chain -> (line, how)
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        self._walk_block(self.fn.body)
        return self.findings

    # -- linear walk, loads before stores per statement ----------------------
    def _walk_block(self, stmts: List[ast.stmt]) -> None:
        for st in stmts:
            self._walk_stmt(st)

    def _walk_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self._visit_expr(st.value)
            pos = _made_positions(self.m, st.value)
            for t in st.targets:
                self._store_target(t)
            if pos is not None and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                self.consumers[st.targets[0].id] = pos
            return
        if isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                self._visit_expr(st.value)
            self._store_target(st.target)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._visit_expr(st.iter)
            self._store_target(st.target)
            # two passes over the body: catches consumed-in-iteration-1,
            # read-in-iteration-2 without a re-bind
            self._walk_block(st.body)
            self._walk_block(st.body)
            self._walk_block(st.orelse)
            return
        if isinstance(st, ast.While):
            self._visit_expr(st.test)
            self._walk_block(st.body)
            self._walk_block(st.body)
            self._walk_block(st.orelse)
            return
        if isinstance(st, ast.If):
            self._visit_expr(st.test)
            dead_before = dict(self.dead)
            self._walk_block(st.body)
            dead_body = self.dead
            self.dead = dict(dead_before)
            self._walk_block(st.orelse)
            # conservative join: dead in either arm stays dead
            self.dead.update(dead_body)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._visit_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._store_target(item.optional_vars)
            self._walk_block(st.body)
            return
        if isinstance(st, ast.Try):
            self._walk_block(st.body)
            for h in st.handlers:
                self._walk_block(h.body)
            self._walk_block(st.orelse)
            self._walk_block(st.finalbody)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._visit_expr(child)

    def _store_target(self, target: ast.AST) -> None:
        chain = _chain(target)
        if chain is not None:
            # re-binding a name (or an attribute chain) revives it and
            # every chain under it
            for d in [d for d in self.dead
                      if d == chain or d.startswith(chain + ".")]:
                del self.dead[d]
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._store_target(el)
        elif isinstance(target, ast.Starred):
            self._store_target(target.value)

    def _dead_hit(self, chain: str) -> Optional[str]:
        for d in self.dead:
            if chain == d or chain.startswith(d + "."):
                return d
        return None

    def _visit_expr(self, expr: ast.AST) -> None:
        # loads: the outermost Name/Attribute chains of the expression
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(node.ctx, ast.Load):
                chain = _chain(node)
                if chain is not None:
                    hit = self._dead_hit(chain)
                    if hit is not None:
                        line, how = self.dead.pop(hit)
                        self.findings.append(Finding(
                            "DON01", self.m.relpath, node.lineno,
                            f"{hit!r} was consumed by {how} at line "
                            f"{line} (it updates its argument in place "
                            f"and returns it) and is read here without "
                            f"re-binding — it holds the new values now"))
                    continue
            stack.extend(ast.iter_child_nodes(node))
        # process consumptions after recording loads (args load first)
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            pos, how = None, ""
            if isinstance(node.func, ast.Name) \
                    and node.func.id in self.consumers:
                pos, how = self.consumers[node.func.id], \
                    f"{node.func.id}()"
            else:
                tail = (self.m.call_name(node) or "").split(".")[-1]
                if tail in CONSUMING_FUNCTIONS:
                    pos, how = CONSUMING_FUNCTIONS[tail], f"{tail}()"
            if pos is None:
                continue
            args = [node.args[p] for p in pos if p < len(node.args)]
            args += [k.value for k in node.keywords if k.arg in pos.values()]
            for arg in args:
                chain = _chain(arg)
                if chain is not None:
                    self.dead[chain] = (node.lineno, how)


def run(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for module in project.modules:
        for _, fn in iter_functions(module):
            findings.extend(_Scope(module, fn).run())
    return findings
