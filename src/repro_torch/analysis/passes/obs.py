"""Pass — observability clock discipline (OBS01).

OBS01: wall-clock ``time.time()`` differenced into a duration.  The
wall clock steps (NTP slew/step, manual adjustment, leap smearing), so
``time.time() - t0`` can go backwards or jump mid-measurement — the
class once fixed by hand in ``benchmarks/run.py`` and the reason every
:mod:`repro_torch.obs.trace` span uses ``time.perf_counter``.  Durations
must come from a monotonic clock; wall time is for *timestamps* only.

Detection is per scope (module body, each function body — nested defs
are their own scope): names assigned from ``time.time()`` /
``time.time_ns()`` become wall variables, and any subtraction whose
operand is a wall variable or a direct wall-clock call is flagged.
Subtracting a literal constant is exempt — ``time.time() - 3600`` is
computing a *time point* (an hour ago), not measuring elapsed time.
``self.<attr>`` assignments from the wall clock join the wall set
module-wide (the cross-method ``self._t0`` stamp-then-diff pattern).

Legitimate wall-clock timestamps (journal entries, log lines, file
mtimes) are untouched — only subtraction triggers the rule.  A genuine
epoch-seconds difference (comparing two *external* wall timestamps, e.g.
journal replay ages) can be suppressed with
``# repro-lint: disable=OBS01 -- <why>``.
"""
from __future__ import annotations

import ast
from typing import List, Set

from ..findings import Finding
from ..symbols import ModuleInfo, Project

WALL_CALLS = {"time.time", "time.time_ns"}


def _is_wall_call(module: ModuleInfo, node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (module.call_name(node) or "") in WALL_CALLS)


def _self_attr(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


class _ScopeScan(ast.NodeVisitor):
    """One lexical scope: track wall-clock bindings, flag subtractions."""

    def __init__(self, module: ModuleInfo, wall_attrs: Set[str]):
        self.m = module
        self.wall_vars: Set[str] = set()
        self.wall_attrs = wall_attrs     # module-wide self.<attr> stamps
        self.findings: List[Finding] = []

    # nested defs/lambdas are separate scopes, scanned by the caller
    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _bind(self, target: ast.AST, wall: bool) -> None:
        if isinstance(target, ast.Name):
            (self.wall_vars.add if wall
             else self.wall_vars.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, wall)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        wall = _is_wall_call(self.m, node.value)
        for t in node.targets:
            self._bind(t, wall)
            attr = _self_attr(t)
            if attr and wall:
                self.wall_attrs.add(attr)

    def _wallish(self, node: ast.AST) -> bool:
        if _is_wall_call(self.m, node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.wall_vars
        attr = _self_attr(node)
        return bool(attr) and attr in self.wall_attrs

    def visit_BinOp(self, node: ast.BinOp) -> None:
        self.generic_visit(node)
        if not isinstance(node.op, ast.Sub):
            return
        pairs = ((node.left, node.right), (node.right, node.left))
        for wall_side, other in pairs:
            if self._wallish(wall_side) \
                    and not isinstance(other, ast.Constant):
                self.findings.append(Finding(
                    "OBS01", self.m.relpath, node.lineno,
                    "wall-clock time.time() differenced into a duration "
                    "— the wall clock can step backwards under NTP; use "
                    "time.perf_counter() (monotonic) for elapsed time"))
                return


def _scan_module(module: ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    wall_attrs: Set[str] = set()
    scopes: List[List[ast.stmt]] = [module.tree.body]
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append(node.body)
    # two rounds: round one lets every scope contribute its self.<attr>
    # wall stamps, round two flags with the complete module-wide set
    for _ in range(2):
        findings = []
        for body in scopes:
            scan = _ScopeScan(module, wall_attrs)
            for st in body:
                scan.visit(st)
            findings.extend(scan.findings)
    return findings


def run(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for module in project.modules:
        findings.extend(_scan_module(module))
    return findings
