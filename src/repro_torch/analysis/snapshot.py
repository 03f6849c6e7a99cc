"""Static ExperimentState snapshot-coverage extraction.

The durability contract is that a snapshot of one ``ExperimentState``
(:mod:`repro_torch.checkpoint`) is *sufficient* to resume any fused
driver bit for bit. That only holds while every value the drivers carry
from one epoch to the next has a home in ``ExperimentState`` — a new
carried value added to a driver without a matching state field would
silently escape checkpointing and break kill -9 resume.

The JAX package's drivers are ``lax.scan`` bodies that unpack a
``<names> = carry`` tuple. The port's ``fused_scan`` and
``fused_scan_async`` are Python loops over epochs (ticks) that rebind
locals instead, so the carry is read from the loop:

* :func:`scan_carry_names` takes each driver's epoch loop (the first
  ``for``/``while`` of its body) and collects the names that the loop
  body rebinds *and* that are bound before the loop (parameters or
  earlier assignments) — the values one epoch hands to the next.
  Temporaries first bound inside the loop (the split keys, the step's
  output tuple) are not carried. The names are ordered as the driver
  returns them (the whole carry goes in and comes out), any others after
  them in the order of their first rebinding;
* :func:`experiment_state_fields` reads the ``ExperimentState``
  NamedTuple definition in ``core/types.py``;
* :func:`check_coverage` confirms every carried name maps onto a state
  field and that the leftover fields are exactly the documented
  host-managed set.

tests/test_torch_analysis.py runs this as a meta-test and holds the
carried names to the JAX package's extraction, alias for alias.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .symbols import Project

# The segment drivers whose carry must be snapshot-covered, and the local
# spellings that map onto an ExperimentState field of a different name
# (the async drivers call the epoch counter a tick).
SCAN_FUNCTIONS = {
    "repro_torch.core.evolution": "fused_scan",
    "repro_torch.core.async_migration": "fused_scan_async",
}
STATE_MODULE = "repro_torch.core.types"
CARRY_ALIASES = {"tick": "epoch"}
# Fields deliberately outside the carry, maintained by the host-side
# segment loop / elastic resize. "astate" is host-managed only for the
# *sync* carry — the async loop carries it.
HOST_MANAGED = {"stats", "next_uuid"}


def _store_names(nodes) -> List[str]:
    """Names stored by assignments / loop targets / with-targets in
    ``nodes``' statements (nested defs skipped), in source order."""
    out: List[str] = []

    def targets(t):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                targets(el)
        elif isinstance(t, ast.Starred):
            targets(t.value)

    def visit(st):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            for t in st.targets:
                targets(t)
        elif isinstance(st, (ast.AugAssign, ast.AnnAssign)):
            targets(st.target)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            targets(st.target)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                if item.optional_vars is not None:
                    targets(item.optional_vars)
        for field in ("body", "orelse", "finalbody"):
            for sub in getattr(st, field, []) or []:
                if isinstance(sub, ast.stmt):
                    visit(sub)
        for h in getattr(st, "handlers", []) or []:
            for sub in h.body:
                visit(sub)

    for st in nodes:
        visit(st)
    return out


def _epoch_loop(fn: ast.FunctionDef) -> Optional[int]:
    for i, st in enumerate(fn.body):
        if isinstance(st, (ast.For, ast.While, ast.AsyncFor)):
            return i
    return None


def loop_carry_names(fn: ast.FunctionDef) -> Optional[List[str]]:
    """The names ``fn``'s epoch loop carries (see the module docstring),
    or None when ``fn`` has no loop."""
    at = _epoch_loop(fn)
    if at is None:
        return None
    loop = fn.body[at]
    args = fn.args
    before: Set[str] = {a.arg for a in (args.posonlyargs + args.args
                                        + args.kwonlyargs)}
    before.update(_store_names(fn.body[:at]))
    inner = _store_names(loop.body)
    carried: List[str] = []
    for name in inner:
        if name in before and name not in carried:
            carried.append(name)
    returned: List[str] = []
    for st in fn.body[at + 1:]:
        if isinstance(st, ast.Return) and isinstance(st.value, ast.Tuple):
            returned = [e.id for e in st.value.elts
                        if isinstance(e, ast.Name)]
    ordered = [n for n in returned if n in carried]
    return ordered + [n for n in carried if n not in ordered]


def scan_carry_names(project: Project) -> Dict[str, List[str]]:
    """``{driver qualname: [carried names]}`` extracted from each
    driver's epoch loop."""
    out: Dict[str, List[str]] = {}
    for module in project.modules:
        fn_name = SCAN_FUNCTIONS.get(module.name)
        if fn_name is None:
            continue
        entry = module.functions.get(fn_name)
        if entry is None:
            continue
        names = loop_carry_names(entry.node)
        if names is not None:
            out[f"{module.name}.{fn_name}"] = names
    return out


def experiment_state_fields(project: Project) -> List[str]:
    """Field names of the ``ExperimentState`` NamedTuple, in order."""
    for module in project.modules:
        if module.name != STATE_MODULE:
            continue
        cls = module.classes.get("ExperimentState")
        if cls is None:
            break
        return [stmt.target.id for stmt in cls.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)]
    return []


def check_coverage(project: Project) -> List[str]:
    """Problems with the carry<->state correspondence (empty = covered)."""
    problems: List[str] = []
    fields = experiment_state_fields(project)
    if not fields:
        return [f"ExperimentState not found in {STATE_MODULE}"]
    carries = scan_carry_names(project)
    for module, fn in SCAN_FUNCTIONS.items():
        if f"{module}.{fn}" not in carries:
            problems.append(f"no epoch loop found in {module}.{fn}")
    covered = set()
    for qualname, names in carries.items():
        for name in names:
            field = CARRY_ALIASES.get(name, name)
            if field not in fields:
                problems.append(
                    f"{qualname} carries {name!r} with no ExperimentState "
                    f"field {field!r} — it would escape snapshots")
            covered.add(field)
    for field in fields:
        if field not in covered and field not in HOST_MANAGED:
            problems.append(
                f"ExperimentState.{field} is neither loop-carried nor in "
                f"the documented host-managed set {sorted(HOST_MANAGED)}")
    return problems
