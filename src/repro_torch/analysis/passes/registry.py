"""Pass 4 — registry contracts (REG01/REG02/REG03).

The registrations are read in every form the port writes them:

* decorators, as in the JAX package: ``@register_kernel(op, kind,
  impl)``, ``@register_topology(name)``, ``@register_policy(name)``;
* a registering decorator called on a callable:
  ``registry.register_kernel("generation", _kind, "jnp")(fn)``
  (``core/ga.py``);
* the tables written directly: ``KERNELS.update({(op, kind, impl): fn,
  ...})`` and ``KERNELS[(op, kind, impl)] = fn`` (``kernels/ga/ops.py``;
  ``TOPOLOGIES`` and ``ACCEPTANCE_POLICIES`` the same way).

Each key element is a string literal or the variable of an enclosing
``for`` loop over a literal tuple or list of strings; nested loops give
every combination.  A key that does not fold to strings (the
registering functions' own bodies) is not a registration.

REG01 — every registration is checked against its protocol signature.
The callable checked is the function registered: a ``def`` named
directly, or, for a name bound to a call of a local factory
(``generation = _entry(_pallas)``), the function that factory returns.

* kernel ``generation``: accepts 6 positional arguments
  ``(rng, pop, fitness, pop_size, cfg, genome)``; ``generation_eval``:
  7 (``... fused``).  Accepting means no more required positional
  parameters than that and room for that many (a defaulted ``fused=None``
  lets one callable serve both ops); extra *keyword-only* params with
  defaults (``consts=``, tile sizes) are fine.
* topology: >= 4 positional ``(pool, bests_genome, bests_fitness, rng)``
  plus keyword-only ``{mig, axis, epoch, available}`` (or ``**kwargs``).
* acceptance policy: 6 positional ``(pool_genomes, pool_fitness,
  cand_genomes, cand_fitness, cand_valid, rng)`` plus keyword-only
  ``{ptr, count, acc}`` (or ``**kwargs``).

REG02 — completeness matrices with explicit exemptions via the baseline:
the kernel (op x genome_kind x impl) cube must be full for every impl
that appears at all (a half-registered impl dispatches fine in the smoke
you wrote and KeyErrors in the driver you didn't), and every registered
acceptance policy must appear in ``HOST_MIRRORED`` (PoolServer refuses
non-mirrored policies at construction).

REG03 — acceptance dispatch at insert sites: any call to
``pool_put_batch`` / ``pool_insert_host`` outside ``core/pool.py`` and
``core/acceptance.py`` must thread a policy (``acc=`` keyword) — a bare
insert silently bypasses the acceptance engine at one site while every
other site applies it.

The statically-extracted matrices are exported via
:func:`collect_registrations` so a runtime check can assert they match
``repro_torch.kernels.ga.registry.registered_kernels()``,
``core/migration.py::TOPOLOGIES``, ``core/acceptance.py::
ACCEPTANCE_POLICIES`` and ``HOST_MIRRORED`` at head.
"""
from __future__ import annotations

import ast
import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..findings import Finding
from ..symbols import ModuleInfo, Project

KERNEL_POSITIONAL = {"generation": 6, "generation_eval": 7}
TOPOLOGY_KWONLY = {"mig", "axis", "epoch", "available"}
POLICY_KWONLY = {"ptr", "count", "acc"}

DECORATOR_FAMILIES = {"register_kernel": "kernel",
                      "register_topology": "topology",
                      "register_policy": "acceptance"}
TABLE_FAMILIES = {"KERNELS": "kernel", "TOPOLOGIES": "topology",
                  "ACCEPTANCE_POLICIES": "acceptance"}


@dataclasses.dataclass(frozen=True)
class Registration:
    family: str                 # kernel | topology | acceptance
    key: Tuple[str, ...]        # (op, kind, impl) or (name,)
    func: str
    path: str
    line: int


Env = Dict[str, str]


def _fold(node: ast.AST, env: Env) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return env[node.id]
    return None


def _fold_key(node: ast.AST, env: Env) -> Optional[Tuple[str, ...]]:
    elts = node.elts if isinstance(node, (ast.Tuple, ast.List)) else [node]
    vals = [_fold(e, env) for e in elts]
    if any(v is None for v in vals):
        return None
    return tuple(vals)  # type: ignore[arg-type]


def _fold_args(call: ast.Call, env: Env) -> Optional[Tuple[str, ...]]:
    vals = [_fold(a, env) for a in call.args]
    if call.keywords or any(v is None for v in vals):
        return None
    return tuple(vals)  # type: ignore[arg-type]


def _loop_values(node: ast.For) -> Optional[List[str]]:
    if not isinstance(node.target, ast.Name) \
            or not isinstance(node.iter, (ast.Tuple, ast.List)):
        return None
    vals = [_fold(e, {}) for e in node.iter.elts]
    return None if any(v is None for v in vals) else vals  # type: ignore


def _func_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _table_family(module: ModuleInfo, node: ast.AST) -> Optional[str]:
    name = module.dotted(node) or ""
    return TABLE_FAMILIES.get(name.split(".")[-1])


def _statement_regs(module: ModuleInfo, st: ast.stmt, env: Env,
                    ) -> Iterator[Registration]:
    for node in ast.walk(st):
        if isinstance(node, ast.Call):
            func = node.func
            # register_kernel(op, kind, impl)(fn)
            if isinstance(func, ast.Call) and len(node.args) == 1:
                tail = (module.call_name(func) or "").split(".")[-1]
                family = DECORATOR_FAMILIES.get(tail)
                key = _fold_args(func, env) if family else None
                if key is not None:
                    yield Registration(family, key,
                                       _func_name(node.args[0]),
                                       module.relpath, node.lineno)
            # KERNELS.update({key: fn, ...})
            elif isinstance(func, ast.Attribute) and func.attr == "update" \
                    and len(node.args) == 1 \
                    and isinstance(node.args[0], ast.Dict):
                family = _table_family(module, func.value)
                if family is None:
                    continue
                for k, v in zip(node.args[0].keys, node.args[0].values):
                    key = _fold_key(k, env) if k is not None else None
                    if key is not None:
                        yield Registration(family, key, _func_name(v),
                                           module.relpath, node.lineno)
        # KERNELS[key] = fn
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if not isinstance(t, ast.Subscript):
                    continue
                family = _table_family(module, t.value)
                key = _fold_key(t.slice, env) if family else None
                if key is not None:
                    yield Registration(family, key, _func_name(node.value),
                                       module.relpath, node.lineno)


def _walk_statements(module: ModuleInfo, stmts: List[ast.stmt],
                     envs: List[Env]) -> Iterator[Registration]:
    for st in stmts:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue  # registering functions' own bodies fold nothing
        if isinstance(st, ast.For):
            vals = _loop_values(st)
            if vals is not None:
                inner = [dict(e, **{st.target.id: v})
                         for e, v in itertools.product(envs, vals)]
                yield from _walk_statements(module, st.body, inner)
                continue
        if isinstance(st, (ast.For, ast.While, ast.If, ast.With, ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                yield from _walk_statements(module, getattr(st, field, []),
                                            envs)
            for h in getattr(st, "handlers", []):
                yield from _walk_statements(module, h.body, envs)
            continue
        for env in envs:
            yield from _statement_regs(module, st, env)


def collect_registrations(project: Project) -> List[Registration]:
    regs: List[Registration] = []
    for module in project.modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                tail = (module.call_name(dec) or "").split(".")[-1]
                family = DECORATOR_FAMILIES.get(tail)
                if family is None:
                    continue
                key = _fold_args(dec, {})
                if key is None:
                    continue
                regs.append(Registration(family, key, node.name,
                                         module.relpath, dec.lineno))
        regs.extend(_walk_statements(module, module.tree.body, [{}]))
    return regs


def _sig(node: ast.FunctionDef) -> Tuple[List[str], int, Set[str], bool,
                                         bool]:
    pos = [a.arg for a in node.args.posonlyargs + node.args.args]
    required = len(pos) - len(node.args.defaults)
    kwonly = {a.arg for a in node.args.kwonlyargs}
    return pos, required, kwonly, node.args.vararg is not None, \
        node.args.kwarg is not None


def _defs_in(root: ast.AST) -> Dict[str, ast.FunctionDef]:
    """The functions defined anywhere under ``root``, by name."""
    return {n.name: n for n in ast.walk(root)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not root}


def _registered_def(module: ModuleInfo, name: str,
                    defs: Dict[str, ast.FunctionDef], depth: int = 0,
                    ) -> Optional[ast.FunctionDef]:
    """The function a registered name denotes: a def of that name, or,
    for ``name = factory(...)`` at module level, the def the local
    factory returns."""
    if depth > 4:
        return None
    for st in module.tree.body:
        if isinstance(st, ast.Assign) and isinstance(st.value, ast.Call) \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in st.targets):
            factory = defs.get(_func_name(st.value.func))
            if factory is None:
                return None
            for ret in ast.walk(factory):
                if isinstance(ret, ast.Return) \
                        and isinstance(ret.value, ast.Name):
                    return _registered_def(module, ret.value.id,
                                           _defs_in(factory), depth + 1)
            return None
    return defs.get(name)


def _check_signatures(project: Project, regs: List[Registration],
                      ) -> List[Finding]:
    findings: List[Finding] = []
    by_path = {m.relpath: m for m in project.modules}
    defs_of = {m.relpath: _defs_in(m.tree) for m in project.modules}

    for reg in regs:
        module = by_path.get(reg.path)
        if module is None:
            continue
        node = _registered_def(module, reg.func, defs_of[reg.path])
        if node is None:
            continue
        pos, required, kwonly, has_vararg, has_kwarg = _sig(node)
        if reg.family == "kernel" and len(reg.key) == 3:
            op = reg.key[0]
            want = KERNEL_POSITIONAL.get(op)
            if want is not None and not (
                    required <= want and (has_vararg or want <= len(pos))):
                findings.append(Finding(
                    "REG01", reg.path, reg.line,
                    f"kernel ({', '.join(reg.key)}): {reg.func} takes "
                    f"{required}-{len(pos)} positional params, protocol "
                    f"for {op!r} passes {want} "
                    f"(rng, pop, fitness, pop_size, cfg, genome"
                    f"{', fused' if op == 'generation_eval' else ''})"))
        elif reg.family == "topology":
            missing = TOPOLOGY_KWONLY - kwonly if not has_kwarg else set()
            if (len(pos) < 4 and not has_vararg) or missing:
                findings.append(Finding(
                    "REG01", reg.path, reg.line,
                    f"topology {reg.key[0]!r}: {reg.func} does "
                    f"not match the Topology protocol "
                    f"(need 4 positional (pool, bests_genome, "
                    f"bests_fitness, rng) + keyword-only "
                    f"{sorted(TOPOLOGY_KWONLY)}; missing "
                    f"{sorted(missing) or 'positional params'})"))
        elif reg.family == "acceptance":
            missing = POLICY_KWONLY - kwonly if not has_kwarg else set()
            if (len(pos) != 6 and not has_vararg) or missing:
                findings.append(Finding(
                    "REG01", reg.path, reg.line,
                    f"acceptance policy {reg.key[0]!r}: {reg.func} does "
                    f"not match the AcceptancePolicy protocol (6 "
                    f"positional (pool_genomes, pool_fitness, "
                    f"cand_genomes, cand_fitness, cand_valid, rng) + "
                    f"keyword-only {sorted(POLICY_KWONLY)}; missing "
                    f"{sorted(missing) or 'positional arity'})"))
    return findings


def _host_mirrored(project: Project) -> Optional[Set[str]]:
    """The HOST_MIRRORED tuple from core/acceptance.py, lexically."""
    for module in project.modules:
        if not module.relpath.endswith("core/acceptance.py"):
            continue
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "HOST_MIRRORED"
                            for t in node.targets) \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                vals = set()
                for el in node.value.elts:
                    if isinstance(el, ast.Constant):
                        vals.add(el.value)
                return vals
    return None


def _check_completeness(project: Project, regs: List[Registration],
                        ) -> List[Finding]:
    findings: List[Finding] = []
    kernel_regs = [r for r in regs
                   if r.family == "kernel" and len(r.key) == 3]
    if kernel_regs:
        ops = sorted({r.key[0] for r in kernel_regs})
        kinds = sorted({r.key[1] for r in kernel_regs})
        impls = sorted({r.key[2] for r in kernel_regs})
        have = {r.key for r in kernel_regs}
        first_site = {}
        for r in kernel_regs:
            first_site.setdefault(r.key[2], r)
        for impl in impls:
            missing = [(op, kind) for op in ops for kind in kinds
                       if (op, kind, impl) not in have]
            if missing:
                site = first_site[impl]
                findings.append(Finding(
                    "REG02", site.path, site.line,
                    f"kernel impl {impl!r} leaves completeness-matrix "
                    f"holes: missing {missing} — drivers dispatching "
                    f"those cells will KeyError at runtime"))

    mirrored = _host_mirrored(project)
    if mirrored is not None:
        for r in regs:
            if r.family == "acceptance" and r.key[0] not in mirrored:
                findings.append(Finding(
                    "REG02", r.path, r.line,
                    f"acceptance policy {r.key[0]!r} is registered but "
                    f"absent from HOST_MIRRORED — PoolServer(acceptance="
                    f"...) will reject it at construction; add a numpy "
                    f"mirror or exempt it in the baseline"))
    return findings


INSERT_SITES = {"pool_put_batch", "pool_insert_host"}
INSERT_SITE_HOME = ("core/pool.py", "core/acceptance.py")


def _check_insert_sites(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for module in project.modules:
        if module.relpath.endswith(INSERT_SITE_HOME):
            continue
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = (module.call_name(node) or "").split(".")[-1]
            if tail not in INSERT_SITES:
                continue
            kwargs = {k.arg for k in node.keywords}
            n_pos = len(node.args)
            # acc reached positionally: put_batch(pool, g, f, valid, acc)
            # = index 4; insert_host(pool, genomes, fits, acc) = index 3
            acc_pos = 5 if tail == "pool_put_batch" else 4
            if "acc" in kwargs or "acceptance" in kwargs \
                    or n_pos >= acc_pos:
                continue
            findings.append(Finding(
                "REG03", module.relpath, node.lineno,
                f"{tail}() without an acceptance policy (acc=...) — this "
                f"insert site bypasses the acceptance engine every other "
                f"site dispatches"))
    return findings


def run(project: Project) -> List[Finding]:
    regs = collect_registrations(project)
    return (_check_signatures(project, regs)
            + _check_completeness(project, regs)
            + _check_insert_sites(project))
