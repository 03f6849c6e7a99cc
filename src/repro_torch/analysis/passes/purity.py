"""Pass 3 — kernel-wrapper and graph purity (PAL01 / JIT01).

The JAX package's roots are the ``pl.pallas_call`` kernel bodies (PAL01)
and the callables handed to ``jax.jit`` / ``pjit`` / ``shard_map``
(JIT01).  The port has none of these; its counterparts are:

* **PAL01 roots — the kernel wrappers and their plain versions.**  Each
  function that launches a kernel through ``_build.library()`` (that
  loads the library and names one of its ``*_launch`` entries: the
  binary and float generation launchers, the tiled generation and the
  roulette CDF, trap, F15, WKV and flash), and the plain PyTorch version
  that each wrapper runs for a CPU tensor: the call returned under an
  ``if <tensor>.device.type == "cpu":`` test in a launcher or in a
  function that calls one.  A wrapper launches on the current stream
  and must stay free of host syncs, so that the epoch and the decode step
  can be captured as CUDA graphs; its plain version is the kernel's
  definition and keeps to the same rules.  :mod:`repro_torch._build`
  (the ``nvcc`` build, the loader and its error check) is the launch
  primitive, as ``pallas_call`` is in the JAX package: the callgraph is
  not followed into it.
* **JIT01 roots — code that torch traces or captures.**  The bodies of
  ``torch.library.custom_op`` ops and their ``register_fake`` fakes
  (``kernels/rwkv6/ops.py``, ``kernels/flash_attention/ops.py``), the
  ``forward``/``backward`` (and ``setup_context``, ``jvp``, ``vjp``) of
  ``torch.autograd.Function`` subclasses (``models/common.py``,
  ``launch/partition.py``), callables handed to ``torch.compile`` (also
  as a decorator) or ``torch.cuda.make_graphed_callables``, and
  everything run inside ``with torch.cuda.graph(...)`` or between a
  graph's ``capture_begin()`` and ``capture_end()`` — the region's own
  lines and the functions it calls.  ``partial`` and one level of
  local-variable indirection are unwrapped, as the JAX package does.

``shard_map`` has no counterpart: the port's ranks run eagerly over a
``torch.distributed`` group (:mod:`repro_torch.core.sharded`), each its
own program, so nothing is traced across ranks.

Flagged in both contexts: ``print``/``input``, ``open`` (host file I/O),
``global``/``nonlocal`` declarations, the host syncs ``.item()``,
``.tolist()``, ``.cpu()`` and ``.numpy()``, and ``int()``/``float()``/
``bool()`` of a function parameter (a host read of a device value).
Flagged in kernel context only (PAL01): any ``np.*`` call other than a
dtype.  Flagged in traced context only (JIT01): host clock calls
(``time.time``/``sleep``/``perf_counter``/``monotonic``).

Host syncs that a graph will meet and that are not roots today: the
fused drivers' early-stop latch ``bool(stopped)``
(``core/evolution.py::fused_scan``, ``core/async_migration.py::
fused_scan_async``), read once an epoch or tick without W², stays
between graph replays; the decode step's ``int(index)``
(``models/attention.py::decode_step`` and its sharded twin) is a host
int that capture would freeze, so a graphed decode step needs the slot
and the position as device tensors first.  When such code becomes a
root, these rules report those lines.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ..findings import Finding
from ..symbols import (FunctionEntry, ModuleInfo, Project, iter_functions,
                       unwrap_partial)

LAUNCH_TAIL = "_build.library"
LAUNCH_SUFFIX = "_launch"
BUILD_MODULE_TAIL = "_build"
COMPILE_NAMES = {"torch.compile"}
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables"}
GRAPH_CONTEXTS = {"torch.cuda.graph"}
CUSTOM_OP_TAILS = {"custom_op"}
FAKE_TAILS = {"register_fake"}
AUTOGRAD_BASE_TAIL = "autograd.Function"
AUTOGRAD_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _key(entry: FunctionEntry) -> str:
    return f"{entry.module.name}.{entry.qualname}"


def _local_env(fn: ast.AST) -> Dict[str, ast.AST]:
    env: Dict[str, ast.AST] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env[node.targets[0].id] = node.value
    return env


def _callable_names(module: ModuleInfo, expr: ast.AST,
                    env: Dict[str, ast.AST], depth: int = 0) -> List[str]:
    """Dotted names of the callables an expression may denote."""
    if depth > 4:
        return []
    expr = unwrap_partial(module, expr)
    if isinstance(expr, ast.Name) and expr.id in env:
        return _callable_names(module, env[expr.id], env, depth + 1)
    if isinstance(expr, (ast.Name, ast.Attribute)):
        name = module.dotted(expr)
        return [name] if name else []
    if isinstance(expr, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in expr.elts:
            out.extend(_callable_names(module, el, env, depth + 1))
        return out
    if isinstance(expr, ast.Lambda):
        out = []
        for sub in ast.walk(expr.body):
            if isinstance(sub, ast.Call):
                out.extend(_callable_names(module, sub.func, env, depth + 1))
        return out
    if isinstance(expr, ast.Call):
        # compile(fn)(...) or a builder call: look at its first argument
        name = module.call_name(expr) or ""
        if name in COMPILE_NAMES | GRAPHED_CALLABLES and expr.args:
            return _callable_names(module, expr.args[0], env, depth + 1)
    return []


def _is_cpu_test(test: ast.AST) -> bool:
    """``<x>.device.type == "cpu"``."""
    return (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.left.value, ast.Attribute)
            and test.left.value.attr == "device"
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def _calls_in(module: ModuleInfo, nodes: Iterable[ast.AST]) -> List[str]:
    out = []
    for root in nodes:
        for sub in ast.walk(root):
            if isinstance(sub, ast.Call):
                name = module.call_name(sub)
                if name:
                    out.append(name)
    return out


def _launches(module: ModuleInfo, fn: ast.FunctionDef) -> bool:
    """``fn`` launches a kernel: it loads the library
    (``_build.library()``) and names one of its ``*_launch`` entries.
    Functions that only query the library (shared memory, occupancy)
    are not launchers."""
    loads = names = False
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and (module.call_name(node) or "").endswith(LAUNCH_TAIL):
            loads = True
        elif isinstance(node, ast.Attribute) \
                and node.attr.endswith(LAUNCH_SUFFIX):
            names = True
    return loads and names


def _in_build(entry: FunctionEntry) -> bool:
    return entry.module.name.split(".")[-1] == BUILD_MODULE_TAIL


class _Region:
    """A captured region: statements inside a graph capture, checked as
    if they were a function body (the enclosing function's parameters
    count as parameters)."""

    def __init__(self, module: ModuleInfo, fn: ast.FunctionDef,
                 stmts: List[ast.stmt], line: int):
        self.module, self.fn, self.stmts, self.line = module, fn, stmts, line


def _capture_regions(module: ModuleInfo, fn: ast.FunctionDef,
                     ) -> List[_Region]:
    regions: List[_Region] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and (
                        module.call_name(ctx) or "") in GRAPH_CONTEXTS:
                    regions.append(_Region(module, fn, node.body,
                                           node.lineno))
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        for stmts in (body, getattr(node, "orelse", []),
                      getattr(node, "finalbody", [])):
            begin = None
            for i, st in enumerate(stmts):
                if isinstance(st, ast.Expr) and isinstance(st.value,
                                                           ast.Call) \
                        and isinstance(st.value.func, ast.Attribute):
                    attr = st.value.func.attr
                    if attr == "capture_begin":
                        begin = i
                    elif attr == "capture_end" and begin is not None:
                        regions.append(_Region(module, fn,
                                               stmts[begin + 1:i],
                                               stmts[begin].lineno))
                        begin = None
    return regions


def _decorated_root(module: ModuleInfo, fn: ast.FunctionDef) -> bool:
    """``fn`` is decorated by ``torch.compile``, ``custom_op`` or a
    ``register_fake``."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = module.dotted(target) or ""
        tail = name.split(".")[-1]
        if name in COMPILE_NAMES or tail in CUSTOM_OP_TAILS \
                or tail in FAKE_TAILS:
            return True
    return False


def _collect_roots(project: Project,
                   ) -> Tuple[Set[str], Set[str], List[_Region]]:
    """(kernel_roots, traced_roots, capture regions); roots are
    project-qualified function keys."""
    launchers: Set[str] = set()
    jit: Set[str] = set()
    regions: List[_Region] = []
    cpu_arms: Dict[str, List[str]] = {}   # wrapper key -> plain names
    for module in project.modules:
        for qual, fn in iter_functions(module):
            key = f"{module.name}.{qual}"
            env = _local_env(fn)
            if _decorated_root(module, fn):
                jit.add(key)
            if _launches(module, fn):
                launchers.add(key)
            for node in ast.walk(fn):
                if isinstance(node, ast.If) and _is_cpu_test(node.test) \
                        and node.body \
                        and isinstance(node.body[-1], ast.Return) \
                        and node.body[-1].value is not None:
                    cpu_arms.setdefault(key, []).extend(
                        _calls_in(module, [node.body[-1].value]))
                if not isinstance(node, ast.Call):
                    continue
                name = module.call_name(node) or ""
                if name in COMPILE_NAMES | GRAPHED_CALLABLES \
                        and node.args:
                    for cname in _callable_names(module, node.args[0], env):
                        entry = project.resolve_function(module, cname)
                        if entry:
                            jit.add(_key(entry))
            for region in _capture_regions(module, fn):
                regions.append(region)
                for cname in _calls_in(module, region.stmts):
                    entry = project.resolve_function(module, cname)
                    if entry:
                        jit.add(_key(entry))
        for cname, cls in module.classes.items():
            if not any((module.dotted(b) or "").endswith(AUTOGRAD_BASE_TAIL)
                       for b in cls.bases):
                continue
            for meth in AUTOGRAD_METHODS:
                entry = module.functions.get(f"{cname}.{meth}")
                if entry is not None:
                    jit.add(_key(entry))

    # a wrapper is a launcher, or a function that calls one; its CPU
    # arm's callees are the plain versions
    kernel = set(launchers)
    for key, plain in cpu_arms.items():
        entry = project.func_index.get(key)
        if entry is None or not (key in launchers or any(
                _key(c) in launchers for c in _callees(project, entry))):
            continue
        module = project.func_index[key].module
        for name in plain:
            entry = project.resolve_function(module, name)
            if entry and not _in_build(entry):
                kernel.add(_key(entry))
    return kernel, jit, regions


def _callees(project: Project, entry: FunctionEntry) -> List[FunctionEntry]:
    out = []
    for node in ast.walk(entry.node):
        if isinstance(node, ast.Call):
            name = entry.module.call_name(node)
            if not name:
                continue
            callee = project.resolve_function(entry.module, name)
            if callee and not _in_build(callee):
                out.append(callee)
    return out


def _reachable(project: Project, roots: Set[str]) -> Dict[str, str]:
    """BFS over the project callgraph: function key -> root it came from."""
    seen: Dict[str, str] = {}
    frontier = [(r, r) for r in roots]
    while frontier:
        key, root = frontier.pop()
        if key in seen:
            continue
        seen[key] = root
        entry = project.func_index.get(key)
        if entry is None:
            continue
        for callee in _callees(project, entry):
            ckey = _key(callee)
            if ckey not in seen:
                frontier.append((ckey, root))
    return seen


def _impurities(m: ModuleInfo, fn: ast.FunctionDef, nodes: List[ast.AST],
                kernel_ctx: bool, rule: str, where: str) -> List[Finding]:
    params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs)}
    out: List[Finding] = []

    def flag(line: int, what: str) -> None:
        out.append(Finding(rule, m.relpath, line, f"{what} in {where}"))

    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                flag(node.lineno,
                     f"{type(node).__name__.lower()} declaration")
            elif isinstance(node, ast.Call):
                name = m.call_name(node) or ""
                tail = name.split(".")[-1]
                method = node.func.attr \
                    if isinstance(node.func, ast.Attribute) else ""
                if name in ("print", "input"):
                    flag(node.lineno, f"{name}() side effect")
                elif name == "open":
                    flag(node.lineno, "host file I/O (open())")
                elif name.startswith("time.") and not kernel_ctx \
                        and tail in ("time", "sleep", "perf_counter",
                                     "monotonic"):
                    flag(node.lineno, f"host clock call {name}()")
                elif kernel_ctx and name.startswith("numpy.") \
                        and tail not in ("dtype", "float32", "int32",
                                         "uint32", "bool_", "float64",
                                         "int64"):
                    flag(node.lineno, f"host numpy call {name}()")
                elif method in HOST_SYNC_METHODS and not node.args \
                        and not node.keywords:
                    flag(node.lineno, f"`.{method}()` host sync")
                elif name in ("float", "int", "bool") \
                        and len(node.args) == 1 \
                        and isinstance(node.args[0], ast.Name) \
                        and node.args[0].id in params:
                    flag(node.lineno,
                         f"{name}() coercion of parameter "
                         f"{node.args[0].id!r} (a host read of a device "
                         f"value)")
    return out


def _where(kernel_ctx: bool, fn_name: str, root: str) -> str:
    ctx = "kernel wrapper" if kernel_ctx else "traced function"
    return f"{ctx} {fn_name!r} (reachable from {root.split('.')[-1]})"


def run(project: Project) -> List[Finding]:
    kernel_roots, jit_roots, regions = _collect_roots(project)
    kernel_reach = _reachable(project, kernel_roots)
    jit_reach = _reachable(project, jit_roots)
    findings: List[Finding] = []
    seen_lines: Set[Tuple[str, int, str]] = set()

    def add(fs: List[Finding]) -> None:
        for f in fs:
            dedup = (f.path, f.line, f.rule_id)
            if dedup not in seen_lines:
                seen_lines.add(dedup)
                findings.append(f)

    for reach, kernel_ctx, rule in ((kernel_reach, True, "PAL01"),
                                    (jit_reach, False, "JIT01")):
        for key, root in reach.items():
            if not kernel_ctx and key in kernel_reach:
                continue  # kernel context wins; don't double-report
            entry = project.func_index.get(key)
            if entry is None:
                continue
            add(_impurities(entry.module, entry.node, [entry.node],
                            kernel_ctx, rule,
                            _where(kernel_ctx, entry.node.name, root)))
    for region in regions:
        add(_impurities(region.module, region.fn, region.stmts, False,
                        "JIT01", f"graph capture region at line "
                                 f"{region.line} of {region.fn.name!r}"))
    return findings
