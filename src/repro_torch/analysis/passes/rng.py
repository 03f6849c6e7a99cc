"""Pass 1 — RNG-key discipline (RNG01) and nondeterministic sources (RNG02).

RNG01: a key of :mod:`repro_torch.rand` (the (..., 2) Threefry words that
take the place of ``jax.random`` keys) must reach exactly one sink.  A
sink is ``rand.split``, a keyed sampler (``rand.keyed_bits``,
``keyed_uniform``, ``keyed_randint``, ``keyed_bernoulli``,
``keyed_permutation``, ``keyed_gumbel``, ``keyed_categorical``,
``keyed_normal``), or any other call the key is passed to (the callee
consumes it).  *Derivations* — ``rand.fold_in`` / ``rand.key`` /
``rand.key_data`` and a key's ``.clone()`` — are not sinks: folding
distinct constants off one parent key is the idiomatic decorrelation
pattern.  Two sinks on one binding break replica determinism (the fused
drivers' per-epoch streams and the kernels' counter RNG are seeded from
exactly-once keys).  Also flagged: a key bound *outside* a loop and
consumed *inside* it with no re-bind anywhere in the loop body — every
iteration would draw identical randomness.

The analysis is per function scope, linear in statement order, with the
JAX package's refinements:

* branch awareness — sinks in mutually exclusive ``if``/``elif`` arms
  don't conflict, and a terminating arm (ends in return/raise) makes the
  code after the ``if`` its else arm;
* the carry pattern — ``keys = rand.split(key, 2)`` then ``key, k =
  keys[0], keys[1]`` inside a loop re-binds ``key`` each iteration and is
  therefore exempt from the loop rule.  A tuple assigned to a tuple binds
  each name with its own element's keyness, so ``keys[0]`` makes a key
  and a non-key element untracks its name.

RNG02: wall-clock and global-RNG calls in the seeded roots (core/,
kernels/, benchmarks/, and the port's models/, data/ and optim/, which
draw from ``torch.Generator`` objects where the JAX package drew from
keys): ``time.time``, module-level ``random.*``, unseeded
``np.random.*`` / legacy global ``np.random`` samplers, no-arg
``random.Random()``/``default_rng()``, and torch's global RNG:

* ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
  ``multinomial``/``normal`` and the in-place ``uniform_``/``normal_``/
  ``random_``/``bernoulli_``/``exponential_`` (so also
  ``torch.nn.init.normal_``), each when called without ``generator=``;
* ``torch.manual_seed``, ``torch.seed`` and ``torch.cuda.manual_seed*``
  (they reseed every caller's global stream);
* a ``torch.Generator()`` that is never seeded (no ``.manual_seed(s)``
  chained onto it or called on the name it is bound to in its scope).

These silently decouple a BENCH row or a replica from its recorded seed.
``time.perf_counter`` is fine (duration measurement is what it is for);
``torch.Generator(device=d).manual_seed(seed)`` passed as ``generator=``
(``launch/serve.py::make_inputs``) is the seeded idiom.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..findings import Finding
from ..symbols import ModuleInfo, Project, iter_functions, terminates

KEY_NAME_RE = re.compile(r"^(rng|key|keys|k_[a-z0-9_]+|[a-z0-9_]*_(rng|key|keys))$")

RAND_MODULE = "repro_torch.rand"
# rand functions that derive keys without consuming the argument
DERIVATIONS = {"fold_in", "key", "key_data"}
# key producers: binding RHS that makes the target a key variable
PRODUCERS = {"key", "split", "fold_in", "key_data"}
# callees through which passing a key is not a consumption
SINK_EXEMPT_TAILS = {"asarray", "as_tensor", "device_put",
                     "block_until_ready", "print", "repr", "str", "id",
                     "format", "tree_map", "append", "isinstance", "type",
                     "len", "shape"}

SEEDED_ROOT_PARTS = ("core", "kernels", "benchmarks", "models", "data",
                     "optim")

# nondeterministic sources: dotted-name -> message
WALL_CLOCK = {"time.time", "time.time_ns", "datetime.datetime.now",
              "datetime.datetime.utcnow"}
GLOBAL_RANDOM_MODULE = "random"
SEEDED_OK = {"random.Random", "numpy.random.default_rng",
             "numpy.random.Generator", "numpy.random.RandomState"}
# torch samplers that draw from the global generator unless given one
TORCH_SAMPLERS = {f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal")}
TORCH_INPLACE = {"uniform_", "normal_", "random_", "bernoulli_",
                 "exponential_"}
TORCH_GLOBAL_SEEDERS = {"torch.manual_seed", "torch.seed",
                        "torch.random.manual_seed", "torch.random.seed",
                        "torch.cuda.manual_seed",
                        "torch.cuda.manual_seed_all", "torch.cuda.seed",
                        "torch.cuda.seed_all"}
TORCH_GENERATOR = "torch.Generator"
GENERATOR_SEEDERS = {"manual_seed", "set_state"}


def _is_rand(dotted: str) -> bool:
    return dotted.startswith(RAND_MODULE + ".")


def _branch_compatible(a: Tuple, b: Tuple) -> bool:
    """Two branch paths can both execute iff they agree on the arm of
    every ``if`` node they share."""
    arms_a = dict(a)
    for node_id, arm in b:
        if node_id in arms_a and arms_a[node_id] != arm:
            return False
    return True


class _Event:
    __slots__ = ("var", "gen", "line", "branch", "loops", "kind")

    def __init__(self, var, gen, line, branch, loops, kind):
        self.var, self.gen, self.line = var, gen, line
        self.branch, self.loops, self.kind = branch, loops, kind


class _FuncScan:
    """Linear scan of one function body (nested defs/lambdas skipped —
    separate scopes; free-variable keys are out of lexical reach)."""

    def __init__(self, module: ModuleInfo, fn: ast.FunctionDef):
        self.m = module
        self.fn = fn
        self.gen: Dict[str, int] = {}
        self.is_key: Dict[str, bool] = {}
        self.assign_loops: Dict[Tuple[str, int], Tuple] = {}
        self.sinks: List[_Event] = []
        self.rebinds: List[_Event] = []
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        args = self.fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if KEY_NAME_RE.match(a.arg):
                self._bind(a.arg, a.lineno, (), (), key=True)
        self._block(self.fn.body, branch=(), loops=())
        self._report()
        return self.findings

    # -- binding ------------------------------------------------------------
    def _bind(self, var: str, line: int, branch: Tuple, loops: Tuple,
              key: bool) -> None:
        self.gen[var] = self.gen.get(var, -1) + 1
        self.is_key[var] = key
        self.assign_loops[(var, self.gen[var])] = loops
        self.rebinds.append(_Event(var, self.gen[var], line, branch, loops,
                                   "bind"))

    def _rhs_is_key(self, value: ast.AST) -> bool:
        if isinstance(value, ast.Call):
            name = self.m.call_name(value) or ""
            if _is_rand(name) and name.split(".")[-1] in PRODUCERS:
                return True
            # k.clone() of a key is a key
            func = value.func
            if isinstance(func, ast.Attribute) and func.attr == "clone":
                return self._rhs_is_key(func.value)
            return False
        if isinstance(value, ast.Name):
            return self.is_key.get(value.id, False)
        if isinstance(value, ast.Subscript):
            return self._rhs_is_key(value.value)
        return False

    # -- statements ---------------------------------------------------------
    def _block(self, stmts: List[ast.stmt], branch: Tuple, loops: Tuple):
        for st in stmts:
            self._stmt(st, branch, loops)
            if isinstance(st, ast.If) and terminates(st.body) \
                    and not st.orelse:
                # everything after this if is its else arm
                branch = branch + ((id(st), "else"),)

    def _stmt(self, st: ast.stmt, branch: Tuple, loops: Tuple) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # separate scope
        if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = st.value
            if value is not None:
                self._expr(value, branch, loops)
            targets = st.targets if isinstance(st, ast.Assign) \
                else [st.target]
            for t in targets:
                self._bind_value(t, value, branch, loops)
            return
        if isinstance(st, ast.If):
            self._expr(st.test, branch, loops)
            self._block(st.body, branch + ((id(st), "body"),), loops)
            self._block(st.orelse, branch + ((id(st), "else"),), loops)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(st.iter, branch, loops)
            inner = loops + (id(st),)
            self._bind_target(st.target, False, branch, inner)
            self._block(st.body, branch, inner)
            self._block(st.orelse, branch, loops)
            return
        if isinstance(st, ast.While):
            inner = loops + (id(st),)
            self._expr(st.test, branch, inner)
            self._block(st.body, branch, inner)
            self._block(st.orelse, branch, loops)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, branch, loops)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, False, branch,
                                      loops)
            self._block(st.body, branch, loops)
            return
        if isinstance(st, ast.Try):
            self._block(st.body, branch, loops)
            for h in st.handlers:
                self._block(h.body, branch + ((id(h), "except"),), loops)
            self._block(st.orelse, branch, loops)
            self._block(st.finalbody, branch, loops)
            return
        if isinstance(st, ast.Return) and st.value is not None:
            self._expr(st.value, branch, loops)
            return
        if isinstance(st, ast.Expr):
            self._expr(st.value, branch, loops)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(child, branch, loops)

    def _bind_value(self, target: ast.AST, value: Optional[ast.AST],
                    branch, loops) -> None:
        """``a, b = x, y`` binds each name with its own element's
        keyness; any other shape binds every name with the whole RHS's."""
        if isinstance(target, (ast.Tuple, ast.List)) \
                and isinstance(value, (ast.Tuple, ast.List)) \
                and len(target.elts) == len(value.elts) \
                and not any(isinstance(e, ast.Starred)
                            for e in target.elts + value.elts):
            for t, v in zip(target.elts, value.elts):
                self._bind_value(t, v, branch, loops)
            return
        keyish = value is not None and self._rhs_is_key(value)
        self._bind_target(target, keyish, branch, loops)

    def _bind_target(self, target: ast.AST, keyish: bool, branch, loops):
        if isinstance(target, ast.Name):
            # keyness follows RHS *provenance*, not the target's name — a
            # key-sounding name bound to a non-key value (cache tuple,
            # position index) untracks it.  Parameters, which have no RHS,
            # are the one place the name heuristic applies (see run()).
            self._bind(target.id, target.lineno, branch, loops, key=keyish)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, keyish, branch, loops)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, keyish, branch, loops)
        # attribute / subscript targets don't create local bindings

    # -- expressions: find sinks --------------------------------------------
    def _expr(self, node: ast.AST, branch: Tuple, loops: Tuple) -> None:
        if isinstance(node, ast.IfExp):
            # ternary arms are mutually exclusive, same as if/else suites
            self._expr(node.test, branch, loops)
            self._expr(node.body, branch + ((id(node), "body"),), loops)
            self._expr(node.orelse, branch + ((id(node), "else"),), loops)
            return
        if isinstance(node, ast.Lambda):
            return  # separate scope
        if isinstance(node, ast.Call):
            self._call(node, branch, loops)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, branch, loops)

    def _call(self, call: ast.Call, branch: Tuple, loops: Tuple) -> None:
        name = self.m.call_name(call) or ""
        tail = name.split(".")[-1]
        if _is_rand(name) and tail in DERIVATIONS:
            return  # derivation, not a sink
        if tail in SINK_EXEMPT_TAILS:
            return
        direct = [a for a in call.args if isinstance(a, ast.Name)]
        direct += [k.value for k in call.keywords
                   if isinstance(k.value, ast.Name)]
        for arg in direct:
            var = arg.id
            if not self.is_key.get(var, False):
                continue
            self.sinks.append(_Event(var, self.gen.get(var, 0), arg.lineno,
                                     branch, loops, tail or name))

    # -- verdicts -----------------------------------------------------------
    def _report(self) -> None:
        by_binding: Dict[Tuple[str, int], List[_Event]] = {}
        for ev in self.sinks:
            by_binding.setdefault((ev.var, ev.gen), []).append(ev)
        for (var, gen), events in by_binding.items():
            events.sort(key=lambda e: e.line)
            # (a) two compatible-branch sinks on one binding
            flagged = set()
            for i in range(len(events)):
                for j in range(i + 1, len(events)):
                    a, b = events[i], events[j]
                    if id(b) in flagged:
                        continue
                    if _branch_compatible(a.branch, b.branch):
                        flagged.add(id(b))
                        self.findings.append(Finding(
                            "RNG01", self.m.relpath, b.line,
                            f"key {var!r} consumed again (sink #{j + 1}, "
                            f"via {b.kind}) without an intervening "
                            f"split/fold_in — first sink at line "
                            f"{a.line}; reuse breaks replica determinism"))
            # (b) bound outside a loop, consumed inside, never re-bound
            assign_loops = self.assign_loops.get((var, gen), ())
            for ev in events:
                extra = [lp for lp in ev.loops if lp not in assign_loops]
                if not extra:
                    continue
                rebound_inside = any(
                    rb.var == var and any(lp in rb.loops for lp in extra)
                    for rb in self.rebinds)
                if not rebound_inside:
                    self.findings.append(Finding(
                        "RNG01", self.m.relpath, ev.line,
                        f"key {var!r} bound outside this loop is consumed "
                        f"inside it with no re-bind — every iteration "
                        f"draws identical randomness"))


def _in_seeded_root(relpath: str) -> bool:
    parts = relpath.split("/")
    return any(p in SEEDED_ROOT_PARTS for p in parts[:-1])


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _seeded_generators(module: ModuleInfo) -> Set[int]:
    """ids of the ``torch.Generator(...)`` calls that are seeded: with
    ``.manual_seed(s)`` chained onto the call, or bound to a name (or
    ``self.<attr>``) on which ``.manual_seed``/``.set_state`` is called in
    the same scope."""
    seeded: Set[int] = set()
    scopes: List[ast.AST] = [module.tree] + [
        n for n in ast.walk(module.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        bound: Dict[str, List[ast.Call]] = {}
        seeded_names: Set[str] = set()
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in GENERATOR_SEEDERS:
                base = node.func.value
                if isinstance(base, ast.Call) and (
                        module.call_name(base) or "") == TORCH_GENERATOR:
                    seeded.add(id(base))
                else:
                    name = module.dotted(base)
                    if name:
                        seeded_names.add(name)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and (module.call_name(node.value) or "") \
                    == TORCH_GENERATOR:
                for t in node.targets:
                    name = module.dotted(t)
                    if name:
                        bound.setdefault(name, []).append(node.value)
        for name, calls in bound.items():
            if name in seeded_names:
                seeded.update(id(c) for c in calls)
    return seeded


def _rng02(module: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    if not _in_seeded_root(module.relpath):
        return out
    seeded_gens = _seeded_generators(module)
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            name = module.call_name(node) or ""
            method = node.func.attr if isinstance(node.func, ast.Attribute) \
                else ""
            if name in WALL_CLOCK:
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"wall-clock call {name}() in a seeded path — use "
                    f"time.perf_counter() for durations or thread a "
                    f"timestamp in explicitly"))
            elif name in SEEDED_OK:
                if not node.args and not node.keywords:
                    out.append(Finding(
                        "RNG02", module.relpath, node.lineno,
                        f"{name}() without a seed draws OS entropy in a "
                        f"seeded path — pass an explicit seed"))
            elif name.startswith("random.") \
                    and module.imports.get("random") == "random":
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"global-state {name}() in a seeded path — use a "
                    f"seeded random.Random(seed) instance"))
            elif name.startswith("numpy.random.") \
                    and name not in SEEDED_OK:
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"legacy global numpy RNG {name}() in a seeded path — "
                    f"use np.random.default_rng(seed)"))
            elif name in TORCH_SAMPLERS and not _has_generator(node):
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"{name}() without generator= draws from torch's "
                    f"global RNG in a seeded path — pass a seeded "
                    f"torch.Generator"))
            elif method in TORCH_INPLACE and not _has_generator(node):
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"in-place .{method}() without generator= draws from "
                    f"torch's global RNG in a seeded path — pass a seeded "
                    f"torch.Generator"))
            elif name in TORCH_GLOBAL_SEEDERS:
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    f"{name}() reseeds torch's global RNG (every caller's "
                    f"stream) in a seeded path — seed a torch.Generator "
                    f"of your own"))
            elif name == TORCH_GENERATOR and id(node) not in seeded_gens:
                out.append(Finding(
                    "RNG02", module.relpath, node.lineno,
                    "torch.Generator() never seeded in a seeded path — it "
                    "starts from a fixed default, not the run's seed; "
                    "call .manual_seed(seed) on it"))
    # reference scan: time.time passed as a callback (not called here),
    # e.g. ``field(default_factory=time.time)``

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Attribute):
                    name = module.dotted(arg) or ""
                    if name in WALL_CLOCK:
                        out.append(Finding(
                            "RNG02", module.relpath, arg.lineno,
                            f"wall-clock callable {name} handed off in a "
                            f"seeded path — nondeterministic at every "
                            f"later call"))
    return out


def run(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for module in project.modules:
        for _, fn in iter_functions(module):
            findings.extend(_FuncScan(module, fn).run())
        findings.extend(_rng02(module))
    return findings
