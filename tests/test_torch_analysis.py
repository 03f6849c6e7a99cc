"""The port's analyzer (:mod:`repro_torch.analysis`) against the JAX
package's (:mod:`repro.analysis`).

(a) Rules that name no JAX idiom (LCK01, LCK02, OBS01, LNT01, RNG02's
time/random/numpy part, REG03): each violation fixture and clean twin of
``tests/test_analysis.py`` goes through both analyzers, and the
``(rule, path, line)`` sets must be equal.
(b) Rules that name one (RNG01, PAL01, JIT01, DON01, REG01/REG02): each
reference fixture rewritten line for line in the port's idiom must give
the port's analyzer the ``(rule, line)`` set that the reference's
analyzer gives on the original.
(c) The port's additions: torch's global RNG, host syncs, graph-capture,
``custom_op`` and ``autograd.Function`` roots, the consumed-state tables
and the ``KERNELS.update`` extraction.
(d) Suppression round-trips and the CLI's exit contract.
(e) Meta-tests against the tree: clean under
``analysis_baseline_torch.json`` with no stale entry, the static registry
matrix equal to the runtime registries, and the fused drivers' loop
carries covered by ``ExperimentState`` and equal to the reference's scan
carries.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro import analysis as ref_analysis  # noqa: E402
from repro.analysis import snapshot as ref_snapshot  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    Baseline, analyze_paths, parse_pragmas)
from repro_torch.analysis import snapshot  # noqa: E402
from repro_torch.analysis.engine import collect_python_files  # noqa: E402
from repro_torch.analysis.passes.registry import (  # noqa: E402
    collect_registrations)
from repro_torch.analysis.symbols import load_project  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "analysis_baseline_torch.json")


def _write(tmp_path, source, name):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))


def lint(tmp_path, source, name="mod.py", baseline=None, package=analysis):
    """Run every pass of ``package``'s analyzer over one module."""
    _write(tmp_path, source, name)
    return package.analyze_paths([str(tmp_path)], root=str(tmp_path),
                                 baseline=baseline)


def active(result):
    return result["errors"] + result["active"]


def rules_at(result):
    return {(f.rule_id, f.path, f.line) for f in active(result)}


def lines_of(result):
    return {(f.rule_id, f.line) for f in active(result)}


# ---------------------------------------------------------------------------
# (a) parity on the rules that name no JAX idiom
# ---------------------------------------------------------------------------
LOCK_BAD = """\
    import threading

    class Server:
        def __init__(self):
            self._lock = threading.Lock()
            self._up = True

        def kill(self):
            with self._lock:
                self._up = False

        def is_up(self):
            return self._up
    """

# split so that this file's own line is no pragma to the analyzer
REASONLESS = "# repro-lint: " "disable=OBS01"

SHARED = {
    "rng02_wall_clock_seeded": ("""\
        import time

        def stamp():
            return time.time()
        """, "core/clockmod.py"),
    "rng02_wall_clock_unseeded": ("""\
        import time

        def stamp():
            return time.time()
        """, "tools/clockmod.py"),
    "rng02_handed_off_and_global_random": ("""\
        import time
        import random

        def entry(field):
            return field(default_factory=time.time)

        def draw():
            return random.random()

        def seeded_ok():
            return random.Random(7).random()
        """, "kernels/srcmod.py"),
    "rng02_numpy": ("""\
        import numpy as np

        def draws():
            a = np.random.rand(3)
            b = np.random.default_rng()
            c = np.random.default_rng(7).normal(size=3)
            return a, b, c
        """, "benchmarks/npmod.py"),
    "lck01_unlocked_read": (LOCK_BAD, "mod.py"),
    "lck01_clean_twin_and_nested_worker": ("""\
        import threading

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self._up = True
                self.meta = 0

            def kill(self):
                with self._lock:
                    self._up = False

            def is_up(self):
                with self._lock:
                    return self._up

            def spawn(self):
                def worker():
                    while self._up:
                        pass
                return worker
        """, "mod.py"),
    "lck02_unlocked_read": ("""\
        import asyncio

        class Registry:
            def __init__(self):
                self._lock = asyncio.Lock()
                self._count = 0

            async def add(self):
                async with self._lock:
                    self._count = self._count + 1

            async def snapshot(self):
                return self._count
        """, "mod.py"),
    "lck02_clean_twin_loop_owned": ("""\
        import asyncio

        class Frontend:
            def __init__(self):
                self._lock = asyncio.Lock()
                self._registry = {}
                self._requests = 0

            async def create(self, name):
                async with self._lock:
                    self._registry = {**self._registry, name: 1}

            async def handle(self, name):
                self._requests += 1
                async with self._lock:
                    return self._registry.get(name)
        """, "mod.py"),
    "lck_flavors_do_not_cross": ("""\
        import asyncio
        import threading

        class Mixed:
            def __init__(self):
                self._tlock = threading.Lock()
                self._alock = asyncio.Lock()
                self._a = 0
                self._t = 0

            async def bump_a(self):
                async with self._alock:
                    self._a = 1

            def bump_t(self):
                with self._tlock:
                    self._t = 1

            def wrong_flavor(self):
                with self._tlock:
                    return self._a

            async def wrong_flavor_async(self):
                async with self._alock:
                    return self._t
        """, "mod.py"),
    "obs01_duration": ("""\
        import time

        def timed(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
        """, "mod.py"),
    "obs01_self_attr": ("""\
        import time

        class Job:
            def start(self):
                self._t0 = time.time()

            def elapsed(self):
                return time.time() - self._t0
        """, "mod.py"),
    "obs01_perf_counter_twin": ("""\
        import time

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        """, "mod.py"),
    "obs01_timestamp_and_timepoint": ("""\
        import time

        def stamp(record):
            record["timestamp"] = time.time()
            record["yesterday"] = time.time() - 86400
            return record
        """, "mod.py"),
    "obs01_rebind_untracks": ("""\
        import time

        def timed(fn):
            t0 = time.time()
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        """, "mod.py"),
    "reg03_bare_insert": ("""\
        from repro.core.pool import pool_insert_host

        def absorb(pool, gs, fs, policy):
            pool = pool_insert_host(pool, gs, fs)
            return pool_insert_host(pool, gs, fs, acc=policy)
        """, "mod.py"),
    "reg03_put_batch_positional_acc": ("""\
        from repro_torch.core.pool import pool_put_batch

        def absorb(pool, gs, fs, valid, policy):
            pool = pool_put_batch(pool, gs, fs, valid, policy)
            return pool_put_batch(pool, gs, fs, valid)
        """, "mod.py"),
    "lnt01_reasonless_pragma": ("""\
        import time

        def stamp():
            return time.time()  %s
        """ % REASONLESS, "mod.py"),
    "lnt01_pragma_suppresses": (LOCK_BAD.replace(
        "return self._up",
        "return self._up  # repro-lint: disable=LCK01 -- test fixture"),
        "mod.py"),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_rules_give_the_references_findings(tmp_path, case):
    source, name = SHARED[case]
    ref = lint(tmp_path / "ref", source, name, package=ref_analysis)
    port = lint(tmp_path / "port", source, name)
    assert rules_at(port) == rules_at(ref)
    assert {(f.rule_id, f.path, f.line) for f in port["suppressed"]} == \
        {(f.rule_id, f.path, f.line) for f in ref["suppressed"]}


def test_shared_fixtures_are_not_all_clean(tmp_path):
    """The parity above is not the parity of two silent analyzers."""
    rules = set()
    for case, (source, name) in SHARED.items():
        rules |= {r for r, _, _ in rules_at(lint(tmp_path / case, source,
                                                  name))}
    assert rules == {"RNG02", "LCK01", "LCK02", "OBS01", "REG03", "LNT01"}


# ---------------------------------------------------------------------------
# (b) translated pairs: the reference's fixture, then the port's idiom
# ---------------------------------------------------------------------------
TRANSLATED = {
    "rng01_double_sink": ("""\
        import jax

        def f(rng):
            a = jax.random.normal(rng, (4,))
            b = jax.random.uniform(rng, (4,))
            return a + b
        """, """\
        from repro_torch import rand

        def f(rng):
            a = rand.keyed_normal(rng, (4,))
            b = rand.keyed_uniform(rng, (4,))
            return a + b
        """),
    "rng01_clean_split_twin": ("""\
        import jax

        def f(rng):
            k_a, k_b = jax.random.split(rng)
            a = jax.random.normal(k_a, (4,))
            b = jax.random.uniform(k_b, (4,))
            return a + b
        """, """\
        from repro_torch import rand

        def f(rng):
            k_a, k_b = rand.split(rng)
            a = rand.keyed_normal(k_a, (4,))
            b = rand.keyed_uniform(k_b, (4,))
            return a + b
        """),
    "rng01_fold_in_is_derivation": ("""\
        import jax

        def f(rng, axis):
            k_put = jax.random.fold_in(rng, 0xACC)
            rng = jax.random.fold_in(rng, axis)
            a = jax.random.normal(k_put, (4,))
            b = jax.random.normal(rng, (4,))
            return a + b
        """, """\
        from repro_torch import rand

        def f(rng, axis):
            k_put = rand.fold_in(rng, 0xACC)
            rng = rand.fold_in(rng, axis)
            a = rand.keyed_normal(k_put, (4,))
            b = rand.keyed_normal(rng, (4,))
            return a + b
        """),
    "rng01_exclusive_branches": ("""\
        import jax

        def f(rng, kind):
            if kind == "binary":
                return jax.random.bernoulli(rng, 0.5, (4,))
            return jax.random.uniform(rng, (4,))

        def g(rng, kind):
            pop = (jax.random.bernoulli(rng, 0.5, (4,)) if kind == "b"
                   else jax.random.uniform(rng, (4,)))
            return pop
        """, """\
        from repro_torch import rand

        def f(rng, kind):
            if kind == "binary":
                return rand.keyed_bernoulli(rng, 0.5, (4,))
            return rand.keyed_uniform(rng, (4,))

        def g(rng, kind):
            pop = (rand.keyed_bernoulli(rng, 0.5, (4,)) if kind == "b"
                   else rand.keyed_uniform(rng, (4,)))
            return pop
        """),
    "rng01_loop_reuse_vs_carry": ("""\
        import jax

        def bad(rng):
            out = []
            for _ in range(3):
                out.append(jax.random.normal(rng, (2,)))
            return out

        def carry(rng):
            out = []
            for _ in range(3):
                rng, k = jax.random.split(rng)
                out.append(jax.random.normal(k, (2,)))
            return out
        """, """\
        from repro_torch import rand

        def bad(rng):
            out = []
            for _ in range(3):
                out.append(rand.keyed_normal(rng, (2,)))
            return out

        def carry(rng):
            out = []
            for _ in range(3):
                rng, k = rand.split(rng)
                out.append(rand.keyed_normal(k, (2,)))
            return out
        """),
    "pal01_impure_kernel_body": ("""\
        import numpy as np
        from jax.experimental import pallas as pl

        def kernel(x_ref, o_ref):
            print("trace")
            o_ref[...] = np.tanh(x_ref[...])

        def launch(x):
            return pl.pallas_call(kernel, out_shape=x)(x)
        """, """\
        import numpy as np
        from repro_torch import _build

        def plain(x, o):
            print("trace")
            o[...] = np.tanh(x)

        def launch(x, o):
            if x.device.type == "cpu":
                return plain(x, o)
            lib = _build.library()
            lib.tanh_launch(x.data_ptr(), o.data_ptr())
            return o
        """),
    "pal01_clean_twin": ("""\
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        def kernel(x_ref, o_ref):
            o_ref[...] = jnp.tanh(x_ref[...])

        def launch(x):
            return pl.pallas_call(kernel, out_shape=x)(x)
        """, """\
        import torch
        from repro_torch import _build

        def plain(x, o):
            o[...] = torch.tanh(x)

        def launch(x, o):
            if x.device.type == "cpu":
                return plain(x, o)
            lib = _build.library()
            lib.tanh_launch(x.data_ptr(), o.data_ptr())
            return o
        """),
    "jit01_through_partial": ("""\
        import time
        from functools import partial
        import jax

        def step(x, n):
            jax.debug.print("x={}", x)
            time.sleep(0.1)
            return x * n

        def driver(x):
            f = jax.jit(partial(step, n=2))
            return f(x)
        """, """\
        import time
        from functools import partial
        import torch

        def step(x, n):
            x = x + 0
            time.sleep(0.1)
            return x * n

        def driver(x):
            f = torch.compile(partial(step, n=2))
            return f(x)
        """),
    "don01_use_after_donation": ("""\
        import jax
        from functools import partial

        def driver(step_fn, state, xs):
            run = jax.jit(partial(step_fn), donate_argnums=(0,))
            out = run(state, xs)
            return state.mean() + out

        def carry_ok(step_fn, state, xs):
            run = jax.jit(step_fn, donate_argnums=(0,))
            for _ in range(3):
                state = run(state, xs)
            return state
        """, """\
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim.schedules import constant

        def driver(model, state, xs):
            run = make_train_step(model, schedule=constant(1e-3))
            out = run(state, xs)
            return state.mean() + out

        def carry_ok(model, state, xs):
            run = make_train_step(model, schedule=constant(1e-3))
            for _ in range(3):
                state = run(state, xs)
            return state
        """),
    "reg01_arity_reg02_hole_decorators": ("""\
        from repro.kernels.ga.registry import register_kernel

        @register_kernel("generation", "binary", "ref")
        def gen_binary(rng, pop, fitness, pop_size, cfg, genome):
            return pop

        @register_kernel("generation", "float", "ref")
        def gen_float(rng, pop, fitness):
            return pop

        @register_kernel("generation", "binary", "lonely")
        def gen_lonely(rng, pop, fitness, pop_size, cfg, genome):
            return pop
        """, """\
        from repro_torch.kernels.ga.registry import register_kernel

        @register_kernel("generation", "binary", "ref")
        def gen_binary(rng, pop, fitness, pop_size, cfg, genome):
            return pop

        @register_kernel("generation", "float", "ref")
        def gen_float(rng, pop, fitness):
            return pop

        @register_kernel("generation", "binary", "lonely")
        def gen_lonely(rng, pop, fitness, pop_size, cfg, genome):
            return pop
        """),
    "reg01_arity_reg02_hole_tables": ("""\
        from repro.kernels.ga.registry import register_kernel

        @register_kernel("generation", "binary", "ref")
        def gen_binary(rng, pop, fitness, pop_size, cfg, genome):
            return pop

        @register_kernel("generation", "float", "ref")
        def gen_float(rng, pop, fitness):
            return pop

        @register_kernel("generation", "binary", "lonely")
        def gen_lonely(rng, pop, fitness, pop_size, cfg, genome):
            return pop
        """, """\
        from repro_torch.kernels.ga.registry import KERNELS, register_kernel
        def gen_binary(rng, pop, fitness, pop_size, cfg, genome): return pop
        KERNELS[("generation", "binary", "ref")] = gen_binary

        def gen_float(rng, pop, fitness):
            return pop
        register_kernel("generation", "float", "ref")(gen_float)

        def gen_lonely(rng, pop, fitness, pop_size, cfg, genome):
            return pop
        KERNELS.update({("generation", "binary", "lonely"): gen_lonely})
        """),
}


@pytest.mark.parametrize("case", sorted(TRANSLATED))
def test_translated_fixture_gives_the_references_lines(tmp_path, case):
    ref_src, port_src = TRANSLATED[case]
    ref = lint(tmp_path / "ref", ref_src, package=ref_analysis)
    port = lint(tmp_path / "port", port_src)
    assert lines_of(port) == lines_of(ref)


def test_translated_fixtures_cover_every_jax_rule(tmp_path):
    rules = set()
    for case, (_, port_src) in TRANSLATED.items():
        rules |= {r for r, _ in lines_of(lint(tmp_path / case, port_src))}
    assert rules == {"RNG01", "PAL01", "JIT01", "DON01", "REG01", "REG02"}


# ---------------------------------------------------------------------------
# (c) the port's additions
# ---------------------------------------------------------------------------
GLOBAL_RNG = """\
    import torch

    def draws(w, g):
        a = torch.randn(3)
        b = torch.randn(3, generator=g)
        w.normal_(0.0, 0.1)
        w.uniform_(-1.0, 1.0, generator=g)
        torch.nn.init.normal_(w)
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        c = torch.randint(0, 9, (4,), generator=g)
        return a, b, c

    def generators(dev, seed):
        g0 = torch.Generator()
        g1 = torch.Generator(device=dev).manual_seed(seed)
        g2 = torch.Generator(device=dev)
        g2.manual_seed(seed)
        return torch.rand(2, generator=g1), torch.randperm(5), g0, g2
    """


@pytest.mark.parametrize("root", ["models", "data", "optim", "core",
                                  "kernels"])
def test_rng02_torch_global_rng_in_seeded_roots(tmp_path, root):
    res = lint(tmp_path, GLOBAL_RNG, name=f"{root}/init.py")
    assert lines_of(res) == {("RNG02", n) for n in (4, 6, 8, 9, 10, 15, 19)}


def test_rng02_torch_global_rng_outside_seeded_roots(tmp_path):
    assert not active(lint(tmp_path, GLOBAL_RNG, name="launch/init.py"))


def test_rng01_port_carry_idiom_and_loop_reuse(tmp_path):
    res = lint(tmp_path, """\
        from repro_torch import rand

        def carry(key, n):
            out = []
            for _ in range(n):
                keys = rand.split(key, 2)
                key, k_mig = keys[0], keys[1]
                out.append(rand.keyed_bits(k_mig, (4,)))
            return out

        def reuse(key, n):
            keys = rand.split(key, 2)
            k_mig = keys[1]
            out = []
            for _ in range(n):
                out.append(rand.keyed_bits(k_mig, (4,)))
            return out

        def derived(key):
            k = key.clone()
            a = rand.keyed_bits(rand.key_data(k), (2,))
            return a, rand.keyed_bits(key, (2,))
        """)
    assert lines_of(res) == {("RNG01", 16)}


def test_rng01_imports_resolve_through_aliases(tmp_path):
    src = """\
        {imp}

        def f(rng):
            a = {r}.keyed_uniform(rng, (4,))
            return a, {r}.split(rng, 2)
        """
    for imp, r in (("from repro_torch import rand as R", "R"),
                   ("import repro_torch.rand as rr", "rr")):
        res = lint(tmp_path / r, src.format(imp=imp, r=r))
        assert lines_of(res) == {("RNG01", 5)}
    # inside the package: `from .. import rand`
    res = lint(tmp_path / "pkg", src.format(imp="from .. import rand",
                                            r="rand"),
               name="src/repro_torch/core/mod.py")
    assert lines_of(res) == {("RNG01", 5)}


WRAPPER = """\
    import numpy as np
    import torch
    from repro_torch import _build

    def _plain(x, n):
        return x * n.tolist()[0]

    def _check(x):
        if not bool(x.is_contiguous()):
            raise ValueError(x)

    def launch(x, n, flag):
        _check(x)
        lib = _build.library()
        lib.scale_launch(x.data_ptr(), int(n), x.cpu().numpy().size)
        return x, bool(flag), np.float32(1)

    def scale(x, n, flag=False):
        if x.device.type == "cpu":
            return _plain(x, n)
        return launch(x, n, flag)

    def smem_bytes(x):
        return int(_build.library().scale_smem_bytes()) + x.sum().item()

    def host_report(x):
        return x.sum().item()
    """


def test_pal01_launcher_wrapper_and_plain_version(tmp_path):
    res = lint(tmp_path, WRAPPER)
    assert lines_of(res) == {("PAL01", 6), ("PAL01", 15), ("PAL01", 16)}
    msgs = {f.line: f.message for f in active(res)}
    assert "`.tolist()` host sync" in msgs[6]
    assert "int() coercion of parameter 'n'" in msgs[15] \
        or "`.cpu()`" in msgs[15]


def test_pal01_reports_each_marker_of_a_line(tmp_path):
    res = lint(tmp_path, """\
        from repro_torch import _build

        def launch(x, n):
            lib = _build.library()
            lib.a_launch(x.item())
            lib.a_launch(x.tolist())
            lib.a_launch(x.cpu())
            lib.a_launch(x.numpy())
            lib.a_launch(float(n))
            lib.a_launch(x.sum().item())
            global COUNT
            print(x)
            open("log")
        """)
    assert lines_of(res) == {("PAL01", n) for n in range(5, 14)}


GRAPHS = """\
    import torch

    def body(x, n):
        return x * int(n)

    def pure(x):
        return x + 1

    def capture(x, n):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = body(x, n)
            z = pure(y).cpu()
        return g, z

    def capture_legacy(x):
        g = torch.cuda.CUDAGraph()
        g.capture_begin()
        y = x.item()
        g.capture_end()
        return y, x.item()

    def graphed(f, x):
        return torch.cuda.make_graphed_callables((f, stepped), (x,))

    def stepped(x):
        print(x)
        return x

    @torch.compile
    def compiled(x):
        return x.tolist()

    def compiled_later(x):
        return torch.compile(lambda y: helper(y))(x)

    def helper(y):
        return y.numpy()
    """


def test_jit01_graph_capture_roots(tmp_path):
    res = lint(tmp_path, GRAPHS)
    assert lines_of(res) == {("JIT01", n) for n in (4, 13, 19, 27, 32, 38)}


CUSTOM_OPS = """\
    import torch

    @torch.library.custom_op("ns::op", mutates_args=())
    def op(x: torch.Tensor) -> torch.Tensor:
        return x * x.cpu().numpy().size

    @op.register_fake
    def _op_fake(x):
        print("fake")
        return torch.empty_like(x)

    class Fused(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, s):
            ctx.save_for_backward(a)
            return a * float(s)

        @staticmethod
        def backward(ctx, g):
            return g.item(), None

        @staticmethod
        def helper(a):
            return a.item()

    class NotAFunction:
        def forward(self, a):
            return a.item()
    """


def test_jit01_custom_op_and_autograd_function_roots(tmp_path):
    res = lint(tmp_path, CUSTOM_OPS)
    assert lines_of(res) == {("JIT01", n) for n in (5, 9, 16, 20)}


def test_jit01_shard_map_is_no_root_in_the_port(tmp_path):
    res = lint(tmp_path, """\
        import jax

        def step(x):
            print(x)
            return x

        def driver(x, mesh):
            return jax.shard_map(step, mesh=mesh)(x)
        """)
    assert not active(res)


def test_don01_consuming_functions_and_attribute_chains(tmp_path):
    res = lint(tmp_path, """\
        from repro_torch.optim.adamw import adamw_update
        from repro_torch.launch.steps import make_decode_step

        def update(grads, state):
            params, opt, m = adamw_update(grads, state.opt, state.params,
                                          lr=1e-3)
            norm = m["grad_norm"] + state.opt.mu["w"].sum()
            state = state._replace(params=params, opt=opt)
            return state.opt, norm

        def decode(model, inputs):
            step = make_decode_step(model)
            logits, caches = step(inputs)
            return logits, inputs["caches"]

        def decode_ok(model, token, index, caches):
            step = make_decode_step(model)
            logits, caches = step({"token": token, "index": index,
                                   "caches": caches})
            return logits, caches

        def keyword(grads, opt, params):
            p, o, m = adamw_update(grads, state=opt, params=params, lr=1.0)
            return opt
        """)
    assert lines_of(res) == {("DON01", 7), ("DON01", 14), ("DON01", 24)}


def test_registrations_fold_loops_factories_and_decorators(tmp_path):
    _write(tmp_path, """\
        from repro_torch.kernels.ga.registry import KERNELS, register_kernel

        def _entry(callee):
            def op(rng, pop, fitness, pop_size, cfg, genome, fused=None, *,
                   consts=None):
                return callee(rng, pop)
            return op

        def _bad_entry(callee):
            def op(rng, pop, fitness, pop_size, cfg, genome, fused, extra):
                return callee(rng, pop)
            return op

        good = _entry(print)
        bad = _bad_entry(print)

        for _kind in ("binary", "float"):
            for _op in ("generation", "generation_eval"):
                KERNELS.update({(_op, _kind, "a"): good,
                                (_op, _kind, "b"): bad})
            KERNELS[("generation", _kind, "c")] = good
            register_kernel("generation_eval", _kind, "c")(good)

        @register_kernel("generation", "binary", "d")
        def gen_d(rng, pop, fitness, pop_size, cfg, genome):
            return pop

        def register_all(op, kind, impl, fn):
            KERNELS[(op, kind, impl)] = fn
        """, "kernels/table.py")
    project = load_project(collect_python_files([str(tmp_path)],
                                                root=str(tmp_path)))
    keys = {r.key for r in collect_registrations(project)}
    cube = {(o, k) for o in ("generation", "generation_eval")
            for k in ("binary", "float")}
    assert keys == ({(o, k, i) for o, k in cube for i in "abc"}
                    | {("generation", "binary", "d")})
    res = analyze_paths([str(tmp_path)], root=str(tmp_path))
    # 'b' takes 8 required positionals (REG01 at both of its update
    # lines' cells, one per op), 'd' is half-registered (REG02)
    assert lines_of(res) == {("REG01", 19), ("REG02", 24)}
    assert sum(f.rule_id == "REG01" for f in active(res)) == 4


# ---------------------------------------------------------------------------
# (d) suppression round-trips and the CLI contract
# ---------------------------------------------------------------------------
def test_pragma_requires_reason_and_suppresses(tmp_path):
    sup, bad = parse_pragmas(
        ["x = 1  # repro-lint: disable=LCK01 -- helper called under lock",
         "y = 2  # repro-lint: disable=RNG01"], "m.py")
    assert sup == {1: {"LCK01"}}
    assert [f.rule_id for f in bad] == ["LNT01"]

    res = lint(tmp_path, """\
        from repro_torch import rand

        def f(rng):
            a = rand.keyed_normal(rng, (4,))
            # repro-lint: disable=RNG01 -- fixture: covers the next line
            b = rand.keyed_uniform(rng, (4,))
            return a + b
        """)
    assert not active(res)
    assert [f.rule_id for f in res["suppressed"]] == ["RNG01"]


def test_baseline_round_trip_one_shot_and_stale(tmp_path):
    entry = {"rule": "LCK01", "path": "mod.py", "line": 13,
             "snippet": "return self._up",
             "justification": "test fixture"}
    bl = Baseline([dict(entry)])
    res = lint(tmp_path, LOCK_BAD, baseline=bl)
    assert not active(res) and not bl.unused()

    twice = LOCK_BAD + textwrap.dedent("""\

        def also_up(self):
            return self._up
        """).replace("def also_up", "    def also_up").replace(
        "        return", "            return")
    bl2 = Baseline([dict(entry)])
    assert len(active(lint(tmp_path, twice, baseline=bl2))) == 1

    bl3 = Baseline([dict(entry, snippet="return self._up and True")])
    res3 = lint(tmp_path, LOCK_BAD, baseline=bl3)
    assert len(active(res3)) == 1 and len(bl3.unused()) == 1

    with pytest.raises(ValueError):
        Baseline([dict(entry, justification="  ")])
    with pytest.raises(ValueError):
        Baseline([{"rule": "LCK01", "path": "mod.py", "justification": "x"}])


def test_shared_pragmas_read_by_both_analyzers_and_unused_ones_quiet():
    """The port's files carry the JAX package's pragmas: the three "fold_in
    derives" pragmas suppress the reference's RNG01 and nothing in the
    port's analyzer, which reports no pragma as unused."""
    files = [os.path.join(REPO, "src", "repro_torch", "core", f)
             for f in ("migration.py", "async_migration.py")]
    ref = ref_analysis.analyze_paths(files, root=REPO)
    port = analyze_paths(files, root=REPO)
    assert not active(ref) and not active(port)
    assert {f.rule_id for f in ref["suppressed"]} == {"RNG01"}
    assert not [f for f in port["suppressed"] if f.rule_id == "RNG01"]


def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))


def test_cli_exit_contract(tmp_path):
    bad = tmp_path / "models" / "badmod.py"
    bad.parent.mkdir()
    bad.write_text("import torch\n\n\ndef f():\n    return torch.rand(3)\n")

    r = _cli(tmp_path, "--baseline", "none", "models")
    assert r.returncode == 1 and "RNG02" in r.stdout
    r = _cli(tmp_path, "--baseline", "none", "--format", "github", "models")
    assert r.returncode == 1 and "::error file=models/badmod.py" in r.stdout

    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"entries": [
        {"rule": "RNG02", "path": "models/badmod.py", "line": 5,
         "snippet": "return torch.rand(3)", "justification": "fixture"}]}))
    r = _cli(tmp_path, "--baseline", str(bl), "models")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 suppressed, 0 stale" in r.stdout

    # the default baseline is ./analysis_baseline_torch.json
    (tmp_path / "analysis_baseline_torch.json").write_text(bl.read_text())
    assert _cli(tmp_path, "models").returncode == 0

    r = _cli(tmp_path, "--baseline", str(tmp_path / "missing.json"),
             "models")
    assert r.returncode == 2
    assert _cli(tmp_path).returncode == 2

    r = _cli(tmp_path, "--selfcheck")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "selfcheck OK" in r.stdout


def test_selfcheck_covers_every_rule():
    from repro_torch.analysis.__main__ import SELFCHECK_EXPECT
    assert set(SELFCHECK_EXPECT.values()) == {
        "RNG01", "RNG02", "LCK01", "LCK02", "PAL01", "JIT01", "REG01",
        "REG02", "REG03", "DON01", "OBS01", "LNT01"}


# ---------------------------------------------------------------------------
# (e) meta-tests against the tree
# ---------------------------------------------------------------------------
def _lint_paths():
    return ([os.path.join(REPO, "src", "repro_torch"),
             os.path.join(REPO, "chip_smoke.py")]
            + sorted(glob.glob(os.path.join(REPO, "tests",
                                            "test_torch_*.py"))))


def test_tree_is_clean_under_the_committed_baseline():
    bl = Baseline.load(BASELINE)
    res = analyze_paths(_lint_paths(), root=REPO, baseline=bl)
    assert not active(res), [f.format() for f in active(res)]
    assert not bl.unused(), bl.unused()


def test_baseline_entries_reference_live_lines():
    bl = Baseline.load(BASELINE)
    assert bl.entries
    for e in bl.entries:
        src = open(os.path.join(REPO, e["path"])).read().splitlines()
        assert 1 <= e["line"] <= len(src)
        assert src[e["line"] - 1].strip() == e["snippet"].strip(), e
        assert e["justification"].strip()
        assert set(e) == {"rule", "path", "line", "snippet",
                          "justification"}


def _port_project():
    return load_project(collect_python_files(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO))


def test_static_registry_matrix_matches_runtime():
    from repro_torch.core import acceptance as acc_lib
    from repro_torch.core import ga  # noqa: F401 — registers the jnp impl
    from repro_torch.core import migration as mig_lib
    from repro_torch.kernels.ga import ops  # noqa: F401 — fills the table
    from repro_torch.kernels.ga.registry import registered_kernels

    regs = collect_registrations(_port_project())
    assert {r.key for r in regs if r.family == "kernel"} == \
        set(registered_kernels())
    assert {r.key[0] for r in regs if r.family == "topology"} == \
        set(mig_lib.TOPOLOGIES)
    policies = {r.key[0] for r in regs if r.family == "acceptance"}
    assert policies == set(acc_lib.ACCEPTANCE_POLICIES)
    assert policies <= set(acc_lib.HOST_MIRRORED)


def _ref_project():
    return ref_analysis.symbols.load_project(
        ref_analysis.collect_python_files(
            [os.path.join(REPO, "src", "repro", "core")], root=REPO))


def test_snapshot_coverage_of_the_ports_loops():
    project = _port_project()
    assert snapshot.check_coverage(project) == []
    from repro_torch.core.types import ExperimentState
    assert snapshot.experiment_state_fields(project) == \
        list(ExperimentState._fields)


def test_loop_carries_equal_the_references_scan_carries():
    port = snapshot.scan_carry_names(_port_project())
    ref = ref_snapshot.scan_carry_names(_ref_project())
    assert port == {k.replace("repro.", "repro_torch.", 1): v
                    for k, v in ref.items()}
    assert len(port) == 2
    for names in port.values():
        assert [snapshot.CARRY_ALIASES.get(n, n) for n in names] == \
            [ref_snapshot.CARRY_ALIASES.get(n, n) for n in names]
    assert snapshot.HOST_MANAGED == ref_snapshot.HOST_MANAGED


def test_coverage_check_catches_an_escaped_carry(monkeypatch):
    project = _port_project()
    monkeypatch.setattr(snapshot, "CARRY_ALIASES", {})
    problems = snapshot.check_coverage(project)
    assert any("tick" in p and "escape" in p for p in problems)


def test_coverage_check_catches_a_new_loop_local(tmp_path):
    _write(tmp_path, """\
        def fused_scan(islands, pool, key, epoch0=0, stopped0=False,
                       obs0=(), *, max_epochs):
            epoch, stopped, obs, best = epoch0, stopped0, obs0, None
            for _ in range(max_epochs):
                keys = split(key)
                key, k = keys[0], keys[1]
                islands, pool = step(islands, pool, k)
                best = islands.best if best is None else best
                epoch = epoch + 1
            return islands, pool, key, epoch, stopped, obs, ()
        """, "src/repro_torch/core/evolution.py")
    types = open(os.path.join(REPO, "src", "repro_torch", "core",
                              "types.py")).read()
    _write(tmp_path, types, "src/repro_torch/core/types.py")
    project = load_project(collect_python_files([str(tmp_path)],
                                                root=str(tmp_path)))
    carries = snapshot.scan_carry_names(project)
    assert carries["repro_torch.core.evolution.fused_scan"] == \
        ["islands", "pool", "key", "epoch", "best"]
    problems = snapshot.check_coverage(project)
    assert any("'best'" in p and "escape" in p for p in problems)
    # 'stopped' and 'obs' are never rebound here, and astate is carried by
    # no loop: each field left out of every carry is reported
    assert any("ExperimentState.astate" in p for p in problems)
