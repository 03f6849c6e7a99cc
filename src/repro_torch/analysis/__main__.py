"""CLI: ``python -m repro_torch.analysis [options] paths...``

Exits 0 when every finding is pragma- or baseline-suppressed, 1 when any
active finding (or parse error, or reasonless pragma) remains, 2 on bad
invocation.  ``--format github`` emits ``::error`` workflow commands.
The default baseline is ``./analysis_baseline_torch.json`` if present.

``--selfcheck`` writes known-bad snippets in the port's idiom, one per
rule (a reused :mod:`repro_torch.rand` key, torch's global RNG in a
seeded root, unlocked reads of locked state in both lock flavors, a host
sync in a kernel wrapper and in a graph capture, a consumed train state
read again, a kernel of the wrong arity and a half-registered impl, a
bare pool insert, a wall-clock duration and a reasonless pragma) to a
scratch directory, runs the analyzer over them, and exits 0 only if all
are caught — so a silently broken analyzer cannot green-light the tree.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .engine import analyze_paths
from .findings import Baseline

DEFAULT_BASELINE = "analysis_baseline_torch.json"

SELFCHECK_SNIPPETS = {
    "bad_rng.py": (
        "from repro_torch import rand\n"
        "\n"
        "\n"
        "def sample_twice(rng):\n"
        "    a = rand.keyed_normal(rng, (4,))\n"
        "    b = rand.keyed_uniform(rng, (4,))\n"
        "    return a + b\n"
    ),
    "core/bad_global_rng.py": (
        "import torch\n"
        "\n"
        "\n"
        "def init_weights(shape):\n"
        "    return torch.randn(shape)\n"
    ),
    "bad_lock.py": (
        "import threading\n"
        "\n"
        "\n"
        "class Server:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._up = True\n"
        "\n"
        "    def kill(self):\n"
        "        with self._lock:\n"
        "            self._up = False\n"
        "\n"
        "    def is_up(self):\n"
        "        return self._up\n"
    ),
    "bad_async_lock.py": (
        "import asyncio\n"
        "\n"
        "\n"
        "class Registry:\n"
        "    def __init__(self):\n"
        "        self._lock = asyncio.Lock()\n"
        "        self._count = 0\n"
        "\n"
        "    async def add(self):\n"
        "        async with self._lock:\n"
        "            self._count = self._count + 1\n"
        "\n"
        "    async def snapshot(self):\n"
        "        return self._count\n"
    ),
    "bad_wrapper.py": (
        "from repro_torch import _build\n"
        "\n"
        "\n"
        "def scale_kernel(x, n):\n"
        "    lib = _build.library()\n"
        "    lib.scale_launch(x.data_ptr(), int(x.sum().item()))\n"
        "    return x\n"
    ),
    "bad_graph.py": (
        "import torch\n"
        "\n"
        "\n"
        "def step(x):\n"
        "    return x * 2\n"
        "\n"
        "\n"
        "def capture(x):\n"
        "    g = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(g):\n"
        "        y = step(x)\n"
        "        n = y.tolist()\n"
        "    return g, y, n\n"
    ),
    "bad_consumed.py": (
        "from repro_torch.launch.steps import make_train_step\n"
        "\n"
        "\n"
        "def train(model, state, batch, schedule):\n"
        "    step = make_train_step(model, schedule=schedule)\n"
        "    new_state, metrics = step(state, batch)\n"
        "    return state.params, new_state\n"
    ),
    "bad_arity.py": (
        "from repro_torch.kernels.ga.registry import KERNELS\n"
        "\n"
        "\n"
        "def gen_short(rng, pop, fitness):\n"
        "    return pop\n"
        "\n"
        "\n"
        "for _kind in (\"binary\", \"float\"):\n"
        "    for _op in (\"generation\", \"generation_eval\"):\n"
        "        KERNELS.update({(_op, _kind, \"short\"): gen_short})\n"
    ),
    "bad_matrix.py": (
        "from repro_torch.kernels.ga import registry\n"
        "\n"
        "\n"
        "def gen(rng, pop, fitness, pop_size, cfg, genome, fused=None):\n"
        "    return pop\n"
        "\n"
        "\n"
        "for _op in (\"generation\", \"generation_eval\"):\n"
        "    registry.register_kernel(_op, \"binary\", \"full\")(gen)\n"
        "    registry.register_kernel(_op, \"float\", \"full\")(gen)\n"
        "registry.register_kernel(\"generation\", \"binary\",\n"
        "                         \"lonely\")(gen)\n"
    ),
    "bad_insert.py": (
        "from repro_torch.core.pool import pool_put_batch\n"
        "\n"
        "\n"
        "def absorb(pool, genomes, fitness):\n"
        "    return pool_put_batch(pool, genomes, fitness)\n"
    ),
    "bad_wallclock.py": (
        "import time\n"
        "\n"
        "\n"
        "def timed_work(fn):\n"
        "    t0 = time.time()\n"
        "    fn()\n"
        "    return time.time() - t0\n"
    ),
    "bad_pragma.py": (
        "import time\n"
        "\n"
        "\n"
        "def stamp():\n"
        "    return time.time()  # repro-lint: disable=OBS01\n"
    ),
}
SELFCHECK_EXPECT = {"bad_rng.py": "RNG01", "core/bad_global_rng.py": "RNG02",
                    "bad_lock.py": "LCK01", "bad_async_lock.py": "LCK02",
                    "bad_wrapper.py": "PAL01", "bad_graph.py": "JIT01",
                    "bad_consumed.py": "DON01", "bad_arity.py": "REG01",
                    "bad_matrix.py": "REG02", "bad_insert.py": "REG03",
                    "bad_wallclock.py": "OBS01", "bad_pragma.py": "LNT01"}


def _selfcheck() -> int:
    with tempfile.TemporaryDirectory(prefix="repro_lint_selfcheck_") as tmp:
        for name, src in SELFCHECK_SNIPPETS.items():
            path = os.path.join(tmp, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                fh.write(src)
        result = analyze_paths([tmp], root=tmp)
        hits = {}
        for f in result["errors"] + result["active"]:
            hits.setdefault(f.path, set()).add(f.rule_id)
        ok = True
        for name, rule in SELFCHECK_EXPECT.items():
            if hits.get(name) != {rule}:
                ok = False
                print(f"selfcheck FAILED: expected {rule} in {name}, "
                      f"got {sorted(hits.get(name, ()))!r}",
                      file=sys.stderr)
        if ok:
            print(f"selfcheck OK: analyzer caught "
                  f"{sorted(SELFCHECK_EXPECT.values())} in seeded snippets")
            return 0
        return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint for the PyTorch port: AST invariant "
                    "analyzer (RNG/lock/purity/registry/consumed-state "
                    "discipline)")
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--format", choices=("text", "github"), default="text")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression file (default: ./{DEFAULT_BASELINE} "
                         f"if present; 'none' disables)")
    ap.add_argument("--root", default=None,
                    help="anchor for repo-relative paths (default: CWD)")
    ap.add_argument("--selfcheck", action="store_true",
                    help="verify the analyzer catches seeded violations")
    args = ap.parse_args(argv)

    if args.selfcheck:
        return _selfcheck()
    if not args.paths:
        ap.print_usage(sys.stderr)
        print("error: no paths given", file=sys.stderr)
        return 2

    baseline = None
    bl_path = args.baseline
    if bl_path != "none":
        if bl_path is None and os.path.isfile(DEFAULT_BASELINE):
            bl_path = DEFAULT_BASELINE
        if bl_path is not None:
            if not os.path.isfile(bl_path):
                print(f"error: baseline {bl_path!r} not found",
                      file=sys.stderr)
                return 2
            try:
                baseline = Baseline.load(bl_path)
            except ValueError as exc:
                print(f"error: bad baseline: {exc}", file=sys.stderr)
                return 2

    result = analyze_paths(args.paths, root=args.root, baseline=baseline)
    active = result["errors"] + result["active"]
    for f in active:
        print(f.format(args.format))

    n_sup = len(result["suppressed"])
    stale = baseline.unused() if baseline is not None else []
    for e in stale:
        msg = (f"stale baseline entry: {e['rule']} at {e['path']} "
               f"(snippet {e['snippet']!r}) no longer matches any "
               f"finding — remove it")
        print(msg if args.format == "text"
              else f"::warning title=stale-baseline::{msg}")

    summary = (f"repro-lint: {len(active)} finding(s), "
               f"{n_sup} suppressed, {len(stale)} stale baseline entr"
               f"{'y' if len(stale) == 1 else 'ies'}")
    print(summary, file=sys.stderr if active else sys.stdout)
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
