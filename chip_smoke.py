#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and print
   the card's name and power limit;
2. the trap kernel against its plain version on the card (bit-equal);
2b. the F15 kernel against its plain version at (10000, 1000, m 50),
   Fig. 4's shape, at (1000, 1000, 50) and at (256, 200, 20) (bit-equal);
3. the binary generation kernel against its plain version on the card,
   every selection x crossover x fused eval, at 8 islands of 256 x 160
   with pop_size drawn in [128, 256] (bit-equal);
3b. the float generation kernel against its plain version, every
   selection x {two_point, uniform, blend} x {none, rastrigin, sphere,
   f15}, at 8 islands of 256 x 1000 with pop_size drawn in [128, 256] and
   the problem's fitness (bit-equal);
3c. the tiled generation kernel and the selection-plan kernel against
   their plain versions (bit-equal, genes and fitness): binary 2 x 2048 x
   160 with fused trap, every selection x {two_point, uniform}; binary
   1 x 2048 x 256, two-point, no eval; float 1 x 10,000 x 1000, every
   selection x blend x {none, f15}; then the tiled kernel against the
   untiled ones at the main paths' shapes, and three rows per block giving
   identical bits;
4. the main path: ``run_fused`` at the paper's configuration (trap 40x4,
   max_pop 256, min_pop 128, 100 generations per epoch, pool topology,
   8 islands, 5 epochs, W²) through the kernels, then again through the
   plain versions from the same seed: islands, pool and stats must be
   equal, and both of its kernels must have been launched;
4b. the paper's F15 path (D 1000, m 50, the shipped constants, blend
   crossover, sigma 0.3, otherwise as in 4): 2 epochs through the kernels
   and through the plain versions from the same seed, which must be equal,
   then a timed 5-epoch kernel run; both of its kernels must launch;
4c. both paths under ``impl="pallas_tiled"`` (paper-8 5 epochs, paper-f15-8
   2 epochs): equal to the ``impl="pallas"`` runs from the same seed, the
   tiled and plan kernels launched and the untiled ones not; a step
   profile of each, then evals/s of both impls in turns (pallas, tiled,
   tiled, pallas, 5 epochs each) on both paths;
4d. Fig. 4's row (``benchmarks/fig4_f15.py``): one fused generation+F15
   step of a 10,000 x 1000 population through ``impl="pallas"``, which
   routes it to the tiled kernel and then the F15 kernel; bit-equal to the
   plain version, timed as ms per 10,000 evaluations;
5. the trap kernel run at 132 islands (one block per SM), 3 epochs;
6. each kernel's time at the main paths' shapes, the tiled kernel's swept
   rows per block against the heuristic's, and one JSON line with each
   kernel's launches, time, plain time and bound;
7. the last line: ``{"ok": true, "device": {...}}``.

It imports the port only (``src/repro_torch``), never JAX or the reference.
Run times are wall clock around work that ends in
``torch.cuda.synchronize()``; kernel and plain-version times are CUDA
events around back-to-back calls (:func:`event_ms`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 2016
# Bounds of the card (NVIDIA H100 SXM data sheet, at the 700 W limit):
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# int32 operations: each of an SM's 4 schedulers issues one warp
# instruction (32 lanes) per clock, whether it goes to the integer ALU pipe
# (add, shift, logic) or as an IMAD to the FMA pipe, so at most 128 int32
# operations per SM per clock. At the clock of the f32 figure, which counts
# each of 128 FMA lanes as two operations, that is half of it.
INT32_OPS_PER_S = F32_OPS_PER_S / 2
# int32 operations of one Threefry-2x32 draw in generation.cu, counted as
# the compiled code runs it: only x0 is returned, a rotate by a constant is
# one funnel shift, and the salt word's key add, its first rotate and each
# injection's k + c are the same for every draw of a thread. So: the
# counter's key add; round 1's add and xor; rounds 2-19 of (add, shift,
# xor); round 20's add (its x1 is dead); 4 injections of 2 adds; the last
# injection's add to x0.
THREEFRY_OPS = 1 + 2 + 18 * 3 + 1 + 4 * 2 + 1
# int32 operations of a child gene besides its draws, read from phase 2 of
# generation.cu at their least: its counter, the mutation test (an integer
# compare of the bits against the rate's threshold) and the flip; on a row
# whose crossover gate is on, two cut compares and the select (two-point)
# or one compare and the select (uniform).
GENE_OPS = 3
CROSS_OPS = {"two_point": 3, "uniform": 2}
# A Box-Muller draw keeps the second word too: round 20's rotate and xor
# and the last injection's add to x1.
THREEFRY2_OPS = THREEFRY_OPS + 3
# f32 operations of the float generation, counted at their least from
# generation_float.cu (an FMA counts two, a transcendental one): a blended
# gene (sub and two FMAs), a mutated gene (1 - u1, log, -2 *, sqrt,
# 2 pi *, cos, r * cos, two int-to-float scalings, the FMA) and the clip
# of a child gene.
BLEND_F32 = 5
NORMAL_F32 = 11
CLIP_F32 = 2
# f32 operations per gene of an F15 row besides its rotation: z - o, the
# term (r * r, 2 pi * r, cos, 10 *, -, +) and its add to the sum.
F15_GENE_F32 = 8
TIMED_CALLS = 50
# head start of the timed windows: the card spins this long while the host
# enqueues the calls (the spin is counted in clock cycles; 2 GHz is above
# the H100's boost clock, so the spin lasts at least this long)
HEAD_START_S = 0.2
SPIN_CYCLES_PER_S = 2.0e9
# the paper's published CPU times for 10,000 F15 evaluations, in ms
# (2015; benchmarks/fig4_f15.py PAPER_MS)
PAPER_FIG4_MS = {"java": 991.0, "js_node": 1234.0}


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def event_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` by CUDA events around ``reps`` calls. The
    card first spins for :data:`HEAD_START_S`, while the host enqueues all
    the calls, so the events time the device running them back to back
    rather than the host's enqueue rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(HEAD_START_S * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def generation_work(seed, size, fit, spec, n_isl: int, n: int):
    """(bytes, int32 operations) that one generation kernel call needs on
    these inputs: each input read once and each output written once, and
    the Threefry draws and per-gene work of its child rows. Which rows cross
    over depends on the data, so the gate is read from the plain version's
    plan. The per-row work besides the draws (the randint modulo, the
    tournament compares) is left out: under 0.5 % of the count."""
    from repro_torch.kernels.ga.common import selection_plan
    if spec.selection != "tournament":
        raise ValueError("the bound is derived for tournament selection")
    length, children = spec.length, n - spec.elite
    gated = int(selection_plan(seed, fit, size, spec, n).gate.sum().item())
    row_draws = 2 * spec.tournament_k + 1 + (
        2 if spec.crossover == "two_point" else 0)
    draws = (n_isl * children * (row_draws + length)
             + (gated * length if spec.crossover == "uniform" else 0))
    ops = (draws * THREEFRY_OPS + n_isl * children * length * GENE_OPS
           + gated * length * CROSS_OPS[spec.crossover])
    fused = spec.fused_eval is not None
    nbytes = (2 * n_isl * n * length + (2 if fused else 1) * 4 * n_isl * n
              + 2 * 8 * n_isl + 4 * n_isl)
    return nbytes, ops


def plan_draws(spec) -> int:
    """Threefry draws of one child row's plan: k per tournament, two
    tournaments, the gate, and two cuts under two-point crossover."""
    return 2 * spec.tournament_k + 1 + (
        2 if spec.crossover == "two_point" else 0)


def plan_work(spec, n_isl: int, n: int):
    """(bytes, int32 operations) of the plan kernel: the fitness, seed and
    size read once and the five (I, n) int32 vectors written once; the
    Threefry draws of every child row (tournament selection)."""
    if spec.selection != "tournament":
        raise ValueError("the bound is derived for tournament selection")
    nbytes = 4 * n_isl * n + 2 * 8 * n_isl + 4 * n_isl + 5 * 4 * n_isl * n
    return nbytes, n_isl * (n - spec.elite) * plan_draws(spec) * THREEFRY_OPS


def float_generation_work(seed, size, fit, spec, consts, n_isl: int,
                          n: int, plan: bool = True):
    """(bytes, int32 operations, f32 operations) that one float generation
    kernel call needs on these inputs. The gated rows and the mutation
    hits (each a Box-Muller draw) are read from the plain version's draws
    on the same counters. With ``plan=False`` it is the tiled child
    kernel's work: the plan is read (five (I, n) int32 vectors) and its
    draws are the plan kernel's."""
    from repro_torch import rand
    from repro_torch.kernels.ga import common
    if spec.selection != "tournament":
        raise ValueError("the bound is derived for tournament selection")
    length, children = spec.length, n - spec.elite
    gated = int(common.selection_plan(seed, fit, size, spec,
                                      n).gate.sum().item())
    k0 = seed[:, 0].reshape(-1, 1, 1)
    k1 = seed[:, 1].reshape(-1, 1, 1)
    hits = int(rand.bernoulli(k0, k1, (children, length), spec.mutation_rate,
                              common.SALT_MUTATE).sum().item())
    genes = n_isl * children * length
    draws = ((n_isl * children * plan_draws(spec) if plan else 0) + genes
             + (gated * length if spec.crossover != "two_point" else 0))
    int_ops = draws * THREEFRY_OPS + hits * THREEFRY2_OPS + genes * GENE_OPS
    f32_ops = (hits * NORMAL_F32 + genes * CLIP_F32
               + (gated * length * BLEND_F32
                  if spec.crossover == "blend" else 0))
    # the population in and out, the seed words; the fitness in and out, or
    # the plan in and a fused fitness out
    nbytes = (2 * 4 * n_isl * n * length + 2 * 8 * n_isl
              + (4 * n_isl + 2 * 4 * n_isl * n if plan
                 else 5 * 4 * n_isl * n
                 + (4 * n_isl * n if spec.fused_eval else 0)))
    ev = spec.eval_spec or {}
    if ev.get("eval") == "f15":
        groups, m = int(ev["n_groups"]), int(ev["m"])
        f32_ops += n_isl * n * (groups * m * m * 2 + length * F15_GENE_F32)
        nbytes += consts_bytes(consts)
    return nbytes, int_ops, f32_ops


def consts_bytes(consts) -> int:
    return sum(t.numel() * t.element_size() for t in consts.values())


def f15_work(consts, rows: int):
    """(bytes, f32 operations) of the F15 kernel on ``rows`` rows: the
    population read once, the constants once, the values written once;
    the rotation's multiply-adds (two operations each) and the per-gene
    work."""
    groups, m, _ = consts["M"].shape
    dim = groups * m
    nbytes = rows * dim * 4 + consts_bytes(consts) + rows * 4
    return nbytes, rows * (groups * m * m * 2 + dim * F15_GENE_F32)


def bound_of(nbytes: int, int_ops: int = 0, f32_ops: int = 0):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over their rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT32_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def step_profile(tag: str, islands, problem, cfg, steps: int = 20):
    """Where a generation's time goes: its CUDA kernels (profiler) against
    the wall time of the same steps run unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import island as island_lib

    def generations(state):
        for _ in range(steps):
            state = island_lib.generation_step(state, problem, cfg)
        torch.cuda.synchronize()

    generations(islands)
    t = time.perf_counter()
    generations(islands)
    step_wall_us = (time.perf_counter() - t) / steps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generations(islands)
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"[{tag}] generation step: {step_wall_us:.1f} us wall per "
        f"generation (unprofiled, {steps} steps)")
    if not dev_events:
        log(f"[{tag}] device kernels per generation: not measured (the "
            "profiler saw no device events)")
        return
    busy_us = sum(e.device_time for e in dev_events) / steps
    by_name = {}
    for e in dev_events:
        cnt, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (cnt + 1, us + e.device_time)
    log(f"[{tag}] device kernels per generation: "
        f"{len(dev_events) / steps}; device busy {busy_us:.1f} us per "
        f"generation = {busy_us / step_wall_us:.3f} of the wall time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (cnt, us) in top:
        log(f"[{tag}]   {us / steps:9.2f} us/gen  {cnt / steps:6.1f} "
            f"launches/gen  {name[:90]}")
    # the host's side (profiled, so inflated alike on every path): the
    # operators that take the most of its own time
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"[{tag}]   host {e.self_cpu_time_total / steps:9.2f} us/gen "
            f"self  {e.count / steps:6.1f} calls/gen  {e.key[:60]}")


def same_run(tag: str, a, b):
    """Fail unless two (islands, pool, epochs, stats) results are equal."""
    import torch
    for what, x, y in (("islands", a[0], b[0]), ("pool", a[1], b[1]),
                       ("stats", a[3], b[3])):
        for name, u, v in zip(x._fields, x, y):
            if not torch.equal(u, v):
                fail(f"{tag}: {what}.{name} differs between the kernel run "
                     f"and the plain run")
    if int(a[2]) != int(b[2]):
        fail(f"{tag}: epoch counts differ")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch import _build, convert, kernels, rand
    from repro_torch.core import (EAConfig, MigrationConfig, make_f15,
                                  make_rastrigin, make_sphere, make_trap,
                                  run_fused)
    from repro_torch.core.problems import default_f15_consts
    from repro_torch.kernels.ga import autotune as _autotune
    from repro_torch.kernels.ga import get_kernel
    from repro_torch.kernels.ga import ref as gen_ref
    from repro_torch.kernels.ga.common import GenerationSpec
    from repro_torch.kernels.rastrigin import f15 as f15_k
    from repro_torch.kernels.rastrigin import ref as f15_ref
    from repro_torch.kernels.trap import ref as trap_ref
    from repro_torch.kernels.trap import trap as trap_k
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    # ---- 1: build, identify the card -------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> "
        f"{_build.library_path().relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for entry in _build.BUILD_LOG:
        for line in entry.splitlines():
            if line.startswith("==") or "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)

    # ---- 2: trap kernel against its plain version ------------------------
    consts = {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4}
    trap_err = 0.0
    for n, n_traps in ((8 * 256, 40), (1000, 40), (2048, 80)):
        pop = (torch.rand(n, n_traps * 4, generator=gen) < 0.5).to(
            torch.int8).to(dev)
        got = trap_k.trap_fitness(consts, pop, n_traps=n_traps)
        torch.cuda.synchronize()
        want = trap_ref.trap_fitness(pop, n_traps=n_traps, l=4, a=1.0, b=2.0,
                                     z=3.0)
        err = (got - want).abs().max().item()
        log(f"[trap] ({n}, {n_traps * 4}) bit-equal={torch.equal(got, want)} "
            f"max_abs_err={err}")
        if not torch.equal(got, want):
            fail(f"trap kernel differs from its plain version at {n}")
        if n_traps == 40 and n == 8 * 256:
            trap_err = err

    # ---- 2b: F15 kernel against its plain version -----------------------
    f15_consts = convert.f15_consts_from_numpy(default_f15_consts(), dev)

    def random_f15_consts(dim, m):
        groups = dim // m
        q, _ = torch.linalg.qr(torch.randn(groups, m, m, generator=gen,
                                           dtype=torch.float64))
        return {"o": (torch.rand(dim, generator=gen) * 10 - 5).to(dev),
                "perm": torch.randperm(dim, generator=gen).to(
                    torch.int32).to(dev),
                "M": q.to(torch.float32).contiguous().to(dev)}

    f15_err = 0.0
    for rows_n, dim, m in ((10000, 1000, 50), (1000, 1000, 50),
                           (256, 200, 20)):
        c = f15_consts if (dim, m) == (1000, 50) else random_f15_consts(dim,
                                                                        m)
        x = (torch.rand(rows_n, dim, generator=gen) * 10 - 5).to(dev)
        got = f15_k.f15(c, x)
        torch.cuda.synchronize()
        want = f15_ref.f15(c, x)
        err = (got - want).abs().max().item()
        diff = int((got != want).sum().item())
        log(f"[f15] ({rows_n}, {dim}, m {m}) bit-equal={diff == 0} "
            f"differing rows={diff} max_abs_err={err}")
        if diff:
            fail(f"F15 kernel differs from its plain version at "
                 f"({rows_n}, {dim}, {m}): {diff} rows")
        if rows_n == 10000:
            f15_err, f15_fig4 = err, (c, x)

    # ---- 3: generation kernel against its plain version ------------------
    n_isl, n, length = 8, 256, 160
    fused_specs = {
        "none": None,
        "trap": (("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4),
                 ("z", 3.0)),
        "onemax": (("eval", "onemax"),),
        "royal_road": (("eval", "royal_road"), ("r", 8)),
    }
    main_inputs = None
    gen_err = 0.0
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform"):
            for fname, fused in fused_specs.items():
                spec = GenerationSpec(
                    kind="binary", length=length, elite=2,
                    selection=selection, tournament_k=2, crossover=crossover,
                    crossover_rate=0.9, mutation_rate=1.0 / length,
                    mutation_sigma=0.3, fused_eval=fused)
                pop = (torch.rand(n_isl, n, length, generator=gen) < 0.5).to(
                    torch.int8).to(dev)
                fit = (torch.randn(n_isl, n, generator=gen) * 10).to(dev)
                size = torch.randint(128, 257, (n_isl,), generator=gen,
                                     dtype=torch.int32).to(dev)
                seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                                     dtype=torch.int64).to(dev)
                got = gen_k.generation_kernel(seed, size, pop, fit, spec)
                torch.cuda.synchronize()
                want = gen_ref.generation(seed, size, pop, fit, spec)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rows = int((got[0] != want[0]).any(-1).sum().item())
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
                fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
                log(f"[generation] {selection}/{crossover}/{fname}: "
                    f"pop bit-equal={rows == 0} differing rows={rows} "
                    f"fitness equal={fit_eq} max_abs_err={err}")
                # bit equality in every case, roulette included: the kernel
                # and the plain version both scan its f32 CDF left to right
                if rows or not fit_eq:
                    fail(f"generation kernel differs: {selection}/"
                         f"{crossover}/{fname}, {rows} rows")
                if (selection, crossover, fname) == ("tournament",
                                                     "two_point", "trap"):
                    main_inputs = (seed, size, pop, fit, spec)
                    gen_err = err

    # ---- 3b: float generation kernel against its plain version -----------
    f_len = 1000
    float_problems = {"none": make_rastrigin(f_len),
                      "rastrigin": make_rastrigin(f_len),
                      "sphere": make_sphere(f_len),
                      "f15": make_f15(device=dev)}
    float_inputs = None
    float_err = 0.0
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform", "blend"):
            for fname, prob in float_problems.items():
                g = prob.genome
                spec = GenerationSpec(
                    kind="float", length=f_len, elite=2,
                    selection=selection, tournament_k=2, crossover=crossover,
                    crossover_rate=0.9, mutation_rate=1.0 / f_len,
                    mutation_sigma=0.3, low=g.low, high=g.high,
                    fused_eval=(None if fname == "none"
                                else tuple(sorted(prob.fused.items()))))
                pop = (torch.rand(n_isl, n, f_len, generator=gen)
                       * (g.high - g.low) + g.low).to(dev)
                fit = prob.evaluate(prob.consts, pop.reshape(-1, f_len)
                                    ).reshape(n_isl, n)
                size = torch.randint(128, 257, (n_isl,), generator=gen,
                                     dtype=torch.int32).to(dev)
                seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                                     dtype=torch.int64).to(dev)
                got = gen_k.generation_kernel(seed, size, pop, fit, spec,
                                              prob.consts)
                torch.cuda.synchronize()
                want = gen_ref.generation(seed, size, pop, fit, spec,
                                          prob.consts)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                genes = int((got[0] != want[0]).sum().item())
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
                log(f"[generation_float] {selection}/{crossover}/{fname}: "
                    f"pop bit-equal={genes == 0} differing genes={genes} "
                    f"fitness equal={fit_eq} max_abs_err={err}")
                if genes or not fit_eq:
                    fail(f"float generation kernel differs: {selection}/"
                         f"{crossover}/{fname}, {genes} genes")
                if (selection, crossover, fname) == ("tournament", "blend",
                                                     "f15"):
                    float_inputs = (seed, size, pop, fit, spec, prob.consts)
                    float_err = err

    # ---- 3c: the tiled kernel and the plan kernel -------------------------
    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def random_case(kind, n_isl, n, length, selection, crossover, fused,
                    sizes=None, fit=None):
        spec = GenerationSpec(
            kind=kind, length=length, elite=2, selection=selection,
            tournament_k=2, crossover=crossover, crossover_rate=0.9,
            mutation_rate=1.0 / length, mutation_sigma=0.3,
            fused_eval=fused)
        if kind == "binary":
            pop = (torch.rand(n_isl, n, length, generator=gen) < 0.5).to(
                torch.int8).to(dev)
        else:
            pop = (torch.rand(n_isl, n, length, generator=gen) * 10 - 5).to(
                dev)
        if fit is None:
            fit = (torch.randn(n_isl, n, generator=gen) * 10).to(dev)
        size = (torch.full((n_isl,), n, dtype=torch.int32) if sizes is None
                else torch.randint(sizes[0], sizes[1] + 1, (n_isl,),
                                   generator=gen, dtype=torch.int32)).to(dev)
        seed = torch.randint(0, 2**32, (n_isl, 2), generator=gen,
                             dtype=torch.int64).to(dev)
        return (seed, size, pop, fit), spec

    def tiled_check(tag, args, spec, consts=None, rows=None, plan=False):
        """The tiled kernel (and the plan kernel) against the plain
        version; fail unless bit-equal. Returns the kernel's output and its
        largest difference."""
        got = as_tuple(tiling_k.generation_tiled(*args, spec, tile_pop=rows,
                                                 consts=consts))
        torch.cuda.synchronize()
        want = as_tuple(gen_ref.generation(*args, spec, consts))
        genes = int((got[0] != want[0]).sum().item())
        fit_eq = len(got) == 1 or torch.equal(got[1], want[1])
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        plan_eq = True
        if plan:
            p_seed, p_size, _, p_fit = args
            got_p = tiling_k.plan_kernel(p_seed, p_size, p_fit, spec)
            want_p = selection_plan(p_seed, p_fit, p_size, spec,
                                    p_fit.shape[1])
            plan_eq = all(torch.equal(a, b) for a, b in zip(got_p, want_p))
            plan_errs.append(max((a - b).abs().max().item()
                                 for a, b in zip(got_p, want_p)))
        log(f"[tiled] {tag}: pop bit-equal={genes == 0} differing genes="
            f"{genes} fitness equal={fit_eq}"
            + (f" plan equal={plan_eq}" if plan else "")
            + f" max_abs_err={err}")
        if genes or not fit_eq or not plan_eq:
            fail(f"tiled kernel differs from its plain version: {tag}")
        return got, err

    tiling_k = importlib.import_module("repro_torch.kernels.ga.tiling")
    from repro_torch.kernels.ga.common import selection_plan
    trap_fused = fused_specs["trap"]
    tiled_err = 0.0
    plan_errs = []
    for selection in ("tournament", "roulette"):
        for crossover in ("two_point", "uniform"):
            args, spec = random_case("binary", 2, 2048, 160, selection,
                                     crossover, trap_fused, (1024, 2048))
            _, err = tiled_check(f"binary 2x2048x160 trap {selection}/"
                                 f"{crossover}", args, spec, plan=True)
            tiled_err = max(tiled_err, err)
    args, spec = random_case("binary", 1, 2048, 256, "tournament",
                             "two_point", None)
    tiled_check("binary 1x2048x256 (the reference's roofline shape)", args,
                spec)
    f15_fused = tuple(sorted(float_problems["f15"].fused.items()))
    tiled_fig4 = None
    for selection in ("tournament", "roulette"):
        for fname, fused in (("none", None), ("f15", f15_fused)):
            args, spec = random_case("float", 1, 10000, 1000, selection,
                                     "blend", fused)
            got, err = tiled_check(
                f"float 1x10000x1000 {selection}/blend/{fname}", args, spec,
                consts=f15_consts if fused else None, plan=fname == "none")
            tiled_err = max(tiled_err, err)
            if (selection, fname) == ("tournament", "none"):
                tiled_fig4 = (args, spec, got[0])
    # the tiled kernel equals the untiled ones at the main paths' shapes
    for tag, inputs in (("binary 8x256x160 trap", main_inputs + (None,)),
                        ("float 8x256x1000 f15", float_inputs)):
        *args, spec, u_consts = inputs
        untiled = as_tuple(gen_k.generation_kernel(*args, spec, u_consts))
        tiled = as_tuple(tiling_k.generation_tiled(*args, spec,
                                                   consts=u_consts))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(tiled, untiled))
        log(f"[tiled] {tag}: tiled == untiled kernel (genes and fitness) "
            f"{same}")
        if not same:
            fail(f"tiled kernel differs from the untiled one: {tag}")
    # any rows per block give the same bits
    args, spec, base = tiled_fig4
    for rows in (1, 7, 32):
        other = tiling_k.generation_tiled(*args, spec, tile_pop=rows)
        torch.cuda.synchronize()
        log(f"[tiled] float 1x10000x1000, {rows} rows per block: identical "
            f"to the autotuned rows {torch.equal(other, base)}")
        if not torch.equal(other, base):
            fail(f"tiled kernel output depends on the rows per block ({rows})")

    # ---- 4: the main path at the paper's configuration -------------------
    cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                   generations_per_epoch=100)
    mig = MigrationConfig(topology="pool")
    problem = make_trap(40, 4, impl="pallas")

    def drive(problem, cfg, n_islands, max_epochs, seed):
        t = time.perf_counter()
        out = run_fused(problem, cfg, mig, n_islands=n_islands,
                        max_epochs=max_epochs, rng=seed, w2=True,
                        return_stats=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    drive(problem, cfg, 8, 1, SEED + 1)              # warm-up, not counted
    kernels.reset_launches()
    run, wall = drive(problem, cfg, 8, 5, SEED)
    islands, pool, epochs, stats = run
    launches = dict(kernels.LAUNCHES)
    evals = int(islands.evaluations.sum().item())
    log(f"[main] kernels: 8 islands x 5 epochs: {evals} evaluations in "
        f"{wall:.3f} s = {evals / wall:.1f} evals/s, {wall / 5:.4f} s per "
        f"epoch; launches {launches}; best "
        f"{islands.best_fitness.max().item()}")
    if min(launches["trap_fitness"], launches["generation"]) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    ref_cfg = EAConfig(impl="pallas_ref", max_pop=256, min_pop=128,
                       generations_per_epoch=100)
    kernels.reset_launches()
    r_run, r_wall = drive(make_trap(40, 4), ref_cfg, 8, 5, SEED)
    r_evals = int(r_run[0].evaluations.sum().item())
    log(f"[main] plain: {r_evals} evaluations in {r_wall:.3f} s = "
        f"{r_evals / r_wall:.1f} evals/s; launches {dict(kernels.LAUNCHES)}")
    if max(kernels.LAUNCHES.values()) != 0:
        fail("the plain run launched a kernel")
    same_run("main path", run, r_run)
    log(f"[main] kernel run == plain run: islands, pool, stats "
        f"({convert.to_numpy(stats).best_fitness.tolist()} best per epoch)")
    if not bool(torch.isfinite(islands.best_fitness).all()):
        fail("non-finite best fitness")
    step_profile("main", islands, problem, cfg)

    # ---- 4b: the paper's F15 path ----------------------------------------
    f_cfg = EAConfig(impl="pallas", max_pop=256, min_pop=128,
                     generations_per_epoch=100, crossover="blend",
                     mutation_sigma=0.3)
    f_problem = make_f15(impl="pallas")
    f_kernels = ("f15", "generation_float")
    kernels.reset_launches()
    f_run, f_wall = drive(f_problem, f_cfg, 8, 2, SEED)
    log(f"[f15-main] kernels: 8 islands x 2 epochs in {f_wall:.3f} s; "
        f"launches {dict(kernels.LAUNCHES)}")
    if min(kernels.LAUNCHES[k] for k in f_kernels) <= 0:
        fail(f"a kernel of the F15 path was never launched: "
             f"{dict(kernels.LAUNCHES)}")
    kernels.reset_launches()
    fr_run, fr_wall = drive(make_f15(), EAConfig(
        impl="pallas_ref", max_pop=256, min_pop=128,
        generations_per_epoch=100, crossover="blend", mutation_sigma=0.3),
        8, 2, SEED)
    log(f"[f15-main] plain: 8 islands x 2 epochs in {fr_wall:.3f} s; "
        f"launches {dict(kernels.LAUNCHES)}")
    if max(kernels.LAUNCHES.values()) != 0:
        fail("the plain F15 run launched a kernel")
    same_run("F15 path", f_run, fr_run)
    log(f"[f15-main] kernel run == plain run: islands, pool, stats "
        f"({convert.to_numpy(f_run[3]).best_fitness.tolist()} best per "
        f"epoch)")
    kernels.reset_launches()
    (f_isl, _, _, _), f_wall5 = drive(f_problem, f_cfg, 8, 5, SEED)
    f_launches = dict(kernels.LAUNCHES)
    f_evals = int(f_isl.evaluations.sum().item())
    log(f"[f15-main] kernels: 8 islands x 5 epochs: {f_evals} evaluations "
        f"in {f_wall5:.3f} s = {f_evals / f_wall5:.1f} evals/s, "
        f"{f_wall5 / 5:.4f} s per epoch; launches {f_launches}; best "
        f"{f_isl.best_fitness.max().item()}")
    if min(f_launches[k] for k in f_kernels) <= 0:
        fail(f"a kernel of the F15 path was never launched: {f_launches}")
    if not bool(torch.isfinite(f_isl.best_fitness).all()):
        fail("non-finite best fitness on the F15 path")
    step_profile("f15-main", f_isl, f_problem, f_cfg)

    # ---- 4c: both paths under impl="pallas_tiled" --------------------------
    tiled_kernels = ("generation_tiled", "selection_plan")

    def tiled_launches_ok(tag, launches):
        if min(launches[k] for k in tiled_kernels) <= 0 or max(
                launches["generation"], launches["generation_float"]) != 0:
            fail(f"{tag}: want the tiled and plan kernels only, got "
                 f"{launches}")

    t_cfg = dataclasses.replace(cfg, impl="pallas_tiled")
    drive(problem, t_cfg, 8, 1, SEED + 1)   # warm-up, autotune sweep
    kernels.reset_launches()
    t_run, t_wall = drive(problem, t_cfg, 8, 5, SEED)
    t_launches = dict(kernels.LAUNCHES)
    tiled_launches_ok("paper-8 pallas_tiled", t_launches)
    same_run("paper-8 pallas_tiled vs pallas", t_run, run)
    t_evals = int(t_run[0].evaluations.sum().item())
    log(f"[tiled-main] paper-8 pallas_tiled: {t_evals} evaluations in "
        f"{t_wall:.3f} s = {t_evals / t_wall:.1f} evals/s (pallas "
        f"{evals / wall:.1f}); launches {t_launches}; islands, pool, stats "
        f"== the pallas run")
    step_profile("tiled-main", t_run[0], problem, t_cfg)

    tf_cfg = dataclasses.replace(f_cfg, impl="pallas_tiled")
    drive(f_problem, tf_cfg, 8, 1, SEED + 1)   # warm-up, autotune sweep
    kernels.reset_launches()
    tf_run, tf_wall = drive(f_problem, tf_cfg, 8, 2, SEED)
    tf_launches = dict(kernels.LAUNCHES)
    tiled_launches_ok("paper-f15-8 pallas_tiled", tf_launches)
    if tf_launches["f15"] <= 0:
        fail(f"paper-f15-8 pallas_tiled: the F15 kernel never launched: "
             f"{tf_launches}")
    same_run("paper-f15-8 pallas_tiled vs pallas", tf_run, f_run)
    tf_evals = int(tf_run[0].evaluations.sum().item())
    f2_evals = int(f_run[0].evaluations.sum().item())
    log(f"[tiled-f15-main] paper-f15-8 pallas_tiled: 8 islands x 2 epochs: "
        f"{tf_evals} evaluations in {tf_wall:.3f} s = "
        f"{tf_evals / tf_wall:.1f} evals/s (pallas, first 2-epoch run: "
        f"{f2_evals / f_wall:.1f}; 5 epochs: {f_evals / f_wall5:.1f}); "
        f"launches {tf_launches}; islands, pool, stats == the pallas run")
    step_profile("tiled-f15-main", tf_run[0], f_problem, tf_cfg)

    # evals/s of both impls in turns (pallas, tiled, tiled, pallas), 5
    # epochs each: one call's host spread between runs is wider than the
    # difference a single pair of runs could show
    for tag, prob, p_cfg, p_tiled in (("paper-8", problem, cfg, t_cfg),
                                      ("paper-f15-8", f_problem, f_cfg,
                                       tf_cfg)):
        rates = []
        for c in (p_cfg, p_tiled, p_tiled, p_cfg):
            (isl, _, _, _), w = drive(prob, c, 8, 5, SEED)
            rates.append(f"{c.impl} {isl.evaluations.sum().item() / w:.1f}")
        log(f"[tiled-turns] {tag} evals/s in turns: " + "; ".join(rates))

    # ---- 4d: Fig. 4's row: one fused generation+F15 step, 10,000 x 1000 ---
    fig4_problem = float_problems["f15"]
    fig4_cfg = EAConfig(max_pop=10000, min_pop=8, crossover="blend",
                        mutation_sigma=0.3)
    g4 = fig4_problem.genome
    fig4_pop = (torch.rand(1, 10000, f_len, generator=gen)
                * (g4.high - g4.low) + g4.low).to(dev)
    fig4_fit = fig4_problem.evaluate(fig4_problem.consts,
                                     fig4_pop[0])[None]
    fig4_args = (rand.key(1, device=dev)[None], fig4_pop, fig4_fit,
                 torch.tensor([10000], dtype=torch.int32, device=dev),
                 fig4_cfg, g4, fig4_problem.fused)
    fig4_kern = get_kernel("generation_eval", "float", "pallas")

    def fig4_call():
        return fig4_kern(*fig4_args, consts=fig4_problem.consts)

    fig4_call()                              # warm-up, autotune sweep
    torch.cuda.synchronize()
    kernels.reset_launches()
    fig4_out = fig4_call()
    torch.cuda.synchronize()
    fig4_launches = dict(kernels.LAUNCHES)
    want_launches = {"generation_tiled": 1, "selection_plan": 1, "f15": 1,
                     "generation_float": 0, "generation": 0}
    if any(fig4_launches[k] != v for k, v in want_launches.items()):
        fail(f"Fig. 4's row did not take the tiled path: {fig4_launches}")
    fig4_want = get_kernel("generation_eval", "float", "pallas_ref")(
        *fig4_args, consts=fig4_problem.consts)
    fig4_eq = all(torch.equal(a, b) for a, b in zip(fig4_out, fig4_want))
    fig4_err = max((a - b).abs().max().item()
                   for a, b in zip(fig4_out, fig4_want))
    log(f"[fig4] generation_eval float pallas at 1x10000x1000 (F15, blend, "
        f"sigma 0.3): launches {fig4_launches}; bit-equal to the plain "
        f"version {fig4_eq} (max_abs_err {fig4_err})")
    if not fig4_eq:
        fail("Fig. 4's row differs from its plain version")
    if not bool(torch.isfinite(fig4_out[1]).all()):
        fail("Fig. 4's row: non-finite fitness")
    fig4_step_ms = event_ms(fig4_call, TIMED_CALLS)
    log(f"[fig4] {fig4_step_ms:.4f} ms per 10,000 evaluations (one fused "
        f"generation+F15 step, CUDA events, {card}); the paper's published "
        f"2015 CPU figures for 10,000 F15 evaluations "
        f"(benchmarks/fig4_f15.py): Java {PAPER_FIG4_MS['java']} ms, "
        f"Node {PAPER_FIG4_MS['js_node']} ms")

    # ---- 5: one block per SM ---------------------------------------------
    drive(problem, cfg, 132, 1, SEED + 2)            # warm-up
    (w_isl, _, _, _), w_wall = drive(problem, cfg, 132, 3, SEED)
    w_evals = int(w_isl.evaluations.sum().item())
    log(f"[wide] kernels: 132 islands x 3 epochs: {w_evals} evaluations in "
        f"{w_wall:.3f} s = {w_evals / w_wall:.1f} evals/s, "
        f"{w_wall / 3:.4f} s per epoch; {w_evals / w_wall / (evals / wall):.2f}"
        f" times paper-8's evals/s, {w_wall / 3 / (wall / 5):.2f} times its "
        f"wall per epoch")

    # ---- 6: kernel times at the main-path shapes --------------------------
    seed, size, pop, fit, spec = main_inputs
    flat = pop.reshape(-1, length)
    def trap_call():
        return trap_k.trap_fitness(consts, flat, n_traps=40)

    def gen_call():
        return gen_k.generation_kernel(seed, size, pop, fit, spec)

    f_seed, f_size, f_pop, f_fit, f_spec, f_consts = float_inputs

    def float_call():
        return gen_k.generation_kernel(f_seed, f_size, f_pop, f_fit, f_spec,
                                       f_consts)

    # the F15 path's own F15 calls score a whole batch of islands at once
    f15_x = f_pop.reshape(-1, f_len)

    trap_ms = event_ms(trap_call, TIMED_CALLS)
    trap_plain_ms = event_ms(lambda: trap_ref.trap_fitness(
        flat, n_traps=40, l=4, a=1.0, b=2.0, z=3.0), 10)
    gen_ms = event_ms(gen_call, TIMED_CALLS)
    gen_plain_ms = event_ms(lambda: gen_ref.generation(seed, size, pop, fit,
                                                       spec), 5)
    float_ms = event_ms(float_call, TIMED_CALLS)
    float_plain_ms = event_ms(lambda: gen_ref.generation(
        f_seed, f_size, f_pop, f_fit, f_spec, f_consts), 3)
    f15_ms = event_ms(lambda: f15_k.f15(f15_consts, f15_x), TIMED_CALLS)
    f15_plain_ms = event_ms(lambda: f15_ref.f15(f15_consts, f15_x), 5)
    fig4_c, fig4_x = f15_fig4
    fig4_ms = event_ms(lambda: f15_k.f15(fig4_c, fig4_x), TIMED_CALLS)
    fig4_plain_ms = event_ms(lambda: f15_ref.f15(fig4_c, fig4_x), 3)
    # the rotation alone as one batched product (TF32 off), the yardstick
    # for a later redesign; no single PyTorch call computes F15
    groups, m, _ = fig4_c["M"].shape
    zg = f15_ref.shift_permute(fig4_x, fig4_c["o"], fig4_c["perm"]).reshape(
        -1, groups, m).transpose(0, 1).contiguous()
    bmm_ms = event_ms(lambda: torch.bmm(zg, fig4_c["M"]), TIMED_CALLS)
    # the tiled kernel and the plan kernel at Fig. 4's 10,000 x 1000
    # (tournament, blend, no fused eval), each alone
    (t_seed, t_size, t_pop, t_fit), t_spec, _ = tiled_fig4
    t_n = t_pop.shape[1]
    t_plan = tiling_k.plan_buffer(t_seed, t_size, t_fit, t_spec)
    tiled_ms = event_ms(lambda: tiling_k.child_kernel(t_seed, t_pop, t_plan,
                                                      t_spec), TIMED_CALLS)
    tiled_plain_ms = event_ms(lambda: gen_ref.generation(
        t_seed, t_size, t_pop, t_fit, t_spec), 3)
    plan_ms = event_ms(lambda: tiling_k.plan_buffer(t_seed, t_size, t_fit,
                                                    t_spec), TIMED_CALLS)
    plan_plain_ms = event_ms(lambda: selection_plan(t_seed, t_fit, t_size,
                                                    t_spec, t_n), 3)
    # the gather of both parents by one PyTorch call each: the yardstick of
    # the child kernel's bytes (the port does not call it)
    gather_ms = event_ms(lambda: (
        torch.index_select(t_pop[0], 0, t_plan[0, 0]),
        torch.index_select(t_pop[0], 0, t_plan[1, 0])), TIMED_CALLS)
    tl_bytes, tl_int, tl_f32 = float_generation_work(
        t_seed, t_size, t_fit, t_spec, None, 1, t_n, plan=False)
    tiled_bound, tiled_by = bound_of(tl_bytes, tl_int, tl_f32)
    pl_bytes, pl_ops = plan_work(t_spec, 1, t_n)
    plan_bound, plan_by = bound_of(pl_bytes, int_ops=pl_ops)
    t_rows = tiling_k.max_rows(f_len, t_spec, gen_k.max_smem_bytes(0))
    log(f"[kernels] generation_tiled at 1x{t_n}x{f_len} (tournament, blend):"
        f" {tiled_ms * 1e3:.2f} us, plain {tiled_plain_ms * 1e3:.1f} us, "
        f"bound {tiled_bound * 1e3:.3f} us ({tiled_by}: {tl_bytes} B, "
        f"{tl_int} int32 ops, {tl_f32} f32 ops), {tiled_ms / tiled_bound:.1f}"
        f" times it; index_select of both parents {gather_ms * 1e3:.2f} us; "
        f"selection_plan {plan_ms * 1e3:.2f} us, plain "
        f"{plan_plain_ms * 1e3:.1f} us, bound {plan_bound * 1e3:.4f} us "
        f"({plan_by}: {pl_bytes} B, {pl_ops} int32 ops); rows per block "
        f"{_autotune.load_cache().get(torch.cuda.get_device_name(), {})}"
        f" (shared memory holds {t_rows})")
    # the child kernel at paper-8's shape (8 x 256 x 160, fused trap), the
    # shape of its 500 launches in 4c
    m_plan = tiling_k.plan_buffer(seed, size, fit, spec)
    tiled_main_ms = event_ms(lambda: tiling_k.child_kernel(seed, pop, m_plan,
                                                           spec), TIMED_CALLS)
    plan_main_ms = event_ms(lambda: tiling_k.plan_buffer(seed, size, fit,
                                                         spec), TIMED_CALLS)
    log(f"[kernels] at paper-8's ({n_isl}, {n}, {length}) fused trap: "
        f"generation_tiled {tiled_main_ms * 1e3:.2f} us, selection_plan "
        f"{plan_main_ms * 1e3:.2f} us (the untiled generation kernel below)")
    # the swept rows per block against the heuristic's, in turns (swept,
    # heuristic, heuristic, swept) at both shapes: whether the sweep earns
    # its keep
    for tag, (r_seed, r_pop, r_plan, r_spec) in (
            ("paper-8 8x256x160 trap", (seed, pop, m_plan, spec)),
            ("Fig. 4 1x10000x1000", (t_seed, t_pop, t_plan, t_spec))):
        r_isl, r_n, r_len = r_pop.shape
        cap = tiling_k.max_rows(r_len, r_spec, gen_k.max_smem_bytes(0))
        swept = min(_autotune.best_tiles(r_n, r_len, r_spec.kind,
                                         n_islands=r_isl, spec=r_spec)[0],
                    cap)
        rule = min(_autotune.heuristic_rows(r_len), cap)
        turns = []
        for rows in (swept, rule, rule, swept):
            turns.append(event_ms(lambda: tiling_k.child_kernel(
                r_seed, r_pop, r_plan, r_spec, rows), TIMED_CALLS))
        log(f"[autotune] {tag}: swept {swept} rows per block "
            f"{turns[0] * 1e3:.2f} / {turns[3] * 1e3:.2f} us, heuristic "
            f"{rule} rows {turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us "
            f"(in turns, CUDA events, {card})")
    log(f"[kernels] events per call: trap {trap_ms * 1e3:.2f} us, plain "
        f"{trap_plain_ms * 1e3:.1f} us; generation {gen_ms * 1e3:.2f} us, "
        f"plain {gen_plain_ms * 1e3:.1f} us; generation_float "
        f"{float_ms * 1e3:.2f} us, plain {float_plain_ms * 1e3:.1f} us; f15 "
        f"({f15_x.shape[0]}, {f_len}) {f15_ms * 1e3:.2f} us, plain "
        f"{f15_plain_ms * 1e3:.1f} us")
    rows_n = flat.shape[0]
    trap_bytes = rows_n * length + 4 * rows_n
    trap_ops = rows_n * length + rows_n * 40 * 6
    trap_bound, trap_by = bound_of(trap_bytes, f32_ops=trap_ops)
    gen_bytes, gen_ops = generation_work(seed, size, fit, spec, n_isl, n)
    gen_bound, gen_by = bound_of(gen_bytes, int_ops=gen_ops)
    log(f"[kernels] generation work: {gen_bytes} B, {gen_ops} int32 ops "
        f"({THREEFRY_OPS} per draw) -> bound {gen_bound * 1e3:.4f} us; "
        f"kernel at {gen_ms / gen_bound:.1f} times its bound")
    fl_bytes, fl_int, fl_f32 = float_generation_work(
        f_seed, f_size, f_fit, f_spec, f_consts, n_isl, n)
    float_bound, float_by = bound_of(fl_bytes, fl_int, fl_f32)
    log(f"[kernels] generation_float work: {fl_bytes} B, {fl_int} int32 "
        f"ops, {fl_f32} f32 ops -> bound {float_bound * 1e3:.4f} us; kernel "
        f"at {float_ms / float_bound:.1f} times its bound")
    f15_bytes, f15_ops = f15_work(f15_consts, f15_x.shape[0])
    f15_bound, f15_by = bound_of(f15_bytes, f32_ops=f15_ops)
    fig4_bytes, fig4_ops = f15_work(fig4_c, fig4_x.shape[0])
    fig4_bound, _ = bound_of(fig4_bytes, f32_ops=fig4_ops)
    log(f"[kernels] f15 work at ({f15_x.shape[0]}, {f_len}): {f15_bytes} B, "
        f"{f15_ops} f32 ops -> bound {f15_bound * 1e3:.4f} us; kernel at "
        f"{f15_ms / f15_bound:.1f} times its bound")
    log(f"[kernels] f15 at Fig. 4's ({fig4_x.shape[0]}, {f_len}): "
        f"{fig4_ms * 1e3:.2f} us, plain {fig4_plain_ms * 1e3:.1f} us, bound "
        f"{fig4_bound * 1e3:.3f} us ({fig4_bytes} B, {fig4_ops} f32 ops); "
        f"the rotation alone by torch.bmm (TF32 off) {bmm_ms * 1e3:.2f} us")
    result = {"kernels": [
        {"name": "trap_fitness", "route": "cuda",
         "source": "src/repro_torch/kernels/trap/csrc/trap.cu",
         "replaces": "src/repro/kernels/trap/trap.py:33",
         "launches": launches["trap_fitness"], "max_abs_err": trap_err,
         "ms": trap_ms, "plain_ms": trap_plain_ms, "bound_ms": trap_bound,
         "bound_by": trap_by, "library_ms": None},
        {"name": "generation", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation.cu",
         "replaces": "src/repro/kernels/ga/generation.py:58",
         "launches": launches["generation"], "max_abs_err": gen_err,
         "ms": gen_ms, "plain_ms": gen_plain_ms, "bound_ms": gen_bound,
         "bound_by": gen_by, "library_ms": None},
        {"name": "generation_float", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation_float.cu",
         "replaces": "src/repro/kernels/ga/generation.py:58",
         "launches": f_launches["generation_float"],
         "max_abs_err": float_err, "ms": float_ms,
         "plain_ms": float_plain_ms, "bound_ms": float_bound,
         "bound_by": float_by, "library_ms": None},
        {"name": "f15", "route": "cuda",
         "source": "src/repro_torch/kernels/rastrigin/csrc/f15.cu",
         "replaces": "src/repro/kernels/rastrigin/rastrigin.py:50",
         "launches": f_launches["f15"], "max_abs_err": f15_err,
         "ms": f15_ms, "plain_ms": f15_plain_ms, "bound_ms": f15_bound,
         "bound_by": f15_by, "library_ms": None},
        {"name": "generation_tiled", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation_tiled.cu",
         "replaces": "src/repro/kernels/ga/tiling.py:133",
         "launches": fig4_launches["generation_tiled"],
         "max_abs_err": tiled_err, "ms": tiled_ms,
         "plain_ms": tiled_plain_ms, "bound_ms": tiled_bound,
         "bound_by": tiled_by, "library_ms": gather_ms},
        {"name": "selection_plan", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/plan.cu",
         "replaces": "src/repro/kernels/ga/tiling.py:168",
         "launches": fig4_launches["selection_plan"],
         "max_abs_err": max(plan_errs), "ms": plan_ms,
         "plain_ms": plan_plain_ms, "bound_ms": plan_bound,
         "bound_by": plan_by, "library_ms": None},
    ]}
    log(f"[kernels] shapes: trap ({rows_n}, {length}); generation "
        f"({n_isl}, {n}, {length}) fused trap, tournament, two_point; "
        f"generation_float ({n_isl}, {n}, {f_len}) fused f15, tournament, "
        f"blend; f15 ({f15_x.shape[0]}, {f_len}, m 50); generation_tiled "
        f"and selection_plan (1, {t_n}, {f_len}) tournament, blend, no eval, "
        f"launches from Fig. 4's row (4d); card {card}")
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
