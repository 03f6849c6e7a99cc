#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` and print
   the card's name and power limit;
2. the trap kernel against its plain version on the card (bit-equal);
3. the generation kernel against its plain version on the card, every
   selection x crossover x fused eval, at 8 islands of 256 x 160 with
   pop_size drawn in [128, 256] (bit-equal);
4. the main path: ``run_fused`` at the paper's configuration (trap 40x4,
   max_pop 256, min_pop 128, 100 generations per epoch, pool topology,
   8 islands, 5 epochs, W²) through the kernels, then again through the
   plain versions from the same seed: islands, pool and stats must be
   equal, and both kernels must have been launched;
5. the same kernel run at 132 islands (one block per SM), 3 epochs;
6. one JSON line with each kernel's launches, time, plain time and bound;
7. the last line: ``{"ok": true, "device": {...}}``.

It imports the port only (``src/repro_torch``), never JAX or the reference.
Run times are wall clock around work that ends in
``torch.cuda.synchronize()``; kernel and plain-version times are CUDA
events around back-to-back calls (:func:`event_ms`).
"""
from __future__ import annotations

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
TIMED_CALLS = 50
# head start of the timed windows: the card spins this long while the host
# enqueues the calls (the spin is counted in clock cycles; 2 GHz is above
# the H100's boost clock, so the spin lasts at least this long)
HEAD_START_S = 0.2
SPIN_CYCLES_PER_S = 2.0e9


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch import _build, convert, kernels
    from repro_torch.core import (EAConfig, MigrationConfig, make_trap,
                                  run_fused)
    from repro_torch.kernels.ga import ref as gen_ref
    from repro_torch.kernels.ga.common import GenerationSpec
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
    (islands, pool, epochs, stats), wall = drive(problem, cfg, 8, 5, SEED)
    launches = dict(kernels.LAUNCHES)
    evals = int(islands.evaluations.sum().item())
    generations = 5 * cfg.generations_per_epoch
    log(f"[main] kernels: 8 islands x 5 epochs: {evals} evaluations in "
        f"{wall:.3f} s = {evals / wall:.1f} evals/s, {wall / 5:.4f} s per "
        f"epoch; launches {launches}; best "
        f"{islands.best_fitness.max().item()}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")

    ref_cfg = EAConfig(impl="pallas_ref", max_pop=256, min_pop=128,
                       generations_per_epoch=100)
    kernels.reset_launches()
    (r_isl, r_pool, r_epochs, r_stats), r_wall = drive(
        make_trap(40, 4), ref_cfg, 8, 5, SEED)
    r_evals = int(r_isl.evaluations.sum().item())
    log(f"[main] plain: {r_evals} evaluations in {r_wall:.3f} s = "
        f"{r_evals / r_wall:.1f} evals/s; launches {dict(kernels.LAUNCHES)}")
    if max(kernels.LAUNCHES.values()) != 0:
        fail("the plain run launched a kernel")
    for what, a, b in (("islands", islands, r_isl), ("pool", pool, r_pool),
                       ("stats", stats, r_stats)):
        for name, x, y in zip(a._fields, a, b):
            if not torch.equal(x, y):
                fail(f"main path: {what}.{name} differs between the kernel "
                     f"run and the plain run")
    if int(epochs) != int(r_epochs):
        fail("main path: epoch counts differ")
    log(f"[main] kernel run == plain run: islands, pool, stats "
        f"({convert.to_numpy(stats).best_fitness.tolist()} best per epoch)")
    if not bool(torch.isfinite(islands.best_fitness).all()):
        fail("non-finite best fitness")

    # where a generation's time goes: its CUDA kernels (profiler) against
    # the wall time of the same steps run unprofiled
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import island as island_lib
    steps = 20

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
    log(f"[main] generation step: {step_wall_us:.1f} us wall per "
        f"generation (unprofiled, {steps} steps)")
    if dev_events:
        busy_us = sum(e.device_time for e in dev_events) / steps
        by_name = {}
        for e in dev_events:
            cnt, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (cnt + 1, us + e.device_time)
        log(f"[main] device kernels per generation: "
            f"{len(dev_events) / steps}; device busy {busy_us:.1f} us per "
            f"generation = {busy_us / step_wall_us:.3f} of the wall time")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        for name, (cnt, us) in top:
            log(f"[main]   {us / steps:9.2f} us/gen  {cnt / steps:6.1f} "
                f"launches/gen  {name[:90]}")
    else:
        log("[main] device kernels per generation: not measured (the "
            "profiler saw no device events)")

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

    trap_ms = event_ms(trap_call, TIMED_CALLS)
    trap_plain_ms = event_ms(lambda: trap_ref.trap_fitness(
        flat, n_traps=40, l=4, a=1.0, b=2.0, z=3.0), 10)
    gen_ms = event_ms(gen_call, TIMED_CALLS)
    gen_plain_ms = event_ms(lambda: gen_ref.generation(seed, size, pop, fit,
                                                       spec), 5)
    log(f"[kernels] events per call: trap {trap_ms * 1e3:.2f} us, plain "
        f"{trap_plain_ms * 1e3:.1f} us; generation {gen_ms * 1e3:.2f} us, "
        f"plain {gen_plain_ms * 1e3:.1f} us")
    rows_n = flat.shape[0]
    trap_bytes = rows_n * length + 4 * rows_n
    trap_ops = rows_n * length + rows_n * 40 * 6
    trap_bound = max(trap_bytes / HBM_BYTES_PER_S,
                     trap_ops / F32_OPS_PER_S) * 1e3
    gen_bytes, gen_ops = generation_work(seed, size, fit, spec, n_isl, n)
    gen_bound = max(gen_bytes / HBM_BYTES_PER_S,
                    gen_ops / INT32_OPS_PER_S) * 1e3
    log(f"[kernels] generation work: {gen_bytes} B, {gen_ops} int32 ops "
        f"({THREEFRY_OPS} per draw) -> bound {gen_bound * 1e3:.4f} us; "
        f"kernel at {gen_ms / gen_bound:.1f} times its bound")
    result = {"kernels": [
        {"name": "trap_fitness", "route": "cuda",
         "source": "src/repro_torch/kernels/trap/csrc/trap.cu",
         "replaces": "src/repro/kernels/trap/trap.py:33",
         "launches": launches["trap_fitness"], "max_abs_err": trap_err,
         "ms": trap_ms, "plain_ms": trap_plain_ms, "bound_ms": trap_bound,
         "bound_by": ("bytes" if trap_bytes / HBM_BYTES_PER_S
                      >= trap_ops / F32_OPS_PER_S else "operations"),
         "library_ms": None},
        {"name": "generation", "route": "cuda",
         "source": "src/repro_torch/kernels/ga/csrc/generation.cu",
         "replaces": "src/repro/kernels/ga/generation.py:58",
         "launches": launches["generation"], "max_abs_err": gen_err,
         "ms": gen_ms, "plain_ms": gen_plain_ms, "bound_ms": gen_bound,
         "bound_by": ("bytes" if gen_bytes / HBM_BYTES_PER_S
                      >= gen_ops / INT32_OPS_PER_S else "operations"),
         "library_ms": None},
    ]}
    log(f"[kernels] shapes: trap ({rows_n}, {length}); generation "
        f"({n_isl}, {n}, {length}) fused trap, tournament, two_point; "
        f"card {card}")
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
