"""The NodIO experiment from the command line: the ``ea`` command.

The port of ``repro/launch/evolve.py``: the host loop
(:func:`~repro_torch.core.run_experiment`) or, with ``--fused``,
:func:`~repro_torch.core.run_fused`; with ``--runtime async`` their
asynchronous counterparts (:func:`~repro_torch.core.run_experiment_async`,
:func:`~repro_torch.core.run_fused_async`), with ``--min-rate``,
``--max-rate``, ``--staleness`` and ``--churn``. The fused drivers take
``--snapshot-every``, ``--snapshot-dir`` and ``--resume`` (kill the
process, rerun with ``--resume``, and the final state is the uninterrupted
run's; another ``--islands`` resizes the restored state). ``--bridge``
attaches an in-process :class:`~repro_torch.core.PoolServer` to a host
loop through :class:`~repro_torch.core.HostBridge`
(:class:`~repro_torch.core.AsyncHostBridge` under ``--runtime async``).

``--sharded`` splits the islands over ranks (:mod:`repro_torch.core.
sharded`): the host loop :func:`~repro_torch.core.run_sharded` (which takes
``--bridge``), ``--fused`` :func:`~repro_torch.core.run_fused_sharded`,
``--runtime async`` :func:`~repro_torch.core.run_fused_sharded_async` (both
take the snapshots). Under ``torchrun`` every process is a rank
(``WORLD_SIZE`` of them); otherwise the command spawns ``--shards`` ranks
(default: one per visible card, one on the CPU), NCCL where each rank has
its own card, gloo on the CPU or with host copies where ranks share a
card; ``--islands`` are split as the reference splits them
(``max(1, islands // shards)`` a rank). On the card:

    python -m repro_torch.launch.evolve ea --problem trap --islands 8

and on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.evolve ea --problem trap \\
        --islands 8 --epochs 3 --device cpu [--impl jnp|pallas|...] \\
        [--topology ...] [--acceptance ...] [--fused] [--runtime async] \\
        [--bridge] [--snapshot-every 2 --snapshot-dir DIR [--resume]] \\
        [--sharded --shards 2]

The ``pbt`` command is not ported yet and raises ``NotImplementedError``
naming its ROADMAP item (Queue A item 14).
"""
from __future__ import annotations

import argparse
import os
import time

from functools import partial

import torch

from .._device import DeviceLike, resolve_device
from ..core import (AcceptanceConfig, AsyncConfig, AsyncHostBridge, EAConfig,
                    HostBridge, MigrationConfig, PoolServer,
                    available_acceptance_policies, available_topologies,
                    make_problem, run_experiment, run_experiment_async,
                    run_fused, run_fused_async, run_fused_sharded,
                    run_fused_sharded_async, run_sharded)
from ..core import sharded as sharded_lib
from ..kernels.ga import available_impls

# (flag, ROADMAP Queue A item) of the reference's drivers not ported yet
_LATER = {"pbt": 14}


def _later(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP, Queue A "
                              f"item {_LATER[key]})")


def run_ea(problem_name: str = "trap", islands: int = 8, epochs: int = 50,
           w2: bool = False, sharded: bool = False, seed: int = 0,
           verbose: bool = True, topology: str = "pool", fused: bool = False,
           bridge: bool = False, runtime: str = "sync",
           acfg: AsyncConfig = None, acceptance: str = "always",
           acceptance_epsilon: float = 0.0, impl: str = "jnp",
           max_pop: int = None, min_pop: int = None,
           gens_per_epoch: int = None, snapshot_every: int = None,
           snapshot_dir: str = None, resume: bool = False,
           device: DeviceLike = None, shards: int = None,
           timeout: float = 1800.0, **problem_kwargs):
    """Run the NodIO experiment. ``topology`` and ``acceptance`` select the
    registered migration strategy and immigrant policy
    (``acceptance_epsilon`` is dedup's radius), ``impl`` the generation
    operator, ``fused`` the fused driver, ``runtime='async'`` the
    asynchronous runtime under ``acfg``. The fused drivers snapshot every
    ``snapshot_every`` epochs into ``snapshot_dir`` and ``resume`` from
    there; the host loops take no snapshots. ``bridge`` syncs a host
    loop's device pool with an in-process ``PoolServer(capacity=256,
    seed=seed)`` under the run's acceptance policy. ``sharded`` splits
    the islands over ``shards`` ranks (see the module's docstring), each
    collective and the whole world bounded by ``timeout`` seconds.
    Returns the host loop's ``RunResult`` (``AsyncRunResult``), or
    ``(islands, pool)`` of the fused and the sharded drivers."""
    if runtime not in ("sync", "async"):
        raise ValueError(f"unknown runtime {runtime!r}")
    is_async = runtime == "async"
    if acfg is None:
        acfg = AsyncConfig()
    # the sharded async driver is fused only, as the reference's
    on_device = fused or (sharded and is_async)
    if bridge and on_device:
        print("note: --bridge needs a host loop; the fused drivers run on "
              "the device alone, so the bridge is off")
        bridge = False
    snap_kw = {"snapshot_every": snapshot_every,
               "snapshot_dir": snapshot_dir, "resume": resume}
    if snapshot_dir is not None and not on_device:
        print("note: --snapshot-dir snapshots the fused drivers; the host "
              "loops are not segmented, so no snapshot is taken")
        snap_kw = {}
    if sharded:
        return _run_ea_sharded(dict(
            problem_name=problem_name, islands=islands, epochs=epochs,
            w2=w2, seed=seed, verbose=verbose, topology=topology,
            fused=fused, bridge=bridge, is_async=is_async, acfg=acfg,
            acceptance=acceptance, acceptance_epsilon=acceptance_epsilon,
            impl=impl, max_pop=max_pop, min_pop=min_pop,
            gens_per_epoch=gens_per_epoch, snap_kw=snap_kw,
            problem_kwargs=problem_kwargs), device, shards, timeout)
    dev = resolve_device(device)
    if problem_name == "f15":
        problem_kwargs.setdefault("device", dev)
    problem = make_problem(problem_name, **problem_kwargs)
    cfg, mig, acc = _configs(impl, max_pop, min_pop, gens_per_epoch,
                             topology, acceptance, acceptance_epsilon)
    host_bridge = _bridge(seed, acc, is_async) if bridge else None
    t0 = time.perf_counter()
    if fused:
        run = (partial(run_fused_async, acfg=acfg, max_ticks=epochs)
               if is_async else partial(run_fused, max_epochs=epochs))
        isl, pool, ep = run(problem, cfg, mig, n_islands=islands, w2=w2,
                            rng=seed, device=dev, **snap_kw)
        if verbose:
            best = float(isl.best_fitness.max())
            print(f"[fused {'async ' if is_async else ''}topo={topology}] "
                  f"best={best} epochs={int(ep)} "
                  f"({time.perf_counter() - t0:.1f}s)")
            print(f"final best={best!r} epochs={int(ep)}")
        return isl, pool
    if is_async:
        res = run_experiment_async(problem, cfg, mig, acfg,
                                   n_islands=islands, max_ticks=epochs,
                                   w2=w2, rng=seed, verbose=verbose,
                                   host_bridge=host_bridge, device=dev)
        if host_bridge is not None:
            res.pool = host_bridge.flush(res.pool)
            host_bridge.close()
    else:
        res = run_experiment(problem, cfg, mig, n_islands=islands,
                             max_epochs=epochs, w2=w2, rng=seed,
                             verbose=verbose, host_bridge=host_bridge,
                             device=dev)
    if verbose:
        extra = f" fires={res.total_fires}" if is_async else ""
        print(f"success={res.success} evals_to_solution="
              f"{res.evaluations_to_solution} wall={res.wall_time_s:.1f}s"
              + (f" bridge={host_bridge.stats()}" if host_bridge else "")
              + extra)
    return res


def _configs(impl, max_pop, min_pop, gens_per_epoch, topology, acceptance,
             acceptance_epsilon):
    ea_kw = {"impl": impl}
    if max_pop is not None:
        ea_kw["max_pop"] = max_pop
    if min_pop is not None:
        ea_kw["min_pop"] = min_pop
    if gens_per_epoch is not None:
        ea_kw["generations_per_epoch"] = gens_per_epoch
    acc = AcceptanceConfig(policy=acceptance, epsilon=acceptance_epsilon)
    mig = MigrationConfig(topology=topology, acceptance=acc)
    return EAConfig(**ea_kw), mig, acc


def _bridge(seed: int, acc: AcceptanceConfig, is_async: bool):
    server = PoolServer(capacity=256, seed=seed, acceptance=(
        acc if acc.policy != "always" else None))
    return (AsyncHostBridge(server, acceptance=acc) if is_async
            else HostBridge(server, acceptance=acc))


def _sharded_rank(group, kw):
    """One rank of ``ea --sharded``: the driver on this rank's islands.
    Rank 0 returns the run's lines and the global ``(islands, pool)``;
    every rank builds the bridge (only rank 0's syncs)."""
    problem_kwargs = dict(kw["problem_kwargs"])
    if kw["problem_name"] == "f15":
        problem_kwargs.setdefault("device", group.device)
    problem = make_problem(kw["problem_name"], **problem_kwargs)
    cfg, mig, acc = _configs(kw["impl"], kw["max_pop"], kw["min_pop"],
                             kw["gens_per_epoch"], kw["topology"],
                             kw["acceptance"], kw["acceptance_epsilon"])
    is_async, fused = kw["is_async"], kw["fused"]
    per = max(1, kw["islands"] // group.world)
    run_kw = dict(islands_per_shard=per, w2=kw["w2"], rng=kw["seed"])
    t0 = time.perf_counter()
    if is_async:
        isl, pool, ep = run_fused_sharded_async(
            group, problem, cfg, mig, kw["acfg"], max_ticks=kw["epochs"],
            **run_kw, **kw["snap_kw"])
    elif fused:
        isl, pool, ep = run_fused_sharded(group, problem, cfg, mig,
                                          max_epochs=kw["epochs"], **run_kw,
                                          **kw["snap_kw"])
    else:
        bridge = _bridge(kw["seed"], acc, False) if kw["bridge"] else None
        isl, pool, ep = run_sharded(group, problem, cfg, mig,
                                    max_epochs=kw["epochs"], **run_kw,
                                    host_bridge=bridge)
    if group.rank != 0:
        return None
    best = float(isl.best_fitness.max())
    lines = [f"[sharded x{group.world} {'fused ' if fused else ''}"
             f"{'async ' if is_async else ''}topo={kw['topology']}] "
             f"best={best} epochs={int(ep)} "
             f"({time.perf_counter() - t0:.1f}s) backend={group.name}",
             f"final best={best!r} epochs={int(ep)}"]
    return {"lines": lines, "islands": isl, "pool": pool}


def _run_ea_sharded(kw, device, shards, timeout):
    """``ea --sharded``: in this process under ``torchrun``, else on
    ``shards`` spawned ranks (default one per visible card; on the CPU
    one)."""
    if "WORLD_SIZE" in os.environ:
        from .mesh import make_host_group
        owned = not torch.distributed.is_initialized()
        try:
            out = _sharded_rank(make_host_group(device, timeout=timeout), kw)
        finally:
            if owned and torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
    else:
        dev = resolve_device(device)
        world = shards or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
        backend, _ = sharded_lib.choose_backend(dev, world)
        out = sharded_lib.spawn(_sharded_rank, world, backend, dev,
                                timeout=timeout, args=(kw,))[0]
    if out is None:
        return None
    if kw["verbose"]:
        for line in out["lines"]:
            print(line)
    return out["islands"], out["pool"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    ea = sub.add_parser("ea")
    ea.add_argument("--problem", default="trap")
    ea.add_argument("--islands", type=int, default=8)
    ea.add_argument("--epochs", type=int, default=50)
    ea.add_argument("--seed", type=int, default=0)
    ea.add_argument("--w2", action="store_true")
    ea.add_argument("--max-pop", type=int, default=None,
                    help="static lane count (padded population)")
    ea.add_argument("--min-pop", type=int, default=None,
                    help="W² lower population bound")
    ea.add_argument("--gens-per-epoch", type=int, default=None,
                    help="generations between migrations (paper's n)")
    ea.add_argument("--topology", default="pool",
                    choices=available_topologies(),
                    help="registered migration topology (core.migration)")
    ea.add_argument("--acceptance", default="always",
                    choices=available_acceptance_policies(),
                    help="registered immigrant-acceptance policy "
                         "(core.acceptance): always = accept every PUT; "
                         "elitist = replace the worst if better; crowding "
                         "= replace the nearest by genome distance; dedup "
                         "= reject epsilon-duplicates, then elitist")
    ea.add_argument("--acceptance-epsilon", type=float, default=0.0,
                    help="dedup rejection radius (genome distance)")
    ea.add_argument("--impl", default="jnp",
                    choices=available_impls("generation"),
                    help="generation operator (kernels.ga registry): jnp = "
                         "the classic operators; pallas = the hand-written "
                         "CUDA kernels; pallas_tiled = the tiled kernel; "
                         "pallas_ref = their plain PyTorch version")
    ea.add_argument("--fused", action="store_true",
                    help="the fused driver (run_fused, run_fused_async)")
    ea.add_argument("--runtime", choices=("sync", "async"), default="sync",
                    help="async = per-island clocks, no epoch barrier "
                         "(core.async_migration)")
    ea.add_argument("--min-rate", type=float, default=0.25,
                    help="slowest volunteer speed (async runtime)")
    ea.add_argument("--max-rate", type=float, default=1.0,
                    help="fastest volunteer speed (async runtime)")
    ea.add_argument("--staleness", type=int, default=3,
                    help="inbox immigrant lifetime in ticks (async runtime)")
    ea.add_argument("--churn", type=float, default=0.0,
                    help="fraction of islands with a seeded down-window "
                         "(async runtime)")
    ea.add_argument("--snapshot-every", type=int, default=None,
                    help="snapshot the whole ExperimentState every N "
                         "epochs (fused drivers; for kill + --resume)")
    ea.add_argument("--snapshot-dir", default=None,
                    help="checkpoint directory for --snapshot-every and "
                         "--resume")
    ea.add_argument("--resume", action="store_true",
                    help="restore the latest snapshot from --snapshot-dir "
                         "and continue bit for bit (another --islands "
                         "resizes the restored state)")
    ea.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ea.add_argument("--bridge", action="store_true",
                    help="sync a host loop's device pool with an in-process "
                         "PoolServer (HostBridge; AsyncHostBridge under "
                         "--runtime async)")
    ea.add_argument("--sharded", action="store_true",
                    help="split the islands over ranks (run_sharded; "
                         "run_fused_sharded with --fused; "
                         "run_fused_sharded_async with --runtime async)")
    ea.add_argument("--shards", type=int, default=None,
                    help="ranks of --sharded (default: WORLD_SIZE under "
                         "torchrun, else one per visible card; with "
                         "--device cpu, gloo ranks on the CPU)")
    ea.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds that bound each collective and the whole "
                         "world of --sharded")
    pbt = sub.add_parser("pbt")
    pbt.add_argument("--arch", default="minicpm-2b")
    pbt.add_argument("--members", type=int, default=4)
    pbt.add_argument("--epochs", type=int, default=5)
    pbt.add_argument("--steps-per-epoch", type=int, default=20)
    args = ap.parse_args(argv)
    if args.mode == "pbt":
        _later("the pbt command", "pbt")
    acfg = AsyncConfig(min_rate=args.min_rate, max_rate=args.max_rate,
                       staleness=args.staleness, churn_fraction=args.churn)
    return run_ea(args.problem, args.islands, args.epochs, args.w2,
                  args.sharded, seed=args.seed, topology=args.topology,
                  fused=args.fused, bridge=args.bridge, runtime=args.runtime,
                  acfg=acfg, acceptance=args.acceptance,
                  acceptance_epsilon=args.acceptance_epsilon,
                  impl=args.impl, max_pop=args.max_pop, min_pop=args.min_pop,
                  gens_per_epoch=args.gens_per_epoch,
                  snapshot_every=args.snapshot_every,
                  snapshot_dir=args.snapshot_dir, resume=args.resume,
                  device=args.device, shards=args.shards,
                  timeout=args.timeout)


if __name__ == "__main__":
    main()
