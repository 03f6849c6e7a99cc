"""The NodIO experiment from the command line: the ``ea`` command.

The port of ``repro/launch/evolve.py`` for one device: the host loop
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
On the card:

    python -m repro_torch.launch.evolve ea --problem trap --islands 8

and on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.evolve ea --problem trap \\
        --islands 8 --epochs 3 --device cpu [--impl jnp|pallas|...] \\
        [--topology ...] [--acceptance ...] [--fused] [--runtime async] \\
        [--bridge] [--snapshot-every 2 --snapshot-dir DIR [--resume]]

The reference's other drivers are not ported yet, and their flags raise
``NotImplementedError`` naming the ROADMAP item that brings them:
``--sharded`` (Queue A item 13) and the ``pbt`` command (item 14).
"""
from __future__ import annotations

import argparse
import time

from functools import partial

from .._device import DeviceLike, resolve_device
from ..core import (AcceptanceConfig, AsyncConfig, AsyncHostBridge, EAConfig,
                    HostBridge, MigrationConfig, PoolServer,
                    available_acceptance_policies, available_topologies,
                    make_problem, run_experiment, run_experiment_async,
                    run_fused, run_fused_async)
from ..kernels.ga import available_impls

# (flag, ROADMAP Queue A item) of the reference's drivers not ported yet
_LATER = {"sharded": 13, "pbt": 14}


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
           device: DeviceLike = None, **problem_kwargs):
    """Run the NodIO experiment. ``topology`` and ``acceptance`` select the
    registered migration strategy and immigrant policy
    (``acceptance_epsilon`` is dedup's radius), ``impl`` the generation
    operator, ``fused`` the fused driver, ``runtime='async'`` the
    asynchronous runtime under ``acfg``. The fused drivers snapshot every
    ``snapshot_every`` epochs into ``snapshot_dir`` and ``resume`` from
    there; the host loops take no snapshots. ``bridge`` syncs a host
    loop's device pool with an in-process ``PoolServer(capacity=256,
    seed=seed)`` under the run's acceptance policy; ``sharded`` raises.
    Returns the host loop's ``RunResult`` (``AsyncRunResult``), or
    ``(islands, pool)`` of the fused driver."""
    if sharded:
        _later("--sharded", "sharded")
    if runtime not in ("sync", "async"):
        raise ValueError(f"unknown runtime {runtime!r}")
    is_async = runtime == "async"
    if acfg is None:
        acfg = AsyncConfig()
    if bridge and fused:
        print("note: --bridge needs a host loop; the fused drivers run on "
              "the device alone, so the bridge is off")
        bridge = False
    snap_kw = {"snapshot_every": snapshot_every,
               "snapshot_dir": snapshot_dir, "resume": resume}
    if snapshot_dir is not None and not fused:
        print("note: --snapshot-dir snapshots the fused drivers; the host "
              "loops are not segmented, so no snapshot is taken")
    dev = resolve_device(device)
    if problem_name == "f15":
        problem_kwargs.setdefault("device", dev)
    problem = make_problem(problem_name, **problem_kwargs)
    ea_kw = {"impl": impl}
    if max_pop is not None:
        ea_kw["max_pop"] = max_pop
    if min_pop is not None:
        ea_kw["min_pop"] = min_pop
    if gens_per_epoch is not None:
        ea_kw["generations_per_epoch"] = gens_per_epoch
    cfg = EAConfig(**ea_kw)
    acc = AcceptanceConfig(policy=acceptance, epsilon=acceptance_epsilon)
    mig = MigrationConfig(topology=topology, acceptance=acc)
    host_bridge = None
    if bridge:
        server = PoolServer(capacity=256, seed=seed, acceptance=(
            acc if acceptance != "always" else None))
        host_bridge = (AsyncHostBridge(server, acceptance=acc) if is_async
                       else HostBridge(server, acceptance=acc))
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
    # the reference's flag of a driver not ported yet: it raises
    ea.add_argument("--sharded", action="store_true")
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
                  device=args.device)


if __name__ == "__main__":
    main()
