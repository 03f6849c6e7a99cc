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

The ``pbt`` command (:func:`run_pbt`) trains ``--members`` smoke models of
``--arch`` as the islands of a :class:`~repro_torch.core.PoolServer`
(:mod:`repro_torch.core.pbt`), on the card or, with ``--device cpu``, on
the CPU:

    PYTHONPATH=src python -m repro_torch.launch.evolve pbt \
        --arch minicpm-2b --members 2 --epochs 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

from functools import partial
from typing import Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..core import (AcceptanceConfig, AsyncConfig, AsyncHostBridge, EAConfig,
                    HostBridge, MigrationConfig, PoolServer,
                    available_acceptance_policies, available_topologies,
                    make_problem, run_experiment, run_experiment_async,
                    run_fused, run_fused_async, run_fused_sharded,
                    run_fused_sharded_async, run_sharded)
from ..configs import ARCHS, get_config
from ..core import graphed
from ..core import pbt as pbt_lib
from ..core import sharded as sharded_lib
from ..data import SyntheticLM
from ..kernels.ga import available_impls
from ..models import build_model
from . import steps as steps_lib
from .steps import init_train_state


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


def run_pbt(arch: str = "minicpm-2b", members: int = 4, epochs: int = 5,
            steps_per_epoch: int = 20, batch: int = 8, seq: int = 64,
            seed: int = 0, verbose: bool = True, device: DeviceLike = None,
            graphs: Optional[bool] = None, on_step=None):
    """Population-based training of ``members`` smoke models of ``arch``
    through a :class:`PoolServer` (capacity 64, seeded ``seed``). Member
    ``uid`` starts from weights drawn from a generator seeded ``seed +
    uid`` on ``device``, trains on its own slice of the step space and is
    evaluated on a shared batch per epoch. Returns the controller.

    ``graphs`` (default: on the card) replays each member's step and eval
    as CUDA graphs (:func:`~repro_torch.launch.steps.compiled_hyper_step`,
    :func:`~repro_torch.launch.steps.compiled_eval`), the hypers host
    values filled before each replay; ``graphs=False`` calls the same
    steps eagerly. The reference keeps one executable for every member,
    its states passed in and out; a graph's buffers are one state, so one
    shared graph would copy each member's state over the last one's and
    back at every step: the port keeps a donating graph a member, over
    that member's state. ``on_step(member, metrics)`` is the
    controller's per-step hook."""
    dev = resolve_device(device)
    graphs = graphed.graphs_on(dev) if graphs is None else graphs
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, dev)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed, device=dev)
    runners: Dict[Tuple[str, int], object] = {}

    def runner(kind: str, uid: int):
        if (kind, uid) in runners:
            return runners[kind, uid]
        if kind == "step":
            run = (steps_lib.compiled_hyper_step(model) if graphs else
                   graphed.EagerStep(partial(steps_lib.hyper_train_step,
                                             model, model.leaf_groups()),
                                     dev))
        else:
            run = (steps_lib.compiled_eval(model) if graphs else
                   graphed.EagerStep(partial(steps_lib.eval_graph_step,
                                             model), dev))
        runners[kind, uid] = run
        return run

    def step_fn(state, batch_, lr, wd, member):
        (state, _), metrics = runner("step", member)((state, batch_), lr, wd)
        return state, metrics

    def eval_fn(state, batch_, member):
        return runner("eval", member)((state.params, batch_))[1]

    def init_state_fn(uid):
        return init_train_state(model, torch.Generator(
            device=dev).manual_seed(seed + uid))

    ctrl = pbt_lib.PBTController(
        step_fn=step_fn, eval_fn=eval_fn, init_state_fn=init_state_fn,
        pool=PoolServer(capacity=64, seed=seed), seed=seed, on_step=on_step)

    def batches(uid, epoch):
        # each member trains on its own slice of the step space (islands
        # see different data: the volunteers' heterogeneity); offsetting
        # by uid avoids any divisibility constraint between batch and
        # members
        return (data.batch_for_step(
            uid * 1_000_000 + epoch * steps_per_epoch + s, 0, 1)
            for s in range(steps_per_epoch))

    def eval_batch(uid, epoch):
        return data.batch_for_step(10_000 + epoch, 0, 1)

    ctrl.run(members, epochs, batches, eval_batch, verbose=verbose)
    # the members keep their states (the donated buffers); a later
    # train_epoch captures again
    if graphs:
        for run in runners.values():
            run.release()
    best = ctrl.best_member()
    if verbose:
        print(f"best member {best.uuid}: val={-best.fitness:.4f} "
              f"lr={best.hypers['lr']:.2e} exploits={best.exploits}")
    return ctrl


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
    pbt.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    pbt.add_argument("--members", type=int, default=4)
    pbt.add_argument("--epochs", type=int, default=5)
    pbt.add_argument("--steps-per-epoch", type=int, default=20)
    pbt.add_argument("--device", default=None,
                     help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "pbt":
        return run_pbt(args.arch, args.members, args.epochs,
                       args.steps_per_epoch, device=args.device)
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
