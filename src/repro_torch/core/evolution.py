"""The NodIO experiment loop: islands x pool, epochs of autonomous evolution.

Two drivers, as in the reference:

* :func:`run_experiment`, the host loop around one epoch step: where the
  server's failures (``server_up``), logging and the stop on success live;
* :func:`run_fused`, the port of the reference's fused driver: the
  reference runs the whole experiment as one ``lax.scan``; here it is a
  Python loop over epochs (:func:`fused_scan`) whose body is
  :func:`epoch_step`. The loop keeps the scan's contract: the key is split
  every epoch, early success (without W²) freezes the state, ``epoch``
  counts the live epochs, and the stats rows after a stop repeat the
  frozen state.

Both walk the same keys, so from one seed they reach the same state. Every
generation inside an epoch dispatches through the kernel table
(``EAConfig.impl``), every migration through the topology registry
(``MigrationConfig.topology``, ``.acceptance``). ``return_obs=True`` carries
the counter ledger (:mod:`repro_torch.obs.counters`). Snapshots and resume
(ROADMAP, Queue A item 11) and the host pool and its bridge (item 12) come
in later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

import torch

from .. import convert, rand
from .._device import resolve_device
from ..obs import counters as obs_lib
from . import island as island_lib
from . import migration as migration_lib
from . import pool as pool_lib
from .problems import Problem
from .types import (EAConfig, ExperimentState, ExperimentStats, IslandState,
                    MigrationConfig, PoolState)


def success_mask(islands: IslandState, problem: Problem,
                 cfg: EAConfig) -> torch.Tensor:
    return island_lib.success(islands.best_fitness, problem, cfg)


def epoch_step(islands: IslandState, pool: PoolState, rng: torch.Tensor,
               problem: Problem, cfg: EAConfig, mig: MigrationConfig,
               w2: bool, available=True, epoch=0, obs=None):
    """One epoch of every island: evolve, migrate, absorb the immigrants,
    and under W² restart the islands that solved their experiment.

    With ``obs`` (an :class:`~repro_torch.obs.counters.ObsCounters`) the
    migration keeps its ledger and the return grows to ``(islands, pool,
    obs)``."""
    islands = island_lib.island_epoch(islands, problem, cfg)
    if obs is not None:
        pool, imm_g, imm_f, delivered, accepted = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            epoch=epoch, available=available, with_ledger=True)
        n = islands.best_fitness.shape[0]
        fired = torch.as_tensor(available, device=delivered.device).expand(n)
        obs = obs_lib.record_exchange(obs, fired, delivered, accepted)
        # the sync drivers absorb at delivery: age 0
        obs = obs_lib.record_absorb(obs, accepted, torch.zeros(
            n, dtype=torch.int32, device=delivered.device))
    else:
        pool, imm_g, imm_f = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            epoch=epoch, available=available)
    islands = island_lib.receive_immigrant(islands, imm_g, imm_f,
                                           replace=mig.replace)
    if w2:
        succeeded = success_mask(islands, problem, cfg)
        restarted = island_lib.restart_island(islands, problem, cfg)
        islands = island_lib.where_islands(succeeded, restarted, islands)
    if obs is not None:
        return islands, pool, obs
    return islands, pool


def collect_stats(islands: IslandState, epoch) -> ExperimentStats:
    """Per-epoch record: global best, f32 mean of island bests, summed
    evaluations, islands done, solved experiments (all 0-d tensors)."""
    dev = islands.best_fitness.device
    return ExperimentStats(
        epoch=torch.as_tensor(epoch, dtype=torch.int32, device=dev),
        best_fitness=islands.best_fitness.max(),
        mean_best=islands.best_fitness.mean(),
        total_evaluations=islands.evaluations.sum(dtype=torch.int32),
        n_done=islands.done.sum(dtype=torch.int32),
        experiments_solved=islands.experiments.sum(dtype=torch.int32),
    )


def fused_scan(islands: IslandState, pool: PoolState, key: torch.Tensor,
               epoch0=0, stopped0=False, obs0=(), *, problem: Problem,
               cfg: EAConfig, mig: MigrationConfig, w2: bool,
               max_epochs: int, with_stats: bool = True):
    """``max_epochs`` epochs; returns ``(islands, pool, key, epoch,
    stopped, obs, stats)`` like the reference's scan. ``obs0`` is an
    :class:`~repro_torch.obs.counters.ObsCounters` to accumulate (``()``:
    none, returned as ``()``); ``stats`` is stacked over epochs, or
    ``()``."""
    with_obs = hasattr(obs0, "_fields")
    obs = obs0
    dev = islands.pop.device
    epoch = torch.as_tensor(epoch0, dtype=torch.int32, device=dev)
    stopped = torch.as_tensor(stopped0, dtype=torch.bool, device=dev)
    if not w2:
        stopped = stopped | success_mask(islands, problem, cfg).any()
    rows = []
    for _ in range(max_epochs):
        keys = rand.split(key, 2)
        key, k_mig = keys[0], keys[1]
        # without W² the latch is read on the host once per epoch; with W²
        # it never sets, and the loop never waits for the device
        if w2 or not bool(stopped):
            out = epoch_step(islands, pool, k_mig, problem, cfg, mig, w2,
                             True, epoch=epoch + 1,
                             obs=obs if with_obs else None)
            islands, pool = out[:2]
            if with_obs:
                obs = out[2]
            epoch = epoch + 1
        if not w2:
            stopped = stopped | success_mask(islands, problem, cfg).any()
        if with_obs:
            # latches the first stopping epoch, idempotent after
            obs = obs_lib.record_early_stop(obs, stopped, epoch)
        if with_stats:
            rows.append(collect_stats(islands, epoch))
    stats = (ExperimentStats(*(torch.stack(col) for col in zip(*rows)))
             if with_stats and rows else ())
    return islands, pool, key, epoch, stopped, obs, stats


def run_fused(problem: Problem,
              cfg: EAConfig = EAConfig(),
              mig: MigrationConfig = MigrationConfig(),
              n_islands: int = 8,
              max_epochs: int = 100,
              rng: Union[int, torch.Tensor, None] = None,
              w2: bool = False,
              return_stats: bool = False,
              return_obs: bool = False, *,
              device=None,
              state: Optional[ExperimentState] = None):
    """The whole experiment. ``rng`` is a key (``(2,)`` words) or an int
    seed (default seed 0). Returns ``(islands, pool, epochs)`` plus the
    stacked :class:`ExperimentStats` when ``return_stats``, plus the
    harvested counter dict when ``return_obs`` (appended last). Stops
    early on global success without W².

    ``state`` starts the run from a given :class:`ExperimentState` instead
    of a fresh one (the parity tests carry the reference's initial state
    across with :mod:`repro_torch.convert`); the run then covers the epochs
    from ``state.epoch`` to ``max_epochs``. Runs on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    if state is None:
        if rng is None or isinstance(rng, int):
            rng = rand.key(0 if rng is None else rng, device=dev)
        keys = rand.split(rng.to(dev), 2)
        islands = island_lib.init_islands(keys[0], n_islands, problem, cfg,
                                          device=dev)
        pool = pool_lib.pool_init(mig.pool_capacity, problem.genome,
                                  device=dev)
        state = ExperimentState(
            islands=islands, pool=pool, astate=(), key=keys[1],
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            stopped=torch.zeros((), dtype=torch.bool, device=dev),
            stats=(), next_uuid=torch.tensor(n_islands, dtype=torch.int32,
                                            device=dev))
    islands = IslandState(*(t.to(dev) for t in state.islands))
    pool = PoolState(*(t.to(dev) for t in state.pool))
    done = int(state.epoch)
    obs0 = ()
    if return_obs:
        obs0 = (obs_lib.ObsCounters(*(t.to(dev) for t in state.obs))
                if hasattr(state.obs, "_fields")
                else obs_lib.init_obs(islands.pop.shape[0], device=dev))
    islands, pool, _, epoch, _, obs, stats = fused_scan(
        islands, pool, state.key.to(dev), state.epoch.to(dev),
        state.stopped.to(dev), obs0, problem=problem, cfg=cfg, mig=mig,
        w2=w2, max_epochs=max(max_epochs - done, 0),
        with_stats=return_stats)
    out = (islands, pool, epoch)
    if return_stats:
        out += (stats,)
    if return_obs:
        out += (obs_lib.harvest(obs),)
    return out


@dataclasses.dataclass
class RunResult:
    islands: IslandState
    pool: PoolState
    stats: List[ExperimentStats]
    success: bool
    epochs: int
    wall_time_s: float
    evaluations: int
    # evaluations summed over islands at the first epoch with a success
    evaluations_to_solution: Optional[int] = None


def run_experiment(problem: Problem,
                   cfg: EAConfig = EAConfig(),
                   mig: MigrationConfig = MigrationConfig(),
                   n_islands: int = 8,
                   max_epochs: int = 100,
                   rng: Union[int, torch.Tensor, None] = None,
                   w2: bool = False,
                   server_up: Optional[Callable[[int], bool]] = None,
                   host_pool=None,
                   host_bridge=None,
                   stop_on_success: bool = True,
                   verbose: bool = False, *,
                   device=None) -> RunResult:
    """Run a NodIO experiment in a host loop, one :func:`epoch_step` per
    epoch. ``server_up(epoch) -> bool`` takes the pool server down for
    chosen epochs (the paper's fault tolerance). Each epoch's stats row is
    read back to the host (numpy); the loop stops after the first epoch
    with a success unless ``stop_on_success`` is false or under W².
    ``rng`` is a key or an int seed (default seed 0), and the loop walks
    the keys :func:`run_fused` walks. Runs on the card unless ``device``
    says otherwise."""
    if host_pool is not None or host_bridge is not None:
        raise NotImplementedError("the host pool server and its bridge come "
                                  "with the host tier (ROADMAP, Queue A "
                                  "item 12)")
    dev = resolve_device(device)
    if rng is None or isinstance(rng, int):
        rng = rand.key(0 if rng is None else rng, device=dev)
    keys = rand.split(rng.to(dev), 2)
    rng = keys[1]
    islands = island_lib.init_islands(keys[0], n_islands, problem, cfg,
                                      device=dev)
    dpool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    stats: List[ExperimentStats] = []
    t0 = time.perf_counter()
    success = False
    evals_at_solution = None
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        keys = rand.split(rng, 2)
        rng, k_mig = keys[0], keys[1]
        up = True if server_up is None else bool(server_up(epoch))
        islands, dpool = epoch_step(islands, dpool, k_mig, problem, cfg, mig,
                                    w2, available=up, epoch=epoch)
        st = convert.to_numpy(collect_stats(islands, epoch))
        stats.append(st)
        if verbose:
            print(f"epoch {epoch}: best={st.best_fitness:.4f} "
                  f"evals={int(st.total_evaluations)} done={int(st.n_done)} "
                  f"solved={int(st.experiments_solved)} "
                  f"server={'up' if up else 'DOWN'}")
        succeeded_now = bool(success_mask(islands, problem, cfg).any()) or (
            w2 and int(st.experiments_solved) > 0)
        if succeeded_now and not success:
            success = True
            evals_at_solution = int(st.total_evaluations)
        if success and stop_on_success and not w2:
            break
    return RunResult(
        islands=islands, pool=dpool, stats=stats, success=success,
        epochs=epoch, wall_time_s=time.perf_counter() - t0,
        evaluations=int(islands.evaluations.sum()),
        evaluations_to_solution=evals_at_solution)
