"""The NodIO experiment loop: islands x pool, epochs of autonomous evolution.

:func:`run_fused` is the port of the reference's fused driver: the
reference runs the whole experiment as one ``lax.scan``; here it is a
Python loop over epochs (:func:`fused_scan`) whose body is
:func:`epoch_step`. Every generation inside an epoch dispatches through
the kernel table (``EAConfig.impl``). The loop keeps the scan's contract:
the key is split every epoch, early success (without W²) freezes the
state, ``epoch`` counts the live epochs, and the stats rows after a stop
repeat the frozen state. Snapshots, resume, the observability counters
and the host-loop ``run_experiment`` come in later slices.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import rand
from .._device import resolve_device
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
               w2: bool, available=True, epoch=0):
    """One epoch of every island: evolve, migrate, absorb the immigrants,
    and under W² restart the islands that solved their experiment."""
    islands = island_lib.island_epoch(islands, problem, cfg)
    pool, imm_g, imm_f = migration_lib.migrate(
        pool, islands.best_genome, islands.best_fitness, rng, mig,
        epoch=epoch, available=available)
    islands = island_lib.receive_immigrant(islands, imm_g, imm_f,
                                           replace=mig.replace)
    if w2:
        succeeded = success_mask(islands, problem, cfg)
        restarted = island_lib.restart_island(islands, problem, cfg)
        islands = island_lib.where_islands(succeeded, restarted, islands)
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
               epoch0=0, stopped0=False, *, problem: Problem,
               cfg: EAConfig, mig: MigrationConfig, w2: bool,
               max_epochs: int, with_stats: bool = True):
    """``max_epochs`` epochs; returns ``(islands, pool, key, epoch,
    stopped, obs, stats)`` like the reference's scan; ``obs`` is ``()``
    (the counters come later) and ``stats`` is stacked over epochs, or
    ``()``."""
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
            islands, pool = epoch_step(islands, pool, k_mig, problem, cfg,
                                       mig, w2, True, epoch=epoch + 1)
            epoch = epoch + 1
        if not w2:
            stopped = stopped | success_mask(islands, problem, cfg).any()
        if with_stats:
            rows.append(collect_stats(islands, epoch))
    stats = (ExperimentStats(*(torch.stack(col) for col in zip(*rows)))
             if with_stats and rows else ())
    return islands, pool, key, epoch, stopped, (), stats


def run_fused(problem: Problem,
              cfg: EAConfig = EAConfig(),
              mig: MigrationConfig = MigrationConfig(),
              n_islands: int = 8,
              max_epochs: int = 100,
              rng: Union[int, torch.Tensor, None] = None,
              w2: bool = False,
              return_stats: bool = False, *,
              device=None,
              state: Optional[ExperimentState] = None):
    """The whole experiment. ``rng`` is a key (``(2,)`` words) or an int
    seed (default seed 0). Returns ``(islands, pool, epochs)`` plus the
    stacked :class:`ExperimentStats` when ``return_stats``. Stops early on
    global success without W².

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
    islands, pool, _, epoch, _, _, stats = fused_scan(
        islands, pool, state.key.to(dev), state.epoch.to(dev),
        state.stopped.to(dev), problem=problem, cfg=cfg, mig=mig, w2=w2,
        max_epochs=max(max_epochs - done, 0), with_stats=return_stats)
    out = (islands, pool, epoch)
    if return_stats:
        out += (stats,)
    return out
