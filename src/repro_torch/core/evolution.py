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
the counter ledger (:mod:`repro_torch.obs.counters`).

Durability, as in the reference: :func:`run_segments` runs the fused
drivers (this one and
:func:`repro_torch.core.async_migration.run_fused_async`) as segments of
:func:`segment_plan`'s lengths and snapshots the whole
:class:`ExperimentState` after each (:mod:`repro_torch.checkpoint`);
chaining segments is one long run, so a run resumed from its latest
snapshot reaches the uninterrupted run's state bit for bit, and a resume
at another island count resizes the state
(:mod:`repro_torch.runtime.elastic`). The host pool and its bridge
(ROADMAP, Queue A item 12) come in a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Union

import torch

from .. import convert, rand
from .._device import resolve_device
from ..checkpoint import Checkpointer
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


def empty_stats(device=None) -> ExperimentStats:
    """Zero-row stacked stats, the ``stats`` of a fresh
    :class:`ExperimentState` (the dtypes of :func:`collect_stats`)."""
    def z(dtype):
        return torch.zeros((0,), dtype=dtype, device=device)
    return ExperimentStats(epoch=z(torch.int32), best_fitness=z(torch.float32),
                           mean_best=z(torch.float32),
                           total_evaluations=z(torch.int32),
                           n_done=z(torch.int32),
                           experiments_solved=z(torch.int32))


def segment_plan(done: int, total: int,
                 snapshot_every: Optional[int]) -> List[int]:
    """The remaining ``total - done`` epochs as segment lengths:
    ``snapshot_every``-sized chunks and a remainder (``None`` or 0: one
    segment)."""
    if total <= done:
        return []
    if not snapshot_every or snapshot_every <= 0:
        return [total - done]
    out = []
    at = done
    while at < total:
        n = min(snapshot_every, total - at)
        out.append(n)
        at += n
    return out


def resolve_checkpointer(snapshot_dir, checkpointer, keep: int = 3):
    """One checkpointer per run: an explicit one wins, else one is made on
    ``snapshot_dir`` (None: no snapshots)."""
    if checkpointer is not None:
        return checkpointer
    if snapshot_dir is None:
        return None
    return Checkpointer(snapshot_dir, keep=keep)


def restore_experiment_state(checkpointer, template: ExperimentState,
                             device=None) -> ExperimentState:
    """The latest snapshot in ``template``'s structure (the leaves' shapes
    come from the snapshot, so another island count restores too), on
    ``device``."""
    state = checkpointer.restore_latest(target=template)
    return convert.to_device(state, resolve_device(device))


def run_segments(state: ExperimentState, max_steps: int, segment_fn, *,
                 snapshot_every: Optional[int] = None, checkpointer=None,
                 w2: bool = False, return_stats: bool = False
                 ) -> ExperimentState:
    """The segmented loop every fused driver shares.

    ``segment_fn(state, seg_len) -> (state', seg_stats)`` runs ``seg_len``
    epochs (ticks) from ``state``. After each segment the whole state is
    snapshotted (:meth:`Checkpointer.save_async`: copied to the host here,
    written on a thread), so a kill loses at most ``snapshot_every``
    epochs. Early success (without W²) ends the loop; the stats rows are
    then padded with the frozen final row to ``max_steps`` rows, as a
    frozen epoch of the one-segment run gives. A state that has already
    stopped (a resume of a run that ended early) runs no segment, so its
    loop key too stays the uninterrupted run's; the reference runs one
    frozen segment there, which splits the key on (ROADMAP, Reference
    watch). Write errors surface at the end (``Checkpointer.wait``)."""
    stats = state.stats if isinstance(state.stats, ExperimentStats) else None
    for seg_len in segment_plan(int(state.epoch), max_steps,
                                snapshot_every):
        if not w2 and bool(state.stopped):
            break
        state, seg_stats = segment_fn(state, seg_len)
        if return_stats:
            stats = seg_stats if stats is None else ExperimentStats(
                *(torch.cat([a, b]) for a, b in zip(stats, seg_stats)))
            state = state._replace(stats=stats)
        if checkpointer is not None:
            checkpointer.save_async(int(state.epoch), state)
        if not w2 and bool(state.stopped):
            break
    if return_stats and stats is not None:
        rows = int(stats.epoch.shape[0])
        if rows and rows < max_steps:
            pad = max_steps - rows
            stats = ExperimentStats(*(torch.cat([a, a[-1:].expand(
                (pad,) + a.shape[1:])]) for a in stats))
            state = state._replace(stats=stats)
    if checkpointer is not None:
        checkpointer.wait()
    return state


def resume_state(ckpt, template: ExperimentState, n_islands: int,
                 problem: Problem, cfg: EAConfig, device) -> ExperimentState:
    """The latest snapshot, resized to ``n_islands`` islands when it holds
    another count (joiners seeded from the pool under new uuids)."""
    if ckpt is None:
        raise ValueError("resume=True needs snapshot_dir or checkpointer")
    state = restore_experiment_state(ckpt, template, device)
    if int(state.islands.pop.shape[0]) != n_islands:
        from ..runtime import elastic  # deferred: elastic imports core
        state = elastic.resize_experiment(state, n_islands, problem, cfg)
    return state


def carried_state(state: ExperimentState, n_islands: int, return_stats: bool,
                  return_obs: bool, device) -> ExperimentState:
    """A given state on ``device`` with the stats and counters the run
    returns (fresh ones where the state has none)."""
    state = convert.to_device(state, device)
    if return_stats and not isinstance(state.stats, ExperimentStats):
        state = state._replace(stats=empty_stats(device))
    if not return_stats:
        state = state._replace(stats=())
    if return_obs and not hasattr(state.obs, "_fields"):
        state = state._replace(obs=obs_lib.init_obs(n_islands,
                                                    device=device))
    if not return_obs:
        state = state._replace(obs=())
    return state


def run_fused(problem: Problem,
              cfg: EAConfig = EAConfig(),
              mig: MigrationConfig = MigrationConfig(),
              n_islands: int = 8,
              max_epochs: int = 100,
              rng: Union[int, torch.Tensor, None] = None,
              w2: bool = False,
              return_stats: bool = False,
              return_obs: bool = False,
              snapshot_every: Optional[int] = None,
              snapshot_dir: Optional[str] = None,
              snapshot_keep: int = 3,
              checkpointer=None,
              resume: bool = False, *,
              device=None,
              state: Optional[ExperimentState] = None):
    """The whole experiment. ``rng`` is a key (``(2,)`` words) or an int
    seed (default seed 0). Returns ``(islands, pool, epochs)`` plus the
    stacked :class:`ExperimentStats` when ``return_stats``, plus the
    harvested counter dict when ``return_obs`` (appended last). Stops
    early on global success without W².

    Durability: ``snapshot_every=k`` runs ``k``-epoch segments and
    snapshots the whole :class:`ExperimentState` to ``snapshot_dir`` (or
    through ``checkpointer``) after each, keeping the newest
    ``snapshot_keep``; ``resume=True`` restores the latest snapshot and
    continues, bit for bit the uninterrupted run. A resume at another
    ``n_islands`` resizes the restored state.

    ``state`` starts the run from a given :class:`ExperimentState` instead
    of a fresh one (the parity tests carry the reference's state across
    with :mod:`repro_torch.convert`); the run then covers the epochs from
    ``state.epoch`` to ``max_epochs``. Runs on the card unless ``device``
    says otherwise."""
    dev = resolve_device(device)
    if rng is None or isinstance(rng, int):
        rng = rand.key(0 if rng is None else rng, device=dev)
    keys = rand.split(rng.to(dev), 2)
    k_init, k_loop = keys[0], keys[1]
    ckpt = resolve_checkpointer(snapshot_dir, checkpointer, snapshot_keep)

    def fresh_state(n: int) -> ExperimentState:
        return ExperimentState(
            islands=island_lib.init_islands(k_init, n, problem, cfg,
                                            device=dev),
            pool=pool_lib.pool_init(mig.pool_capacity, problem.genome,
                                    device=dev),
            astate=(), key=k_loop,
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            stopped=torch.zeros((), dtype=torch.bool, device=dev),
            stats=empty_stats(dev) if return_stats else (),
            next_uuid=torch.tensor(n, dtype=torch.int32, device=dev),
            obs=obs_lib.init_obs(n, device=dev) if return_obs else ())

    if resume:
        state = resume_state(ckpt, fresh_state(n_islands), n_islands,
                             problem, cfg, dev)
    elif state is not None:
        state = carried_state(state, n_islands, return_stats, return_obs,
                              dev)
    else:
        state = fresh_state(n_islands)

    def segment_fn(state: ExperimentState, seg_len: int):
        islands, pool, key, epoch, stopped, obs, seg_stats = fused_scan(
            state.islands, state.pool, state.key, state.epoch,
            state.stopped, state.obs, problem=problem, cfg=cfg, mig=mig,
            w2=w2, max_epochs=seg_len, with_stats=return_stats)
        return state._replace(islands=islands, pool=pool, key=key,
                              epoch=epoch, stopped=stopped,
                              obs=obs), seg_stats

    state = run_segments(state, max_epochs, segment_fn,
                         snapshot_every=snapshot_every, checkpointer=ckpt,
                         w2=w2, return_stats=return_stats)
    out = (state.islands, state.pool, state.epoch)
    if return_stats:
        out += (state.stats,)
    if return_obs:
        out += (obs_lib.harvest(state.obs),)
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
