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

Both walk the same keys, so from one seed they reach the same state. On
the card both replay CUDA graphs, the port's counterpart of the
reference's ``jax.jit`` (:func:`fused_jit`, :mod:`repro_torch.core.
graphed`): ``run_fused`` one graph per epoch of :func:`fused_scan`'s loop,
``run_experiment`` one per :func:`experiment_step`; on the CPU they call
the same functions eagerly. Every
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
(:mod:`repro_torch.runtime.elastic`). :func:`run_experiment` also mixes
the device islands with a host pool server (``host_pool``) and syncs the
device pool with one (``host_bridge``, :class:`~repro_torch.core.
migration.HostBridge`).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from .. import convert, rand
from .._device import as_device, resolve_device
from ..checkpoint import Checkpointer
from ..obs import counters as obs_lib
from ..obs import trace as obs_trace
from . import graphed
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
               w2: bool, available=True, epoch=0, axis=None, obs=None,
               evolved: Optional[IslandState] = None):
    """One epoch of every island: evolve, migrate, absorb the immigrants,
    and under W² restart the islands that solved their experiment.
    ``evolved`` is the islands after this epoch's generations where the
    caller has run them already (a graph replays them a generation at a
    time, :mod:`repro_torch.core.graphed`).

    With ``axis`` (a :class:`~repro_torch.core.sharded.ShardGroup`) the
    islands are this rank's and migration goes through the group's
    collectives. With ``obs`` (an
    :class:`~repro_torch.obs.counters.ObsCounters`) the migration keeps its
    ledger and the return grows to ``(islands, pool, obs)``."""
    islands = (island_lib.island_epoch(islands, problem, cfg)
               if evolved is None else evolved)
    if obs is not None:
        pool, imm_g, imm_f, delivered, accepted = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            axis=axis, epoch=epoch, available=available, with_ledger=True)
        n = islands.best_fitness.shape[0]
        fired = as_device(available, torch.bool, delivered.device).expand(n)
        obs = obs_lib.record_exchange(obs, fired, delivered, accepted)
        # the sync drivers absorb at delivery: age 0
        obs = obs_lib.record_absorb(obs, accepted, torch.zeros(
            n, dtype=torch.int32, device=delivered.device))
    else:
        pool, imm_g, imm_f = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            axis=axis, epoch=epoch, available=available)
    islands = island_lib.receive_immigrant(islands, imm_g, imm_f,
                                           replace=mig.replace)
    if w2:
        succeeded = success_mask(islands, problem, cfg)
        restarted = island_lib.restart_island(islands, problem, cfg)
        islands = island_lib.where_islands(succeeded, restarted, islands)
    if obs is not None:
        return islands, pool, obs
    return islands, pool


def collect_stats(islands: IslandState, epoch,
                  axis=None) -> ExperimentStats:
    """Per-epoch record: global best, f32 mean of island bests, summed
    evaluations, islands done, solved experiments (all 0-d tensors).

    Under ``axis`` every rank returns the global record, as the
    reference's ``pmax``/``psum`` give it: the best's max over the ranks,
    the mean as the ranks' means summed in rank order over the world size
    (each rank holds as many islands), the counts summed."""
    dev = islands.best_fitness.device
    best = islands.best_fitness.max()
    mean = islands.best_fitness.mean()
    counts = torch.stack([islands.evaluations.sum(dtype=torch.int32),
                          islands.done.sum(dtype=torch.int32),
                          islands.experiments.sum(dtype=torch.int32)])
    if axis is not None:
        best = axis.all_reduce(best, "max")
        mean = axis.sum_in_order(mean) / axis.world
        counts = axis.all_reduce(counts, "sum")
    return ExperimentStats(
        epoch=as_device(epoch, torch.int32, dev),
        best_fitness=best,
        mean_best=mean,
        total_evaluations=counts[0],
        n_done=counts[1],
        experiments_solved=counts[2],
    )


def global_success(islands: IslandState, problem: Problem, cfg: EAConfig,
                   axis=None) -> torch.Tensor:
    """True when an island (of any rank, under ``axis``) has solved."""
    s = success_mask(islands, problem, cfg).any()
    return s if axis is None else axis.any(s)


def pack_stats(st: ExperimentStats) -> torch.Tensor:
    """One stats record as a (6,) int32 row, its f32 fields as their bits
    (one clone or host read moves the whole row)."""
    return torch.stack([st.epoch.to(torch.int32),
                        st.best_fitness.view(torch.int32),
                        st.mean_best.view(torch.int32),
                        st.total_evaluations, st.n_done,
                        st.experiments_solved])


def unpack_stats(rows: torch.Tensor) -> ExperimentStats:
    """(k, 6) packed rows -> the stacked :class:`ExperimentStats`."""
    cols = rows.t().contiguous()
    return ExperimentStats(
        epoch=cols[0], best_fitness=cols[1].view(torch.float32),
        mean_best=cols[2].view(torch.float32), total_evaluations=cols[3],
        n_done=cols[4], experiments_solved=cols[5])


def scan_epoch(carry, live: bool, *, problem: Problem, cfg: EAConfig,
               mig: MigrationConfig, w2: bool, axis=None,
               with_stats: bool = True,
               evolved: Optional[IslandState] = None):
    """One iteration of :func:`fused_scan`'s loop on ``carry = (islands,
    pool, key, epoch, stopped, obs)``: the key is split; a live epoch
    (``live``) runs :func:`epoch_step` and counts itself, a frozen one
    leaves the state as it is; the stop latch (without W²), the counters'
    early-stop epoch and the packed stats row (``with_stats``, else None)
    follow. Returns ``(carry', row)``. The live iteration is what the
    card's graph captures (under ``axis``: its generations, the rest
    running eagerly after the replay)."""
    islands, pool, key, epoch, stopped, obs = carry
    with_obs = hasattr(obs, "_fields")
    keys = rand.split(key, 2)
    key, k_mig = keys[0], keys[1]
    if live:
        out = epoch_step(islands, pool, k_mig, problem, cfg, mig, w2, True,
                         epoch=epoch + 1, axis=axis,
                         obs=obs if with_obs else None, evolved=evolved)
        islands, pool = out[:2]
        if with_obs:
            obs = out[2]
        epoch = epoch + 1
    if not w2:
        stopped = stopped | global_success(islands, problem, cfg, axis)
    if with_obs:
        # latches the first stopping epoch, idempotent after
        obs = obs_lib.record_early_stop(obs, stopped, epoch)
    row = (pack_stats(collect_stats(islands, epoch, axis)) if with_stats
           else None)
    return (islands, pool, key, epoch, stopped, obs), row


def fused_scan(islands: IslandState, pool: PoolState, key: torch.Tensor,
               epoch0=0, stopped0=False, obs0=(), *, problem: Problem,
               cfg: EAConfig, mig: MigrationConfig, w2: bool,
               max_epochs: int, axis=None, with_stats: bool = True,
               step: Optional[Callable] = None):
    """``max_epochs`` epochs; returns ``(islands, pool, key, epoch,
    stopped, obs, stats)`` like the reference's scan. ``obs0`` is an
    :class:`~repro_torch.obs.counters.ObsCounters` to accumulate (``()``:
    none, returned as ``()``); ``stats`` is stacked over epochs, or
    ``()``. Under ``axis`` (a shard group) the islands are this rank's,
    the stats are the global ones, and the stop flag is all-reduced before
    the host reads it, so every rank stops at the same epoch.

    Each live epoch is ``step(carry) -> (carry', row)``, by default
    :func:`scan_epoch` called here; :func:`run_fused` gives the card's
    :class:`~repro_torch.core.graphed.StepGraph` of it. Frozen epochs
    (after an early stop) run :func:`scan_epoch` eagerly."""
    dev = islands.pop.device
    epoch = as_device(epoch0, torch.int32, dev)
    stopped = as_device(stopped0, torch.bool, dev)
    if not w2:
        stopped = stopped | global_success(islands, problem, cfg, axis)
    body = functools.partial(scan_epoch, problem=problem, cfg=cfg, mig=mig,
                             w2=w2, axis=axis, with_stats=with_stats)
    live = step if step is not None else functools.partial(body, live=True)
    frozen = functools.partial(body, live=False)
    obs = obs0
    rows = []
    for _ in range(max_epochs):
        # without W² the latch is read on the host once per epoch; with W²
        # it never sets, and the loop never waits for the device
        run = live if w2 or not bool(stopped) else frozen
        (islands, pool, key, epoch, stopped, obs), row = run(
            (islands, pool, key, epoch, stopped, obs))
        if with_stats:
            rows.append(row)
    stats = unpack_stats(torch.stack(rows)) if with_stats and rows else ()
    return islands, pool, key, epoch, stopped, obs, stats


def unique_buffers(tree):
    """Copy any tensor leaf whose storage an earlier leaf shares (keyed on
    the storage, not the Python object: two views of one tensor share it).
    The reference copies such leaves so that its whole state can be
    donated; the port's graphs copy a carry into their static buffers
    (:mod:`repro_torch.core.graphed`), and a leaf that shares storage
    with a static buffer is copied first, so that no copy reads what an
    earlier one overwrote."""
    seen = set()

    def once(x):
        if not isinstance(x, torch.Tensor):
            return x
        k = (x.device, x.untyped_storage().data_ptr())
        if k in seen:
            return x.clone()
        seen.add(k)
        return x

    return pytree.tree_map(once, tree)


# One runner per (problem identity, static key), as the reference keeps one
# compiled driver: on the card a CUDA graph of the driver's step
# (graphed.StepGraph), on the CPU the eager function. Problem's dataclass
# equality leaves out its consts, so the cache is keyed on the object's
# identity, checked against the stored problem (the entry keeps the problem
# alive, so a live entry's id is never a recycled one). A bounded LRU:
# runners are evicted oldest first, and an evicted runner releases its
# graphs and their private memory pool.
_FUSED_CACHE: "collections.OrderedDict[tuple, Tuple[Problem, Callable]]" = \
    collections.OrderedDict()
_FUSED_CACHE_MAX = 32


def _release(runner) -> None:
    release = getattr(runner, "release", None)
    if release is not None:
        release()


def fused_jit(problem: Problem, static_key: tuple,
              builder: Callable[[], Callable]) -> Callable:
    """Memoize ``builder()`` per ``problem`` object and ``static_key``, so
    repeated runs reuse one runner (one captured graph).

    The key holds what the runner's graph depends on: the driver's name,
    ``cfg``, ``mig`` (and ``acfg``), ``w2``, ``return_stats``,
    ``return_obs``, the island count and the device; a sharded driver's
    also its group, whose collectives the runner calls (the entry keeps
    the group alive, as it keeps the problem). The reference's key
    has the segment length instead of the last two: its scan is compiled
    for a length and a shape is traced from the arguments, while the
    port's graph holds one epoch, which serves any segment length, over
    static buffers whose shapes and device are fixed at its capture."""
    key = (id(problem), static_key)
    entry = _FUSED_CACHE.get(key)
    if entry is None or entry[0] is not problem:
        if entry is not None:
            _release(entry[1])
        _FUSED_CACHE[key] = entry = (problem, builder())
        while len(_FUSED_CACHE) > _FUSED_CACHE_MAX:
            _release(_FUSED_CACHE.popitem(last=False)[1][1])
    _FUSED_CACHE.move_to_end(key)
    return entry[1]


def clear_fused_cache() -> None:
    """Release every cached runner (its graphs and private pool), as
    ``jax.clear_caches`` drops compiled executables."""
    while _FUSED_CACHE:
        _release(_FUSED_CACHE.popitem()[1][1])


def scan_runner(problem: Problem, cfg: EAConfig, mig: MigrationConfig,
                 w2: bool, with_stats: bool, device: torch.device,
                 axis=None):
    """:func:`fused_scan` bound to its statics: eager on the CPU, its live
    epoch replayed as a graph on the card. Under ``axis`` (a shard group)
    the graph holds the rank's generations and the exchange runs eagerly
    between replays (:class:`~repro_torch.core.graphed.RankGraph`)."""
    run = functools.partial(fused_scan, problem=problem, cfg=cfg, mig=mig,
                            w2=w2, axis=axis, with_stats=with_stats)
    if not graphed.graphs_on(device):
        return run
    live = functools.partial(scan_epoch, live=True, problem=problem,
                             cfg=cfg, mig=mig, w2=w2, axis=axis,
                             with_stats=with_stats)
    if axis is not None:
        return graphed.Runner(run, graphed.rank_graph(problem, cfg, live))
    return graphed.Runner(run, graphed.StepGraph(
        live, **graphed.unit_args(problem, cfg)))


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
        with obs_trace.span("driver.segment", seg_len=seg_len,
                            epoch=int(state.epoch)):
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
        run = fused_jit(
            problem,
            ("batched", cfg, mig, w2, return_stats, return_obs,
             int(state.islands.pop.shape[0]), str(dev)),
            lambda: scan_runner(problem, cfg, mig, w2, return_stats, dev))
        islands, pool, key, epoch, stopped, obs, seg_stats = run(
            state.islands, state.pool, state.key, state.epoch,
            state.stopped, state.obs, max_epochs=seg_len)
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


def experiment_step(carry, epoch: torch.Tensor, up: torch.Tensor, *,
                    problem: Problem, cfg: EAConfig, mig: MigrationConfig,
                    w2: bool, evolved: Optional[IslandState] = None):
    """:func:`run_experiment`'s epoch on ``carry = (islands, pool, rng)``:
    the key split, :func:`epoch_step` with the server's state ``up`` and
    the 1-based ``epoch`` (0-d device tensors, filled before each replay
    on the card), and a (7,) int32 row: the packed stats and whether an
    island has solved. Returns ``(carry', row)``."""
    islands, pool, rng = carry
    keys = rand.split(rng, 2)
    rng, k_mig = keys[0], keys[1]
    islands, pool = epoch_step(islands, pool, k_mig, problem, cfg, mig, w2,
                               available=up, epoch=epoch, evolved=evolved)
    solved = success_mask(islands, problem, cfg).any().to(torch.int32)
    row = torch.cat([pack_stats(collect_stats(islands, epoch)),
                     solved.reshape(1)])
    return (islands, pool, rng), row


def _experiment_runner(problem: Problem, cfg: EAConfig,
                       mig: MigrationConfig, w2: bool, device: torch.device):
    """:func:`experiment_step` bound to its statics: called eagerly on the
    CPU, replayed as a graph on the card."""
    step = functools.partial(experiment_step, problem=problem, cfg=cfg,
                             mig=mig, w2=w2)
    if not graphed.graphs_on(device):
        return graphed.EagerStep(step, device)
    return graphed.StepGraph(step, **graphed.unit_args(problem, cfg))


def read_row(row: torch.Tensor) -> Tuple[ExperimentStats, bool]:
    """A host loop's (7,) row on the host: the stats record (numpy 0-d
    arrays, as :func:`collect_stats` read back) and the solved flag."""
    row = row.cpu()
    st = ExperimentStats(*(c[0] for c in unpack_stats(row[None, :6])))
    return convert.to_numpy(st), bool(row[6])


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
                   host_bridge: Optional[migration_lib.HostBridge] = None,
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
    says otherwise.

    ``host_pool`` (a :class:`~repro_torch.core.async_pool.PoolServer`)
    receives every island's best after each epoch the server is up, so
    volunteer clients of the same server see them (best effort: a failure
    is a lost XHR). ``host_bridge`` (a
    :class:`~repro_torch.core.migration.HostBridge`) syncs the device pool
    with its server after each epoch: best out, volunteer entries in."""
    dev = resolve_device(device)
    if rng is None or isinstance(rng, int):
        rng = rand.key(0 if rng is None else rng, device=dev)
    keys = rand.split(rng.to(dev), 2)
    rng = keys[1]
    islands = island_lib.init_islands(keys[0], n_islands, problem, cfg,
                                      device=dev)
    dpool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    step = fused_jit(
        problem, ("host", cfg, mig, w2, n_islands, str(dev)),
        lambda: _experiment_runner(problem, cfg, mig, w2, dev))
    stats: List[ExperimentStats] = []
    t0 = time.perf_counter()
    success = False
    evals_at_solution = None
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        up = True if server_up is None else bool(server_up(epoch))
        (islands, dpool, rng), row = step((islands, dpool, rng), epoch, up)
        if host_pool is not None and up:
            _host_pool_exchange(host_pool, islands)
        if host_bridge is not None:
            # the bridge's pool goes into the graph's buffers at the next
            # call
            dpool = host_bridge.sync(dpool, epoch)
        st, solved = read_row(row)
        stats.append(st)
        if verbose:
            print(f"epoch {epoch}: best={st.best_fitness:.4f} "
                  f"evals={int(st.total_evaluations)} done={int(st.n_done)} "
                  f"solved={int(st.experiments_solved)} "
                  f"server={'up' if up else 'DOWN'}")
        succeeded_now = solved or (w2 and int(st.experiments_solved) > 0)
        if succeeded_now and not success:
            success = True
            evals_at_solution = int(st.total_evaluations)
        if success and stop_on_success and not w2:
            break
    islands, dpool = step.detach((islands, dpool))
    return RunResult(
        islands=islands, pool=dpool, stats=stats, success=success,
        epochs=epoch, wall_time_s=time.perf_counter() - t0,
        evaluations=int(islands.evaluations.sum()),
        evaluations_to_solution=evals_at_solution)


def _host_pool_exchange(host_pool, islands: IslandState) -> None:
    """PUT every island's best into the host PoolServer, best effort: any
    failure is swallowed, as a browser client loses its XHR."""
    try:
        bests = islands.best_genome.cpu().numpy()
        fits = islands.best_fitness.cpu().numpy()
        uuids = islands.uuid.cpu().numpy()
        for g, f, u in zip(bests, fits, uuids):
            host_pool.put(g, float(f), uuid=int(u))
    except Exception:  # noqa: BLE001 -- a down server is tolerated
        pass
