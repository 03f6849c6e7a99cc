"""The asynchronous runtime: per-island clocks, no epoch barrier.

The port of ``repro.core.async_migration`` for one batch of islands on one
device. NodIO's volunteers evolve at their own pace, join and leave, and
trade through the pool with no barrier; here every island still runs the
same program, and a per-island fire mask says who moved:

* **Clocks and volunteer speeds.** Each island carries a clock and a
  ``rate`` drawn from ``[AsyncConfig.min_rate, max_rate]``. Every global
  *tick* the clock advances by the rate; when it reaches
  ``AsyncConfig.period`` the island *fires*: it evolves one epoch, emits
  its best and absorbs an immigrant. Every island is evolved every tick
  (the kernels run for all of them, as in the reference) and the islands
  that did not fire are selected back whole, their keys included.
* **Inboxes bounded by staleness.** Deliveries land in the destination's
  ring buffer of ``inbox_capacity`` slots, stamped with their tick; an
  island absorbs the best entry at most ``staleness`` ticks old at its own
  next fire, and the entry is cleared.
* **Churn.** ``churn_fraction`` of the islands get one seeded down-window:
  a down island accrues no clock, so it neither evolves nor trades, and
  rejoins with its state intact.
* **Exchange** goes through :func:`repro_torch.core.migration.migrate` with
  the fire mask as the vector ``available``, so every registered topology
  and acceptance policy runs asynchronously.

In the degenerate configuration (rates 1, staleness 0, no churn) every
island fires every tick and :func:`run_fused_async` is
:func:`repro_torch.core.evolution.run_fused` bit for bit, per topology.

Drivers: :func:`run_experiment_async`, the host loop (``server_up(tick)``
takes the pool server down), and :func:`run_fused_async`, the fused driver
with the durability of :func:`~repro_torch.core.evolution.run_fused`
(segments, snapshots that carry the :class:`AsyncState`, resume, elastic
resize). :class:`AsyncHostBridge` syncs the host loop's device pool
with a pool server without waiting on it. The sharded driver is
:func:`repro_torch.core.sharded.run_fused_sharded_async`.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import convert, rand
from .._device import resolve_device
from ..obs import counters as obs_lib
from ..obs import trace as obs_trace
from . import acceptance as acceptance_lib
from . import evolution as evolution_lib
from . import island as island_lib
from . import migration as migration_lib
from . import pool as pool_lib
from .evolution import (RunResult, collect_stats, global_success,
                        success_mask)
from .pool import NEG_INF
from .problems import Problem
from .types import (EAConfig, ExperimentState, ExperimentStats, GenomeSpec,
                    IslandState, MigrationConfig, PoolState)


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Volunteer speeds, staleness and churn.

    rate ~ U[min_rate, max_rate] per island, in clock units per tick;
    ``period`` is the clock an epoch costs. With min_rate = max_rate =
    period = 1 every island fires every tick (the synchronous degenerate
    configuration). ``staleness`` is the oldest, in ticks, an inbox entry
    may be when absorbed (0: the same tick only). ``churn_fraction`` of the
    islands get one seeded down-window inside ``[churn_window[0],
    churn_window[1]) x max_ticks``."""

    period: float = 1.0
    min_rate: float = 1.0
    max_rate: float = 1.0
    staleness: int = 0
    inbox_capacity: int = 4
    churn_fraction: float = 0.0
    churn_window: Tuple[float, float] = (0.25, 0.75)
    seed: int = 0

    def __post_init__(self):
        if not (0.0 < self.min_rate <= self.max_rate <= 1.0):
            raise ValueError("need 0 < min_rate <= max_rate <= 1")
        if self.inbox_capacity < 1:
            raise ValueError("inbox_capacity must be >= 1")
        if self.staleness < 0:
            raise ValueError("staleness must be >= 0")

    @property
    def degenerate(self) -> bool:
        """True when this config is the synchronous anchor."""
        return (self.min_rate == self.max_rate == self.period == 1.0
                and self.churn_fraction == 0.0)


class AsyncState(NamedTuple):
    """Per-island asynchrony (leading axis: islands). The field order is
    the reference's: the names are snapshot paths.

    clock, rate:           (I,) f32, the logical clock and the speed
    down_start, down_end:  (I,) int32, the churn window in ticks (a start
                           beyond every tick: never down)
    inbox_genomes:         (I, C, L) the genome dtype, the ring buffer
    inbox_fitness:         (I, C) f32, -inf marks an empty slot
    inbox_born:            (I, C) int32, the birth tick (-1: empty)
    inbox_ptr:             (I,) int32, the next slot to write
    fires:                 (I,) int32, fires so far
    """

    clock: torch.Tensor
    rate: torch.Tensor
    down_start: torch.Tensor
    down_end: torch.Tensor
    inbox_genomes: torch.Tensor
    inbox_fitness: torch.Tensor
    inbox_born: torch.Tensor
    inbox_ptr: torch.Tensor
    fires: torch.Tensor


def init_async_state(rng: torch.Tensor, n_islands: int, acfg: AsyncConfig,
                     max_ticks: int, genome: GenomeSpec) -> AsyncState:
    """Draw the speeds and the churn schedule from ``rng``'s keys
    ``split(fold_in(rng, acfg.seed), 4)``; on ``rng``'s device."""
    dev = rng.device
    k_rate, k_who, k_start, k_dur = rand.split(rand.fold_in(rng, acfg.seed),
                                               4)
    if acfg.min_rate == acfg.max_rate:
        # the exact value: the degenerate anchor accrues 1.0 a tick
        rate = torch.full((n_islands,), acfg.min_rate, dtype=torch.float32,
                          device=dev)
    else:
        rate = rand.keyed_uniform(k_rate, (n_islands,), acfg.min_rate,
                                  acfg.max_rate)
    lo = max(1, int(acfg.churn_window[0] * max_ticks))
    hi = max(lo + 1, int(acfg.churn_window[1] * max_ticks))
    churned = rand.keyed_bernoulli(k_who, acfg.churn_fraction, (n_islands,))
    start = rand.keyed_randint(k_start, (n_islands,), lo, hi)
    dur = rand.keyed_randint(k_dur, (n_islands,), 1, max(2, hi - lo))
    never = torch.full((n_islands,), max_ticks + 1, dtype=torch.int32,
                       device=dev)
    cap = int(acfg.inbox_capacity)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return AsyncState(
        clock=full((n_islands,), 0.0, torch.float32),
        rate=rate,
        down_start=torch.where(churned, start, never),
        down_end=torch.where(churned, start + dur, never),
        inbox_genomes=full((n_islands, cap, genome.length), 0, genome.dtype),
        inbox_fitness=full((n_islands, cap), NEG_INF, torch.float32),
        inbox_born=full((n_islands, cap), -1, torch.int32),
        inbox_ptr=full((n_islands,), 0, torch.int32),
        fires=full((n_islands,), 0, torch.int32),
    )


def _tick(tick, device) -> torch.Tensor:
    return torch.as_tensor(tick, dtype=torch.int32, device=device)


def _inbox_push(astate: AsyncState, imm_g: torch.Tensor,
                imm_f: torch.Tensor, tick) -> AsyncState:
    """Write this tick's finite deliveries into the destinations' inboxes
    at their pointers, stamped with ``tick``. Genomes are cast to the
    inbox's dtype and written into a copy; slots of other deliveries keep
    what they held."""
    push = torch.isfinite(imm_f)
    n, cap = astate.inbox_fitness.shape
    dev = imm_f.device
    rows = torch.arange(n, device=dev)
    slot = astate.inbox_ptr.long()
    new_g = astate.inbox_genomes.clone()
    new_g[rows, slot] = imm_g.to(astate.inbox_genomes.dtype)
    new_f = astate.inbox_fitness.clone()
    new_f[rows, slot] = imm_f
    new_b = astate.inbox_born.clone()
    new_b[rows, slot] = _tick(tick, dev)
    return astate._replace(
        inbox_genomes=torch.where(push[:, None, None], new_g,
                                  astate.inbox_genomes),
        inbox_fitness=torch.where(push[:, None], new_f, astate.inbox_fitness),
        inbox_born=torch.where(push[:, None], new_b, astate.inbox_born),
        inbox_ptr=(astate.inbox_ptr + push.to(torch.int32)) % cap,
    )


def _inbox_take(astate: AsyncState, tick, staleness: int,
                absorb: torch.Tensor, with_ledger: bool = False):
    """The best live entry (age at most ``staleness``) of each absorbing
    island, cleared from its inbox so nothing is absorbed twice. An
    island with no live entry reads lane 0 with fitness ``-inf``.

    ``with_ledger=True`` appends ``(consumed, take_age)``: which islands
    absorbed, and the age in ticks of the entry each one read."""
    age = _tick(tick, absorb.device) - astate.inbox_born
    live = ((astate.inbox_born >= 0) & (age >= 0) & (age <= staleness)
            & torch.isfinite(astate.inbox_fitness))
    cand = torch.where(live, astate.inbox_fitness, NEG_INF)
    n, cap = cand.shape
    rows = torch.arange(n, device=cand.device)
    j = cand.argmax(1)           # the first lane on ties, lane 0 if none
    take_f = torch.where(absorb, cand[rows, j], NEG_INF)
    take_g = astate.inbox_genomes[rows, j]
    consumed = absorb & torch.isfinite(take_f)
    lanes = torch.arange(cap, device=cand.device)
    cleared = consumed[:, None] & (lanes[None, :] == j[:, None])
    astate = astate._replace(
        inbox_fitness=torch.where(cleared, NEG_INF, astate.inbox_fitness),
        inbox_born=torch.where(cleared, -1, astate.inbox_born),
    )
    if with_ledger:
        return take_g, take_f, astate, consumed, age[rows, j]
    return take_g, take_f, astate


def async_step(islands: IslandState, pool: PoolState, astate: AsyncState,
               rng: torch.Tensor, problem: Problem, cfg: EAConfig,
               mig: MigrationConfig, acfg: AsyncConfig, w2: bool,
               server_up: Union[bool, torch.Tensor] = True, tick=0,
               axis=None, obs=None):
    """One global tick: clocks accrue, the firing islands evolve an epoch
    and trade through the topology, every other island is left as it was.

    ``server_up=False`` loses the whole exchange (the dead pool server)
    and stops neither evolution nor the clocks; an island inside its
    churn window freezes whole. In the degenerate config this is
    :func:`~repro_torch.core.evolution.epoch_step`. Under ``axis`` (a
    shard group) the islands are this rank's and the fire mask is the
    topologies' vector availability of its islands. With ``obs`` (an
    :class:`~repro_torch.obs.counters.ObsCounters`) the counters record the
    down ticks, the exchange ledger and the absorbed entries' ages, and
    the return grows to ``(islands, pool, astate, obs)``."""
    dev = islands.pop.device
    tick = _tick(tick, dev)
    up = ~((astate.down_start <= tick) & (tick < astate.down_end))
    # f32 throughout: the period and the rates are f32, as in the reference
    clock = astate.clock + torch.where(up, astate.rate, 0.0)
    fire = up & (clock >= acfg.period)
    clock = torch.where(fire, clock - acfg.period, clock)
    if obs is not None:
        obs = obs_lib.record_churn(obs, ~up)

    # every island evolves; the silent ones are selected back whole
    evolved = island_lib.island_epoch(islands, problem, cfg)
    islands = island_lib.where_islands(fire, evolved, islands)

    # the fire mask is the topology's vector availability
    exchange = fire & server_up if isinstance(server_up, torch.Tensor) \
        else (fire if server_up else torch.zeros_like(fire))
    if obs is not None:
        pool, imm_g, imm_f, delivered, accepted = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            axis=axis, epoch=tick, available=exchange, with_ledger=True)
        obs = obs_lib.record_exchange(obs, exchange, delivered, accepted)
    else:
        pool, imm_g, imm_f = migration_lib.migrate(
            pool, islands.best_genome, islands.best_fitness, rng, mig,
            axis=axis, epoch=tick, available=exchange)

    # deliveries wait in the destinations' inboxes; each island absorbs
    # at its own fire
    astate = _inbox_push(astate, imm_g, imm_f, tick)
    if obs is not None:
        take_g, take_f, astate, consumed, take_age = _inbox_take(
            astate, tick, acfg.staleness, fire, with_ledger=True)
        obs = obs_lib.record_absorb(obs, consumed, take_age)
    else:
        take_g, take_f, astate = _inbox_take(astate, tick, acfg.staleness,
                                             fire)
    # the policy gates again at absorb: an entry accepted at delivery may
    # have gone stale against the island's current best (deterministic
    # policies make this a no-op in the degenerate config)
    acc = mig.acceptance
    if acc is not None and acc.policy != "always":
        # repro-lint: disable=RNG01  -- fold_in derives, as jax.random's does
        k_gate = rand.fold_in(rng, 0xAB50)
        take_f = acceptance_lib.gate_immigrants(
            islands.best_genome, islands.best_fitness, take_g, take_f,
            k_gate, acc)
    received = island_lib.receive_immigrant(islands, take_g, take_f,
                                            replace=mig.replace)
    islands = island_lib.where_islands(fire, received, islands)

    if w2:
        succeeded = fire & success_mask(islands, problem, cfg)
        restarted = island_lib.restart_island(islands, problem, cfg)
        islands = island_lib.where_islands(succeeded, restarted, islands)

    astate = astate._replace(clock=clock,
                             fires=astate.fires + fire.to(torch.int32))
    if obs is not None:
        return islands, pool, astate, obs
    return islands, pool, astate


# ---------------------------------------------------------------------------
# The host loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AsyncRunResult(RunResult):
    astate: Optional[AsyncState] = None
    total_fires: int = 0


def run_experiment_async(problem: Problem,
                         cfg: EAConfig = EAConfig(),
                         mig: MigrationConfig = MigrationConfig(),
                         acfg: AsyncConfig = AsyncConfig(),
                         n_islands: int = 8,
                         max_ticks: int = 100,
                         rng: Union[int, torch.Tensor, None] = None,
                         w2: bool = False,
                         server_up: Optional[Callable[[int], bool]] = None,
                         host_bridge=None,
                         stop_on_success: bool = True,
                         verbose: bool = False, *,
                         device=None) -> AsyncRunResult:
    """The asynchronous :func:`~repro_torch.core.evolution.run_experiment`:
    epochs are ticks, and a tick advances only the islands whose clock
    reached the period. ``server_up(tick) -> bool`` takes the pool server
    down for chosen ticks. Each tick's stats row is read back to the host.
    ``host_bridge`` takes a blocking
    :class:`~repro_torch.core.migration.HostBridge` or the non-blocking
    :class:`AsyncHostBridge`, synced after every tick. Runs on the card
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    if rng is None or isinstance(rng, int):
        rng = rand.key(0 if rng is None else rng, device=dev)
    keys = rand.split(rng.to(dev), 2)
    k_init, rng = keys[0], keys[1]
    islands = island_lib.init_islands(k_init, n_islands, problem, cfg,
                                      device=dev)
    dpool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    astate = init_async_state(rand.fold_in(k_init, 7), n_islands, acfg,
                              max_ticks, problem.genome)
    stats: List[ExperimentStats] = []
    t0 = time.perf_counter()
    success = False
    evals_at_solution = None
    tick = 0
    for tick in range(1, max_ticks + 1):
        keys = rand.split(rng, 2)
        rng, k_mig = keys[0], keys[1]
        up = True if server_up is None else bool(server_up(tick))
        islands, dpool, astate = async_step(
            islands, dpool, astate, k_mig, problem, cfg, mig, acfg, w2,
            server_up=up, tick=tick)
        if host_bridge is not None:
            dpool = host_bridge.sync(dpool, tick)
        st = convert.to_numpy(collect_stats(islands, tick))
        stats.append(st)
        if verbose:
            print(f"tick {tick}: best={st.best_fitness:.4f} "
                  f"evals={int(st.total_evaluations)} "
                  f"fires={int(astate.fires.sum())} "
                  f"server={'up' if up else 'DOWN'}")
        succeeded_now = bool(success_mask(islands, problem, cfg).any()) or (
            w2 and int(st.experiments_solved) > 0)
        if succeeded_now and not success:
            success = True
            evals_at_solution = int(st.total_evaluations)
        if success and stop_on_success and not w2:
            break
    return AsyncRunResult(
        islands=islands, pool=dpool, stats=stats, success=success,
        epochs=tick, wall_time_s=time.perf_counter() - t0,
        evaluations=int(islands.evaluations.sum()),
        evaluations_to_solution=evals_at_solution,
        astate=astate, total_fires=int(astate.fires.sum()))


# ---------------------------------------------------------------------------
# The fused driver
# ---------------------------------------------------------------------------
def fused_scan_async(islands: IslandState, pool: PoolState,
                     astate: AsyncState, key: torch.Tensor, tick0=0,
                     stopped0=False, obs0=(), *, problem: Problem,
                     cfg: EAConfig, mig: MigrationConfig, acfg: AsyncConfig,
                     w2: bool, max_ticks: int, axis=None,
                     with_stats: bool = True):
    """``max_ticks`` ticks; returns ``(islands, pool, astate, key, tick,
    stopped, obs, stats)``, the async mirror of
    :func:`~repro_torch.core.evolution.fused_scan` (the same key schedule,
    early-stop freeze and stats rows). It is a resumable segment: the
    whole carry goes in and comes out. The early-stop latch is read on the
    host once per tick (never under W²; under ``axis`` after its
    all-reduce, so every rank stops at the same tick); nothing else waits
    for the device."""
    with_obs = hasattr(obs0, "_fields")
    obs = obs0
    dev = islands.pop.device
    tick = torch.as_tensor(tick0, dtype=torch.int32, device=dev)
    stopped = torch.as_tensor(stopped0, dtype=torch.bool, device=dev)
    if not w2:
        stopped = stopped | global_success(islands, problem, cfg, axis)
    rows = []
    for _ in range(max_ticks):
        keys = rand.split(key, 2)
        key, k_mig = keys[0], keys[1]
        if w2 or not bool(stopped):
            # tick + 1: the host loop's 1-based tick numbers
            out = async_step(islands, pool, astate, k_mig, problem, cfg, mig,
                             acfg, w2, server_up=True, tick=tick + 1,
                             axis=axis, obs=obs if with_obs else None)
            islands, pool, astate = out[:3]
            if with_obs:
                obs = out[3]
            tick = tick + 1
        if not w2:
            stopped = stopped | global_success(islands, problem, cfg, axis)
        if with_obs:
            obs = obs_lib.record_early_stop(obs, stopped, tick)
        if with_stats:
            rows.append(collect_stats(islands, tick, axis))
    stats = (ExperimentStats(*(torch.stack(col) for col in zip(*rows)))
             if with_stats and rows else ())
    return islands, pool, astate, key, tick, stopped, obs, stats


def run_fused_async(problem: Problem,
                    cfg: EAConfig = EAConfig(),
                    mig: MigrationConfig = MigrationConfig(),
                    acfg: AsyncConfig = AsyncConfig(),
                    n_islands: int = 8,
                    max_ticks: int = 100,
                    rng: Union[int, torch.Tensor, None] = None,
                    w2: bool = False,
                    return_stats: bool = False,
                    return_astate: bool = False,
                    return_obs: bool = False,
                    snapshot_every: Optional[int] = None,
                    snapshot_dir: Optional[str] = None,
                    snapshot_keep: int = 3,
                    checkpointer=None,
                    resume: bool = False, *,
                    device=None,
                    state: Optional[ExperimentState] = None):
    """The asynchronous :func:`~repro_torch.core.evolution.run_fused`.
    Returns ``(islands, pool, ticks)``, then the stacked stats
    (``return_stats``), the :class:`AsyncState` (``return_astate``) and the
    harvested counters (``return_obs``). In the degenerate ``acfg`` the
    result is :func:`run_fused`'s bit for bit.

    The durability arguments act as in ``run_fused``; the snapshot also
    carries the :class:`AsyncState`, and an elastic resume gives the
    joining islands fresh clocks, the mean rate and no churn window.
    ``state`` starts from a given :class:`ExperimentState` (its ``astate``
    set). Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    if rng is None or isinstance(rng, int):
        rng = rand.key(0 if rng is None else rng, device=dev)
    keys = rand.split(rng.to(dev), 2)
    k_init, k_loop = keys[0], keys[1]
    ckpt = evolution_lib.resolve_checkpointer(snapshot_dir, checkpointer,
                                              snapshot_keep)

    def fresh_state(n: int) -> ExperimentState:
        return ExperimentState(
            islands=island_lib.init_islands(k_init, n, problem, cfg,
                                            device=dev),
            pool=pool_lib.pool_init(mig.pool_capacity, problem.genome,
                                    device=dev),
            astate=init_async_state(rand.fold_in(k_init, 7), n, acfg,
                                    max_ticks, problem.genome),
            key=k_loop,
            epoch=torch.zeros((), dtype=torch.int32, device=dev),
            stopped=torch.zeros((), dtype=torch.bool, device=dev),
            stats=evolution_lib.empty_stats(dev) if return_stats else (),
            next_uuid=torch.tensor(n, dtype=torch.int32, device=dev),
            obs=obs_lib.init_obs(n, device=dev) if return_obs else ())

    if resume:
        state = evolution_lib.resume_state(ckpt, fresh_state(n_islands),
                                           n_islands, problem, cfg, dev)
    elif state is not None:
        state = evolution_lib.carried_state(state, n_islands, return_stats,
                                            return_obs, dev)
    else:
        state = fresh_state(n_islands)

    def segment_fn(state: ExperimentState, seg_len: int):
        islands, pool, astate, key, tick, stopped, obs, seg_stats = \
            fused_scan_async(state.islands, state.pool, state.astate,
                             state.key, state.epoch, state.stopped,
                             state.obs, problem=problem, cfg=cfg, mig=mig,
                             acfg=acfg, w2=w2, max_ticks=seg_len,
                             with_stats=return_stats)
        return state._replace(islands=islands, pool=pool, astate=astate,
                              key=key, epoch=tick, stopped=stopped,
                              obs=obs), seg_stats

    state = evolution_lib.run_segments(
        state, max_ticks, segment_fn, snapshot_every=snapshot_every,
        checkpointer=ckpt, w2=w2, return_stats=return_stats)
    out = (state.islands, state.pool, state.epoch)
    if return_stats:
        out += (state.stats,)
    if return_astate:
        out += (state.astate,)
    if return_obs:
        out += (obs_lib.harvest(state.obs),)
    return out


class AsyncHostBridge(migration_lib.HostBridge):
    """A :class:`~repro_torch.core.migration.HostBridge` whose server round
    trips run on a daemon worker thread, so the driver never waits on the
    pool server (a browser island's asynchronous XHR).

    :meth:`sync` puts into the device pool what the worker fetched since
    the last call, then queues this tick's best (copied to host numpy: the
    driver thread alone touches card tensors) and a fetch, and returns.
    The worker PUTs the best and drains the server with
    :meth:`~repro_torch.core.async_pool.PoolServer.get_since` (an advancing
    sequence cursor), so each server entry enters the device pool at most
    once, and drops the entries of its own uuid, so its pushes never come
    back. Any exception of a round trip is a lost XHR, counted in
    ``lost``. Entries the server retired before the cursor reached them
    are counted in ``dropped`` (:meth:`stats`).

    ``cursor_id`` names a server-side cursor, so the drain position
    survives a restart of either end. ``server`` may be a URL: the worker
    then speaks the wire protocol through
    :class:`~repro_torch.server.client.RemotePoolServer`, whose cursor is
    the service's per-shard vector. :meth:`flush` waits for the worker
    (tests and shutdown); :meth:`close` stops it and closes a
    RemotePoolServer the bridge built itself.
    """

    def __init__(self, server, pull: int = 4, uuid: int = -1,
                 acceptance=None, cursor_id: Optional[str] = None,
                 experiment: str = "default"):
        self._owns_server = isinstance(server, str)
        super().__init__(server, every=1, pull=pull, uuid=uuid,
                         acceptance=acceptance, experiment=experiment)
        self._jobs: "queue.Queue" = queue.Queue()
        self._fetched: List[Tuple[np.ndarray, float]] = []
        self._flock = threading.Lock()
        self._last_seq = -1
        self._cursor_id = cursor_id
        self._absorbs = 0
        self.dropped = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- worker side -------------------------------------------------------
    def _run(self):
        while True:
            job = self._jobs.get()
            if job is None:
                self._jobs.task_done()
                return
            genome, fitness = job
            try:
                if genome is not None:
                    with obs_trace.span("bridge.put"):
                        self.server.put(genome, fitness, uuid=self.uuid)
                    with self._flock:
                        self.pushed += 1
                # the cursor read and the results published under the
                # lock, the server's I/O outside it
                with self._flock:
                    cursor = self._last_seq
                with obs_trace.span("bridge.drain"):
                    entries, cursor, dropped = self.server.get_since(
                        cursor, limit=self.pull, cursor_id=self._cursor_id)
                fresh = [(e.genome.copy(), e.fitness) for e in entries
                         if e.uuid != self.uuid]
                with self._flock:
                    self._last_seq = cursor
                    self.dropped += dropped
                    if fresh:
                        self._fetched.extend(fresh)
            except Exception:  # noqa: BLE001 -- a lost XHR: count it and
                # keep the worker alive (a dead one would hang flush())
                with self._flock:
                    self.lost += 1
            finally:
                self._jobs.task_done()

    # -- driver side -------------------------------------------------------
    def _absorb_fetched(self, pool: PoolState) -> PoolState:
        with self._flock:
            got, self._fetched = self._fetched, []
        if got:
            self._absorbs += 1
            key = rand.fold_in(rand.key(17, device=pool.genomes.device),
                               self._absorbs)
            pool = pool_lib.pool_insert_host(
                pool, [g for g, _ in got], [f for _, f in got],
                acc=self.acceptance, rng=key)
            self.pulled += len(got)
        return pool

    def sync(self, pool: PoolState, epoch: int = 0) -> PoolState:
        """Absorb fetched immigrants, queue best-out and a fetch; never
        waits on the server."""
        with obs_trace.span("bridge.sync", epoch=int(epoch)):
            pool = self._absorb_fetched(pool)
            if int(pool.count) > 0:
                g, f = pool_lib.pool_best(pool)
                self._jobs.put((g.cpu().numpy(), float(f)))
            else:
                self._jobs.put((None, 0.0))
        return pool

    def flush(self, pool: PoolState) -> PoolState:
        """Wait for the worker, then absorb what it fetched."""
        self._jobs.join()
        return self._absorb_fetched(pool)

    def stats(self):
        with self._flock:
            out = super().stats()
            out["dropped"] = self.dropped
        return out

    def close(self):
        if self._worker.is_alive():
            self._jobs.put(None)
            self._worker.join(timeout=5.0)
        if self._owns_server:
            self.server.close()
