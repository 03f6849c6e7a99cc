"""SPMD NodIO: the islands split over ranks of a ``torch.distributed`` group.

The port of ``repro.core.sharded``. The reference maps the volunteer fleet
onto a mesh axis with ``shard_map``; here every rank is a process that
holds a contiguous slab of ``islands_per_shard`` islands on its own device
and a replica of the pool. The generation kernels run on each rank's slab
as they run on one device; migration is the only traffic between ranks,
through the topology registry's SPMD branches
(:mod:`repro_torch.core.migration`).

:class:`ShardGroup` takes the place of the reference's ``axis`` argument
(a mesh axis name): it carries the rank, the world size, the rank's device
and the process group, and the collectives the SPMD branches use:

========================================  ==================================
reference                                 :class:`ShardGroup`
========================================  ==================================
``all_gather(x, axis, tiled=True)``       :meth:`~ShardGroup.gather`
``all_gather(x, axis)``                   :meth:`~ShardGroup.gather_stack`
``ppermute(x, axis, perm)``               :meth:`~ShardGroup.permute`
``psum`` / ``pmax`` of integers, max      :meth:`~ShardGroup.all_reduce`
``psum`` of floats                        :meth:`~ShardGroup.sum_in_order`
``axis_index``, ``axis_size``             ``rank``, ``world``
========================================  ==================================

A float sum is an all-gather and then a left-to-right sum in rank order,
so its bits do not depend on the backend's reduction tree.

Backends, chosen by the caller (:func:`choose_backend`): NCCL where each
rank has its own card (``cuda:rank``); gloo on the CPU; gloo where several
ranks share one card (``host_copies``): there a gather of card tensors
goes through the card (each rank's block in a staging buffer the others
map by CUDA IPC), every other collective's tensors are copied to the host
and back. A backend is never a retry after another failed.

Three drivers, as in the reference; each returns the *global* state
(gathered once at the end, on every rank):

* :func:`run_sharded`, the host loop (server failure, the host bridge:
  rank 0 alone talks to the server and broadcasts the pool);
* :func:`run_fused_sharded`, the fused driver in segments with snapshots
  (rank 0 gathers and writes; a resume restores on every rank and keeps
  each rank's rows, resizing a snapshot of another island count);
* :func:`run_fused_sharded_async`, the asynchronous runtime in the same
  shape, the per-rank fire mask being the topologies' vector availability.

:func:`spawn` starts a world of ranks on one host (the ``spawn`` start
method, a ``FileStore`` rendezvous in a temporary directory, a timeout on
every collective and on the whole world).
"""
from __future__ import annotations

import ctypes
import datetime
import os
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .. import rand
from ..obs import counters as obs_lib
from . import async_migration as async_lib
from . import evolution as evolution_lib
from . import island as island_lib
from . import pool as pool_lib
from .async_migration import AsyncConfig
from .problems import Problem
from .types import EAConfig, ExperimentState, MigrationConfig, PoolState

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class ShardGroup:
    """One rank's view of the shard group: ``rank``, ``world``, ``device``,
    the process group ``pg`` (None: the default group), the ``backend``
    name, and whether the ranks share a card (``host_copies``: gloo, each
    collective's tensors copied to the host and back, except the gathers
    of card tensors, which go through the card).

    ``calls`` and ``host_s`` count the collectives this rank issued and
    the host time they took (the copies included), for the per-epoch
    readings of the drivers' callers."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 pg=None, backend: str = "gloo",
                 host_copies: bool = False):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.pg = pg
        self.backend = backend
        self.host_copies = host_copies
        self.calls = 0
        self.host_s = 0.0
        # the gathers through the card: this rank's staging buffer and
        # every rank's, mapped by CUDA IPC (rank order)
        self._staging: Optional[torch.Tensor] = None
        self._peers: List[torch.Tensor] = []

    @classmethod
    def from_default(cls, device=None, pg=None) -> "ShardGroup":
        """The group of an initialized process group (the default one
        unless ``pg``) on ``device``; None: the current card under NCCL,
        the CPU under gloo."""
        if not dist.is_initialized():
            raise RuntimeError("no process group is initialized")
        backend = dist.get_backend(pg)
        rank, world = dist.get_rank(pg), dist.get_world_size(pg)
        if device is None:
            device = ("cuda" if backend == "nccl" else "cpu")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("NCCL needs a CUDA device")
        return cls(rank, world, dev, pg=pg, backend=backend,
                   host_copies=(backend == "gloo" and dev.type == "cuda"))

    @property
    def name(self) -> str:
        """The backend as the run's line prints it."""
        return f"{self.backend}+host" if self.host_copies else self.backend

    # -- transport ---------------------------------------------------------
    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        t = x.to(torch.uint8) if x.dtype == torch.bool else x
        if self.host_copies:
            t = t.cpu()
        return t.contiguous()

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        t = t.to(like.device)
        return t.to(torch.bool) if like.dtype == torch.bool else t

    def _timed(self, fn):
        t = time.perf_counter()
        out = fn()
        self.calls += 1
        self.host_s += time.perf_counter() - t
        return out

    def _card_barrier(self) -> None:
        dist.all_reduce(torch.zeros(1, dtype=torch.int32), group=self.pg)

    def _stage(self, nbytes: int) -> None:
        """Staging buffers of at least ``nbytes`` on every rank (every rank
        asks for the same size: the collectives are SPMD)."""
        cap = 0 if self._staging is None else self._staging.numel()
        if nbytes <= cap:
            return
        from torch.multiprocessing.reductions import reduce_tensor
        buf = torch.empty(max(nbytes, 2 * cap, 1 << 20), dtype=torch.uint8,
                          device=self.device)
        self._peers = []
        shared = [None] * self.world
        dist.all_gather_object(shared, reduce_tensor(buf), group=self.pg)
        self._peers = [buf if r == self.rank else fn(*args)
                       for r, (fn, args) in enumerate(shared)]
        self._staging = buf

    def _gather_on_card(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather_stack` of a card tensor among ranks that share the
        card: each rank writes its block to its staging buffer, and after
        a barrier (a 4-byte gloo message) every rank copies the blocks in
        rank order; a second barrier frees the buffers for the next
        gather. The bits are the host route's (the same blocks, stacked in
        rank order); a 64 MB block takes about a millisecond instead of
        the host round trip's hundreds."""
        xc = x.contiguous()
        flat = xc.reshape(-1).view(torch.uint8)
        n = flat.numel()
        self._stage(n)
        self._staging[:n].copy_(flat)
        torch.cuda.current_stream().synchronize()
        self._card_barrier()
        out = torch.empty((self.world,) + tuple(xc.shape), dtype=xc.dtype,
                          device=xc.device)
        for r, buf in enumerate(self._peers):
            out[r].reshape(-1).view(torch.uint8).copy_(buf[:n])
        torch.cuda.current_stream().synchronize()
        self._card_barrier()
        return out

    # -- collectives -------------------------------------------------------
    def gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(world, ...)``."""
        if self.host_copies and x.device.type == "cuda":
            return self._timed(lambda: self._gather_on_card(x))

        def run():
            w = self._wire(x)
            out = [torch.empty_like(w) for _ in range(self.world)]
            dist.all_gather(out, w, group=self.pg)
            return self._back(torch.stack(out), x)
        return self._timed(run)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (the
        reference's ``all_gather(..., tiled=True)``)."""
        s = self.gather_stack(x)
        return s.reshape((-1,) + tuple(x.shape[1:]))

    def permute(self, x: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``ppermute``: for each ``(src, dst)`` of ``perm`` rank ``dst``
        receives rank ``src``'s ``x``; a rank that is no destination gets
        zeros."""
        dst = {s: d for s, d in perm}.get(self.rank)
        src = {d: s for s, d in perm}.get(self.rank)

        def run():
            w = self._wire(x)
            if src == self.rank and dst == self.rank:
                return self._back(w.clone(), x)
            buf = torch.zeros_like(w)
            ops = []
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, w, dst, group=self.pg))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, buf, src, group=self.pg))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return self._back(buf, x)
        return self._timed(run)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``psum`` (integers only: a float sum goes through
        :meth:`sum_in_order`) or ``pmax``."""
        if op == "sum" and x.is_floating_point():
            raise ValueError("float sums go through sum_in_order")

        def run():
            w = self._wire(x).clone()
            dist.all_reduce(w, _OPS[op], group=self.pg)
            return self._back(w, x)
        return self._timed(run)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool that is true on every rank when it is true on one."""
        return self.all_reduce(flag.to(torch.int32), "max") > 0

    def sum_in_order(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` summed left to right in rank order."""
        s = self.gather_stack(x)
        acc = s[0]
        for i in range(1, self.world):
            acc = acc + s[i]
        return acc

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank."""
        def run():
            w = self._wire(x).clone()
            dist.broadcast(w, src, group=self.pg)
            return self._back(w, x)
        return self._timed(run)

    def barrier(self) -> None:
        self.all_reduce(torch.zeros(1, dtype=torch.int32,
                                    device=self.device))

    # -- rows --------------------------------------------------------------
    def rows(self, x: torch.Tensor, per: int) -> torch.Tensor:
        """This rank's ``per`` rows of a global ``x``."""
        return x[self.rank * per:(self.rank + 1) * per]


# ---------------------------------------------------------------------------
# Backends, devices and worlds
# ---------------------------------------------------------------------------
def choose_backend(device: Union[str, torch.device], world: int
                   ) -> Tuple[str, bool]:
    """``(backend, host_copies)`` for ``world`` ranks on ``device``'s type:
    gloo on the CPU; on cards NCCL where every rank has its own, gloo with
    host copies where ranks share them."""
    if torch.device(device).type == "cpu":
        return "gloo", False
    if world <= torch.cuda.device_count():
        return "nccl", False
    return "gloo", True


def rank_device(backend: str, device: Union[str, torch.device],
                rank: int) -> torch.device:
    """The device of ``rank``: the CPU, ``cuda:rank`` under NCCL, the
    cards taken in turn under gloo."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def _die_with_parent() -> None:
    """Ask Linux to SIGKILL this rank when the process that spawned it
    dies, so a killed driver leaves no rank behind."""
    try:
        libc = ctypes.CDLL(None)
        libc.prctl(1, int(signal.SIGKILL))   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_cpu(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               store_path: str, timeout: float, out_path: str, args,
               threads: Optional[int]) -> None:
    _die_with_parent()
    # the ranks of a spawned world share one host: gloo on loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    result: Tuple[bool, Any]
    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        limit = datetime.timedelta(seconds=timeout)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=limit)
        # gloo's init returns on one rank while a peer may still be in its
        # handshake with it: a rank whose function is short would close its
        # sockets under that handshake ("connectFullMesh failed ...
        # Connection closed by peer"). No rank starts until all have joined.
        store.set(f"joined/{rank}", "1")
        store.wait([f"joined/{r}" for r in range(world)], limit)
        group = ShardGroup.from_default(device=dev)
        result = (True, _to_cpu(fn(group, *args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        result = (False, traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, out_path)
    if not result[0]:
        os._exit(1)


def spawn(fn: Callable, world: int, backend: str = "gloo",
          device: Union[str, torch.device] = "cpu", timeout: float = 120.0,
          args: Sequence = (), threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` ranks and return each rank's
    result (tensors on the CPU), in rank order.

    Each rank is a process of the ``spawn`` start method (``fn`` must be
    importable by its module: a module of this package, or a torch-only
    helper). The ranks meet through a ``FileStore`` in a fresh temporary
    directory, so parallel worlds never share a port. ``timeout`` seconds
    bound every collective and the whole world: a rank that has not ended
    by then is killed and :class:`TimeoutError` raised; a rank that raised
    fails the world with its traceback. ``threads`` sets each rank's
    intra-op CPU threads."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro-shards-") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, str(device), store,
                                   timeout, outs[r], tuple(args), threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise TimeoutError(f"ranks {hung} of {world} did not end "
                                   f"within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {world} died (exit code "
                                   f"{procs[r].exitcode})")
            ok, value = torch.load(path, weights_only=False)
            if not ok:
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
    return results


# ---------------------------------------------------------------------------
# State: rows, gathers, snapshots
# ---------------------------------------------------------------------------
def _rows_of(group: ShardGroup, tree, per: int):
    return type(tree)(*(group.rows(x, per) for x in tree))


def _gather_of(group: ShardGroup, tree):
    return type(tree)(*(group.gather(x) for x in tree))


def _obs_rows(group: ShardGroup, obs, per: int):
    if not hasattr(obs, "_fields"):
        return obs
    return obs._replace(**{f: group.rows(v, per) for f, v in
                           zip(obs._fields, obs)
                           if f != "early_stop_epoch"})


def local_state(group: ShardGroup, state: ExperimentState,
                per: int) -> ExperimentState:
    """This rank's rows of a global :class:`ExperimentState`: the islands,
    the async rows and the per-island counters; the rest is replicated."""
    astate = (_rows_of(group, state.astate, per)
              if hasattr(state.astate, "_fields") else state.astate)
    return state._replace(islands=_rows_of(group, state.islands, per),
                          astate=astate,
                          obs=_obs_rows(group, state.obs, per))


def global_state(group: ShardGroup, state: ExperimentState
                 ) -> ExperimentState:
    """The global :class:`ExperimentState` from every rank's rows."""
    astate = (_gather_of(group, state.astate)
              if hasattr(state.astate, "_fields") else state.astate)
    obs = state.obs
    if hasattr(obs, "_fields"):
        obs = obs._replace(**{f: group.gather(v) for f, v in
                              zip(obs._fields, obs)
                              if f != "early_stop_epoch"})
    return state._replace(islands=_gather_of(group, state.islands),
                          astate=astate, obs=obs)


def broadcast_pool(group: ShardGroup, pool: PoolState,
                   src: int = 0) -> PoolState:
    """Rank ``src``'s pool on every rank, field by field."""
    return PoolState(*(group.broadcast(x, src) for x in pool))


class RankZeroSnapshots:
    """The checkpointer of a sharded run: every rank gathers the global
    state, rank 0 writes it and waits for its writer thread, then every
    rank passes a barrier, so a snapshot on disk is a point every rank has
    passed."""

    def __init__(self, group: ShardGroup, checkpointer):
        self.group = group
        self.checkpointer = checkpointer

    def save_async(self, step: int, state, meta=None) -> None:
        full = global_state(self.group, state)
        if self.group.rank == 0:
            self.checkpointer.save_async(step, full, meta)
            self.checkpointer.wait()
        self.group.barrier()

    def wait(self) -> None:
        if self.group.rank == 0:
            self.checkpointer.wait()


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------
def _key(rng, device) -> torch.Tensor:
    if rng is None or isinstance(rng, int):
        return rand.key(0 if rng is None else rng, device=device)
    return rng.to(device)


def make_sharded_epoch(group: ShardGroup, problem: Problem, cfg: EAConfig,
                       mig: MigrationConfig, w2: bool = False):
    """The SPMD epoch step of this rank: ``step(islands, pool, rng,
    available, epoch) -> (islands, pool)`` on its slab, the pool
    replicated, migration through ``group``'s collectives."""
    def step(islands, pool, rng, available, epoch):
        return evolution_lib.epoch_step(islands, pool, rng, problem, cfg,
                                        mig, w2, available, epoch,
                                        axis=group)
    return step


def _init_sharded(group: ShardGroup, problem: Problem, cfg: EAConfig,
                  mig: MigrationConfig, per: int, rng: torch.Tensor):
    """``(islands, pool, rng', k_init)``: every rank initializes all
    ``world * per`` islands from ``k_init`` and keeps its rows, so the
    islands are the unsharded run's; ``k_init`` feeds the async state."""
    dev = group.device
    keys = rand.split(rng, 2)
    k_init, rng = keys[0], keys[1]
    islands = island_lib.init_islands(k_init, group.world * per, problem,
                                      cfg, device=dev)
    pool = pool_lib.pool_init(mig.pool_capacity, problem.genome, device=dev)
    return _rows_of(group, islands, per), pool, rng, k_init


def run_sharded(group: ShardGroup, problem: Problem,
                cfg: EAConfig = EAConfig(),
                mig: MigrationConfig = MigrationConfig(),
                islands_per_shard: int = 4,
                max_epochs: int = 50,
                rng: Union[int, torch.Tensor, None] = None,
                w2: bool = False,
                server_up: Optional[Callable[[int], bool]] = None,
                host_bridge=None):
    """The host loop of a sharded run, until success or ``max_epochs``;
    returns the global ``(islands, pool, epochs)`` on every rank.

    ``server_up(epoch) -> bool`` takes the pool server down for chosen
    epochs. ``host_bridge`` (a
    :class:`~repro_torch.core.migration.HostBridge`, given on every rank
    with the same ``every``) syncs the replicated pool with a host server:
    rank 0 alone calls its ``sync``, then broadcasts the pool, so the
    server sees one PUT a sync and the replicas stay equal. The early stop
    reads the global best (an all-reduce MAX)."""
    rng = _key(rng, group.device)
    per = islands_per_shard
    islands, pool, rng, _ = _init_sharded(group, problem, cfg, mig, per, rng)
    step = make_sharded_epoch(group, problem, cfg, mig, w2)
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        keys = rand.split(rng, 2)
        rng, k = keys[0], keys[1]
        up = True if server_up is None else bool(server_up(epoch))
        islands, pool = step(islands, pool, k, up, epoch)
        if host_bridge is not None and host_bridge.due(epoch):
            if group.rank == 0:
                pool = host_bridge.sync(pool, epoch)
            pool = broadcast_pool(group, pool)
        if problem.optimum is not None and not w2:
            best = float(group.all_reduce(islands.best_fitness.max(), "max"))
            if best >= problem.optimum - cfg.success_eps:
                break
    return _gather_of(group, islands), pool, epoch


def _fresh_state(group: ShardGroup, islands, pool, astate, key, n_total: int,
                 per: int, return_stats: bool, return_obs: bool
                 ) -> ExperimentState:
    dev = group.device
    return ExperimentState(
        islands=islands, pool=pool, astate=astate, key=key,
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
        stopped=torch.zeros((), dtype=torch.bool, device=dev),
        stats=evolution_lib.empty_stats(dev) if return_stats else (),
        next_uuid=torch.tensor(n_total, dtype=torch.int32, device=dev),
        obs=obs_lib.init_obs(per, device=dev) if return_obs else ())


def _resumed(group: ShardGroup, ckpt, template: ExperimentState,
             n_total: int, per: int, problem: Problem,
             cfg: EAConfig) -> ExperimentState:
    """Every rank restores the latest (global) snapshot, resized to
    ``n_total`` islands when it holds another count, and keeps its
    rows."""
    state = evolution_lib.resume_state(ckpt, template, n_total, problem, cfg,
                                       group.device)
    state = local_state(group, state, per)
    group.barrier()
    return state


def _finish(group: ShardGroup, state: ExperimentState, return_stats: bool,
            return_astate: bool, return_obs: bool):
    out = (_gather_of(group, state.islands), state.pool, state.epoch)
    if return_stats:
        out += (state.stats,)
    if return_astate:
        out += (_gather_of(group, state.astate),)
    if return_obs:
        out += (obs_lib.harvest(state.obs, axis=group),)
    return out


def run_fused_sharded(group: ShardGroup, problem: Problem,
                      cfg: EAConfig = EAConfig(),
                      mig: MigrationConfig = MigrationConfig(),
                      islands_per_shard: int = 4,
                      max_epochs: int = 50,
                      rng: Union[int, torch.Tensor, None] = None,
                      w2: bool = False,
                      return_stats: bool = False,
                      return_obs: bool = False,
                      snapshot_every: Optional[int] = None,
                      snapshot_dir: Optional[str] = None,
                      snapshot_keep: int = 3,
                      checkpointer=None,
                      resume: bool = False):
    """The fused sharded driver: :func:`~repro_torch.core.evolution.
    fused_scan` segments on every rank's slab, the stats replicated
    (reduced over the group every epoch), the stop flag all-reduced before
    the host reads it, so every rank stops at the same epoch. Returns the
    global ``(islands, pool, epochs)`` (+ stats, + the harvested counters).

    Durability as in :func:`~repro_torch.core.evolution.run_fused`: rank 0
    writes each snapshot of the global state (:class:`RankZeroSnapshots`);
    ``resume=True`` restores the latest on every rank, resized when it was
    taken at another island count (another world size), and keeps each
    rank's rows."""
    rng = _key(rng, group.device)
    per = islands_per_shard
    n_total = group.world * per
    ckpt = evolution_lib.resolve_checkpointer(snapshot_dir, checkpointer,
                                              snapshot_keep)
    islands, pool, rng, _ = _init_sharded(group, problem, cfg, mig, per, rng)
    k_loop = rand.split(rng, 2)[1]
    state = _fresh_state(group, islands, pool, (), k_loop, n_total, per,
                         return_stats, return_obs)
    if resume:
        state = _resumed(group, ckpt, state, n_total, per, problem, cfg)

    def segment_fn(state: ExperimentState, seg_len: int):
        islands, pool, key, epoch, stopped, obs, seg_stats = \
            evolution_lib.fused_scan(
                state.islands, state.pool, state.key, state.epoch,
                state.stopped, state.obs, problem=problem, cfg=cfg, mig=mig,
                w2=w2, max_epochs=seg_len, axis=group,
                with_stats=return_stats)
        return state._replace(islands=islands, pool=pool, key=key,
                              epoch=epoch, stopped=stopped,
                              obs=obs), seg_stats

    state = evolution_lib.run_segments(
        state, max_epochs, segment_fn, snapshot_every=snapshot_every,
        checkpointer=(RankZeroSnapshots(group, ckpt) if ckpt is not None
                      else None),
        w2=w2, return_stats=return_stats)
    return _finish(group, state, return_stats, False, return_obs)


def run_fused_sharded_async(group: ShardGroup, problem: Problem,
                            cfg: EAConfig = EAConfig(),
                            mig: MigrationConfig = MigrationConfig(),
                            acfg: AsyncConfig = AsyncConfig(),
                            islands_per_shard: int = 4,
                            max_ticks: int = 50,
                            rng: Union[int, torch.Tensor, None] = None,
                            w2: bool = False,
                            return_stats: bool = False,
                            return_astate: bool = False,
                            return_obs: bool = False,
                            snapshot_every: Optional[int] = None,
                            snapshot_dir: Optional[str] = None,
                            snapshot_keep: int = 3,
                            checkpointer=None,
                            resume: bool = False):
    """The asynchronous :func:`run_fused_sharded`: every rank carries its
    islands' :class:`~repro_torch.core.async_migration.AsyncState` rows
    (each rank draws the state of all islands from ``fold_in(k_init, 7)``
    and keeps its rows), its fire mask is the topologies' vector
    availability. In the degenerate ``acfg`` it equals
    :func:`run_fused_sharded` bit for bit. Returns the global ``(islands,
    pool, ticks)`` (+ stats, + the async state, + the harvested
    counters); durability as in :func:`run_fused_sharded`."""
    rng = _key(rng, group.device)
    per = islands_per_shard
    n_total = group.world * per
    ckpt = evolution_lib.resolve_checkpointer(snapshot_dir, checkpointer,
                                              snapshot_keep)
    islands, pool, rng, k_init = _init_sharded(group, problem, cfg, mig,
                                               per, rng)
    k_loop = rand.split(rng, 2)[1]
    astate = async_lib.init_async_state(rand.fold_in(k_init, 7), n_total,
                                        acfg, max_ticks, problem.genome)
    state = _fresh_state(group, islands, pool, _rows_of(group, astate, per),
                         k_loop, n_total, per, return_stats, return_obs)
    if resume:
        state = _resumed(group, ckpt, state, n_total, per, problem, cfg)

    def segment_fn(state: ExperimentState, seg_len: int):
        islands, pool, astate, key, tick, stopped, obs, seg_stats = \
            async_lib.fused_scan_async(
                state.islands, state.pool, state.astate, state.key,
                state.epoch, state.stopped, state.obs, problem=problem,
                cfg=cfg, mig=mig, acfg=acfg, w2=w2, max_ticks=seg_len,
                axis=group, with_stats=return_stats)
        return state._replace(islands=islands, pool=pool, astate=astate,
                              key=key, epoch=tick, stopped=stopped,
                              obs=obs), seg_stats

    state = evolution_lib.run_segments(
        state, max_ticks, segment_fn, snapshot_every=snapshot_every,
        checkpointer=(RankZeroSnapshots(group, ckpt) if ckpt is not None
                      else None),
        w2=w2, return_stats=return_stats)
    return _finish(group, state, return_stats, return_astate, return_obs)
