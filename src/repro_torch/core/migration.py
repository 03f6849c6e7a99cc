"""Migration: pluggable topologies, each island's receive gate.

The port of ``repro.core.migration`` for one batch of islands on one
device. A topology maps ``(pool, bests_genome, bests_fitness, rng, *, mig,
axis, epoch, available)`` to ``(pool, immigrant_genomes,
immigrant_fitness)``. ``available`` is either

* a scalar, the sync drivers' whole-step gate: ``False`` is a dead
  server, the pool is left as it was and every immigrant reads ``-inf``
  (the lost XHR, a no-op for the island); or
* a vector ``(n,)``, the async runtime's per-island fire mask: only
  firing islands PUT into the pool and GET from it; under the pool-less
  topologies a silent island's best is masked to ``-inf`` at the *source*
  and the deliveries come back unmasked, because the destinations buffer
  them in their inboxes (:mod:`repro_torch.core.async_migration`).

Built-in topologies, as in the reference:

``pool``            PUT every best through the acceptance policy, GET one
                    random member per island (the paper's server);
``ring``            island ``i`` receives island ``i - 1``'s best;
``torus``           the most-square (R, C) grid: east on even epochs,
                    south on odd ones (a prime count is a ring);
``random_graph``    island ``i`` receives from ``perm[i]``, a permutation
                    drawn from the epoch's key;
``broadcast_best``  every island receives the epoch's best.

Register another with :func:`register_topology` and select it with
``MigrationConfig(topology=...)``. :func:`migrate` runs the topology, then
every delivery through the acceptance policy's receive gate.

:class:`HostBridge` syncs the device pool with a host
:class:`~repro_torch.core.async_pool.PoolServer` (or, given a URL, the
networked service).

Every topology also runs in the SPMD context of the sharded drivers
(:mod:`repro_torch.core.sharded`): ``axis`` is then a
:class:`~repro_torch.core.sharded.ShardGroup`, the bests and ``available``
are this rank's islands, the pool is this rank's replica, and the exchange
goes through the group's collectives, as the reference's goes through a
mesh axis:

``pool``            the bests (and a fire mask) are gathered, so every
                    replica applies the same PUT with the key
                    ``fold_in(rng, 0xACC)``; each rank GETs with
                    ``fold_in(rng, rank)``;
``ring``            rank ``s``'s islands go to rank ``s + 1``'s (island
                    ``j`` to island ``j``: the slab moves, not one island);
``torus``           the ranks on the most-square grid; the replicated
                    epoch picks the one permute that runs;
``random_graph``    rank ``s`` receives rank ``perm[s]``'s islands, ``perm``
                    drawn over the ranks from the replicated key;
``broadcast_best``  the fitness is gathered, and the elite's genome is the
                    f32 sum of its owner's row and every other rank's
                    zeros (so a ``-0.0`` gene reads ``+0.0`` past one
                    rank, as the reference's ``psum`` gives it).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import rand
from ..obs import trace as obs_trace
from . import acceptance as acceptance_lib
from .pool import (NEG_INF, pool_best, pool_get_random, pool_insert_host,
                   pool_put_batch)
from .types import AcceptanceConfig, MigrationConfig, PoolState

TOPOLOGIES: Dict[str, Callable] = {}


def register_topology(name: str):
    """Decorator: register a topology under ``name``."""
    def deco(fn: Callable) -> Callable:
        TOPOLOGIES[name] = fn
        fn.topology_name = name
        return fn
    return deco


def available_topologies() -> Tuple[str, ...]:
    return tuple(sorted(TOPOLOGIES))


def get_topology(name: str) -> Callable:
    if name in TOPOLOGIES:
        return TOPOLOGIES[name]
    raise KeyError(f"unknown topology {name!r}; registered: "
                   f"{available_topologies()}")


def resolve_topology_name(mig: MigrationConfig) -> str:
    """An explicit ``topology`` wins; unset, legacy ``collective='ring'``
    means the ring, anything else the pool."""
    if mig.topology is not None:
        return mig.topology
    return "ring" if mig.collective == "ring" else "pool"


def migrate(pool: PoolState, bests_genome: torch.Tensor,
            bests_fitness: torch.Tensor, rng: torch.Tensor,
            mig: MigrationConfig, *, axis=None, epoch=0, available=True,
            with_ledger: bool = False):
    """One migration step through the selected topology, then each
    island's receive gate (skipped under ``always``) with the key
    ``fold_in(rng, 0x5EED)``. ``with_ledger=True`` also returns the
    per-island masks of finite deliveries before and after the gate
    (``delivered``, ``accepted``)."""
    topo = get_topology(resolve_topology_name(mig))
    pool, imm_g, imm_f = topo(pool, bests_genome, bests_fitness, rng,
                              mig=mig, axis=axis, epoch=epoch,
                              available=available)
    delivered = torch.isfinite(imm_f)
    acc = mig.acceptance
    if acc is not None and acc.policy != "always":
        # repro-lint: disable=RNG01  -- fold_in derives, as jax.random's does
        k_gate = rand.fold_in(rng, 0x5EED)
        imm_f = acceptance_lib.gate_immigrants(
            bests_genome, bests_fitness, imm_g, imm_f, k_gate, acc)
    if with_ledger:
        return pool, imm_g, imm_f, delivered, torch.isfinite(imm_f)
    return pool, imm_g, imm_f


def _avail_parts(available, axis, device
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Split ``available`` into ``(scalar, vector)`` bool tensors, exactly
    one of them set: the sync drivers' whole-step gate, or the async
    runtime's per-island fire mask (under ``axis``, this rank's
    islands')."""
    avail = torch.as_tensor(available, dtype=torch.bool, device=device)
    return (avail, None) if avail.dim() == 0 else (None, avail)


def _source_masked(bests_fitness: torch.Tensor, vec):
    """Under a fire mask, silent sources contribute ``-inf``."""
    if vec is None:
        return bests_fitness
    return torch.where(vec, bests_fitness, NEG_INF)


def _deliver(pool: PoolState, imm_g: torch.Tensor, imm_f: torch.Tensor,
             scalar, vec):
    """A scalar gate masks the deliveries; under a fire mask they are
    already source-masked and the destinations buffer them."""
    if vec is not None:
        return pool, imm_g, imm_f
    return pool, imm_g, torch.where(scalar, imm_f, NEG_INF)


def _grid(n: int) -> Tuple[int, int]:
    """Most-square (rows, cols) factorization of ``n`` (rows <= cols)."""
    r = math.isqrt(n)
    while n % r:
        r -= 1
    return r, n // r


@register_topology("pool")
def pool_topology(pool: PoolState, bests_genome: torch.Tensor,
                  bests_fitness: torch.Tensor, rng: torch.Tensor, *,
                  mig: MigrationConfig, axis=None, epoch=0, available=True
                  ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """PUT all (I, L) bests into the pool through the acceptance policy
    (its key ``fold_in(rng, 0xACC)``), GET one random member per island.
    Under a fire mask only the firing islands' bests are valid PUTs (no
    whole-pool select) and only the firing islands' GETs are kept."""
    scalar, vec = _avail_parts(available, axis, bests_fitness.device)
    n_local = bests_genome.shape[0]
    k_put = rand.fold_in(rng, 0xACC)    # replicated: taken before the rank
    put_g, put_f, put_valid = bests_genome, bests_fitness, vec
    if axis is not None:
        # every replica applies the same PUT of every rank's bests
        put_g, put_f = axis.gather(bests_genome), axis.gather(bests_fitness)
        if vec is not None:
            put_valid = axis.gather(vec)
    new_pool = pool_put_batch(pool, put_g, put_f, valid=put_valid,
                              acc=mig.acceptance, rng=k_put)
    if vec is None:
        pool = PoolState(*(torch.where(scalar, a, b)
                           for a, b in zip(new_pool, pool)))
    else:
        pool = new_pool
    if axis is not None:
        # the ranks draw apart, as the reference's fold_in of axis_index
        # repro-lint: disable=RNG01  -- fold_in derives, as jax.random's does
        rng = rand.fold_in(rng, axis.rank)
    keys = rand.split(rng, n_local)
    genomes, fits = pool_get_random(pool, keys)
    gate = scalar if vec is None else vec
    return pool, genomes, torch.where(gate, fits, NEG_INF)


@register_topology("ring")
def ring_topology(pool: PoolState, bests_genome: torch.Tensor,
                  bests_fitness: torch.Tensor, rng: torch.Tensor, *,
                  mig: MigrationConfig, axis=None, epoch=0, available=True
                  ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Island ``i`` receives island ``i - 1``'s best; the pool is
    bypassed."""
    scalar, vec = _avail_parts(available, axis, bests_fitness.device)
    bests_fitness = _source_masked(bests_fitness, vec)
    if axis is not None:
        n = axis.world
        perm = [(i, (i + 1) % n) for i in range(n)]
        imm_g = axis.permute(bests_genome, perm)
        imm_f = axis.permute(bests_fitness, perm)
    else:
        imm_g = torch.roll(bests_genome, 1, dims=0)
        imm_f = torch.roll(bests_fitness, 1, dims=0)
    return _deliver(pool, imm_g, imm_f, scalar, vec)


@register_topology("torus")
def torus_topology(pool: PoolState, bests_genome: torch.Tensor,
                   bests_fitness: torch.Tensor, rng: torch.Tensor, *,
                   mig: MigrationConfig, axis=None, epoch=0, available=True
                   ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """The islands on the most-square (R, C) torus: even epochs migrate
    east ((r, c) -> (r, c + 1)), odd epochs south ((r, c) -> (r + 1, c)).
    A prime count factors as (1, n) and migrates east every epoch."""
    scalar, vec = _avail_parts(available, axis, bests_fitness.device)
    bests_fitness = _source_masked(bests_fitness, vec)
    if axis is not None:
        rows, cols = _grid(axis.world)
        perm = [(r * cols + c, r * cols + (c + 1) % cols)
                for r in range(rows) for c in range(cols)]
        # the epoch is replicated, so every rank runs the same single
        # permute (a host read of a device epoch)
        if rows > 1 and int(epoch) % 2 != 0:
            perm = [(r * cols + c, ((r + 1) % rows) * cols + c)
                    for r in range(rows) for c in range(cols)]
        imm_g = axis.permute(bests_genome, perm)
        imm_f = axis.permute(bests_fitness, perm)
        return _deliver(pool, imm_g, imm_f, scalar, vec)
    n = bests_genome.shape[0]
    rows, cols = _grid(n)
    east = torch.as_tensor(epoch, device=bests_fitness.device) % 2 == 0

    def shift(x):
        if rows == 1:
            return torch.roll(x, 1, dims=0)
        g = x.reshape((rows, cols) + x.shape[1:])
        e = east.reshape((1,) * g.dim())
        return torch.where(e, torch.roll(g, 1, dims=1),
                           torch.roll(g, 1, dims=0)).reshape(x.shape)

    imm_g, imm_f = shift(bests_genome), shift(bests_fitness)
    return _deliver(pool, imm_g, imm_f, scalar, vec)


@register_topology("random_graph")
def random_graph_topology(pool: PoolState, bests_genome: torch.Tensor,
                          bests_fitness: torch.Tensor, rng: torch.Tensor, *,
                          mig: MigrationConfig, axis=None, epoch=0,
                          available=True
                          ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Island ``i`` receives from ``perm[i]``, ``perm`` a permutation drawn
    from the epoch's key: a fresh 1-regular exchange graph every epoch."""
    scalar, vec = _avail_parts(available, axis, bests_fitness.device)
    bests_fitness = _source_masked(bests_fitness, vec)
    if axis is not None:
        # a permutation of the ranks, the same on every rank
        perm = rand.keyed_permutation(rng, axis.world)
        src = perm[axis.rank:axis.rank + 1]
        imm_g = axis.gather_stack(bests_genome).index_select(0, src)[0]
        imm_f = axis.gather_stack(bests_fitness).index_select(0, src)[0]
        return _deliver(pool, imm_g, imm_f, scalar, vec)
    perm = rand.keyed_permutation(rng, bests_genome.shape[0])
    return _deliver(pool, bests_genome[perm], bests_fitness[perm], scalar,
                    vec)


@register_topology("broadcast_best")
def broadcast_best_topology(pool: PoolState, bests_genome: torch.Tensor,
                            bests_fitness: torch.Tensor, rng: torch.Tensor,
                            *, mig: MigrationConfig, axis=None, epoch=0,
                            available=True
                            ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """Every island receives the epoch's best (the lowest island on
    ties); under a fire mask silent islands do not compete for it."""
    scalar, vec = _avail_parts(available, axis, bests_fitness.device)
    bests_fitness = _source_masked(bests_fitness, vec)
    n = bests_fitness.shape[0]
    if axis is not None:
        all_f = axis.gather(bests_fitness)
        g = all_f.argmax().reshape(1)
        owner, local_i = g // n, g % n
        row = bests_genome.index_select(0, local_i)[0]
        # the owner contributes its row, every other rank zeros, summed in
        # f32 as the reference's psum sums them
        contrib = torch.where(owner == axis.rank, row,
                              torch.zeros_like(row)).to(torch.float32)
        elite_g = axis.sum_in_order(contrib).to(bests_genome.dtype)
        elite_f = all_f.index_select(0, g)[0]
    else:
        i = bests_fitness.argmax()
        elite_g, elite_f = bests_genome[i], bests_fitness[i]
    imm_g = elite_g.expand((n,) + bests_genome.shape[1:])
    imm_f = elite_f.expand((n,))
    return _deliver(pool, imm_g, imm_f, scalar, vec)


# ---------------------------------------------------------------------------
# Host <-> device pool bridge
# ---------------------------------------------------------------------------
class HostBridge:
    """Periodic sync between the device-resident :class:`PoolState` and a
    host :class:`~repro_torch.core.async_pool.PoolServer`.

    Out: the device pool's best is PUT to the server, so volunteer clients
    attached to it see the devices' progress. In: up to ``pull`` random
    server entries go into the device pool through the acceptance policy,
    so volunteer contributions become immigrants of the device islands.
    Server loss is a browser client's lost XHR: :meth:`sync` swallows
    :class:`~repro_torch.core.async_pool.PoolUnavailable` and counts it.

    ``acceptance`` is the policy the device pool applies to pulled
    entries; build the PoolServer with the same
    :class:`~repro_torch.core.types.AcceptanceConfig` so both sides decide
    alike. ``server`` may be a URL (``http://host:port`` or
    ``host:port``): the bridge then speaks the JSON wire protocol to a
    ``python -m repro_torch.server`` service through
    :class:`~repro_torch.server.client.RemotePoolServer`.
    """

    def __init__(self, server, every: int = 1, pull: int = 4,
                 uuid: int = -1,
                 acceptance: Optional[AcceptanceConfig] = None,
                 experiment: str = "default"):
        if every < 1:
            raise ValueError("every must be >= 1")
        if isinstance(server, str):
            # deferred: the server tier sits on top of core
            from ..server.client import RemotePoolServer
            server = RemotePoolServer(server, experiment=experiment)
        self.server = server
        self.every = every
        self.pull = pull
        self.uuid = uuid
        self.acceptance = acceptance
        self.pushed = 0
        self.pulled = 0
        self.lost = 0

    def due(self, epoch: int) -> bool:
        """True when this epoch is a sync epoch."""
        return epoch % self.every == 0

    def sync(self, pool: PoolState, epoch: int = 0) -> PoolState:
        """Best out, immigrants in. Returns the (possibly updated) device
        pool; a no-op off cycle or when the server is down."""
        if not self.due(epoch):
            return pool
        from .async_pool import PoolUnavailable  # local: avoid a cycle

        with obs_trace.span("bridge.sync", epoch=int(epoch)):
            try:
                if int(pool.count) > 0:
                    g, f = pool_best(pool)
                    with obs_trace.span("bridge.put"):
                        self.server.put(g.cpu().numpy(), float(f),
                                        uuid=self.uuid)
                    self.pushed += 1
            except PoolUnavailable:
                self.lost += 1
            genomes, fits = [], []
            for _ in range(self.pull):
                try:
                    with obs_trace.span("bridge.get"):
                        g, f = self.server.get_random()
                except PoolUnavailable:
                    # an up-but-empty server is a cold start, not an outage
                    if not getattr(self.server, "up", False):
                        self.lost += 1
                    break
                genomes.append(np.asarray(g))
                fits.append(float(f))
            if genomes:
                key = rand.fold_in(rand.key(17, device=pool.genomes.device),
                                   epoch)
                pool = pool_insert_host(pool, genomes, fits,
                                        acc=self.acceptance, rng=key)
                self.pulled += len(genomes)
        return pool

    def stats(self) -> Dict[str, int]:
        return {"pushed": self.pushed, "pulled": self.pulled,
                "lost": self.lost}
