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

Not ported yet, and raising with the ROADMAP item that brings it: the
SPMD context (``axis``, Queue A item 13).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import rand
from . import acceptance as acceptance_lib
from .pool import NEG_INF, pool_get_random, pool_put_batch
from .types import MigrationConfig, PoolState

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
    runtime's per-island fire mask. The SPMD context raises."""
    if axis is not None:
        raise NotImplementedError("the SPMD topologies (axis=...) come with "
                                  "the sharded drivers (ROADMAP, Queue A "
                                  "item 13)")
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
    new_pool = pool_put_batch(pool, bests_genome, bests_fitness, valid=vec,
                              acc=mig.acceptance,
                              rng=rand.fold_in(rng, 0xACC))
    if vec is None:
        pool = PoolState(*(torch.where(scalar, a, b)
                           for a, b in zip(new_pool, pool)))
    else:
        pool = new_pool
    keys = rand.split(rng, bests_genome.shape[0])
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
    i = bests_fitness.argmax()
    imm_g = bests_genome[i].expand((n,) + bests_genome.shape[1:])
    imm_f = bests_fitness[i].expand((n,))
    return _deliver(pool, imm_g, imm_f, scalar, vec)
