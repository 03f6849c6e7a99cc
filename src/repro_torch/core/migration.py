"""Migration: the paper's pool topology (PUT every best, GET a random one).

This slice carries the ``pool`` topology under the ``always`` acceptance
policy, with the scalar ``available`` gate of the synchronous drivers
(``False`` is a dead server: the pool is left as it was and every
immigrant reads ``-inf``). The ring, torus, random_graph and
broadcast_best topologies and the other policies come later (ROADMAP,
Queue A item 9); the per-island fire mask comes with the async runtime
(Queue A item 10).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .. import rand
from .pool import NEG_INF, pool_get_random, pool_put_batch
from .types import MigrationConfig, PoolState

NOT_PORTED = ("ring", "torus", "random_graph", "broadcast_best")


def pool_topology(pool: PoolState, bests_genome: torch.Tensor,
                  bests_fitness: torch.Tensor, rng: torch.Tensor, *,
                  mig: MigrationConfig, epoch=0, available=True
                  ) -> Tuple[PoolState, torch.Tensor, torch.Tensor]:
    """PUT all (I, L) bests into the pool, GET one random member per
    island."""
    avail = torch.as_tensor(available, device=bests_fitness.device)
    if avail.dim() != 0:
        raise NotImplementedError("a per-island fire mask comes with the "
                                  "async runtime (ROADMAP, Queue A item 10)")
    new_pool = pool_put_batch(pool, bests_genome, bests_fitness,
                              acc=mig.acceptance)
    pool = PoolState(*(torch.where(avail, a, b)
                       for a, b in zip(new_pool, pool)))
    keys = rand.split(rng, bests_genome.shape[0])
    genomes, fits = pool_get_random(pool, keys)
    return pool, genomes, torch.where(avail, fits, NEG_INF)


TOPOLOGIES: Dict[str, Callable] = {"pool": pool_topology}


def resolve_topology_name(mig: MigrationConfig) -> str:
    """An explicit ``topology`` wins; unset, legacy ``collective='ring'``
    means the ring, anything else the pool."""
    if mig.topology is not None:
        return mig.topology
    return "ring" if mig.collective == "ring" else "pool"


def get_topology(name: str) -> Callable:
    if name in TOPOLOGIES:
        return TOPOLOGIES[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"topology {name!r} is not ported yet "
                                  "(ROADMAP, Queue A item 9)")
    raise KeyError(f"unknown topology {name!r}; registered: "
                   f"{sorted(TOPOLOGIES)}")


def migrate(pool: PoolState, bests_genome: torch.Tensor,
            bests_fitness: torch.Tensor, rng: torch.Tensor,
            mig: MigrationConfig, *, epoch=0, available=True):
    """One migration step through the selected topology. The ``always``
    policy accepts every delivery, so no receive gate runs."""
    if mig.acceptance.policy != "always":
        raise NotImplementedError(
            f"acceptance policy {mig.acceptance.policy!r} is not ported yet "
            "(ROADMAP, Queue A item 9)")
    topo = get_topology(resolve_topology_name(mig))
    return topo(pool, bests_genome, bests_fitness, rng, mig=mig,
                epoch=epoch, available=available)
