"""Device-resident chromosome pool: the array form of NodIO's REST server.

``PUT`` inserts every island's best through the acceptance policy;
``GET`` hands each island a uniformly random pool member drawn with its
own key. An empty pool answers with fitness ``-inf``, which islands treat
as a no-op (server down, or cold start).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import rand
from . import acceptance as acceptance_lib
from .types import AcceptanceConfig, GenomeSpec, PoolState

NEG_INF = float("-inf")
_ALWAYS = AcceptanceConfig()


def pool_init(capacity: int, genome: GenomeSpec, *,
              device=None) -> PoolState:
    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)
    return PoolState(
        genomes=torch.zeros((capacity, genome.length), dtype=genome.dtype,
                            device=device),
        fitness=torch.full((capacity,), NEG_INF, dtype=torch.float32,
                           device=device),
        ptr=scalar(), count=scalar())


def pool_put_batch(pool: PoolState, genomes: torch.Tensor,
                   fitness: torch.Tensor,
                   valid: Optional[torch.Tensor] = None,
                   acc: Optional[AcceptanceConfig] = None,
                   rng=None) -> PoolState:
    """Insert k entries through the acceptance policy (default 'always');
    entries with ``valid`` false never take a slot."""
    return acceptance_lib.apply_policy(pool, genomes, fitness, valid, rng,
                                       acc if acc is not None else _ALWAYS)


def pool_get_random(pool: PoolState,
                    rng: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One uniform random member per key of ``rng`` (..., 2); fitness
    -inf when the pool is empty."""
    idx = rand.keyed_randint(rng, (), 0,
                             torch.clamp(pool.count, min=1)).long()
    fit = torch.where(pool.count == 0, NEG_INF, pool.fitness[idx])
    return pool.genomes[idx], fit


def pool_best(pool: PoolState) -> Tuple[torch.Tensor, torch.Tensor]:
    i = pool.fitness.argmax()
    return pool.genomes[i], pool.fitness[i]
