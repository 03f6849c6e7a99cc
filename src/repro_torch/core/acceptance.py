"""Immigrant acceptance: which candidates enter the pool, and where.

This slice carries the ``always`` policy, the reference's legacy ring
insert and its bit-for-bit anchor. A policy maps ``(pool_genomes,
pool_fitness, cand_genomes, cand_fitness, cand_valid, rng, *, ptr, count,
acc)`` to ``(slots, new_ptr, new_count)``: candidate ``j`` overwrites
resident ``slots[j]`` when ``slots[j] < capacity`` and is dropped when it
equals ``capacity``. The elitist, crowding and dedup policies come later
(ROADMAP, Queue A item 9).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .types import AcceptanceConfig, PoolState

NOT_PORTED = ("elitist", "crowding", "dedup")


def always_policy(pool_genomes: torch.Tensor, pool_fitness: torch.Tensor,
                  cand_genomes: torch.Tensor, cand_fitness: torch.Tensor,
                  cand_valid: torch.Tensor, rng, *, ptr: torch.Tensor,
                  count: torch.Tensor, acc: AcceptanceConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ring insert: the r-th valid candidate (original order) takes slot
    ``(ptr + r) % cap``; the pointer advances by the valid count."""
    cap = pool_fitness.shape[0]
    valid = cand_valid.to(torch.int32)
    rank = torch.cumsum(valid, 0, dtype=torch.int32) - 1
    slots = torch.where(cand_valid, (ptr + rank) % cap,
                        torch.full_like(rank, cap)).to(torch.int32)
    n_valid = valid.sum(dtype=torch.int32)
    return (slots, ((ptr + n_valid) % cap).to(torch.int32),
            torch.clamp(count + n_valid, max=cap).to(torch.int32))


ACCEPTANCE_POLICIES: Dict[str, Callable] = {"always": always_policy}


def get_policy(name: str) -> Callable:
    if name in ACCEPTANCE_POLICIES:
        return ACCEPTANCE_POLICIES[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"acceptance policy {name!r} is not "
                                  "ported yet (ROADMAP, Queue A item 9)")
    raise KeyError(f"unknown acceptance policy {name!r}; registered: "
                   f"{sorted(ACCEPTANCE_POLICIES)}")


def _top_cap(fitness: torch.Tensor, valid: torch.Tensor,
             cap: int) -> torch.Tensor:
    """Indices of the ``cap`` best valid candidates, best first, ties to
    the lowest index (``lax.top_k``'s order)."""
    score = torch.where(valid, fitness, float("-inf"))
    order = torch.sort(score, descending=True, stable=True).indices
    return order[:cap]


def apply_policy(pool: PoolState, genomes: torch.Tensor,
                 fitness: torch.Tensor, valid: Optional[torch.Tensor],
                 rng, acc: AcceptanceConfig) -> PoolState:
    """Insert up to ``k`` candidates through the policy; with more
    candidates than capacity the best ``cap`` valid ones go forward."""
    k = genomes.shape[0]
    cap = pool.genomes.shape[0]
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=genomes.device)
    if k > cap:
        top = _top_cap(fitness, valid, cap)
        genomes, fitness, valid = genomes[top], fitness[top], valid[top]
    policy = get_policy(acc.policy)
    slots, new_ptr, new_count = policy(
        pool.genomes, pool.fitness, genomes, fitness, valid, rng,
        ptr=pool.ptr, count=pool.count, acc=acc)
    # one spare row at index ``cap`` takes the dropped candidates, so the
    # scatter needs no host-side filtering
    target = slots.long()
    new_genomes = torch.cat([pool.genomes,
                             torch.zeros_like(pool.genomes[:1])])
    new_genomes[target] = genomes.to(pool.genomes.dtype)
    new_fitness = torch.cat([pool.fitness, pool.fitness[:1]])
    new_fitness[target] = fitness
    return PoolState(genomes=new_genomes[:cap], fitness=new_fitness[:cap],
                     ptr=new_ptr, count=new_count)
