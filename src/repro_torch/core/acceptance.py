"""Immigrant acceptance: which candidates enter a pool, and where.

The port of ``repro.core.acceptance``. A policy maps ``(pool_genomes,
pool_fitness, cand_genomes, cand_fitness, cand_valid, rng, *, ptr, count,
acc)`` to ``(slots, new_ptr, new_count)``: candidate ``j`` overwrites
resident ``slots[j]`` when ``slots[j] < capacity`` and is dropped when it
equals ``capacity``. Slots of accepted candidates are distinct, and every
decision is a deterministic function of the inputs.

Built-in policies, as in the reference:

``always``    the ring insert, the correctness anchor;
``elitist``   the r-th best candidate challenges the r-th worst resident
              (empty slots count as ``-inf`` residents);
``crowding``  each candidate challenges its nearest resident by genome
              distance (the lowest slot on ties) and wins iff fitter;
              candidates crowding one resident resolve to the fittest,
              then the lowest index; empty slots fill first, ring-style;
``dedup``     candidates within ``epsilon`` of a resident, or of an
              earlier surviving candidate, are rejected; the rest go
              through ``elitist``.

Register another with :func:`register_policy` and select it with
``AcceptanceConfig(policy=...)``. Two dispatch surfaces: :func:`apply_policy`
inserts into a device :class:`PoolState` (``pool.pool_put_batch``), and
:func:`gate_immigrants` is every topology's receive gate. :func:`host_accept`
is the numpy mirror of the policies on a one-candidate stream.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import rand
from .types import AcceptanceConfig, PoolState

NEG_INF = float("-inf")

ACCEPTANCE_POLICIES: Dict[str, Callable] = {}


def register_policy(name: str):
    """Decorator: register an acceptance policy under ``name``."""
    def deco(fn: Callable) -> Callable:
        ACCEPTANCE_POLICIES[name] = fn
        fn.policy_name = name
        return fn
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(ACCEPTANCE_POLICIES))


def get_policy(name: str) -> Callable:
    if name in ACCEPTANCE_POLICIES:
        return ACCEPTANCE_POLICIES[name]
    raise KeyError(f"unknown acceptance policy {name!r}; registered: "
                   f"{available_policies()}")


def _distances(residents: torch.Tensor, cands: torch.Tensor,
               acc: AcceptanceConfig) -> torch.Tensor:
    """(k, cap) candidate-to-resident distances: Hamming (the count of
    differing genes) or L2 (``sqrt`` correctly rounded; the sum's order is
    PyTorch's, not XLA's, so float genomes agree within an ulp or so)."""
    metric = acc.metric
    if metric == "auto":
        metric = "l2" if residents.dtype.is_floating_point else "hamming"
    if metric == "hamming":
        return (cands[:, None, :] != residents[None, :, :]).sum(-1).float()
    d = cands.float()[:, None, :] - residents.float()[None, :, :]
    return rand.sqrt_f32((d * d).sum(-1))


def _count_after(pool_fitness: torch.Tensor, slots: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """count plus the accepted candidates landing on empty (-inf) slots,
    saturated at capacity."""
    cap = pool_fitness.shape[0]
    accepted = slots < cap
    tgt_f = pool_fitness[torch.clamp(slots, 0, cap - 1).long()]
    filled = (accepted & ~torch.isfinite(tgt_f)).sum(dtype=torch.int32)
    return torch.clamp(count + filled, max=cap).to(torch.int32)


@register_policy("always")
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


def _elitist_slots(pool_fitness: torch.Tensor, cand_fitness: torch.Tensor,
                   cand_valid: torch.Tensor) -> torch.Tensor:
    """Rank-paired replace-worst-if-better with distinct slots (stable
    index order on ties on both sides)."""
    k = cand_fitness.shape[0]
    cap = pool_fitness.shape[0]
    res_order = torch.sort(pool_fitness, stable=True).indices   # worst first
    score = torch.where(cand_valid, cand_fitness, NEG_INF)
    cand_order = torch.sort(-score, stable=True).indices         # best first
    ranks = torch.clamp(torch.arange(k, device=score.device), max=cap - 1)
    target = res_order[ranks]
    accept = score[cand_order] > pool_fitness[target]
    slot_sorted = torch.where(accept, target, cap).to(torch.int32)
    slots = torch.zeros(k, dtype=torch.int32, device=score.device)
    slots[cand_order] = slot_sorted
    return slots


@register_policy("elitist")
def elitist_policy(pool_genomes, pool_fitness, cand_genomes, cand_fitness,
                   cand_valid, rng, *, ptr, count, acc):
    slots = _elitist_slots(pool_fitness, cand_fitness, cand_valid)
    return slots, ptr, _count_after(pool_fitness, slots, count)


@register_policy("crowding")
def crowding_policy(pool_genomes, pool_fitness, cand_genomes, cand_fitness,
                    cand_valid, rng, *, ptr, count, acc):
    """Nearest-resident replacement; empty slots fill ring-style first."""
    k = cand_fitness.shape[0]
    cap = pool_fitness.shape[0]
    dev = pool_fitness.device
    filled = torch.isfinite(pool_fitness)
    n_empty = cap - filled.sum(dtype=torch.int32)
    empty_order = torch.sort(filled.to(torch.int32),
                             stable=True).indices                # empty first
    vrank = torch.cumsum(cand_valid.to(torch.int32), 0) - 1
    is_fill = cand_valid & (vrank < n_empty)
    fill_slot = empty_order[torch.clamp(vrank, 0, cap - 1)]

    dist = torch.where(filled[None, :],
                       _distances(pool_genomes, cand_genomes, acc),
                       float("inf"))
    nearest = dist.argmin(1)                                 # ties: low slot
    want = cand_valid & ~is_fill & (cand_fitness > pool_fitness[nearest])
    score = torch.where(want, cand_fitness, NEG_INF)
    best_per_slot = torch.full((cap,), NEG_INF, device=dev).scatter_reduce(
        0, nearest, score, reduce="amax")
    is_best = want & (score >= best_per_slot[nearest])
    idx = torch.arange(k, device=dev)
    win_idx = torch.full((cap,), k, device=dev).scatter_reduce(
        0, nearest, torch.where(is_best, idx, k), reduce="amin")
    win = is_best & (win_idx[nearest] == idx)
    slots = torch.where(is_fill, fill_slot,
                        torch.where(win, nearest, cap)).to(torch.int32)
    n_fill = is_fill.sum(dtype=torch.int32)
    return (slots, ((ptr + n_fill) % cap).to(torch.int32),
            torch.clamp(count + n_fill, max=cap).to(torch.int32))


@register_policy("dedup")
def dedup_policy(pool_genomes, pool_fitness, cand_genomes, cand_fitness,
                 cand_valid, rng, *, ptr, count, acc):
    """Candidates within ``acc.epsilon`` of a resident or of an earlier
    surviving candidate are rejected (the reference's ``fori_loop``, one
    step per candidate), then elitist."""
    k = cand_fitness.shape[0]
    filled = torch.isfinite(pool_fitness)
    dist = torch.where(filled[None, :],
                       _distances(pool_genomes, cand_genomes, acc),
                       float("inf"))
    res_dup = (dist <= acc.epsilon).any(1)
    near = _distances(cand_genomes, cand_genomes, acc) <= acc.epsilon
    idx = torch.arange(k, device=cand_fitness.device)
    kept = torch.zeros(k, dtype=torch.bool, device=cand_fitness.device)
    for j in range(k):
        dup_j = res_dup[j] | ((idx < j) & kept & near[j]).any()
        kept = torch.where(idx == j, cand_valid[j] & ~dup_j, kept)
    slots = _elitist_slots(pool_fitness, cand_fitness, kept)
    return slots, ptr, _count_after(pool_fitness, slots, count)


def _top_cap(fitness: torch.Tensor, valid: torch.Tensor,
             cap: int) -> torch.Tensor:
    """Indices of the ``cap`` best valid candidates, best first, ties to
    the lowest index (``lax.top_k``'s order)."""
    score = torch.where(valid, fitness, NEG_INF)
    order = torch.sort(score, descending=True, stable=True).indices
    return order[:cap]


def apply_policy(pool: PoolState, genomes: torch.Tensor,
                 fitness: torch.Tensor, valid: Optional[torch.Tensor],
                 rng: Optional[torch.Tensor],
                 acc: AcceptanceConfig) -> PoolState:
    """Insert up to ``k`` candidates through the policy; with more
    candidates than capacity the best ``cap`` valid ones go forward. No
    key means ``key(0)``, as in the reference."""
    k = genomes.shape[0]
    cap = pool.genomes.shape[0]
    dev = genomes.device
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=dev)
    if k > cap:
        top = _top_cap(fitness, valid, cap)
        genomes, fitness, valid = genomes[top], fitness[top], valid[top]
    if rng is None:
        rng = rand.key(0, device=dev)
    policy = get_policy(acc.policy)
    slots, new_ptr, new_count = policy(
        pool.genomes, pool.fitness, genomes, fitness, valid, rng,
        ptr=pool.ptr, count=pool.count, acc=acc)
    # one spare row at index ``cap`` takes the dropped candidates, so the
    # scatter needs no host-side filtering
    target = torch.clamp(slots.long(), max=cap)
    new_genomes = torch.cat([pool.genomes,
                             torch.zeros_like(pool.genomes[:1])])
    new_genomes[target] = genomes.to(pool.genomes.dtype)
    new_fitness = torch.cat([pool.fitness, pool.fitness[:1]])
    new_fitness[target] = fitness
    return PoolState(genomes=new_genomes[:cap], fitness=new_fitness[:cap],
                     ptr=torch.as_tensor(new_ptr, dtype=torch.int32,
                                         device=dev),
                     count=torch.as_tensor(new_count, dtype=torch.int32,
                                           device=dev))


def gate_immigrants(dest_genome: torch.Tensor, dest_fitness: torch.Tensor,
                    imm_genome: torch.Tensor, imm_fitness: torch.Tensor,
                    rng: torch.Tensor, acc: AcceptanceConfig) -> torch.Tensor:
    """Each destination island runs the policy against the one-slot pool
    of its own current best, with its own key from ``split(rng, n)``;
    rejected deliveries read ``-inf``. The reference vmaps the policy over
    the islands; this loops over them."""
    policy = get_policy(acc.policy)
    n = imm_fitness.shape[0]
    keys = rand.split(rng, n)
    valid = torch.isfinite(imm_fitness)
    zero = torch.zeros((), dtype=torch.int32, device=imm_fitness.device)
    kept = []
    for i in range(n):
        slots, _, _ = policy(
            dest_genome[i:i + 1], dest_fitness[i:i + 1],
            imm_genome[i:i + 1], imm_fitness[i:i + 1], valid[i:i + 1],
            keys[i], ptr=zero,
            count=torch.isfinite(dest_fitness[i]).to(torch.int32), acc=acc)
        kept.append(slots[0] < 1)
    return torch.where(torch.stack(kept), imm_fitness, NEG_INF)


# ---------------------------------------------------------------------------
# The numpy mirror for a host pool server (a one-candidate stream)
# ---------------------------------------------------------------------------
def _host_distances(res_genomes: np.ndarray, cand: np.ndarray,
                    acc: AcceptanceConfig) -> np.ndarray:
    metric = acc.metric
    if metric == "auto":
        metric = "l2" if np.issubdtype(res_genomes.dtype, np.floating) \
            else "hamming"
    if metric == "hamming":
        return (res_genomes != cand[None, :]).sum(-1).astype(np.float64)
    d = res_genomes.astype(np.float64) - cand[None, :].astype(np.float64)
    return np.sqrt((d * d).sum(-1))


APPEND = "append"

#: Policies with an exact numpy mirror in :func:`host_accept`.
HOST_MIRRORED = ("always", "crowding", "dedup", "elitist")


def host_accept(res_genomes: Optional[np.ndarray], res_fitness: np.ndarray,
                cand_genome: np.ndarray, cand_fitness: float,
                acc: AcceptanceConfig, capacity: int):
    """A host pool's decision for one PUT, mirroring the device policies
    on a one-candidate stream: :data:`APPEND` (take a free slot), an
    ``int`` victim index to overwrite, or ``None`` to reject.
    ``res_genomes`` is read only by the distance policies."""
    n = len(res_fitness)
    if acc.policy == "always":
        return APPEND
    if acc.policy == "dedup" and n:
        if _host_distances(res_genomes, cand_genome, acc).min() \
                <= acc.epsilon:
            return None
    if n < capacity:
        return APPEND
    if acc.policy == "crowding":
        victim = int(_host_distances(res_genomes, cand_genome, acc).argmin())
    elif acc.policy in ("elitist", "dedup"):
        victim = int(np.asarray(res_fitness).argmin())
    else:
        raise KeyError(f"acceptance policy {acc.policy!r} has no host "
                       f"mirror; registered device policies: "
                       f"{available_policies()}")
    if cand_fitness > float(res_fitness[victim]):
        return victim
    return None
