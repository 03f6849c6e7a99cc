"""Plain PyTorch trap fitness: the version beside the CUDA kernel.

Per l-bit block with u ones the score is ``a(z-u)/z`` if u <= z, else
``b(u-z)/(l-z)``, in f32, and the block scores are summed over the traps.

The order of that f32 sum is fixed, because a third of a point rounds
differently in another order: the traps are cut into groups of at most
``sum_group(n_traps)`` consecutive traps, each group is summed in
ascending order, and the group sums are added in ascending order. Up to 32
traps that is one left-to-right sum; from 33 to 64 traps it is the split
in two near-halves that XLA's CPU backend makes of an f32 row reduction
(jax 0.9.0), so at the paper's 40 traps this version matches the
reference exactly. The CUDA kernel sums in the same order, so the two
agree bit for bit on the card.
"""
from __future__ import annotations

import torch


def sum_group(n_terms: int) -> int:
    """Terms per group of the ordered f32 sum of ``n_terms`` terms."""
    groups = -(-n_terms // 32)
    return -(-n_terms // max(groups, 1))


def ordered_sum(f: torch.Tensor) -> torch.Tensor:
    """Sum of ``f`` over its last axis in the grouped ascending order."""
    n_terms = f.shape[-1]
    group = sum_group(n_terms)
    total = torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)
    for g0 in range(0, n_terms, group):
        part = torch.zeros_like(total)
        for t in range(g0, min(g0 + group, n_terms)):
            part = part + f[..., t]
        total = total + part
    return total


def trap_scores(u: torch.Tensor, *, l: int, a: float, b: float,
                z: float) -> torch.Tensor:
    """Block scores of the ones counts ``u`` (f32)."""
    return torch.where(u <= z, a * (z - u) / z, b * (u - z) / (l - z))


def trap_fitness(pop: torch.Tensor, *, n_traps: int, l: int, a: float,
                 b: float, z: float) -> torch.Tensor:
    """(N, n_traps*l) genes -> (N,) f32."""
    n = pop.shape[0]
    u = pop.reshape(n, n_traps, l).to(torch.float32).sum(-1)  # exact counts
    return ordered_sum(trap_scores(u, l=l, a=a, b=b, z=z))
