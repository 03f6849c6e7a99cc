"""Plain PyTorch trap fitness: the version beside the CUDA kernel.

Per l-bit block with u ones the score is ``a(z-u)/z`` if u <= z, else
``b(u-z)/(l-z)``, in f32, and the block scores are summed over the traps.

The order of that f32 sum is fixed, because a third of a point rounds
differently in another order. It is the order XLA's CPU backend gives an
f32 row reduction (jax 0.9.0: a ``reduce-window`` of size 32, then a
``reduce`` of the window sums): a row of n > 32 terms is cut into
``w = ceil(n/32)`` windows of 32 over the row padded with ``p = 32w - n``
zeros, ``floor(p/2)`` of them before it, so the first window holds
``window_lead(n) = 32 - floor(p/2)`` terms, the next ones 32 and the last
the rest. Each window is summed from 0 left to right, and the ``w`` window
sums are summed by the same rule, again and again while more than 32 are
left; 32 terms or fewer are one left-to-right sum from 0. For 33-64 terms
that is two near-halves, and at 96 and 128 terms windows of 32, as the
earlier grouped order (groups of ``ceil(n/ceil(n/32))``) had it; from 65
terms on the two orders part, and this one is XLA's. The CUDA kernels sum
in the same order, so the two agree bit for bit on the card.
"""
from __future__ import annotations

import torch


WINDOW = 32


def window_lead(n_terms: int) -> int:
    """Terms in the first window of the ordered sum of ``n_terms`` terms
    (all of them up to 32); the windows after it hold 32 each, the last
    the rest."""
    if n_terms <= WINDOW:
        return n_terms
    pad = WINDOW * -(-n_terms // WINDOW) - n_terms
    return WINDOW - pad // 2


def window_edges(n_terms: int) -> list:
    """Start of every window of the first level and ``n_terms`` last."""
    edges = [0]
    if n_terms > 0:
        edges += list(range(window_lead(n_terms), n_terms, WINDOW))
        edges.append(n_terms)
    return edges


def ordered_sum(f: torch.Tensor) -> torch.Tensor:
    """Sum of ``f`` over its last axis in XLA's window order."""
    n_terms = f.shape[-1]
    if n_terms <= WINDOW:
        total = torch.zeros(f.shape[:-1], dtype=f.dtype, device=f.device)
        for t in range(n_terms):
            total = total + f[..., t]
        return total
    edges = window_edges(n_terms)
    return ordered_sum(torch.stack(
        [ordered_sum(f[..., e0:e1]) for e0, e1 in zip(edges, edges[1:])],
        dim=-1))


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
