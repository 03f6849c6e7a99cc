"""The classic genetic operators (NodEO's 'Classic' algorithm): ``impl='jnp'``.

The port of ``repro.core.ga``. Every function takes a *batch* of islands,
the written-out form of the reference's ``vmap``: populations ``(I, n,
L)``, fitness ``(I, n)``, ``pop_size`` ``(I,)`` and one key per island,
``(I, 2)``. Each draw is the keyed recipe of :mod:`repro_torch.rand` that
follows the reference's ``jax.random`` call, so binary genomes under
tournament selection evolve bit for bit as the reference's do; roulette
(Gumbel) and gaussian mutation (``erf_inv``) go through ``log`` and
``log1p`` and agree within the tolerances their tests state.

Selection draws parent indices in ``[0, pop_size)`` only, so padded lanes
are never parents; they are still written each generation, and their
fitness is forced to ``-inf``. :func:`next_generation_jnp` is the kernel
table's ``("generation", kind, "jnp")`` entry (registered below);
:func:`next_generation` dispatches on ``cfg.impl`` like the reference's.
"""
from __future__ import annotations

import torch

from .. import rand
from ..kernels.ga import registry
from .types import EAConfig, GenomeSpec

NEG_INF = float("-inf")


def mask_fitness(fitness: torch.Tensor,
                 pop_size: torch.Tensor) -> torch.Tensor:
    """(I, n) fitness with lanes >= pop_size forced to -inf."""
    lanes = torch.arange(fitness.shape[-1], device=fitness.device)
    return torch.where(lanes < pop_size[..., None], fitness, NEG_INF)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i]]`` for every island i: (I, n, ...) by (I, m)."""
    isl = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[isl, idx]


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------
def tournament_select(rng: torch.Tensor, fitness: torch.Tensor,
                      pop_size: torch.Tensor, n: int,
                      k: int = 2) -> torch.Tensor:
    """(I, n) parent indices by size-k tournaments over the valid lanes;
    the first candidate wins a tie."""
    cand = rand.keyed_randint(rng, (n, k), 0,
                              torch.clamp(pop_size, min=1)).long()
    cf = torch.gather(fitness, 1, cand.reshape(cand.shape[0], -1)).reshape(
        cand.shape)
    return torch.gather(cand, 2, cf.argmax(-1, keepdim=True))[..., 0]


def roulette_logits(fitness: torch.Tensor,
                    pop_size: torch.Tensor) -> torch.Tensor:
    """Log-weights for fitness-proportional selection: each valid lane's
    fitness minus the island's least, plus 1e-6; invalid lanes get exactly
    ``-inf``."""
    masked = mask_fitness(fitness, pop_size)
    valid = torch.isfinite(masked)
    finite = torch.where(valid, masked, 0.0)
    lo = torch.where(valid, masked, float("inf")).amin(-1, keepdim=True)
    w = torch.where(valid, (finite - lo) + rand.const(
        1e-6, torch.float32, fitness.device), 1.0)
    return torch.where(valid, rand.log_f32(w), NEG_INF)


def roulette_select(rng: torch.Tensor, fitness: torch.Tensor,
                    pop_size: torch.Tensor, n: int) -> torch.Tensor:
    """Fitness-proportional selection (padded lanes unselectable)."""
    return rand.keyed_categorical(rng, roulette_logits(fitness, pop_size),
                                  (n,))


def select(rng: torch.Tensor, fitness: torch.Tensor, pop_size: torch.Tensor,
           n: int, cfg: EAConfig) -> torch.Tensor:
    if cfg.selection == "tournament":
        return tournament_select(rng, fitness, pop_size, n, cfg.tournament_k)
    if cfg.selection == "roulette":
        return roulette_select(rng, fitness, pop_size, n)
    raise ValueError(f"unknown selection {cfg.selection!r}")


# ---------------------------------------------------------------------------
# Crossover
# ---------------------------------------------------------------------------
def two_point_crossover(rng: torch.Tensor, pa: torch.Tensor,
                        pb: torch.Tensor) -> torch.Tensor:
    """Genes in [cut0, cut1) from ``pb``, the rest from ``pa``; the two
    cuts are drawn in [0, L] and sorted."""
    _, n, L = pa.shape
    k1 = rand.split(rng, 2)[:, 0]
    cut = torch.sort(rand.keyed_randint(k1, (n, 2), 0, L + 1), dim=-1).values
    pos = torch.arange(L, device=pa.device)
    inside = (pos >= cut[..., :1]) & (pos < cut[..., 1:])
    return torch.where(inside, pb, pa)


def uniform_crossover(rng: torch.Tensor, pa: torch.Tensor,
                      pb: torch.Tensor) -> torch.Tensor:
    mask = rand.keyed_bernoulli(rng, 0.5, pa.shape[1:])
    return torch.where(mask, pb, pa)


def blend_crossover(rng: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                    alpha: float = 0.5) -> torch.Tensor:
    """BLX-alpha for float genomes: ``pa + u * (pb - pa)``, u uniform in
    [-alpha, 1 + alpha), one fused multiply-add as XLA's CPU code
    contracts it."""
    u = rand.keyed_uniform(rng, pa.shape[1:], -alpha, 1.0 + alpha)
    return rand.fma(u, pb - pa, pa).to(pa.dtype)


def crossover(rng: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
              cfg: EAConfig, genome: GenomeSpec) -> torch.Tensor:
    """Crossover, then the rate gate: a row whose gate is off keeps
    ``pa``."""
    keys = rand.split(rng, 2)
    k_cx, k_rate = keys[:, 0], keys[:, 1]
    if cfg.crossover == "two_point":
        kids = two_point_crossover(k_cx, pa, pb)
    elif cfg.crossover == "uniform":
        kids = uniform_crossover(k_cx, pa, pb)
    elif cfg.crossover == "blend":
        if genome.kind != "float":
            raise ValueError("blend crossover requires float genome")
        kids = blend_crossover(k_cx, pa, pb)
    else:
        raise ValueError(f"unknown crossover {cfg.crossover!r}")
    do = rand.keyed_bernoulli(k_rate, cfg.crossover_rate, (pa.shape[1], 1))
    return torch.where(do, kids, pa)


# ---------------------------------------------------------------------------
# Mutation
# ---------------------------------------------------------------------------
def mutate(rng: torch.Tensor, pop: torch.Tensor, cfg: EAConfig,
           genome: GenomeSpec) -> torch.Tensor:
    """Bit flips at ``cfg.mut_rate``, or gaussian noise of
    ``mutation_sigma`` on the hit genes (``pop + normal * sigma``, one
    fused multiply-add as in the reference) clipped to the bounds."""
    rate = cfg.mut_rate(genome)
    shape = pop.shape[1:]
    if genome.kind == "binary":
        flips = rand.keyed_bernoulli(rng, rate, shape)
        return torch.where(flips, 1 - pop, pop).to(pop.dtype)
    keys = rand.split(rng, 2)
    hits = rand.keyed_bernoulli(keys[:, 0], rate, shape)
    sigma = rand.const(cfg.mutation_sigma, torch.float32, pop.device)
    noisy = rand.fma(rand.keyed_normal(keys[:, 1], shape), sigma, pop)
    out = torch.where(hits, noisy, pop)
    return torch.clamp(out, genome.low, genome.high).to(pop.dtype)


# ---------------------------------------------------------------------------
# One full generation
# ---------------------------------------------------------------------------
def next_generation(rng: torch.Tensor, pop: torch.Tensor,
                    fitness: torch.Tensor, pop_size: torch.Tensor,
                    cfg: EAConfig, genome: GenomeSpec) -> torch.Tensor:
    """The next padded populations, through the kernel table's entry for
    ``cfg.impl`` (the classic path below for ``'jnp'``)."""
    kern = registry.get_kernel("generation", genome.kind, cfg.impl)
    return kern(rng, pop, fitness, pop_size, cfg, genome)


def next_generation_jnp(rng: torch.Tensor, pop: torch.Tensor,
                        fitness: torch.Tensor, pop_size: torch.Tensor,
                        cfg: EAConfig, genome: GenomeSpec) -> torch.Tensor:
    """The classic generation: slots [0, elite) hold the best valid lanes
    (the lowest index first on ties, as ``lax.top_k``), the rest fresh
    children of two selections, crossover and mutation."""
    n = pop.shape[1]
    masked = mask_fitness(fitness, pop_size)
    keys = rand.split(rng, 4)
    n_children = n - cfg.elite
    ia = select(keys[:, 0], masked, pop_size, n_children, cfg)
    ib = select(keys[:, 1], masked, pop_size, n_children, cfg)
    kids = crossover(keys[:, 2], _rows(pop, ia), _rows(pop, ib), cfg, genome)
    kids = mutate(keys[:, 3], kids, cfg, genome)
    elite_idx = torch.sort(masked, dim=-1, descending=True,
                           stable=True).indices[:, :cfg.elite]
    return torch.cat([_rows(pop, elite_idx), kids], dim=1)


for _kind in ("binary", "float"):
    registry.register_kernel("generation", _kind, "jnp")(next_generation_jnp)
