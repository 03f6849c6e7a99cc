"""Islands: independent GAs, each a NodIO browser client.

An epoch is ``generations_per_epoch`` generations with no outside
contact. Every function here takes and returns a *batch* of islands (the
leading axis of each :class:`IslandState` field), the written-out form of
the reference's ``vmap``; :func:`init_island` is the one-island
convenience. Islands that are done are frozen: they charge no evaluations
and draw no keys.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import rand
from .._device import resolve_device
from ..kernels.ga import registry
from . import ga
from .ga import mask_fitness
from .problems import Problem
from .types import EAConfig, IslandState


def success(best: torch.Tensor, problem: Problem,
            cfg: EAConfig) -> torch.Tensor:
    """best >= optimum - eps, the threshold rounded to f32 first."""
    if problem.optimum is None:
        return torch.zeros(best.shape, dtype=torch.bool, device=best.device)
    return best >= rand.f32(problem.optimum - cfg.success_eps)


def where_islands(mask: torch.Tensor, new: IslandState,
                  old: IslandState) -> IslandState:
    """Field-wise select between two island batches by an (I,) mask."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return IslandState(*(pick(a, b) for a, b in zip(new, old)))


def _evaluate(problem: Problem, pop: torch.Tensor) -> torch.Tensor:
    """Problem fitness of an (I, n, L) batch as one (I*n, L) call."""
    flat = pop.reshape(-1, pop.shape[-1])
    return problem.evaluate(problem.consts, flat).reshape(pop.shape[:-1])


def _best(fitness: torch.Tensor, pop: torch.Tensor):
    """Best lane of each island (ties to the lowest index)."""
    best_i = fitness.argmax(-1)
    rows = torch.arange(fitness.shape[0], device=fitness.device)
    return fitness[rows, best_i], pop[rows, best_i]


def _init_batch(keys: torch.Tensor, problem: Problem, cfg: EAConfig,
                uuid: torch.Tensor,
                pop_size: Optional[torch.Tensor] = None) -> IslandState:
    # the reference splits (k_pop, k_size, k_state)
    sub = rand.split(keys, 3)
    if pop_size is None:
        pop_size = rand.keyed_randint(sub[:, 1], (), cfg.min_pop,
                                      cfg.max_pop + 1)
    pop_size = pop_size.to(torch.int32)
    pop = problem.init_population(sub[:, 0], cfg.max_pop)
    fitness = mask_fitness(_evaluate(problem, pop), pop_size)
    best_f, best_g = _best(fitness, pop)
    zeros = torch.zeros_like(pop_size)
    return IslandState(
        pop=pop, fitness=fitness, pop_size=pop_size, rng=sub[:, 2],
        generation=zeros, evaluations=pop_size.clone(), best_fitness=best_f,
        best_genome=best_g, done=success(best_f, problem, cfg),
        experiments=zeros.clone(), uuid=uuid.to(torch.int32))


def init_islands(rng: torch.Tensor, n_islands: int, problem: Problem,
                 cfg: EAConfig, *, device=None) -> IslandState:
    """A batch of islands with heterogeneous population sizes (W²)."""
    dev = resolve_device(device)
    keys = rand.split(rng.to(dev), n_islands)
    uuids = torch.arange(n_islands, dtype=torch.int32, device=dev)
    return _init_batch(keys, problem, cfg, uuids)


def init_island(rng: torch.Tensor, problem: Problem, cfg: EAConfig,
                uuid: int = 0, pop_size: Optional[int] = None, *,
                device=None) -> IslandState:
    """One island, its fields without the island axis."""
    dev = resolve_device(device)
    size = (None if pop_size is None else
            torch.tensor([pop_size], dtype=torch.int32, device=dev))
    batch = _init_batch(rng.to(dev)[None], problem, cfg,
                        torch.tensor([uuid], device=dev), size)
    return IslandState(*(f[0] for f in batch))


def _fused_generation_kernel(problem: Problem, cfg: EAConfig):
    """The generation+evaluation kernel for (problem, cfg), or None to
    evolve and evaluate separately."""
    if cfg.impl == "jnp" or problem.fused is None:
        return None
    if not registry.has_kernel("generation_eval", problem.genome.kind,
                               cfg.impl):
        return None
    return registry.get_kernel("generation_eval", problem.genome.kind,
                               cfg.impl)


def generation_step(state: IslandState, problem: Problem,
                    cfg: EAConfig) -> IslandState:
    """One generation of every island; done islands pass through."""
    keys = rand.split(state.rng, 2)
    rng_next, k_gen = keys[:, 0], keys[:, 1]
    fused = _fused_generation_kernel(problem, cfg)
    if fused is not None:
        new_pop, raw_fit = fused(k_gen, state.pop, state.fitness,
                                 state.pop_size, cfg, problem.genome,
                                 problem.fused, consts=problem.consts)
        new_fit = mask_fitness(raw_fit, state.pop_size)
    else:
        new_pop = ga.next_generation(k_gen, state.pop, state.fitness,
                                     state.pop_size, cfg, problem.genome)
        new_fit = mask_fitness(_evaluate(problem, new_pop), state.pop_size)
    top_f, top_g = _best(new_fit, new_pop)
    improved = top_f > state.best_fitness
    best_fitness = torch.where(improved, top_f, state.best_fitness)
    best_genome = torch.where(improved[:, None], top_g, state.best_genome)

    live = ~state.done
    return IslandState(
        pop=torch.where(live[:, None, None], new_pop, state.pop),
        fitness=torch.where(live[:, None], new_fit, state.fitness),
        pop_size=state.pop_size,
        rng=torch.where(live[:, None], rng_next, state.rng),
        generation=torch.where(live, state.generation + 1, state.generation),
        evaluations=torch.where(live, state.evaluations + state.pop_size,
                                state.evaluations),
        best_fitness=torch.where(live, best_fitness, state.best_fitness),
        best_genome=torch.where(live[:, None], best_genome,
                                state.best_genome),
        done=(state.done | (live & success(best_fitness, problem, cfg))
              | (live & (state.evaluations >= cfg.max_evaluations))),
        experiments=state.experiments,
        uuid=state.uuid,
    )


def island_epoch(state: IslandState, problem: Problem,
                 cfg: EAConfig) -> IslandState:
    """``generations_per_epoch`` generations (the autonomous phase)."""
    for _ in range(cfg.generations_per_epoch):
        state = generation_step(state, problem, cfg)
    return state


def restart_island(state: IslandState, problem: Problem,
                   cfg: EAConfig) -> IslandState:
    """W² restart of the islands that are done: a fresh population and
    pop_size, the uuid and cumulative counters kept, the solved-experiment
    counter bumped. Islands not done are returned unchanged."""
    # the reference splits (k_next, k_pop, k_size)
    sub = rand.split(state.rng, 3)
    pop_size = rand.keyed_randint(sub[:, 2], (), cfg.min_pop,
                                  cfg.max_pop + 1)
    pop = problem.init_population(sub[:, 1], cfg.max_pop)
    fitness = mask_fitness(_evaluate(problem, pop), pop_size)
    best_f, best_g = _best(fitness, pop)
    fresh = IslandState(
        pop=pop, fitness=fitness, pop_size=pop_size, rng=sub[:, 0],
        generation=torch.zeros_like(state.generation),
        evaluations=state.evaluations + pop_size,
        best_fitness=best_f, best_genome=best_g,
        done=success(best_f, problem, cfg),
        experiments=state.experiments + 1, uuid=state.uuid)
    return where_islands(state.done, fresh, state)


def receive_immigrant(state: IslandState, genome: torch.Tensor,
                      fitness: torch.Tensor,
                      replace: str = "worst") -> IslandState:
    """GET side of migration: each island puts its immigrant (I, L) over
    its worst valid lane (lowest index on ties) or a random valid lane. An
    immigrant with -inf fitness (empty pool, server down) is a no-op."""
    valid = torch.isfinite(fitness)
    masked = mask_fitness(state.fitness, state.pop_size)
    if replace == "worst":
        lanes = torch.arange(state.fitness.shape[-1],
                             device=state.fitness.device)
        cand = torch.where(lanes < state.pop_size[:, None], masked,
                           float("inf"))
        slot = cand.argmin(-1)
    elif replace == "random":
        keys = rand.split(state.rng, 2)
        slot = rand.keyed_randint(keys[:, 1], (), 0,
                                  torch.clamp(state.pop_size, min=1)).long()
        state = state._replace(rng=keys[:, 0])
    else:
        raise ValueError(f"unknown replace {replace!r}")
    do = valid & ~state.done
    rows = torch.arange(fitness.shape[0], device=fitness.device)
    genome = genome.to(state.pop.dtype)
    new_pop = state.pop.clone()
    new_pop[rows, slot] = torch.where(do[:, None], genome,
                                      state.pop[rows, slot])
    new_fit = state.fitness.clone()
    new_fit[rows, slot] = torch.where(do, fitness, state.fitness[rows, slot])
    improved = do & (fitness > state.best_fitness)
    return state._replace(
        pop=new_pop,
        fitness=new_fit,
        best_fitness=torch.where(improved, fitness, state.best_fitness),
        best_genome=torch.where(improved[:, None], genome,
                                state.best_genome),
    )
