"""State and configuration types of the island model, in PyTorch.

The same names, fields and dtypes as ``repro.core.types``:

* configuration is frozen dataclasses (hashable, compared by value);
* state is ``NamedTuple``s of tensors. A batch of islands carries a
  leading island axis on every field, the written-out form of the
  reference's ``vmap``;
* fitness is maximised, f32, ``-inf`` on padded lanes; counters are
  int32; binary populations are int8; keys are ``(..., 2)`` tensors of
  words (see :mod:`repro_torch.rand`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GenomeSpec:
    """kind: 'binary' (int8 0/1 genes) or 'float' (f32 genes in bounds)."""

    kind: str
    length: int
    low: float = -5.0
    high: float = 5.0

    def __post_init__(self):
        if self.kind not in ("binary", "float"):
            raise ValueError(f"unknown genome kind {self.kind!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.int8 if self.kind == "binary" else torch.float32


@dataclasses.dataclass(frozen=True)
class EAConfig:
    """The per-island GA. ``impl`` names the generation operator:
    'pallas' is the hand-written kernel (its plain version for a CPU
    tensor), 'pallas_ref' always the plain version; the names mean what
    they mean in the reference, so one config drives both packages."""

    max_pop: int = 256
    min_pop: int = 128
    generations_per_epoch: int = 100
    tournament_k: int = 2
    selection: str = "tournament"
    crossover: str = "two_point"
    crossover_rate: float = 0.9
    mutation_rate: Optional[float] = None  # None -> 1/L per gene
    mutation_sigma: float = 0.3
    elite: int = 2
    max_evaluations: int = 5_000_000
    success_eps: float = 1e-8
    impl: str = "jnp"

    def mut_rate(self, genome: GenomeSpec) -> float:
        return (self.mutation_rate if self.mutation_rate is not None
                else 1.0 / genome.length)


@dataclasses.dataclass(frozen=True)
class AcceptanceConfig:
    """Immigrant acceptance: which candidates enter the pool."""

    policy: str = "always"
    epsilon: float = 0.0
    metric: str = "auto"

    def __post_init__(self):
        if self.epsilon < 0.0:
            raise ValueError("epsilon must be >= 0")
        if self.metric not in ("auto", "hamming", "l2"):
            raise ValueError(f"unknown metric {self.metric!r}")


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """The PUT(best)/GET(random) cycle. ``topology=None`` resolves through
    the legacy ``collective`` field, as in the reference."""

    pool_capacity: int = 64
    get_random: bool = True
    replace: str = "worst"
    collective: str = "all_gather"
    topology: Optional[str] = None
    acceptance: AcceptanceConfig = AcceptanceConfig()


class IslandState(NamedTuple):
    """A batch of islands (leading axis I).

    pop (I, max_pop, L), fitness (I, max_pop) f32, pop_size (I,) int32,
    rng (I, 2) key words, generation/evaluations/experiments/uuid (I,)
    int32, best_fitness (I,) f32, best_genome (I, L), done (I,) bool."""

    pop: Tensor
    fitness: Tensor
    pop_size: Tensor
    rng: Tensor
    generation: Tensor
    evaluations: Tensor
    best_fitness: Tensor
    best_genome: Tensor
    done: Tensor
    experiments: Tensor
    uuid: Tensor


class PoolState(NamedTuple):
    """Fixed-capacity ring buffer of chromosomes (the pool server)."""

    genomes: Tensor   # (capacity, L)
    fitness: Tensor   # (capacity,) f32, -inf for empty slots
    ptr: Tensor       # () int32 next write slot
    count: Tensor     # () int32 valid entries (<= capacity)


class ExperimentStats(NamedTuple):
    """Per-epoch record; stacked over epochs by the driver."""

    epoch: Tensor
    best_fitness: Tensor
    mean_best: Tensor
    total_evaluations: Tensor
    n_done: Tensor
    experiments_solved: Tensor


class ExperimentState(NamedTuple):
    """The whole run state of one experiment. ``astate`` and ``obs`` are
    ``()`` in this port (the async runtime and the counters come later);
    ``stats`` holds the stacked rows so far or ``()``."""

    islands: IslandState
    pool: PoolState
    astate: Any
    key: Tensor
    epoch: Tensor
    stopped: Tensor
    stats: Any
    next_uuid: Tensor
    obs: Any = ()
