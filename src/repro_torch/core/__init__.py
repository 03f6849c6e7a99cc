"""repro_torch.core: the pool-based island model in PyTorch.

Public API (a slice of ``repro.core``):
    problems.make_problem / make_trap / make_onemax / make_royal_road /
        make_rastrigin / make_sphere / make_f15
    EAConfig, MigrationConfig, AcceptanceConfig, IslandState, PoolState
    island.init_islands / island_epoch / generation_step
    pool.pool_init / pool_put_batch / pool_get_random
    migration.migrate (pool topology, always acceptance)
    evolution.run_fused
"""
from .types import (AcceptanceConfig, EAConfig, ExperimentState,
                    ExperimentStats, GenomeSpec, IslandState, MigrationConfig,
                    PoolState)
from .problems import (Problem, make_f15, make_onemax, make_problem,
                       make_rastrigin, make_royal_road, make_sphere,
                       make_trap)
from . import acceptance, evolution, island, migration, pool
from .evolution import run_fused

__all__ = [
    "AcceptanceConfig", "EAConfig", "ExperimentState", "ExperimentStats",
    "GenomeSpec", "IslandState", "MigrationConfig", "PoolState", "Problem",
    "make_f15", "make_onemax", "make_problem", "make_rastrigin",
    "make_royal_road", "make_sphere", "make_trap",
    "acceptance", "evolution", "island", "migration", "pool", "run_fused",
]
