"""repro_torch.core: the pool-based island model in PyTorch.

Public API (a slice of ``repro.core``):
    problems.make_problem / make_trap / make_onemax / make_royal_road /
        make_rastrigin / make_sphere / make_f15
    EAConfig, MigrationConfig, AcceptanceConfig, IslandState, PoolState
    ga.next_generation / next_generation_jnp (the classic operators)
    island.init_islands / island_epoch / generation_step
    pool.pool_init / pool_put_batch / pool_get_random
    acceptance.register_policy / available_policies (acceptance registry)
    migration.migrate / register_topology / available_topologies
        (topology registry)
    evolution.run_experiment / RunResult / run_fused (segments,
        snapshots, resume)
    async_migration.AsyncConfig / AsyncState / run_experiment_async /
        run_fused_async (the asynchronous runtime) / AsyncHostBridge
    async_pool.PoolServer / PoolClient / PoolUnavailable (the host pool
        server and its write-ahead journal); migration.HostBridge
    sharded.ShardGroup / spawn / run_sharded / run_fused_sharded /
        run_fused_sharded_async (the islands split over the ranks of a
        torch.distributed group)
"""
from .types import (AcceptanceConfig, EAConfig, ExperimentState,
                    ExperimentStats, GenomeSpec, IslandState, MigrationConfig,
                    PoolState)
from .problems import (Problem, make_f15, make_onemax, make_problem,
                       make_rastrigin, make_royal_road, make_sphere,
                       make_trap)
from . import (acceptance, async_migration, async_pool, evolution, ga,
               island, migration, pool, sharded)
from .acceptance import (available_policies as available_acceptance_policies,
                         register_policy as register_acceptance_policy)
from .async_migration import (AsyncConfig, AsyncHostBridge, AsyncState,
                              run_experiment_async, run_fused_async)
from .async_pool import PoolClient, PoolServer, PoolUnavailable
from .evolution import RunResult, run_experiment, run_fused
from .migration import (HostBridge, available_topologies, get_topology,
                        register_topology)
from .sharded import (ShardGroup, run_fused_sharded, run_fused_sharded_async,
                      run_sharded)

__all__ = [
    "AcceptanceConfig", "EAConfig", "ExperimentState", "ExperimentStats",
    "GenomeSpec", "IslandState", "MigrationConfig", "PoolState", "Problem",
    "make_f15", "make_onemax", "make_problem", "make_rastrigin",
    "make_royal_road", "make_sphere", "make_trap",
    "acceptance", "evolution", "ga", "island", "migration", "pool",
    "RunResult", "available_acceptance_policies", "available_topologies",
    "get_topology", "register_acceptance_policy", "register_topology",
    "run_experiment", "run_fused", "async_migration", "AsyncConfig",
    "AsyncState", "run_experiment_async", "run_fused_async",
    "AsyncHostBridge", "HostBridge", "PoolClient", "PoolServer",
    "PoolUnavailable", "async_pool", "sharded", "ShardGroup",
    "run_sharded", "run_fused_sharded", "run_fused_sharded_async",
]
