"""The asynchronous runtime (``repro_torch.core.async_migration``) against
the reference's ``repro.core.async_migration``.

* ``AsyncConfig``: the reference's defaults, validation and ``degenerate``;
  ``AsyncState``: the reference's field order (its names are snapshot
  paths); ``init_async_state``'s draws (rates, churn windows) equal the
  reference's.
* The anchor: under ``AsyncConfig()`` ``run_fused_async`` equals the
  port's ``run_fused`` bit for bit for every topology, with and without an
  early stop, and ``run_experiment_async`` equals ``run_experiment``, also
  with the server down; ``total_fires`` is islands x ticks.
* The inbox (staleness, consumption, the best live entry, lane 0 of an
  empty row, the genome cast), the clocks (fires follow the rates; f32
  accrual), churn (a down island is frozen whole, its key included, and
  rejoins) and dead islands that leave the pool empty.
* The heterogeneous parity matrix: binary trap 4x4, 6 islands, ``max_pop``
  16, ``min_pop`` 8, 2 generations per epoch, pool capacity 8, rates
  U[0.3, 1.0], staleness 2, churn 0.5, ``seed=3``, 5 ticks, W² (the case
  of ``tests/test_ga_kernels.py``'s fire-mask test): the port's
  ``run_fused_async`` from the same seed equals the reference's bit for
  bit (islands, pool, ticks, stats, ``AsyncState``, the counter ledger;
  ``mean_best`` within 1e-6 relative, an f32 mean summed in another
  order), for every topology x policy (``always`` and ``elitist`` here,
  ``crowding`` and ``dedup`` in ``tests/test_torch_async_distance.py``)
  and for ``impl`` ``jnp``, ``pallas_ref``, ``pallas`` and
  ``pallas_tiled`` (``pallas`` and ``pallas_tiled`` run their plain
  versions on CPU tensors; the reference runs them in interpret mode).
* Float genomes (rastrigin 16, blend, ``pallas_ref``): the integer fields
  and the ``AsyncState``'s integer fields exact, genes 2e-6, fitness rtol
  2e-4 and atol 1e-3 (ROADMAP Queue C, "Float genes" and "Float
  fitness").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AcceptanceConfig as JAcceptanceConfig
from repro.core import AsyncConfig as JAsyncConfig
from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import async_migration as j_async
from repro.core import island as j_island
from repro.core import pool as j_pool_lib
from repro.core import make_rastrigin as j_rastrigin
from repro.core import make_trap as j_trap
from repro.core import run_experiment_async as j_run_experiment_async
from repro.core import run_fused_async as j_run_fused_async
from repro.core.types import GenomeSpec as JGenomeSpec
from repro.obs import counters as j_counters
from repro_torch import convert, rand
from repro_torch.core import (AcceptanceConfig, AsyncConfig, AsyncState,
                              EAConfig, MigrationConfig, make_onemax,
                              make_rastrigin, make_trap, run_experiment,
                              run_experiment_async, run_fused,
                              run_fused_async)
from repro_torch.core import async_migration
from repro_torch.core import island as island_lib
from repro_torch.core import pool as pool_lib
from repro_torch.core.async_migration import (_inbox_push, _inbox_take,
                                              async_step, init_async_state)
from repro_torch.core.evolution import epoch_step
from repro_torch.core.types import GenomeSpec
from repro_torch.obs import counters

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")
IMPLS = ("jnp", "pallas_ref", "pallas", "pallas_tiled")
CFG = dict(max_pop=32, min_pop=16, generations_per_epoch=5,
           mutation_rate=0.05)
GEN = GenomeSpec("binary", 8)
HETERO = dict(min_rate=0.3, max_rate=1.0, staleness=2, churn_fraction=0.5,
              seed=3)
MEAN_RTOL = 1e-6
GENE_ATOL, FIT_RTOL, FIT_ATOL = 2e-6, 2e-4, 1e-3


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jislands(islands):
    return _np(islands._replace(rng=jax.random.key_data(islands.rng)))


def _equal(got, want, what, mean_rtol=None):
    for name, g, w in zip(want._fields, got, want):
        if name == "mean_best" and mean_rtol is not None:
            np.testing.assert_allclose(g, w, rtol=mean_rtol)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}.{name}")


def _same(a, b, what):
    """Two port trees (tensors) equal leaf for leaf."""
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}.{name}"


# ---------------------------------------------------------------------------
# Configuration and state
# ---------------------------------------------------------------------------
def test_config_matches_reference():
    fields = [(f.name, f.default) for f in dataclasses.fields(AsyncConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JAsyncConfig)]
    assert AsyncConfig().degenerate
    assert not AsyncConfig(min_rate=0.5).degenerate
    assert not AsyncConfig(churn_fraction=0.1).degenerate
    assert not AsyncConfig(period=0.5).degenerate
    for bad in (dict(min_rate=0.0), dict(min_rate=0.9, max_rate=0.5),
                dict(max_rate=1.5), dict(staleness=-1),
                dict(inbox_capacity=0)):
        with pytest.raises(ValueError):
            AsyncConfig(**bad)
        with pytest.raises(ValueError):
            JAsyncConfig(**bad)
    assert AsyncState._fields == j_async.AsyncState._fields


@pytest.mark.parametrize("case", ["degenerate", "hetero", "same_rate",
                                  "all_churn", "short_run"])
def test_rate_and_churn_draws_match_reference(case):
    """The rate draw (the exact ``full`` branch at min == max, else
    ``keyed_uniform``), the churn draws (``uniform < fraction``, two
    ``randint``s with Python-int bounds) from ``split(fold_in(rng, seed),
    4)``, and the empty inbox."""
    kw, n, ticks, genome = {
        "degenerate": ({}, 6, 10, ("binary", 8)),
        "hetero": (HETERO, 6, 5, ("binary", 8)),
        "same_rate": (dict(min_rate=0.7, max_rate=0.7, churn_fraction=0.3,
                           seed=9), 9, 40, ("float", 5)),
        "all_churn": (dict(min_rate=0.25, churn_fraction=1.0,
                           churn_window=(0.1, 0.9), inbox_capacity=3), 16,
                      100, ("binary", 12)),
        "short_run": (dict(min_rate=0.5, churn_fraction=0.6), 5, 2,
                      ("binary", 8)),
    }[case]
    words = np.array([0x1234, 0xABCD0123], np.uint32)
    want = j_async.init_async_state(
        jax.random.wrap_key_data(jnp.asarray(words)), n, JAsyncConfig(**kw),
        ticks, JGenomeSpec(*genome))
    got = init_async_state(torch.from_numpy(words.astype(np.int64)), n,
                           AsyncConfig(**kw), ticks, GenomeSpec(*genome))
    _equal(convert.to_numpy(got), _np(want), case)
    assert got.rate.dtype == torch.float32 and got.clock.dtype == \
        torch.float32
    assert got.inbox_genomes.dtype == GenomeSpec(*genome).dtype


def test_clock_accrual_stays_f32():
    """``clock + rate``, ``clock >= period`` and ``clock - period`` in f32,
    the period rounded to f32 (a period and rates off the f32 grid):
    fires and clocks tick for tick as the reference's and as numpy's f32."""
    acfg = dict(period=0.7, min_rate=0.1, max_rate=0.3)
    words = np.array([7, 11], np.uint32)
    problem, j_problem = make_trap(2, 4), j_trap(2, 4)
    cfg = EAConfig(max_pop=8, min_pop=8, generations_per_epoch=1)
    jcfg = JEAConfig(max_pop=8, min_pop=8, generations_per_epoch=1)
    key = torch.from_numpy(words.astype(np.int64))
    jkey = jax.random.wrap_key_data(jnp.asarray(words))
    islands = island_lib.init_islands(key, 4, problem, cfg, device="cpu")
    pool = pool_lib.pool_init(8, problem.genome, device="cpu")
    astate = init_async_state(key, 4, AsyncConfig(**acfg), 30,
                              problem.genome)
    j_islands = j_island.init_islands(jkey, 4, j_problem, jcfg)
    j_pool = j_pool_lib.pool_init(8, j_problem.genome)
    j_astate = j_async.init_async_state(jkey, 4, JAsyncConfig(**acfg), 30,
                                        j_problem.genome)
    clock = np.zeros(4, np.float32)
    rate = convert.to_numpy(astate.rate)
    period = np.float32(0.7)
    for tick in range(1, 13):
        islands, pool, astate = async_step(
            islands, pool, astate, key, problem, cfg, MigrationConfig(),
            AsyncConfig(**acfg), False, tick=tick)
        j_islands, j_pool, j_astate = j_async.async_step(
            j_islands, j_pool, j_astate, jkey, j_problem, jcfg,
            JMigrationConfig(), JAsyncConfig(**acfg), False, tick=tick)
        clock = clock + rate
        fire = clock >= period
        clock = np.where(fire, clock - period, clock).astype(np.float32)
        np.testing.assert_array_equal(convert.to_numpy(astate.clock), clock)
        _equal(convert.to_numpy(astate), _np(j_astate), f"tick {tick}")
    assert convert.to_numpy(astate.fires).tolist() == \
        np.asarray(j_astate.fires).tolist()


# ---------------------------------------------------------------------------
# The anchor: the degenerate config is the sync driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_fused_equals_sync_bit_for_bit(topo):
    problem = make_onemax(24)
    mig = MigrationConfig(topology=topo, pool_capacity=8)
    sync = run_fused(problem, EAConfig(**CFG), mig, n_islands=6,
                     max_epochs=4, rng=0, w2=True, return_stats=True,
                     return_obs=True, device="cpu")
    asyn = run_fused_async(problem, EAConfig(**CFG), mig, AsyncConfig(),
                           n_islands=6, max_ticks=4, rng=0, w2=True,
                           return_stats=True, return_obs=True,
                           device="cpu")
    for what, a, b in (("islands", sync[0], asyn[0]),
                       ("pool", sync[1], asyn[1]),
                       ("stats", sync[3], asyn[3])):
        _same(a, b, what)
    assert int(sync[2]) == int(asyn[2]) == 4      # epochs == ticks
    assert sync[4] == asyn[4]                     # the same ledger


def test_fused_equals_sync_with_early_stop():
    problem = make_onemax(8)                     # solved fast
    sync = run_fused(problem, EAConfig(**CFG), n_islands=4, max_epochs=10,
                     rng=2, return_stats=True, device="cpu")
    asyn = run_fused_async(problem, EAConfig(**CFG), acfg=AsyncConfig(),
                           n_islands=4, max_ticks=10, rng=2,
                           return_stats=True, device="cpu")
    _same(sync[0], asyn[0], "islands")
    _same(sync[1], asyn[1], "pool")
    _same(sync[3], asyn[3], "stats")
    assert int(sync[2]) == int(asyn[2]) < 10     # the same early stop


@pytest.mark.parametrize("down", [(), (2, 3)])
def test_host_loop_equals_sync(down):
    """Also with the pool server down: the same lost XHR in both
    runtimes."""
    problem = make_onemax(24)
    mig = MigrationConfig(pool_capacity=8)
    server_up = (lambda e: e not in down) if down else None
    sync = run_experiment(problem, EAConfig(**CFG), mig, n_islands=4,
                          max_epochs=4, rng=1, w2=True, server_up=server_up,
                          device="cpu")
    asyn = run_experiment_async(problem, EAConfig(**CFG), mig,
                                AsyncConfig(), n_islands=4, max_ticks=4,
                                rng=1, w2=True, server_up=server_up,
                                device="cpu")
    _same(sync.islands, asyn.islands, "islands")
    _same(sync.pool, asyn.pool, "pool")
    assert asyn.total_fires == 4 * 4             # everyone, every tick
    assert [st.best_fitness for st in sync.stats] == \
        [st.best_fitness for st in asyn.stats]


# ---------------------------------------------------------------------------
# The inbox
# ---------------------------------------------------------------------------
def _astate(n=3, cap=4, staleness=2):
    return init_async_state(rand.key(0), n, AsyncConfig(
        staleness=staleness, inbox_capacity=cap), 50, GEN)


def _imm(n, fit):
    return (torch.ones((n, GEN.length), dtype=GEN.dtype),
            torch.full((n,), fit, dtype=torch.float32))


def test_entry_live_until_staleness_then_expires():
    astate = _inbox_push(_astate(), *_imm(3, 5.0), 10)
    absorb = torch.ones(3, dtype=torch.bool)
    _, take_f, _ = _inbox_take(astate, 12, 2, absorb)   # age 2: live
    assert bool((take_f == 5.0).all())
    _, take_f, _ = _inbox_take(astate, 13, 2, absorb)   # age 3: expired
    assert bool(torch.isneginf(take_f).all())


def test_absorbed_entry_is_consumed():
    astate = _inbox_push(_astate(), *_imm(3, 5.0), 10)
    absorb = torch.ones(3, dtype=torch.bool)
    _, take_f, astate = _inbox_take(astate, 10, 2, absorb)
    assert bool((take_f == 5.0).all())
    _, take_f, _ = _inbox_take(astate, 10, 2, absorb)
    assert bool(torch.isneginf(take_f).all())           # never twice


def test_best_live_entry_wins_and_non_absorbers_keep_theirs():
    astate = _astate(staleness=5)
    for fit in (3.0, 9.0, 6.0):
        astate = _inbox_push(astate, *_imm(3, fit), 1)
    _, take_f, _ = _inbox_take(astate, 2, 5, torch.ones(3, dtype=torch.bool))
    assert bool((take_f == 9.0).all())
    astate = _inbox_push(_astate(), *_imm(3, 5.0), 10)
    _, take_f, astate = _inbox_take(astate, 10, 2,
                                    torch.tensor([True, False, True]))
    assert bool(torch.isneginf(take_f[1]))
    _, take_f, _ = _inbox_take(astate, 11, 2,
                               torch.tensor([False, True, False]))
    assert float(take_f[1]) == 5.0


def test_invalid_immigrants_not_pushed():
    astate = _astate()
    g = torch.zeros((3, GEN.length), dtype=GEN.dtype)
    out = _inbox_push(astate, g, torch.full((3,), float("-inf")), 1)
    assert torch.equal(out.inbox_ptr, astate.inbox_ptr)
    assert bool(torch.isneginf(out.inbox_fitness).all())


def test_inbox_ops_match_reference():
    """Pushes of mixed valid and invalid f32 deliveries (cast to the int8
    inbox), the ring wrapping, then takes with the ledger: a row with no
    live entry takes lane 0 with ``-inf`` and age from lane 0's stamp."""
    g = np.random.default_rng(3)
    n, cap = 5, 3
    words = np.array([1, 2], np.uint32)
    acfg = dict(staleness=2, inbox_capacity=cap)
    astate = init_async_state(torch.from_numpy(words.astype(np.int64)), n,
                              AsyncConfig(**acfg), 20, GEN)
    j_astate = j_async.init_async_state(
        jax.random.wrap_key_data(jnp.asarray(words)), n,
        JAsyncConfig(**acfg), 20, JGenomeSpec("binary", 8))
    for tick in range(1, 6):
        imm_g = g.integers(0, 2, (n, 8)).astype(np.float32)
        imm_f = g.integers(0, 9, n).astype(np.float32)
        imm_f[g.random(n) < 0.4] = -np.inf
        absorb = g.random(n) < 0.5
        astate = _inbox_push(astate, torch.from_numpy(imm_g),
                             torch.from_numpy(imm_f), tick)
        j_astate = j_async._inbox_push(j_astate, jnp.asarray(imm_g),
                                       jnp.asarray(imm_f), jnp.int32(tick))
        out = _inbox_take(astate, tick + 1, 2, torch.from_numpy(absorb),
                          with_ledger=True)
        want = j_async._inbox_take(j_astate, jnp.int32(tick + 1), 2,
                                   jnp.asarray(absorb), with_ledger=True)
        astate, j_astate = out[2], want[2]
        _equal(convert.to_numpy(astate), _np(j_astate), f"tick {tick}")
        for i in (0, 1, 3, 4):
            np.testing.assert_array_equal(convert.to_numpy(out[i]),
                                          np.asarray(want[i]))
    assert astate.inbox_genomes.dtype == torch.int8
    empty = _astate(n=2)
    take_g, take_f, _, consumed, age = _inbox_take(
        empty, 4, 2, torch.ones(2, dtype=torch.bool), with_ledger=True)
    assert bool(torch.isneginf(take_f).all()) and not bool(consumed.any())
    assert torch.equal(take_g, empty.inbox_genomes[:, 0])
    assert age.tolist() == [5, 5]                 # 4 - (-1), lane 0


# ---------------------------------------------------------------------------
# Clocks and churn
# ---------------------------------------------------------------------------
def _run_steps(astate, n, ticks, problem, mig, acfg, record=False):
    cfg = EAConfig(**CFG)
    islands = island_lib.init_islands(rand.key(0), n, problem, cfg,
                                      device="cpu")
    pool = pool_lib.pool_init(mig.pool_capacity, problem.genome,
                              device="cpu")
    rng = rand.key(1)
    snaps = []
    for t in range(1, ticks + 1):
        rng, k = rand.split(rng, 2)
        islands, pool, astate = async_step(islands, pool, astate, k, problem,
                                           cfg, mig, acfg, False, tick=t)
        if record:
            snaps.append((islands, astate))
    return islands, pool, astate, snaps


def test_fire_counts_follow_clocks():
    """fires_i(T) = floor(T * rate_i): the volunteer-speed model."""
    problem = make_trap(4, 4)
    mig = MigrationConfig(topology="ring", pool_capacity=8)
    acfg = AsyncConfig(min_rate=0.25, max_rate=1.0)
    n, ticks = 6, 12
    astate = init_async_state(rand.key(3), n, acfg, ticks, problem.genome)
    rate = np.array([1.0, 0.5, 0.25, 1.0, 0.75, 0.3], np.float32)
    astate = astate._replace(rate=torch.from_numpy(rate))
    _, _, astate, _ = _run_steps(astate, n, ticks, problem, mig, acfg)
    expect = np.floor(ticks * rate + 1e-5).astype(int)
    assert astate.fires.tolist() == expect.tolist()


def test_churned_island_is_frozen_whole_and_rejoins():
    """Island 0 is down for ticks [3, 6): every field of it, its key
    included, stays as it was after tick 2 (masked dense compute: it was
    evolved and selected back whole); then it fires again."""
    problem = make_trap(4, 4)
    mig = MigrationConfig(topology="pool", pool_capacity=8)
    n, ticks = 4, 9
    astate = init_async_state(rand.key(0), n, AsyncConfig(), ticks,
                              problem.genome)
    never = ticks + 1
    astate = astate._replace(
        down_start=torch.tensor([3, never, never, never], dtype=torch.int32),
        down_end=torch.tensor([6, never, never, never], dtype=torch.int32))
    _, _, _, snaps = _run_steps(astate, n, ticks, problem, mig,
                                AsyncConfig(), record=True)
    before, ast2 = snaps[1]
    for t in (3, 4, 5):
        isl, ast = snaps[t - 1]
        for name, a, b in zip(isl._fields, isl, before):
            assert torch.equal(a[0], b[0]), f"tick {t}: island 0 {name}"
        assert int(ast.fires[0]) == int(ast2.fires[0])
        assert float(ast.clock[0]) == float(ast2.clock[0])
    isl_end, ast_end = snaps[-1]
    assert int(ast_end.fires[0]) > int(ast2.fires[0])
    assert int(isl_end.evaluations[0]) > int(before.evaluations[0])
    assert ast_end.fires[1:].tolist() == [ticks] * 3
    assert not torch.equal(isl_end.rng[0], before.rng[0])


def test_dead_islands_leave_the_pool_empty():
    """While down an island neither PUTs nor GETs: all down, the pool
    stays empty and nobody fires."""
    problem = make_trap(4, 4)
    mig = MigrationConfig(topology="pool", pool_capacity=8)
    n, ticks = 4, 5
    astate = init_async_state(rand.key(0), n, AsyncConfig(), ticks,
                              problem.genome)
    astate = astate._replace(
        down_start=torch.zeros(n, dtype=torch.int32),
        down_end=torch.full((n,), ticks + 1, dtype=torch.int32))
    _, pool, astate, _ = _run_steps(astate, n, ticks, problem, mig,
                                    AsyncConfig())
    assert int(pool.count) == 0
    assert astate.fires.tolist() == [0] * n


# ---------------------------------------------------------------------------
# The counters under a per-island fire mask
# ---------------------------------------------------------------------------
def test_counters_under_a_fire_mask_match_reference():
    """``record_churn``, ``record_exchange``, ``record_absorb`` (ages 0-9,
    clipped into the last bin) and ``record_early_stop`` with per-island
    masks, then ``epoch_step``'s ``fired`` from a vector ``available``."""
    g = np.random.default_rng(5)
    n = 6
    obs, j_obs = counters.init_obs(n), j_counters.init_obs(n)
    for step in range(4):
        fire, down, deliv, acc, consumed = (g.random((5, n)) < 0.5)
        acc = acc & deliv
        age = g.integers(0, 10, n).astype(np.int32)
        t = [torch.from_numpy(x) for x in (fire, down, deliv, acc, consumed,
                                           age)]
        obs = counters.record_churn(obs, t[1])
        obs = counters.record_exchange(obs, t[0], t[2], t[3])
        obs = counters.record_absorb(obs, t[4], t[5])
        obs = counters.record_early_stop(obs, torch.tensor(step >= 2), step)
        j_obs = j_counters.record_churn(j_obs, jnp.asarray(down))
        j_obs = j_counters.record_exchange(j_obs, jnp.asarray(fire),
                                           jnp.asarray(deliv),
                                           jnp.asarray(acc))
        j_obs = j_counters.record_absorb(j_obs, jnp.asarray(consumed),
                                         jnp.asarray(age))
        j_obs = j_counters.record_early_stop(j_obs, jnp.asarray(step >= 2),
                                             step)
    assert counters.harvest(obs) == j_counters.harvest(j_obs)
    assert counters.harvest(obs)["early_stop_epoch"] == 2
    # epoch_step expands a vector ``available`` into ``fired`` as is
    problem = make_trap(2, 4)
    cfg = EAConfig(max_pop=8, min_pop=8, generations_per_epoch=1)
    islands = island_lib.init_islands(rand.key(0), 4, problem, cfg,
                                      device="cpu")
    pool = pool_lib.pool_init(8, problem.genome, device="cpu")
    mask = torch.tensor([True, False, True, False])
    _, _, o = epoch_step(islands, pool, rand.key(1), problem, cfg,
                         MigrationConfig(topology="ring"), False,
                         available=mask, obs=counters.init_obs(4))
    assert o.fired.tolist() == [1, 0, 1, 0]
    assert o.delivered.tolist() == [0, 1, 0, 1]   # island i gets i - 1's


# ---------------------------------------------------------------------------
# The heterogeneous runs against the reference
# ---------------------------------------------------------------------------
def check_hetero(topology, policy, impl):
    """The port's ``run_fused_async`` against the reference's from one
    seed, everything returned compared."""
    acc = dict(policy=policy, epsilon=1.0 if policy == "dedup" else 0.0)
    cfg = dict(max_pop=16, min_pop=8, generations_per_epoch=2, impl=impl)
    want = j_run_fused_async(
        j_trap(4, 4), JEAConfig(**cfg),
        JMigrationConfig(topology=topology, pool_capacity=8,
                         acceptance=JAcceptanceConfig(**acc)),
        JAsyncConfig(**HETERO), n_islands=6, max_ticks=5,
        rng=jax.random.key(0), w2=True, return_stats=True,
        return_astate=True, return_obs=True)
    got = run_fused_async(
        make_trap(4, 4), EAConfig(**cfg),
        MigrationConfig(topology=topology, pool_capacity=8,
                        acceptance=AcceptanceConfig(**acc)),
        AsyncConfig(**HETERO), n_islands=6, max_ticks=5, rng=0, w2=True,
        return_stats=True, return_astate=True, return_obs=True,
        device="cpu")
    _equal(convert.to_numpy(got[0]), _jislands(want[0]), "islands")
    _equal(convert.to_numpy(got[1]), _np(want[1]), "pool")
    assert int(got[2]) == int(want[2]) == 5
    _equal(convert.to_numpy(got[3]), _np(want[3]), "stats", MEAN_RTOL)
    _equal(convert.to_numpy(got[4]), _np(want[4]), "astate")
    assert got[5] == want[5]
    t = got[5]["totals"]
    assert t["delivered"] == t["accepted"] + t["rejected"]
    assert t["churn_down"] > 0                   # some island churned
    assert 0 < t["fired"] < 6 * 5                # not everyone, every tick


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("policy", ["always", "elitist"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hetero_run_matches_reference(topology, policy, impl):
    check_hetero(topology, policy, impl)


def test_host_loop_hetero_matches_reference_and_the_fused_driver():
    """``run_experiment_async`` (its own key schedule: ``k_init, rng =
    split(rng)``) against the reference's, with the server down at tick
    2; without the server's fault it reaches ``run_fused_async``'s
    state up to its stop."""
    kw = dict(max_pop=16, min_pop=8, generations_per_epoch=2,
              impl="pallas_ref")
    down = (lambda t: t != 2)
    want = j_run_experiment_async(
        j_trap(4, 4), JEAConfig(**kw), JMigrationConfig(pool_capacity=8),
        JAsyncConfig(**HETERO), n_islands=6, max_ticks=5,
        rng=jax.random.key(4), w2=True, server_up=down)
    got = run_experiment_async(
        make_trap(4, 4), EAConfig(**kw), MigrationConfig(pool_capacity=8),
        AsyncConfig(**HETERO), n_islands=6, max_ticks=5, rng=4, w2=True,
        server_up=down, device="cpu")
    _equal(convert.to_numpy(got.islands), _jislands(want.islands), "islands")
    _equal(convert.to_numpy(got.pool), _np(want.pool), "pool")
    _equal(convert.to_numpy(got.astate), _np(want.astate), "astate")
    assert (got.total_fires, got.epochs, got.evaluations) == \
        (want.total_fires, want.epochs, want.evaluations)
    for row, (st, jst) in enumerate(zip(got.stats, want.stats)):
        _equal(st, _np(jst), f"stats row {row}", MEAN_RTOL)
    # the host loop and the fused driver walk the same keys
    problem = make_onemax(12)
    args = (problem, EAConfig(**kw), MigrationConfig(pool_capacity=8),
            AsyncConfig(**HETERO))
    res = run_experiment_async(*args, n_islands=6, max_ticks=12, rng=6,
                               device="cpu")
    fused = run_fused_async(*args, n_islands=6, max_ticks=12, rng=6,
                            return_astate=True, device="cpu")
    assert res.success and res.epochs == int(fused[2]) < 12
    _same(res.islands, fused[0], "islands")
    _same(res.pool, fused[1], "pool")
    _same(res.astate, fused[3], "astate")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        run_experiment_async(*args, n_islands=2, max_ticks=1,
                             host_bridge=object(), device="cpu")


def test_float_genomes_within_queue_c_tolerances():
    """Rastrigin 16 (float genes), blend, ``pallas_ref``, heterogeneous
    rates and churn: integer fields exact, genes and fitness within Queue
    C's stated tolerances."""
    kw = dict(max_pop=16, min_pop=8, generations_per_epoch=2,
              impl="pallas_ref", crossover="blend", mutation_sigma=0.3)
    want = j_run_fused_async(
        j_rastrigin(16), JEAConfig(**kw), JMigrationConfig(pool_capacity=8),
        JAsyncConfig(**HETERO), n_islands=6, max_ticks=5,
        rng=jax.random.key(0), w2=True, return_astate=True)
    got = run_fused_async(
        make_rastrigin(16), EAConfig(**kw), MigrationConfig(pool_capacity=8),
        AsyncConfig(**HETERO), n_islands=6, max_ticks=5, rng=0, w2=True,
        return_astate=True, device="cpu")
    isl, j_isl = convert.to_numpy(got[0]), _jislands(want[0])
    ast, j_ast = convert.to_numpy(got[3]), _np(want[3])
    for tree, j_tree, genes, fits in (
            (isl, j_isl, ("pop", "best_genome"), ("fitness",
                                                  "best_fitness")),
            (ast, j_ast, ("inbox_genomes",), ("inbox_fitness",))):
        for name in tree._fields:
            a, b = getattr(tree, name), getattr(j_tree, name)
            if name in genes:
                np.testing.assert_allclose(a, b, rtol=0, atol=GENE_ATOL,
                                           err_msg=name)
            elif name in fits:
                np.testing.assert_allclose(a, b, rtol=FIT_RTOL,
                                           atol=FIT_ATOL, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(convert.to_numpy(got[1]).count,
                                  np.asarray(want[1].count))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    for fn in (run_fused_async, run_experiment_async):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(make_onemax(8), EAConfig(**CFG), n_islands=2, max_ticks=1)
    assert async_migration.AsyncRunResult.__mro__[1].__name__ == "RunResult"
