"""The island drivers' CUDA graphs on the card, against the eager functions
they capture.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs_cuda.py

On the card ``run_fused``, ``run_experiment``, ``run_fused_async`` and
``run_experiment_async`` replay CUDA graphs (``core/graphed.py``); the
eager ``fused_scan``, ``fused_scan_async`` and the host loops' steps are
the comparison. Every output must be equal bit for bit, and
``kernels.LAUNCHES`` must count under replay what the eager run counts.
Paper-8's width (8 islands of 128-256, trap 40x4; F15 at D 1000, m 50),
3 generations an epoch.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools
import shutil

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch import kernels, rand
from repro_torch.core import (AsyncConfig, EAConfig, HostBridge,
                              MigrationConfig, PoolServer, make_f15,
                              make_trap, run_experiment, run_fused,
                              run_fused_async)
from repro_torch.core import async_migration as am
from repro_torch.core import evolution, graphed
from repro_torch.core import island as island_lib
from repro_torch.core import pool as pool_lib
from repro_torch.obs import counters as obs_lib

pytestmark = pytest.mark.cuda
CFG = dict(max_pop=256, min_pop=128, generations_per_epoch=3)
N, EPOCHS, SEED = 8, 2, 2016
MIG = MigrationConfig(topology="pool")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    evolution.clear_fused_cache()
    yield torch.device("cuda")
    evolution.clear_fused_cache()


def _problem(name):
    if name == "trap":
        return make_trap(40, 4, impl="pallas"), {}
    return make_f15(impl="pallas"), dict(crossover="blend",
                                         mutation_sigma=0.3)


def _start(problem, cfg, dev, seed=SEED):
    keys = rand.split(rand.key(seed, device=dev), 2)
    return (island_lib.init_islands(keys[0], N, problem, cfg, device=dev),
            pool_lib.pool_init(MIG.pool_capacity, problem.genome,
                               device=dev),
            keys[1], 0, False, obs_lib.init_obs(N, device=dev))


def _same(got, want):
    lg, sg = pytree.tree_flatten(got)
    lw, sw = pytree.tree_flatten(want)
    assert sg == sw
    for i, (g, w) in enumerate(zip(lg, lw)):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w), f"leaf {i}"
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), f"leaf {i}"


@pytest.mark.parametrize("w2", [False, True])
@pytest.mark.parametrize("name", ["trap", "f15"])
@pytest.mark.parametrize("impl", ["pallas", "pallas_tiled", "jnp"])
def test_graphed_scan_bit_equal(card, impl, name, w2):
    """The runner run_fused replays against fused_scan: islands, pool,
    key, epoch, stopped, counters and stats; the launches under replay
    are the eager run's."""
    problem, kw = _problem(name)
    cfg = EAConfig(**CFG, impl=impl, **kw)
    s0 = _start(problem, cfg, card)
    kernels.reset_launches()
    want = evolution.fused_scan(*s0, problem=problem, cfg=cfg, mig=MIG,
                                w2=w2, max_epochs=EPOCHS)
    counted = dict(kernels.LAUNCHES)
    runner = evolution.scan_runner(problem, cfg, MIG, w2, True, card)
    kernels.reset_launches()
    got = runner(*s0, max_epochs=EPOCHS)
    assert dict(kernels.LAUNCHES) == counted
    _same(got, want)
    kernels.reset_launches()
    _same(runner(*s0, max_epochs=EPOCHS), want)
    assert dict(kernels.LAUNCHES) == counted
    assert runner.graph.captures == 1
    if impl != "jnp":
        assert runner.graph.launches and any(counted.values())


def test_one_capture_and_kept_results(card):
    problem, _ = _problem("trap")
    cfg = EAConfig(**CFG, impl="pallas")
    args = dict(n_islands=N, max_epochs=EPOCHS, w2=True, return_stats=True,
                return_obs=True)
    first = run_fused(problem, cfg, MIG, rng=SEED, **args)
    kept = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, first)
    second = run_fused(problem, cfg, MIG, rng=SEED + 1, **args)
    torch.cuda.synchronize()
    _same(first, kept)
    assert not torch.equal(first[0].pop, second[0].pop)
    (runner,) = [e[1] for e in evolution._FUSED_CACHE.values()]
    assert runner.graph.captures == 1


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_graphed_segments_and_resume(card, runtime, tmp_path):
    problem, _ = _problem("trap")
    cfg = EAConfig(**CFG, impl="pallas")
    if runtime == "sync":
        def run(**kw):
            return run_fused(problem, cfg, MIG, n_islands=N, rng=SEED,
                             w2=True, return_stats=True, return_obs=True,
                             **kw)
    else:
        def run(**kw):
            return run_fused_async(
                problem, cfg, MIG, AsyncConfig(min_rate=0.25, staleness=3,
                                               churn_fraction=0.25),
                n_islands=N, rng=SEED, w2=True, return_stats=True,
                return_astate=True, return_obs=True,
                **{("max_ticks" if k == "max_epochs" else k): v
                   for k, v in kw.items()})
    whole = run(max_epochs=4)
    snaps = tmp_path / "snaps"
    _same(run(max_epochs=4, snapshot_every=1, snapshot_dir=str(snaps)),
          whole)
    for step in (3, 4):
        shutil.rmtree(snaps / f"step_{step:08d}")
    _same(run(max_epochs=4, snapshot_every=1, snapshot_dir=str(snaps),
              resume=True), whole)


def test_graphed_async_bit_equal(card):
    problem, _ = _problem("trap")
    cfg = EAConfig(**CFG, impl="pallas")
    acfg = AsyncConfig(min_rate=0.25, staleness=3, churn_fraction=0.25)
    got = run_fused_async(problem, cfg, MIG, acfg, n_islands=N,
                          max_ticks=4, rng=SEED, w2=True, return_stats=True,
                          return_astate=True, return_obs=True)
    keys = rand.split(rand.key(SEED, device=card), 2)
    s0 = _start(problem, cfg, card)
    ast = am.init_async_state(rand.fold_in(keys[0], 7), N, acfg, 4,
                              problem.genome)
    e = am.fused_scan_async(s0[0], s0[1], ast, s0[2], 0, False, s0[5],
                            problem=problem, cfg=cfg, mig=MIG, acfg=acfg,
                            w2=True, max_ticks=4)
    _same(got, (e[0], e[1], e[4], e[7], e[2], obs_lib.harvest(e[6])))


def test_graphed_bridged_bit_equal(card):
    """run_experiment with a HostBridge (the bridge's pool copied into the
    graph's buffers before each replay) and a server down for an epoch,
    against the loop of the eager step."""
    problem, _ = _problem("trap")
    cfg = EAConfig(**CFG, impl="pallas")
    mig = MIG
    up = {1: True, 2: False, 3: True, 4: True}
    bridge = HostBridge(PoolServer(capacity=256, seed=8191), pull=4)
    res = run_experiment(problem, cfg, mig, n_islands=N, max_epochs=4,
                         rng=SEED, w2=True, server_up=up.get,
                         host_bridge=bridge)
    twin = HostBridge(PoolServer(capacity=256, seed=8191), pull=4)
    step = graphed.EagerStep(functools.partial(
        evolution.experiment_step, problem=problem, cfg=cfg, mig=mig,
        w2=True), card)
    s0 = _start(problem, cfg, card)
    carry, rows = (s0[0], s0[1], s0[2]), []
    for epoch in range(1, 5):
        carry, row = step(carry, epoch, up[epoch])
        carry = (carry[0], twin.sync(carry[1], epoch), carry[2])
        rows.append(evolution.read_row(row)[0])
    _same((res.islands, res.pool), carry[:2])
    _same([tuple(s) for s in res.stats], [tuple(s) for s in rows])
    assert bridge.stats() == twin.stats() and bridge.stats()["pulled"] > 0
