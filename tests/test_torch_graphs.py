"""The compiled island drivers on the CPU: ``fused_jit``, ``unique_buffers``
and the drivers' graphs, replayed by an emulation of CUDA graphs.

``fused_jit`` keeps one runner per problem object and static key (the
counterpart of the reference's ``tests/test_migration.py``
``test_compile_cache_reused``), an LRU of 32. On the CPU the runners are
the eager functions; on the card they replay CUDA graphs
(:mod:`repro_torch.core.graphed`). Here ``_torch_capture.emulate_graphs``
gives the CPU a graph's semantics: the capture records the operations with
their Python values frozen and refuses a host read or a host constant, a
replay writes into the capture's tensors. Under it the graphed drivers must
equal the eager functions bit for bit, and the host loops' Python values
that change every epoch (the epoch, the server's state) must reach the
step as device scalars: a torus run still alternates east and south, a
server that goes down for an epoch still gates it, against the
reference. Small sizes: 4 islands, trap 8x4 (onemax 16 where a run must
stop early), F15 at D 32, m 8, ``max_pop`` 32, 3 generations an epoch.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools
import shutil

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_capture import capture_faults, emulate_graphs
from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import make_trap as j_trap
from repro.core import run_experiment as j_run_experiment
from repro.core.async_migration import AsyncConfig as JAsyncConfig
from repro.core.async_migration import \
    run_experiment_async as j_run_experiment_async
from repro_torch import convert, rand
from repro_torch.core import (AcceptanceConfig, AsyncConfig, EAConfig,
                              HostBridge, MigrationConfig, PoolServer,
                              make_f15, make_onemax, make_trap,
                              run_experiment, run_experiment_async,
                              run_fused, run_fused_async)
from repro_torch.core import async_migration as am
from repro_torch.core import evolution, graphed
from repro_torch.core import island as island_lib
from repro_torch.core import pool as pool_lib
from repro_torch.obs import counters as obs_lib

CFG = dict(max_pop=32, min_pop=16, generations_per_epoch=3)
N, EPOCHS, SEED = 4, 3, 11
ACFG = dict(min_rate=0.25, max_rate=1.0, staleness=3, churn_fraction=0.25)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    evolution.clear_fused_cache()
    yield
    evolution.clear_fused_cache()


@pytest.fixture
def graphs(monkeypatch):
    emulate_graphs(monkeypatch)


def _f15():
    rng = np.random.default_rng(5)
    consts = {"o": rng.uniform(-5, 5, 32).astype(np.float32),
              "perm": rng.permutation(32).astype(np.int32),
              "M": rng.standard_normal((4, 8, 8)).astype(np.float32)}
    return make_f15(consts, dim=32, group=8, device="cpu")


def _problem(name):
    if name == "trap":
        return make_trap(8, 4), {}
    return _f15(), dict(crossover="blend", mutation_sigma=0.3)


def _start(problem, cfg, mig, n=N, seed=SEED, obs=True):
    """run_fused's fresh state: (islands, pool, key, epoch, stopped, obs)."""
    keys = rand.split(rand.key(seed), 2)
    return (island_lib.init_islands(keys[0], n, problem, cfg, device=CPU),
            pool_lib.pool_init(mig.pool_capacity, problem.genome,
                               device=CPU),
            keys[1], 0, False, obs_lib.init_obs(n, device=CPU) if obs else ())


def _same(got, want):
    lg, sg = pytree.tree_flatten(got)
    lw, sw = pytree.tree_flatten(want)
    assert sg == sw
    for i, (g, w) in enumerate(zip(lg, lw)):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w), f"leaf {i}"
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), f"leaf {i}"


def _mig(topology="pool", policy="always"):
    return MigrationConfig(topology=topology,
                           acceptance=AcceptanceConfig(policy=policy))


# ---------------------------------------------------------------------------
# fused_jit and unique_buffers
# ---------------------------------------------------------------------------
def test_compile_cache_reused():
    """The counterpart of the reference's test: a second run with the
    same problem object and statics reuses the runner."""
    problem = make_onemax(24)
    cfg, mig = EAConfig(**CFG), MigrationConfig(topology="ring")
    run_fused(problem, cfg, mig, n_islands=4, max_epochs=2, rng=0,
              device="cpu")
    key = (id(problem), ("batched", cfg, mig, False, False, False, 4, "cpu"))
    runner = evolution._FUSED_CACHE[key][1]
    run_fused(problem, cfg, mig, n_islands=4, max_epochs=2, rng=1,
              device="cpu")
    assert evolution._FUSED_CACHE[key][1] is runner
    # an equal problem that is another object gets a runner of its own
    twin = make_onemax(24)
    assert twin == problem and twin is not problem
    run_fused(twin, cfg, mig, n_islands=4, max_epochs=2, rng=0,
              device="cpu")
    assert len(evolution._FUSED_CACHE) == 2
    assert evolution._FUSED_CACHE[key][1] is runner


class _Built:
    def __init__(self, i):
        self.i, self.released = i, False

    def release(self):
        self.released = True


def test_fused_jit_is_an_lru_of_32():
    problem = make_onemax(8)
    built = [evolution.fused_jit(problem, ("k", i),
                                 functools.partial(_Built, i))
             for i in range(32)]
    assert len(evolution._FUSED_CACHE) == 32
    # a hit moves the entry to the end: entry 1 becomes the oldest
    assert evolution.fused_jit(problem, ("k", 0), lambda: None) is built[0]
    evolution.fused_jit(problem, ("k", 32), functools.partial(_Built, 32))
    assert len(evolution._FUSED_CACHE) == 32
    assert built[1].released and (id(problem), ("k", 1)) not in \
        evolution._FUSED_CACHE
    assert not any(b.released for b in built[:1] + built[2:])
    evolution.clear_fused_cache()
    assert not evolution._FUSED_CACHE and all(b.released for b in built)


def test_unique_buffers_copies_shared_storage_only():
    a = torch.arange(6)
    b = torch.zeros(3)
    view = a[2:4]
    tree = {"a": a, "b": b, "again": a, "view": view, "n": 3}
    out = evolution.unique_buffers(tree)
    assert out["a"] is a and out["b"] is b and out["n"] == 3
    for name in ("again", "view"):
        assert out[name] is not tree[name]
        assert torch.equal(out[name], tree[name])
        assert out[name].untyped_storage().data_ptr() != \
            a.untyped_storage().data_ptr()
    distinct = (torch.ones(2), torch.ones(2))
    assert all(x is y for x, y in zip(evolution.unique_buffers(distinct),
                                      distinct))


# ---------------------------------------------------------------------------
# What a capture refuses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", ["pool", "ring", "torus",
                                      "random_graph", "broadcast_best"])
def test_steps_are_capture_clean(topology):
    """No host read, host constant or data-sized output in any driver's
    step, and no write into its inputs, under every policy, impl,
    selection and replacement (on the CPU ``pallas`` runs
    ``pallas_ref``'s plain version)."""
    faults = []
    acfg = AsyncConfig(**ACFG)
    cases = [(impl, name, sel, rep, "always")
             for impl in ("jnp", "pallas_ref") for name in ("trap", "f15")
             for sel, rep in (("tournament", "worst"),
                              ("roulette", "random"))]
    cases += [("jnp", "trap", "tournament", "worst", policy)
              for policy in ("elitist", "crowding", "dedup")]
    for impl, name, sel, rep, policy in cases:
        problem, kw = _problem(name)
        cfg = EAConfig(**dict(CFG, generations_per_epoch=1), impl=impl,
                       selection=sel, **kw)
        mig = MigrationConfig(topology=topology, replace=rep,
                              acceptance=AcceptanceConfig(policy=policy))
        isl, pool, key, _, _, obs = _start(problem, cfg, mig)
        ep = torch.zeros((), dtype=torch.int32)
        st = torch.zeros((), dtype=torch.bool)
        up = torch.ones((), dtype=torch.bool)
        ast = am.init_async_state(rand.key(3), N, acfg, 10, problem.genome)
        common = dict(problem=problem, cfg=cfg, mig=mig)
        for w2 in (False, True):
            faults += capture_faults(
                evolution.scan_epoch, (isl, pool, key, ep, st, obs), True,
                w2=w2, **common)
            faults += capture_faults(
                am.scan_tick, (isl, pool, ast, key, ep, st, obs), True,
                acfg=acfg, w2=w2, **common)
            faults += capture_faults(
                evolution.experiment_step, (isl, pool, key), ep + 1, up,
                w2=w2, **common)
            faults += capture_faults(
                am.async_experiment_step, (isl, pool, ast, key), ep + 1, up,
                acfg=acfg, w2=w2, **common)
    assert not sorted(set(faults))


def test_emulated_capture_refuses_a_host_read(graphs):
    """The emulation refuses what a capture refuses, so the tests below
    would see a host read in a captured step."""
    def step(carry):
        x, = carry
        if bool(x.sum() > 0):
            x = x + 1
        return (x,), None

    g = graphed.StepGraph(step)
    with pytest.raises(RuntimeError, match="_local_scalar_dense"):
        g((torch.ones(3),))


# ---------------------------------------------------------------------------
# The graphed fused runners against the eager functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w2", [False, True])
@pytest.mark.parametrize("name", ["trap", "f15"])
@pytest.mark.parametrize("impl", ["jnp", "pallas", "pallas_tiled",
                                  "pallas_ref"])
def test_graphed_scan_equals_eager(graphs, impl, name, w2):
    """``scan_runner`` (what ``run_fused`` replays) against
    ``fused_scan`` on the same inputs: every output, over two calls (the
    capture, then a replay from a fresh state)."""
    problem, kw = _problem(name)
    cfg = EAConfig(**CFG, impl=impl, **kw)
    mig = _mig()
    runner = evolution.scan_runner(problem, cfg, mig, w2, True, CPU)
    assert isinstance(runner, graphed.Runner)
    assert graphed.unit_of(cfg) == (
        "generation" if impl in ("jnp", "pallas_ref") else "epoch")
    for seed in (SEED, SEED + 1):
        s0 = _start(problem, cfg, mig, seed=seed)
        want = evolution.fused_scan(*s0, problem=problem, cfg=cfg, mig=mig,
                                    w2=w2, max_epochs=EPOCHS)
        got = runner(*s0, max_epochs=EPOCHS)
        _same(got, want)
    assert runner.graph.captures == 1


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_graphed_early_stop_freezes(graphs, runtime):
    """onemax 16 stops in the first epochs: the frozen epochs after the
    stop run eagerly between replays and freeze the carry."""
    problem, cfg, mig = make_onemax(16), EAConfig(**CFG), _mig()
    s0 = _start(problem, cfg, mig)
    if runtime == "sync":
        want = evolution.fused_scan(*s0, problem=problem, cfg=cfg, mig=mig,
                                    w2=False, max_epochs=6)
        got = evolution.scan_runner(problem, cfg, mig, False, True, CPU)(
            *s0, max_epochs=6)
        epoch, stopped = got[3], got[4]
    else:
        acfg = AsyncConfig()
        ast = am.init_async_state(rand.key(3), N, acfg, 6, problem.genome)
        args = (s0[0], s0[1], ast, s0[2], 0, False, s0[5])
        want = am.fused_scan_async(*args, problem=problem, cfg=cfg, mig=mig,
                                   acfg=acfg, w2=False, max_ticks=6)
        got = am.scan_runner(problem, cfg, mig, acfg, False, True, CPU)(
            *args, max_ticks=6)
        epoch, stopped = got[4], got[5]
    _same(got, want)
    assert bool(stopped) and 0 < int(epoch) < 6


# ---------------------------------------------------------------------------
# The drivers through fused_jit, graphed
# ---------------------------------------------------------------------------
def test_one_capture_and_kept_results(graphs):
    """Two run_fused calls with one problem capture once, and the first
    call's results are not overwritten by the second's replays."""
    problem, cfg, mig = make_trap(8, 4), EAConfig(**CFG), _mig()
    kw = dict(n_islands=N, max_epochs=EPOCHS, w2=True, return_stats=True,
              return_obs=True, device="cpu")
    first = run_fused(problem, cfg, mig, rng=SEED, **kw)
    kept = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, first)
    second = run_fused(problem, cfg, mig, rng=SEED + 1, **kw)
    _same(first, kept)
    assert not torch.equal(first[0].pop, second[0].pop)
    (runner,) = [e[1] for e in evolution._FUSED_CACHE.values()]
    assert runner.graph.captures == 1
    evolution.clear_fused_cache()
    _same(run_fused(problem, cfg, mig, rng=SEED, device="cpu",
                    **{k: v for k, v in kw.items() if k != "device"}),
          kept)


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_graphed_segments_and_resume(graphs, runtime, tmp_path):
    """Segments of 1 and a resume from epoch 2 equal the one-segment run,
    all graphed; the one-segment run equals the eager one."""
    problem, cfg, mig = make_trap(8, 4), EAConfig(**CFG), _mig()
    if runtime == "sync":
        def run(**kw):
            return run_fused(problem, cfg, mig, n_islands=N, rng=SEED,
                             w2=True, return_stats=True, return_obs=True,
                             device="cpu", **kw)
    else:
        def run(**kw):
            return run_fused_async(
                problem, cfg, mig, AsyncConfig(**ACFG), n_islands=N,
                rng=SEED, w2=True, return_stats=True, return_astate=True,
                return_obs=True, device="cpu",
                **{("max_ticks" if k == "max_epochs" else k): v
                   for k, v in kw.items()})
    whole = run(max_epochs=4)
    snaps = tmp_path / "snaps"
    _same(run(max_epochs=4, snapshot_every=1, snapshot_dir=str(snaps)),
          whole)
    # a kill after epoch 2: its later snapshots never landed
    for step in (3, 4):
        shutil.rmtree(snaps / f"step_{step:08d}")
    _same(run(max_epochs=4, snapshot_every=1, snapshot_dir=str(snaps),
              resume=True), whole)
    evolution.clear_fused_cache()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphed, "graphs_on", lambda device: False)
        _same(run(max_epochs=4), whole)


def _server(down):
    return lambda epoch: epoch not in down


@pytest.mark.parametrize("graphed_run", [False, True])
@pytest.mark.parametrize("topology,down", [("torus", (2,)),
                                           ("pool", (1, 3))])
def test_host_loop_values_reach_the_step(monkeypatch, graphed_run, topology,
                                         down):
    """run_experiment's epoch and server state reach the step as device
    scalars (eager and graphed): the torus still alternates, a down server
    still gates, against the reference."""
    if graphed_run:
        emulate_graphs(monkeypatch)
    seen = []
    real = evolution.epoch_step

    def spy(*args, **kwargs):
        seen.append((kwargs["epoch"], kwargs["available"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(evolution, "epoch_step", spy)
    epochs = 4
    want = j_run_experiment(
        j_trap(8, 4), JEAConfig(**CFG), JMigrationConfig(topology=topology),
        n_islands=N, max_epochs=epochs, rng=jax.random.key(SEED), w2=True,
        server_up=_server(down))
    got = run_experiment(make_trap(8, 4), EAConfig(**CFG),
                         MigrationConfig(topology=topology), n_islands=N,
                         max_epochs=epochs, rng=SEED, w2=True,
                         server_up=_server(down), device="cpu")
    assert seen and all(isinstance(e, torch.Tensor) and e.dim() == 0
                        and isinstance(a, torch.Tensor) and a.dim() == 0
                        for e, a in seen)
    # the graph captured the step once; the eager loop called it each epoch
    assert len(seen) == (1 if graphed_run else epochs) + graphed_run
    assert got.epochs == want.epochs == epochs
    for field in ("success", "evaluations", "evaluations_to_solution"):
        assert getattr(got, field) == getattr(want, field), field
    for g, w in zip(got.stats, want.stats):
        for name, a, b in zip(w._fields, g, w):
            if name == "mean_best":
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
            else:
                np.testing.assert_array_equal(a, np.asarray(b))
    isl = convert.to_numpy(got.islands)
    j_isl = want.islands._replace(rng=jax.random.key_data(want.islands.rng))
    for name, a, b in zip(isl._fields, isl, j_isl):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for name, a, b in zip(want.pool._fields, convert.to_numpy(got.pool),
                          want.pool):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("graphed_run", [False, True])
def test_async_host_loop_values_reach_the_step(monkeypatch, graphed_run):
    """run_experiment_async's tick and server state, as device scalars,
    against the reference (a down tick, churn, slow volunteers)."""
    if graphed_run:
        emulate_graphs(monkeypatch)
    ticks, down = 5, (2, 3)
    want = j_run_experiment_async(
        j_trap(8, 4), JEAConfig(**CFG), JMigrationConfig(),
        JAsyncConfig(**ACFG), n_islands=N, max_ticks=ticks,
        rng=jax.random.key(SEED), w2=True, server_up=_server(down))
    got = run_experiment_async(
        make_trap(8, 4), EAConfig(**CFG), MigrationConfig(),
        AsyncConfig(**ACFG), n_islands=N, max_ticks=ticks, rng=SEED, w2=True,
        server_up=_server(down), device="cpu")
    assert got.epochs == want.epochs and got.total_fires == want.total_fires
    for name, a, b in zip(want.astate._fields, convert.to_numpy(got.astate),
                          want.astate):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    isl = convert.to_numpy(got.islands)
    j_isl = want.islands._replace(rng=jax.random.key_data(want.islands.rng))
    for name, a, b in zip(isl._fields, isl, j_isl):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_graphed_bridged_loop_equals_eager(graphs):
    """A HostBridge's pool goes back into the graph's buffers before the
    next replay: the graphed bridged run equals the eager one (islands,
    pool, stats rows, bridge counts)."""
    def run():
        bridge = HostBridge(PoolServer(capacity=64, seed=8191), pull=4)
        res = run_experiment(make_trap(8, 4), EAConfig(**CFG), _mig(),
                             n_islands=N, max_epochs=4, rng=SEED, w2=True,
                             host_bridge=bridge, device="cpu")
        return res, bridge.stats()

    got, got_bridge = run()
    assert got_bridge["pulled"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphed, "graphs_on", lambda device: False)
        want, want_bridge = run()
    assert got_bridge == want_bridge
    _same((got.islands, got.pool), (want.islands, want.pool))
    _same([tuple(s) for s in got.stats], [tuple(s) for s in want.stats])
    assert (got.epochs, got.evaluations, got.success) == (
        want.epochs, want.evaluations, want.success)


def test_captured_steps_are_jit01_roots():
    """The analyzer holds the captured steps to JIT01: the steps handed to
    StepGraph, the generations a sharded rank hands to RankGraph and the
    capture region's own calls are roots; the ranks' eager tail, with
    the exchange's collectives, is none."""
    import os

    from repro_torch.analysis.engine import collect_python_files
    from repro_torch.analysis.passes import purity
    from repro_torch.analysis.symbols import load_project
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    project = load_project(collect_python_files(
        [os.path.join(repo, "src", "repro_torch")], root=repo))
    _, jit, regions = purity._collect_roots(project)
    assert {"repro_torch.core.evolution.scan_epoch",
            "repro_torch.core.evolution.experiment_step",
            "repro_torch.core.async_migration.scan_tick",
            "repro_torch.core.async_migration.async_experiment_step",
            "repro_torch.core.island.island_epoch",
            "repro_torch.core.graphed._assign"} <= jit
    assert any(r.module.name == "repro_torch.core.graphed" for r in regions)
