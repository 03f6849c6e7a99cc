"""Durability of the port (``core/evolution.py``'s segmented driver,
``checkpoint/``, ``runtime/``) against the reference's.

* ``segment_plan`` and ``empty_stats`` are the reference's.
* A segmented run equals the one-segment run, sync and async; a run
  resumed from its latest surviving snapshot (the last one dropped, as a
  kill after the one before leaves it) equals the uninterrupted run; a
  finished run's resume replays nothing; ``resume=True`` without a
  directory raises.
* Elastic resume: an 8-island snapshot resumes as 16 and as 4 islands.
  The port's ``resize_experiment`` on a state equals the reference's on
  the same state, joiners take uuids from the ``next_uuid`` watermark and
  never churn, and the resized runs equal the reference's resized runs.
  A joiner's rate is the batch's f32 mean, which PyTorch sums in another
  order than XLA: held to 4 ulps (``RATE_RTOL``, ROADMAP Queue C), as the
  stats' ``mean_best`` is held to 1e-6 relative.
* Snapshots cross packages: a snapshot the reference wrote (sync and
  async) restores into the port, whose resumed run equals the
  reference's resumed run; the reference restores the port's snapshots.
* The checkpointer's regressions: ``wait`` drains its errors, finished
  writers are pruned, stale ``.tmp`` build directories are swept and never
  a candidate, a truncated leaf and a structure mismatch raise, a
  directory without a manifest is no candidate, restore ignores the
  target's leaf shapes, and ``save_async`` copies the tree before it
  returns.
* ``runtime.fault.retry``'s jitter is seedable and leaves the global
  ``random`` alone; ``FailureInjector`` and ``StragglerMonitor`` act as
  the reference's.

Sizes: onemax 24 (96 where a resumed run must go on), ``max_pop`` =
``min_pop`` = 32, 3 generations per epoch, 4 islands (8 for the elastic
cases); the reference's cases use trap 4x4, 6 islands, ``max_pop`` 16.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import json
import os
import random
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.checkpoint import save as j_save
from repro.core import AsyncConfig as JAsyncConfig
from repro.core import EAConfig as JEAConfig
from repro.core import ExperimentState as JExperimentState
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import make_onemax as j_onemax
from repro.core import make_trap as j_trap
from repro.core import run_fused as j_run_fused
from repro.core import run_fused_async as j_run_fused_async
from repro.core import async_migration as j_async
from repro.core import island as j_island
from repro.core import pool as j_pool
from repro.core.evolution import empty_stats as j_empty_stats
from repro.core.evolution import segment_plan as j_segment_plan
from repro.obs import counters as j_counters
from repro.runtime import elastic as j_elastic
from repro.runtime import fault as j_fault
from repro.runtime import straggler as j_straggler
from repro_torch import convert, rand
from repro_torch.checkpoint import (Checkpointer, latest_step, restore, save,
                                    sweep_tmp)
from repro_torch.core import (AsyncConfig, EAConfig, ExperimentState,
                              MigrationConfig, make_onemax, make_trap,
                              run_fused, run_fused_async)
from repro_torch.core import island as island_lib
from repro_torch.core import pool as pool_lib
from repro_torch.core.async_migration import init_async_state
from repro_torch.core.evolution import (collect_stats, empty_stats,
                                        run_segments, segment_plan)
from repro_torch.obs import init_obs
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import FailureInjector, retry
from repro_torch.runtime.straggler import StragglerMonitor

CFG = dict(max_pop=32, min_pop=32, generations_per_epoch=3,
           max_evaluations=10**9)
ACFG = dict(min_rate=0.5, max_rate=1.0, staleness=2, churn_fraction=0.3,
            inbox_capacity=3)
SEED = 42
MEAN_RTOL = 1e-6
RATE_RTOL = 4.8e-7      # 4 ulps of an f32 in [0.25, 1)
# the reference's small case: trap 4x4, 6 islands, heterogeneous + churn
R_CFG = dict(max_pop=16, min_pop=8, generations_per_epoch=2)
R_ACFG = dict(min_rate=0.3, max_rate=1.0, staleness=2, churn_fraction=0.5,
              seed=3)


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_np(tree):
    """A reference tree as numpy, its keys as their words."""
    def leaf(x):
        if hasattr(x, "dtype") and jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(x)
    return jax.tree.map(leaf, tree)


def _named_leaves(tree, name=""):
    """``(field name, numpy leaf)`` of a port or reference result; dicts
    (harvested counters) kept whole."""
    if isinstance(tree, torch.Tensor):
        return [(name, tree.cpu().numpy())]
    if isinstance(tree, dict):
        return [(name, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in _named_leaves(v, f)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _named_leaves(v, name)]
    return [(name, np.asarray(tree))]


# f32 reductions summed in another order than XLA's (ROADMAP Queue C):
# the stats' mean of island bests, and a joiner's rate, the batch's mean
LEAF_RTOL = {"mean_best": MEAN_RTOL, "rate": RATE_RTOL}


def _trees_equal(a, b):
    la, lb = _named_leaves(a), _named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, dict):
            assert x == y
        elif name in LEAF_RTOL:
            np.testing.assert_allclose(x, y, rtol=LEAF_RTOL[name], atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _drop_last_snapshot(d):
    steps = sorted(p for p in os.listdir(d) if p.startswith("step_")
                   and not p.endswith(".tmp"))
    assert len(steps) >= 2, steps
    shutil.rmtree(os.path.join(d, steps[-1]))


def _sync(d=None, **kw):
    kw = dict(dict(n_islands=4, max_epochs=8, rng=SEED, return_stats=True,
                   device="cpu"), **kw)
    problem = kw.pop("problem", make_onemax(24))
    return run_fused(problem, EAConfig(**CFG), snapshot_dir=d, **kw)


def _async(d=None, **kw):
    kw = dict(dict(n_islands=4, max_ticks=9, rng=SEED, return_stats=True,
                   return_astate=True, return_obs=True, device="cpu"), **kw)
    problem = kw.pop("problem", make_onemax(24))
    return run_fused_async(problem, EAConfig(**CFG), acfg=AsyncConfig(**ACFG),
                           snapshot_dir=d, **kw)


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("done,total,every", [
    (0, 10, 4), (4, 10, 4), (10, 10, 4), (0, 10, None), (0, 10, 0),
    (3, 10, None), (0, 103, 7), (12, 11, 3)])
def test_segment_plan_matches_reference(done, total, every):
    plan = segment_plan(done, total, every)
    assert plan == j_segment_plan(done, total, every)
    assert sum(plan) == max(total - done, 0) and len(set(plan)) <= 2


def test_empty_stats_matches_reference_and_collect_stats():
    got, want = empty_stats(), j_empty_stats()
    for name, g, w in zip(want._fields, got, want):
        assert g.shape == (0,) and str(g.dtype) == f"torch.{w.dtype}", name
    isl = island_lib.init_islands(rand.key(0), 2, make_onemax(8),
                                  EAConfig(**CFG), device="cpu")
    for e, s in zip(empty_stats(), collect_stats(isl, 1)):
        assert e.dtype == s.dtype


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_segmented_equals_monolithic(runtime, tmp_path):
    run = _sync if runtime == "sync" else _async
    problem = make_onemax(96)                    # no early stop
    a = run(problem=problem)
    b = run(str(tmp_path), problem=problem, snapshot_every=3)
    _trees_equal(a, b)
    steps = sorted(os.listdir(tmp_path))
    assert len(steps) == 3 and steps[-1] == \
        f"step_{8 if runtime == 'sync' else 9:08d}"


@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_resume_equals_uninterrupted(runtime, tmp_path):
    run = _sync if runtime == "sync" else _async
    problem = make_onemax(96)
    full = run(str(tmp_path), problem=problem, snapshot_every=2)
    _drop_last_snapshot(str(tmp_path))
    res = run(str(tmp_path), problem=problem, snapshot_every=2, resume=True)
    _trees_equal(full, res)


def test_resume_after_an_early_stop(tmp_path):
    """onemax 24 stops before the end: the resumed run replays the same
    frozen rows and stop."""
    full = _async(str(tmp_path), snapshot_every=3)
    assert int(full[2]) < 9
    _drop_last_snapshot(str(tmp_path))
    _trees_equal(full, _async(str(tmp_path), snapshot_every=3, resume=True))


def test_resume_of_a_stopped_run_runs_no_segment(tmp_path):
    """The latest snapshot of a run that stopped early (without W²) is its
    final state: the resume runs no segment and writes no snapshot, so
    even the loop key is the uninterrupted run's. (The reference runs one
    frozen segment there, whose scan splits the key on; ROADMAP,
    Reference watch.)"""
    full = _async(str(tmp_path), snapshot_every=3)
    assert int(full[2]) < 9
    steps = sorted(os.listdir(tmp_path))
    before = restore(str(tmp_path))
    assert bool(before["stopped"])
    res = _async(str(tmp_path), snapshot_every=3, resume=True)
    _trees_equal(full, res)
    assert sorted(os.listdir(tmp_path)) == steps
    calls = []
    state = convert.to_device(restore(str(tmp_path), target=ExperimentState(
        islands=full[0], pool=full[1], astate=full[4], key=rand.key(0),
        epoch=full[2], stopped=torch.tensor(True), stats=full[3],
        next_uuid=torch.tensor(4), obs=init_obs(4))), "cpu")
    out = run_segments(state, 9, lambda st, n: calls.append(n),
                       snapshot_every=3)
    assert calls == [] and torch.equal(out.key, state.key)


def test_resume_of_a_finished_run_replays_nothing(tmp_path):
    full = _sync(str(tmp_path), max_epochs=6, snapshot_every=2,
                 problem=make_onemax(96))
    again = _sync(str(tmp_path), max_epochs=6, snapshot_every=2,
                  problem=make_onemax(96), resume=True)
    _trees_equal(full, again)


def test_resume_without_a_directory_raises():
    with pytest.raises(ValueError, match="resume"):
        _sync(max_epochs=2, resume=True)
    with pytest.raises(ValueError, match="resume"):
        _async(max_ticks=2, resume=True)


# ---------------------------------------------------------------------------
# Elastic resume
# ---------------------------------------------------------------------------
def _j_state(isl, pool, astate, key, epoch, next_uuid):
    return JExperimentState(islands=isl, pool=pool, astate=astate, key=key,
                            epoch=jnp.int32(epoch), stopped=jnp.asarray(False),
                            stats=(), next_uuid=jnp.int32(next_uuid))


@pytest.mark.parametrize("n_new", [16, 4, 8])
def test_resize_experiment_matches_reference(n_new):
    """The same 8-island async state resized by both packages."""
    problem, j_problem = make_trap(4, 4), j_trap(4, 4)
    words = np.array([5, 6], np.uint32)
    jkey = jax.random.wrap_key_data(jnp.asarray(words))
    j_isl = j_island.init_islands(jkey, 8, j_problem, JEAConfig(**R_CFG))
    j_p = j_pool.pool_put_batch(j_pool.pool_init(8, j_problem.genome),
                                j_isl.best_genome, j_isl.best_fitness)
    j_ast = j_async.init_async_state(jkey, 8, JAsyncConfig(**R_ACFG), 10,
                                     j_problem.genome)
    j_st = _j_state(j_isl, j_p, j_ast, jkey, 3, 8)
    j_obs = j_st._replace(obs=j_counters.init_obs(8))
    want = j_elastic.resize_experiment(j_obs, n_new, j_problem,
                                       JEAConfig(**R_CFG))
    state = convert.experiment_from_numpy(_ref_np(j_obs), device="cpu")
    got = elastic.resize_experiment(state, n_new, problem, EAConfig(**R_CFG))
    want = _ref_np(want)
    for field in ("islands", "pool", "astate", "obs"):
        _trees_equal(getattr(got, field), getattr(want, field))
    assert int(got.next_uuid) == int(want.next_uuid)
    if n_new > 8:
        uuids = got.islands.uuid.tolist()
        assert uuids == list(range(n_new))
        assert got.astate.down_start[8:].tolist() == \
            [elastic.NEVER_CHURN] * (n_new - 8)


def test_uuid_watermark_never_reuses_identities():
    problem = make_onemax(24)
    cfg = EAConfig(**CFG)
    state = ExperimentState(
        islands=island_lib.init_islands(rand.key(0), 4, problem, cfg,
                                        device="cpu"),
        pool=pool_lib.pool_init(16, problem.genome, device="cpu"), astate=(),
        key=rand.key(1), epoch=torch.tensor(0, dtype=torch.int32),
        stopped=torch.tensor(False), stats=(),
        next_uuid=torch.tensor(4, dtype=torch.int32))
    state = elastic.resize_experiment(state, 2, problem, cfg)
    assert sorted(state.islands.uuid.tolist()) == [0, 1]
    state = elastic.resize_experiment(state, 5, problem, cfg)
    assert sorted(state.islands.uuid.tolist()) == [0, 1, 4, 5, 6]
    assert int(state.next_uuid) == 7
    two = island_lib.init_islands(rand.key(0), 2, problem, cfg, device="cpu")
    grown = elastic.grow_islands(two, 2, problem, cfg, None, rand.key(5))
    assert sorted(grown.uuid.tolist()) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        elastic.shrink_islands(two, 3)


def test_async_joiners_never_churn_and_keep_the_mean_rate():
    """``grow_async_state`` against the reference's: the joiners' rate is
    the f32 mean of the batch's, summed in PyTorch's order, which lies up
    to 3 ulps from XLA's (ROADMAP Queue C: held to ``RATE_RTOL``); every
    other field exact."""
    acfg = dict(min_rate=0.25, max_rate=1.0, churn_fraction=1.0)
    words = np.array([0, 0], np.uint32)
    for n in (4, 7, 33):
        astate = init_async_state(torch.zeros(2, dtype=torch.int64), n,
                                  AsyncConfig(**acfg), 10, make_onemax(24).genome)
        j_astate = j_async.init_async_state(
            jax.random.wrap_key_data(jnp.asarray(words)), n,
            JAsyncConfig(**acfg), 10, j_onemax(24).genome)
        got = elastic.grow_async_state(astate, 3)
        want = j_elastic.grow_async_state(j_astate, 3)
        _trees_equal(got, _np(want))
        assert got.down_start[n:].tolist() == [elastic.NEVER_CHURN] * 3
        assert bool(torch.isneginf(got.inbox_fitness[n:]).all())
        assert got.fires[n:].tolist() == [0] * 3


@pytest.mark.parametrize("n_new", [16, 4])
def test_elastic_resume_matches_reference(n_new, tmp_path):
    """An 8-island async run snapshotted at tick 4 resumes as ``n_new``
    islands for 2 more ticks, in each package from its own snapshot: the
    same islands, pool, async state and stats."""
    kw = dict(max_ticks=4, w2=True, return_stats=True, return_astate=True,
              snapshot_every=2)
    j_run_fused_async(j_trap(4, 4), JEAConfig(**R_CFG),
                      JMigrationConfig(pool_capacity=8),
                      JAsyncConfig(**R_ACFG), n_islands=8,
                      rng=jax.random.key(1), snapshot_dir=str(tmp_path / "j"),
                      **kw)
    run_fused_async(make_trap(4, 4), EAConfig(**R_CFG),
                    MigrationConfig(pool_capacity=8), AsyncConfig(**R_ACFG),
                    n_islands=8, rng=1, snapshot_dir=str(tmp_path / "t"),
                    device="cpu", **kw)
    kw = dict(kw, max_ticks=6, resume=True)
    want = j_run_fused_async(j_trap(4, 4), JEAConfig(**R_CFG),
                             JMigrationConfig(pool_capacity=8),
                             JAsyncConfig(**R_ACFG), n_islands=n_new,
                             rng=jax.random.key(1),
                             snapshot_dir=str(tmp_path / "j"), **kw)
    got = run_fused_async(make_trap(4, 4), EAConfig(**R_CFG),
                          MigrationConfig(pool_capacity=8),
                          AsyncConfig(**R_ACFG), n_islands=n_new, rng=1,
                          snapshot_dir=str(tmp_path / "t"), device="cpu",
                          **kw)
    assert got[0].pop.shape[0] == n_new and int(got[2]) == 6
    assert sorted(got[0].uuid.tolist()) == list(range(n_new))
    _trees_equal(got, _ref_np(want))
    if n_new > 8:
        assert got[4].down_start[8:].tolist() == \
            [elastic.NEVER_CHURN] * (n_new - 8)


# ---------------------------------------------------------------------------
# Snapshots across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("runtime", ["sync", "async"])
def test_reference_snapshot_restores_into_the_port(runtime, tmp_path):
    """The reference runs 4 ticks with a snapshot every 2 and loses its
    last one; the port resumes from what is left, as the reference does,
    and both reach the same state."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    if runtime == "sync":
        def j_run(**kw):
            return j_run_fused(j_trap(4, 4), JEAConfig(**R_CFG),
                               JMigrationConfig(pool_capacity=8),
                               n_islands=6, max_epochs=4,
                               rng=jax.random.key(0), w2=True,
                               return_stats=True, return_obs=True,
                               snapshot_every=2, **kw)

        def run(**kw):
            return run_fused(make_trap(4, 4), EAConfig(**R_CFG),
                             MigrationConfig(pool_capacity=8), n_islands=6,
                             max_epochs=4, rng=0, w2=True, return_stats=True,
                             return_obs=True, snapshot_every=2, device="cpu",
                             **kw)
    else:
        def j_run(**kw):
            return j_run_fused_async(
                j_trap(4, 4), JEAConfig(**R_CFG),
                JMigrationConfig(pool_capacity=8), JAsyncConfig(**R_ACFG),
                n_islands=6, max_ticks=4, rng=jax.random.key(0), w2=True,
                return_stats=True, return_astate=True, return_obs=True,
                snapshot_every=2, **kw)

        def run(**kw):
            return run_fused_async(
                make_trap(4, 4), EAConfig(**R_CFG),
                MigrationConfig(pool_capacity=8), AsyncConfig(**R_ACFG),
                n_islands=6, max_ticks=4, rng=0, w2=True, return_stats=True,
                return_astate=True, return_obs=True, snapshot_every=2,
                device="cpu", **kw)
    full = j_run(snapshot_dir=ref_dir)
    _drop_last_snapshot(ref_dir)
    shutil.copytree(ref_dir, port_dir)
    got = run(snapshot_dir=port_dir, resume=True)
    want = j_run(snapshot_dir=ref_dir, resume=True)
    _trees_equal(got, _ref_np(want))
    _trees_equal(got, _ref_np(full))
    # the port's snapshot (step 4) reads back in the reference, leaf for
    # leaf, keys as threefry keys
    flat = j_restore(port_dir)
    ref_flat = j_restore(ref_dir)
    assert sorted(flat) == sorted(ref_flat)
    for k in flat:
        x, y = _ref_np(flat[k]), _ref_np(ref_flat[k])
        rtol = LEAF_RTOL.get(k.split("::")[-1])
        if rtol:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_manifest_layout_is_the_reference_s(tmp_path):
    """Leaf paths, files, dtypes and ``prng_impl`` as the reference writes
    them, for a tree with a NamedTuple, a tuple, a dict and keys."""
    isl = island_lib.init_islands(rand.key(3), 2, make_onemax(8),
                                  EAConfig(**CFG), device="cpu")
    tree = {"b": (torch.arange(3, dtype=torch.int32), np.zeros(2, np.int8)),
            "a": isl, "key": rand.key(9)}
    save(str(tmp_path / "t"), 5, tree)
    j_tree = {"b": (jnp.arange(3, dtype=jnp.int32), np.zeros(2, np.int8)),
              "a": j_island.init_islands(jax.random.key(3), 2, j_onemax(8),
                                         JEAConfig(**CFG)),
              "key": jax.random.key(9)}
    j_save(str(tmp_path / "j"), 5, j_tree)
    for name in ("t", "j"):
        assert os.listdir(tmp_path / name) == ["step_00000005"]
    mt, mj = (json.load(open(tmp_path / n / "step_00000005" /
                             "manifest.json")) for n in ("t", "j"))
    assert mt == mj
    got = restore(str(tmp_path / "j"), target=tree)
    np.testing.assert_array_equal(got["key"], np.array([0, 9], np.uint32))
    assert type(got["a"]).__name__ == "IslandState"
    back = convert.to_device(got, "cpu")
    assert torch.equal(back["key"], tree["key"])
    _trees_equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0], tree["b"][0])


# ---------------------------------------------------------------------------
# The checkpointer's regressions
# ---------------------------------------------------------------------------
def test_wait_drains_errors(tmp_path):
    blocker = tmp_path / "dir_is_a_file"
    blocker.write_text("not a directory")
    ck = Checkpointer(str(blocker / "sub"))
    ck.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                    # consumed, not re-raised
    ck.directory = str(tmp_path / "ok")
    ck.save_async(2, {"x": torch.zeros(2)})
    ck.wait()
    assert latest_step(ck.directory) == 2


def test_save_async_prunes_finished_writers_and_copies_first(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(4.0)
    ck.save_async(1, {"x": x})
    x += 100                                      # the caller goes on
    ck.wait()
    np.testing.assert_array_equal(restore(str(tmp_path))["x"],
                                  np.arange(4.0, dtype=np.float32))
    deadline = time.time() + 5
    while any(t.is_alive() for t in ck._pending) and time.time() < deadline:
        time.sleep(0.01)
    ck.save_async(2, {"x": x})
    assert len(ck._pending) == 1
    ck.wait()


def test_stale_tmp_swept_and_never_a_candidate(tmp_path):
    save(str(tmp_path), 3, {"x": torch.zeros(2)})
    stale = tmp_path / "step_00000007.tmp"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial")
    assert latest_step(str(tmp_path)) == 3
    Checkpointer(str(tmp_path))
    assert not stale.exists()
    assert latest_step(str(tmp_path)) == 3
    (tmp_path / "step_00000001.tmp").mkdir()
    removed = sweep_tmp(str(tmp_path))
    assert len(removed) == 1 and removed[0].endswith(".tmp")
    assert (tmp_path / "step_00000003").exists()


def test_restore_validation(tmp_path):
    save(str(tmp_path / "m"), 1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="mismatch"):
        restore(str(tmp_path / "m"), target={"b": torch.zeros(2)})
    save(str(tmp_path / "t"), 1, {"a": torch.arange(64.0)})
    step = tmp_path / "t" / "step_00000001"
    leaf = next(p for p in os.listdir(step) if p.startswith("leaf_"))
    data = (step / leaf).read_bytes()
    (step / leaf).write_bytes(data[: len(data) // 2])
    with pytest.raises(Exception):
        restore(str(tmp_path / "t"), target={"a": torch.zeros(64)})
    (tmp_path / "m" / "step_00000009").mkdir()   # no manifest
    assert latest_step(str(tmp_path / "m")) == 1
    save(str(tmp_path / "s"), 1, {"a": torch.zeros((8, 3))})
    got = restore(str(tmp_path / "s"), target={"a": torch.zeros((16, 3))})
    assert got["a"].shape == (8, 3)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# Fault and straggler
# ---------------------------------------------------------------------------
def _delays(retry_fn, rng):
    seen, calls = [], {"n": 0}

    def boom():
        calls["n"] += 1
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError):
        retry_fn(boom, retries=3, base_delay=0.01, sleep=seen.append,
                 rng=rng)
    assert calls["n"] == 4
    return seen


def test_retry_jitter_is_seedable_and_the_reference_s():
    a = _delays(retry, random.Random(7))
    assert a == _delays(retry, random.Random(7)) and len(a) == 3
    assert a == _delays(j_fault.retry, random.Random(7))
    random.seed(123)
    state = random.getstate()
    _delays(retry, random.Random(1))
    _delays(retry, None)
    assert random.getstate() == state
    flaky = iter([RuntimeError("x"), RuntimeError("y"), 5])

    def f():
        v = next(flaky)
        if isinstance(v, Exception):
            raise v
        return v

    assert retry(f, retries=3, sleep=lambda _: None) == 5
    assert retry(lambda: 1 / 0, retries=1, sleep=lambda _: None,
                 exceptions=(ZeroDivisionError,),
                 on_give_up=lambda e: "degraded") == "degraded"


def test_failure_injector_and_straggler_monitor_match_reference():
    sched = [("server", 3), ("island", 5)]
    for inj in (FailureInjector(sched, p_random=0.3, seed=4),
                j_fault.FailureInjector(sched, p_random=0.3, seed=4)):
        hits = [(k, e) for e in range(10) for k in ("server", "island")
                if inj.fires(k, e)]
        assert ("server", 3) in hits and ("island", 5) in hits
        assert inj.fired == hits
    assert FailureInjector(sched, 0.3, 4).fires("server", 1) == \
        j_fault.FailureInjector(sched, 0.3, 4).fires("server", 1)
    mons = (StragglerMonitor(threshold=2.0),
            j_straggler.StragglerMonitor(threshold=2.0))
    for m in mons:
        for w in range(4):
            for _ in range(5):
                m.record(w, 1.0 if w != 2 else 3.5)
        assert m.stop(9) is None
    assert mons[0].stragglers() == mons[1].stragglers() == [2]
    assert mons[0].gauges() == mons[1].gauges()
    assert mons[0].work_scale(2) == mons[1].work_scale(2) < 1.0
