"""The classic path end to end: ``run_fused`` and ``run_experiment`` under
the default ``EAConfig()`` (``impl="jnp"``) against the reference's, the
counter ledger, and the ``ea`` command.

Small size: 4 islands, trap 8x4 (onemax 16 where a run must succeed
early), ``max_pop`` 32, ``min_pop`` 16, 5 generations per epoch, 3
epochs. On binary genomes every field of the islands, the pool, the epoch
count, the stats rows and the harvest must equal the reference's;
``mean_best`` is an f32 mean whose summation order differs between XLA and
PyTorch and is held to 1e-6 relative, as in ``tests/test_torch_slice.py``.
The float classic path (F15 at D 64, m 8, blend, gaussian sigma 0.3) is
held to that file's float tolerances: integer fields exact, genes 2e-6,
fitness rtol 2e-4 and atol 1e-3.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core import AcceptanceConfig as JAcceptanceConfig
from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import island as j_island
from repro.core import make_onemax as j_onemax
from repro.core import make_trap as j_trap
from repro.core import pool as j_pool
from repro.core import run_experiment as j_run_experiment
from repro.core import run_fused as j_run_fused
from repro.core.problems import make_f15 as j_f15
from repro.core.types import ExperimentState as JExperimentState
from repro_torch import convert
from repro_torch.core import (AcceptanceConfig, EAConfig, MigrationConfig,
                              RunResult, make_f15, make_onemax, make_trap,
                              run_experiment, run_fused)
from repro_torch.launch import evolve

CFG = dict(max_pop=32, min_pop=16, generations_per_epoch=5)
N_ISLANDS, MAX_EPOCHS, SEED = 4, 3, 11
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


def _migs(topology, policy):
    return (JMigrationConfig(topology=topology,
                             acceptance=JAcceptanceConfig(policy=policy)),
            MigrationConfig(topology=topology,
                            acceptance=AcceptanceConfig(policy=policy)))


@pytest.mark.parametrize("w2,topology,policy", [
    (False, "pool", "always"), (True, "pool", "always"),
    (True, "ring", "elitist")])
def test_run_fused_defaults_match_reference(w2, topology, policy):
    """``EAConfig()`` but for the small sizes: the classic path, started
    from the reference's initial state carried across."""
    jm, tm = _migs(topology, policy)
    problem = j_trap(8, 4)
    jcfg = JEAConfig(**CFG)
    assert jcfg.impl == "jnp" and EAConfig(**CFG).impl == "jnp"
    rng = jax.random.key(SEED)
    k_init, k_loop = jax.random.split(rng)
    isl0 = j_island.init_islands(k_init, N_ISLANDS, problem, jcfg)
    init = JExperimentState(
        islands=_jislands(isl0), pool=_np(j_pool.pool_init(
            jm.pool_capacity, problem.genome)), astate=(),
        key=np.asarray(jax.random.key_data(k_loop)), epoch=np.int32(0),
        stopped=np.bool_(False), stats=(), next_uuid=np.int32(N_ISLANDS))
    j_isl, j_p, j_ep, j_st, j_obs = j_run_fused(
        problem, jcfg, jm, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
        rng=rng, w2=w2, return_stats=True, return_obs=True)
    isl, pool, ep, st, obs = run_fused(
        make_trap(8, 4), EAConfig(**CFG), tm, n_islands=N_ISLANDS,
        max_epochs=MAX_EPOCHS, w2=w2, return_stats=True, return_obs=True,
        device="cpu", state=convert.experiment_from_numpy(init,
                                                          device="cpu"))
    _equal(convert.to_numpy(isl), _jislands(j_isl), "islands")
    _equal(convert.to_numpy(pool), _np(j_p), "pool")
    assert int(ep) == int(j_ep)
    _equal(convert.to_numpy(st), _np(j_st), "stats", MEAN_RTOL)
    assert obs == j_obs
    t = obs["totals"]
    assert t["delivered"] == t["accepted"] + t["rejected"]
    # the port's own init from the seed reaches the same state
    isl2, pool2, _ = run_fused(make_trap(8, 4), EAConfig(**CFG), tm,
                               n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
                               w2=w2, rng=SEED, device="cpu")
    _equal(convert.to_numpy(isl2), _jislands(j_isl), "islands (seed)")
    _equal(convert.to_numpy(pool2), _np(j_p), "pool (seed)")


def _server(down):
    return lambda epoch: epoch not in down


@pytest.mark.parametrize("case", ["onemax_stop", "onemax_no_stop",
                                  "trap_w2_server_down", "ring_elitist"])
def test_run_experiment_matches_reference(case):
    name, w2, down, stop, topology, policy = {
        "onemax_stop": ("onemax", False, (), True, "pool", "always"),
        "onemax_no_stop": ("onemax", False, (2,), False, "pool", "always"),
        "trap_w2_server_down": ("trap", True, (1, 3), True, "pool",
                                "always"),
        "ring_elitist": ("trap", False, (2,), True, "ring", "elitist"),
    }[case]
    make_j, make_t = {"onemax": (lambda: j_onemax(16),
                                 lambda: make_onemax(16)),
                      "trap": (lambda: j_trap(8, 4),
                               lambda: make_trap(8, 4))}[name]
    jm, tm = _migs(topology, policy)
    epochs = 6 if name == "onemax" else MAX_EPOCHS
    want = j_run_experiment(make_j(), JEAConfig(**CFG), jm,
                            n_islands=N_ISLANDS, max_epochs=epochs,
                            rng=jax.random.key(SEED), w2=w2,
                            server_up=_server(down), stop_on_success=stop)
    got = run_experiment(make_t(), EAConfig(**CFG), tm, n_islands=N_ISLANDS,
                         max_epochs=epochs, rng=SEED, w2=w2,
                         server_up=_server(down), stop_on_success=stop,
                         device="cpu")
    assert isinstance(got, RunResult)
    for field in ("success", "epochs", "evaluations",
                  "evaluations_to_solution"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.stats) == len(want.stats)
    for g, w in zip(got.stats, want.stats):
        _equal(g, _np(w), "stats row", MEAN_RTOL)
    _equal(convert.to_numpy(got.islands), _jislands(want.islands), "islands")
    _equal(convert.to_numpy(got.pool), _np(want.pool), "pool")
    if case == "onemax_stop":
        assert got.success and got.epochs < epochs


def test_early_stop_is_latched_in_the_harvest():
    """Without W² a solved run stops; the harvest latches the epoch and
    the stats rows after it repeat the frozen state."""
    jm, tm = _migs("pool", "always")
    want = j_run_fused(j_onemax(16), JEAConfig(**CFG), jm,
                       n_islands=N_ISLANDS, max_epochs=6,
                       rng=jax.random.key(SEED), return_stats=True,
                       return_obs=True)
    got = run_fused(make_onemax(16), EAConfig(**CFG), tm,
                    n_islands=N_ISLANDS, max_epochs=6, rng=SEED,
                    return_stats=True, return_obs=True, device="cpu")
    assert got[4] == want[4]
    assert 0 < got[4]["early_stop_epoch"] < 6
    assert int(got[2]) == int(want[2]) == got[4]["early_stop_epoch"]
    _equal(convert.to_numpy(got[3]), _np(want[3]), "stats", MEAN_RTOL)


def test_float_classic_path_within_tolerance():
    ref = j_f15(jax.random.key(64), dim=64, group=8)
    consts = {k: np.asarray(v) for k, v in ref.consts.items()}
    kw = dict(CFG, crossover="blend", mutation_sigma=0.3)
    want = j_run_fused(ref, JEAConfig(**kw), JMigrationConfig(),
                       n_islands=N_ISLANDS, max_epochs=2,
                       rng=jax.random.key(SEED), w2=True, return_stats=True)
    got = run_fused(make_f15(consts, dim=64, group=8, device="cpu"),
                    EAConfig(**kw), MigrationConfig(), n_islands=N_ISLANDS,
                    max_epochs=2, rng=SEED, w2=True, return_stats=True,
                    device="cpu")
    isl, j_isl = convert.to_numpy(got[0]), _jislands(want[0])
    for name in ("pop_size", "rng", "generation", "evaluations", "done",
                 "experiments", "uuid"):
        np.testing.assert_array_equal(getattr(isl, name),
                                      getattr(j_isl, name), err_msg=name)
    for name in ("pop", "best_genome"):
        np.testing.assert_allclose(getattr(isl, name), getattr(j_isl, name),
                                   rtol=0, atol=GENE_ATOL, err_msg=name)
    for name in ("fitness", "best_fitness"):
        np.testing.assert_allclose(getattr(isl, name), getattr(j_isl, name),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(convert.to_numpy(got[1]).count,
                                  np.asarray(want[1].count))


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_ea_command_runs_on_the_cpu(capsys):
    base = ["ea", "--problem", "trap", "--islands", "4", "--epochs", "2",
            "--max-pop", "16", "--min-pop", "8", "--gens-per-epoch", "3",
            "--device", "cpu"]
    res = evolve.main(base)
    assert isinstance(res, RunResult) and res.epochs == 2
    line = _last_line(capsys)
    assert line.startswith("success=False evals_to_solution=None wall=")
    isl, _ = evolve.main(base + ["--fused", "--topology", "torus",
                                 "--acceptance", "dedup",
                                 "--acceptance-epsilon", "1",
                                 "--impl", "pallas_ref", "--w2"])
    best = float(isl.best_fitness.max())
    assert _last_line(capsys) == f"final best={best!r} epochs=2"
    # the same command's numbers are the reference's
    want = j_run_experiment(j_trap(), JEAConfig(max_pop=16, min_pop=8,
                                                generations_per_epoch=3),
                            JMigrationConfig(topology="pool"), n_islands=4,
                            max_epochs=2, rng=jax.random.key(0))
    assert res.evaluations == want.evaluations
    _equal(convert.to_numpy(res.islands), _jislands(want.islands), "islands")


@pytest.mark.parametrize("flags,title", [
    (["--bridge"], "[sharded x2 topo=pool]"),
    (["--fused", "--snapshot-every", "1"], "[sharded x2 fused topo=pool]"),
    (["--runtime", "async", "--bridge"], "[sharded x2 async topo=pool]")],
    ids=["loop-bridge", "fused-snapshots", "async"])
def test_ea_sharded_runs_each_driver(flags, title, tmp_path, capsys,
                                     monkeypatch):
    """``--sharded`` (Queue A item 13) on 2 gloo ranks of the CPU: the
    host loop (with ``--bridge``; it takes no snapshot), the fused driver
    (its snapshots, one an epoch, written by rank 0) and the async driver
    (fused only, so ``--bridge`` is off with the reference's note, and
    its one segment snapshotted) print the reference's two lines and
    return the global islands."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    snaps = tmp_path / "snaps"
    isl, pool = evolve.main(
        ["ea", "--device", "cpu", "--sharded", "--shards", "2", "--islands",
         "4", "--epochs", "2", "--max-pop", "8", "--min-pop", "8",
         "--gens-per-epoch", "1", "--snapshot-dir", str(snaps)] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    best = float(isl.best_fitness.max())
    assert re.fullmatch(re.escape(f"{title} best={best} epochs=2 (")
                        + r"\d+\.\ds\) backend=gloo", lines[-2])
    assert lines[-1] == f"final best={best!r} epochs=2"
    assert isl.pop.shape == (4, 8, 160) and int(pool.count) > 0
    if "--bridge" in flags and "async" in flags:
        assert lines[0].startswith("note: --bridge needs a host loop")
    if "--fused" in flags:
        assert sorted(os.listdir(snaps)) == ["step_00000001",
                                             "step_00000002"]
    elif "async" in flags:   # fused too: one segment, one snapshot
        assert sorted(os.listdir(snaps)) == ["step_00000002"]
    else:                    # the host loop takes none
        assert not snaps.exists()


@pytest.mark.parametrize("flags", [
    ["--bridge"], ["--bridge", "--acceptance", "elitist"],
    ["--bridge", "--impl", "pallas"],
    ["--bridge", "--runtime", "async"], ["--bridge", "--fused"]],
    ids=["sync", "elitist", "pallas", "async", "fused"])
def test_ea_bridge_flags_match_reference(flags, capsys):
    """``--bridge`` (Queue A item 12): the host loop with a HostBridge
    over PoolServer(capacity=256, seed=seed) prints the reference's lines,
    its bridge counts included; under ``--runtime async`` the
    AsyncHostBridge's counts depend on its worker's timing, so there
    only the epochs' lines are compared; ``--fused`` turns the bridge off
    with a note, as in the reference."""
    from repro.launch import evolve as j_evolve
    base = ["ea", "--problem", "trap", "--islands", "4", "--epochs", "3",
            "--max-pop", "16", "--min-pop", "8", "--gens-per-epoch", "3"]
    evolve.main(base + flags + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    j_evolve.main(base + [f if f != "pallas" else "pallas_ref"
                          for f in flags])
    ref_lines = capsys.readouterr().out.strip().splitlines()
    if "async" in flags:
        port_lines, ref_lines = port_lines[:-1], ref_lines[:-1]
    assert [_numbers(x) for x in port_lines if not x.startswith("note:")] \
        == [_numbers(x) for x in ref_lines if not x.startswith("note:")]
    assert any(x.startswith("note: --bridge") for x in port_lines) == (
        "--fused" in flags)


def _numbers(line):
    """A final line without its wall time."""
    return re.sub(r" wall=[0-9.]+s| \([0-9.]+s\)", "", line)


@pytest.mark.parametrize("flags", [
    ["--runtime", "async"],
    ["--runtime", "async", "--churn", "0.5", "--fused"],
    ["--fused", "--snapshot-every", "2", "--snapshot-dir", "{d}"],
    ["--snapshot-dir", "{d}"],
    ["--fused", "--runtime", "async", "--churn", "0.5", "--snapshot-every",
     "1", "--snapshot-dir", "{d}", "--resume"]],
    ids=["runtime_async", "churn", "snapshot_every", "snapshot_dir",
         "resume"])
def test_ea_async_and_snapshot_flags_match_reference(flags, tmp_path,
                                                     capsys):
    """The async runtime's and the snapshots' flags run on the CPU and
    print the reference's numbers. ``--resume`` resumes a run whose last
    snapshot was lost (as a kill after the one before would leave it) and
    must reach the reference's uninterrupted run; ``--snapshot-dir``
    without ``--fused`` snapshots nothing, as in the reference."""
    from repro.launch import evolve as j_evolve
    base = ["ea", "--problem", "trap", "--islands", "4", "--epochs", "3",
            "--max-pop", "16", "--min-pop", "8", "--gens-per-epoch", "3"]
    d = str(tmp_path / "port")
    flags = [f.format(d=d) for f in flags]
    if "--resume" in flags:
        first = [f for f in flags if f != "--resume"]
        evolve.main(base + first + ["--device", "cpu"])
        steps = sorted(os.listdir(d))
        assert steps == ["step_00000001", "step_00000002", "step_00000003"]
        shutil.rmtree(os.path.join(d, steps[-1]))
        capsys.readouterr()
    got = evolve.main(base + flags + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    ref_dir = str(tmp_path / "ref")
    j_evolve.main(base + [ref_dir if f == d else f for f in flags
                          if f != "--resume"])
    ref_lines = capsys.readouterr().out.strip().splitlines()
    # every line but the notes (worded in each package's terms)
    assert [_numbers(x) for x in port_lines if not x.startswith("note:")] \
        == [_numbers(x) for x in ref_lines if not x.startswith("note:")]
    if "--snapshot-dir" in flags:
        def listing(path):
            return sorted(os.listdir(path)) if os.path.isdir(path) else None
        if "--resume" not in flags:
            assert listing(d) == listing(ref_dir)
        if "--fused" not in flags:
            assert listing(d) is None
            assert port_lines[0].startswith("note: --snapshot-dir")
    islands = got[0] if isinstance(got, tuple) else got.islands
    assert int(islands.pop.shape[0]) == 4


def test_pbt_raises_and_the_host_tier_runs():
    """pbt (Queue A item 14) still raises; the host tier (item 12) runs:
    a host pool receives every island's best each epoch, uuids and all,
    and a broken one is a lost XHR."""
    from repro_torch.core import PoolServer
    with pytest.raises(NotImplementedError, match="Queue A item 14"):
        evolve.main(["pbt"])
    run = dict(n_islands=2, max_epochs=2, device="cpu",
               stop_on_success=False)
    server = PoolServer(seed=0)
    res = run_experiment(make_onemax(8), EAConfig(**CFG), host_pool=server,
                         **run)
    assert server.stats()["puts"] == 4
    entries, _, _ = server.get_since(-1)
    assert [e.uuid for e in entries] == [0, 1, 0, 1]
    assert entries[-1].fitness == float(res.islands.best_fitness[1])
    res2 = run_experiment(make_onemax(8), EAConfig(**CFG), host_pool=object(),
                          **run)
    assert torch.equal(res2.islands.pop, res.islands.pop)


def test_run_experiment_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(make_onemax(8), EAConfig(**CFG), n_islands=2,
                       max_epochs=1)
