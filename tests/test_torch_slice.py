"""The port's island model (repro_torch) against the JAX reference, end to
end: ``run_fused`` with the pool topology and the ``pallas_ref`` generation,
W² on and off, on onemax and on the paper's 40-trap problem; and with W² on
the float problems, F15 (its constants carried across) and rastrigin.

The port starts from the reference's initial state, carried across by
``repro_torch.convert``; a second check starts it from its own
``init_islands`` and demands the same state. Tolerances: every field of
the islands, the pool, the epoch count and the stats must be equal, except
``mean_best``, an f32 mean whose summation order differs between XLA and
PyTorch: it is held to 1e-6 relative. On the float problems the integer
fields (keys, pop_size, evaluations, generation, uuid, experiments, done),
the pool's pointer and count and the initial population are exact; genes
are held to 2e-6 and fitness to rtol 2e-4, atol 1e-3, the tolerances of
``tests/test_torch_ga_kernels.py``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import ast
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import island as j_island
from repro.core import make_onemax as j_onemax
from repro.core import make_trap as j_trap
from repro.core.problems import make_f15 as j_f15
from repro.core.problems import make_rastrigin as j_rastrigin
from repro.core import pool as j_pool
from repro.core import run_fused as j_run_fused
from repro.core.types import ExperimentState as JExperimentState
from repro_torch import convert, rand
from repro_torch.core import EAConfig, MigrationConfig, island, run_fused
from repro_torch.core import run_experiment
from repro_torch.core import make_f15, make_onemax, make_rastrigin
from repro_torch.core import make_trap
from repro_torch.kernels.ga import get_kernel
from repro_torch.kernels.ga import ops as ga_ops
from repro_torch.launch import evolve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(impl="pallas_ref", max_pop=32, min_pop=16, generations_per_epoch=5)
N_ISLANDS, MAX_EPOCHS, SEED = 4, 3, 7
MEAN_RTOL = 1e-6

PROBLEMS = {
    "onemax": (lambda: j_onemax(48), lambda: make_onemax(48)),
    "trap": (lambda: j_trap(40, 4), lambda: make_trap(40, 4)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_islands_np(islands):
    return _np(islands._replace(rng=jax.random.key_data(islands.rng)))


def _assert_tree_equal(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what}.{name}")


def _reference(problem, cfg, mig, w2):
    """Initial state and result of the reference's run_fused."""
    rng = jax.random.key(SEED)
    k_init, k_loop = jax.random.split(rng)
    islands0 = j_island.init_islands(k_init, N_ISLANDS, problem, cfg)
    pool0 = j_pool.pool_init(mig.pool_capacity, problem.genome)
    islands, pool, epochs, stats = j_run_fused(
        problem, cfg, mig, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
        rng=rng, w2=w2, return_stats=True)
    init = JExperimentState(
        islands=_jax_islands_np(islands0), pool=_np(pool0), astate=(),
        key=np.asarray(jax.random.key_data(k_loop)), epoch=np.int32(0),
        stopped=np.bool_(False), stats=(), next_uuid=np.int32(N_ISLANDS))
    return init, (_jax_islands_np(islands), _np(pool), int(epochs),
                  _np(stats))


@pytest.mark.parametrize("w2", [False, True], ids=["plain", "w2"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_run_fused_matches_reference(name, w2):
    make_j, make_t = PROBLEMS[name]
    with jax.threefry_partitionable(True):
        init, (j_isl, j_pool_np, j_epochs, j_stats) = _reference(
            make_j(), JEAConfig(**CFG), JMigrationConfig(topology="pool"),
            w2)

    problem = make_t()
    cfg = EAConfig(**CFG)
    mig = MigrationConfig(topology="pool")
    state = convert.experiment_from_numpy(init, device="cpu")

    # the port's own init walks the same streams as the reference's
    own = island.init_islands(rand.split(rand.key(SEED), 2)[0], N_ISLANDS,
                              problem, cfg, device="cpu")
    _assert_tree_equal(convert.to_numpy(own), init.islands, "init")

    islands, pool, epochs, stats = run_fused(
        problem, cfg, mig, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
        w2=w2, return_stats=True, device="cpu", state=state)
    _assert_tree_equal(convert.to_numpy(islands), j_isl, "islands")
    _assert_tree_equal(convert.to_numpy(pool), j_pool_np, "pool")
    assert int(epochs) == j_epochs

    got = convert.to_numpy(stats)
    for field in got._fields:
        g, w = getattr(got, field), getattr(j_stats, field)
        if field == "mean_best":
            np.testing.assert_allclose(g, w, rtol=MEAN_RTOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"stats.{field}")

    # the same seed through the port's own entry point gives the same run
    islands2, pool2, epochs2 = run_fused(
        problem, cfg, mig, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
        rng=SEED, w2=w2, device="cpu")
    _assert_tree_equal(convert.to_numpy(islands2), j_isl, "islands (seed)")
    _assert_tree_equal(convert.to_numpy(pool2), j_pool_np, "pool (seed)")
    assert int(epochs2) == j_epochs


def _f15_pair():
    ref = j_f15(jax.random.key(64), dim=64, group=8)
    consts = {k: np.asarray(v) for k, v in ref.consts.items()}
    return ref, make_f15(consts, dim=64, group=8, device="cpu")


FLOAT_PROBLEMS = {
    "f15": _f15_pair,
    "rastrigin": lambda: (j_rastrigin(16), make_rastrigin(16)),
}
FLOAT_CFG = dict(CFG, crossover="blend", mutation_sigma=0.3)
GENE_ATOL, FIT_RTOL, FIT_ATOL = 2e-6, 2e-4, 1e-3
EXACT = {"pop_size", "rng", "generation", "evaluations", "done",
         "experiments", "uuid", "ptr", "count", "epoch",
         "total_evaluations", "n_done", "experiments_solved"}


def _assert_tree_close(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        msg = f"{what}.{name}"
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=msg)
        elif name in ("pop", "best_genome", "genomes"):
            np.testing.assert_allclose(g, w, rtol=0, atol=GENE_ATOL,
                                       err_msg=msg)
        else:
            np.testing.assert_allclose(g, w, rtol=FIT_RTOL, atol=FIT_ATOL,
                                       err_msg=msg)


@pytest.mark.parametrize("name", sorted(FLOAT_PROBLEMS))
def test_float_run_fused_matches_reference(name):
    with jax.threefry_partitionable(True):
        j_problem, problem = FLOAT_PROBLEMS[name]()
        init, (j_isl, j_pool_np, j_epochs, j_stats) = _reference(
            j_problem, JEAConfig(**FLOAT_CFG),
            JMigrationConfig(topology="pool"), True)
    cfg = EAConfig(**FLOAT_CFG)
    mig = MigrationConfig(topology="pool")

    # the port's own init draws the same population; its fitness is the
    # port's sum order
    own = convert.to_numpy(island.init_islands(
        rand.split(rand.key(SEED), 2)[0], N_ISLANDS, problem, cfg,
        device="cpu"))
    np.testing.assert_array_equal(own.pop, init.islands.pop)
    _assert_tree_close(own, init.islands, "init")

    islands, pool, epochs, stats = run_fused(
        problem, cfg, mig, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
        w2=True, return_stats=True, device="cpu",
        state=convert.experiment_from_numpy(init, device="cpu"))
    _assert_tree_close(convert.to_numpy(islands), j_isl, "islands")
    _assert_tree_close(convert.to_numpy(pool), j_pool_np, "pool")
    _assert_tree_close(convert.to_numpy(stats), j_stats, "stats")
    assert int(epochs) == j_epochs


def test_run_fused_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fused(make_onemax(8), EAConfig(**CFG), MigrationConfig(),
                  n_islands=2, max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        island.init_islands(rand.key(0), 2, make_onemax(8), EAConfig(**CFG))


@pytest.mark.parametrize("helper", ["key", "f15_consts", "islands", "pool",
                                    "experiment", "caches"])
def test_convert_helpers_without_device_need_a_card(helper, monkeypatch):
    """The ``*_from_numpy`` helpers resolve no device to the card, as every
    entry point does, and raise where none is visible."""
    isl = convert.to_numpy(island.init_islands(
        rand.key(0), 2, make_onemax(8), EAConfig(**CFG), device="cpu"))
    pool = SimpleNamespace(genomes=np.zeros((4, 8), np.int8),
                           fitness=np.zeros(4, np.float32),
                           ptr=np.int32(0), count=np.int32(0))
    state = SimpleNamespace(islands=isl, pool=pool,
                            key=np.zeros(2, np.uint32), epoch=np.int32(0),
                            stopped=np.bool_(False), next_uuid=np.int32(2))
    consts = {"o": np.zeros(8, np.float32), "perm": np.arange(8),
              "M": np.eye(4, dtype=np.float32)[None].repeat(2, 0)}
    fn, args = {
        "key": (convert.key_from_numpy, (state.key,)),
        "f15_consts": (convert.f15_consts_from_numpy, (consts,)),
        "islands": (convert.islands_from_numpy, (isl,)),
        "pool": (convert.pool_from_numpy, (pool,)),
        "experiment": (convert.experiment_from_numpy, (state,)),
        "caches": (convert.caches_from_numpy,
                   ([({"wkv": np.zeros((1, 2, 2), np.float32)},)],
                    torch.float32))}[helper]
    fn(*args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)


def test_unported_paths_raise_naming_the_roadmap(tmp_path, monkeypatch):
    cfg = EAConfig(**CFG)
    run = dict(n_islands=2, max_epochs=1, w2=True, device="cpu")
    # the ring topology (Queue A item 9) and the classic impl (item 8) run
    for mig, c in ((MigrationConfig(topology="ring"), cfg),
                   (MigrationConfig(), EAConfig(**dict(CFG, impl="jnp")))):
        isl, _, epochs = run_fused(make_onemax(64), c, mig, **run)
        assert int(epochs) == 1
        assert bool(torch.isfinite(isl.best_fitness).all())
    # what is still unported raises with its item named: the pbt command
    with pytest.raises(NotImplementedError, match="Queue A item 14"):
        evolve.main(["pbt"])
    # the host tier (item 12) runs: a bridged host loop and --bridge
    from repro_torch.core import HostBridge, PoolServer
    bridge = HostBridge(PoolServer(seed=0))
    res = run_experiment(make_onemax(64), cfg, host_bridge=bridge,
                         host_pool=PoolServer(seed=1), **run)
    assert res.epochs == 1 and bridge.stats()["pushed"] == 1
    # the async runtime (item 10) and the snapshots (item 11) run
    small = ["ea", "--device", "cpu", "--islands", "2", "--epochs", "2",
             "--max-pop", "8", "--min-pop", "8", "--gens-per-epoch", "1"]
    res = evolve.main(small + ["--bridge"])
    assert res.epochs == 2
    res = evolve.main(small + ["--runtime", "async"])
    assert res.epochs == 2 and res.total_fires >= 0
    snaps = str(tmp_path / "snaps")
    isl, _ = evolve.main(small + ["--fused", "--runtime", "async",
                                  "--snapshot-every", "1",
                                  "--snapshot-dir", snaps])
    assert sorted(os.listdir(snaps)) == ["step_00000001", "step_00000002"]
    again, _ = evolve.main(small + ["--fused", "--runtime", "async",
                                    "--snapshot-dir", snaps, "--resume"])
    _assert_tree_equal(convert.to_numpy(again), convert.to_numpy(isl),
                       "resumed")
    # the sharded drivers (item 13) run: --sharded on the CPU is one gloo
    # rank (one thread), and its fused driver's islands are the 2 of the
    # command's --islands
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    isl, pool = evolve.main(small + ["--sharded", "--fused"])
    assert isl.pop.shape[0] == 2 and int(pool.count) > 0
    # impl="pallas_tiled" runs, and equals impl="pallas" from the same seed
    runs = [run_fused(make_onemax(64), EAConfig(**dict(CFG, impl=impl)),
                      MigrationConfig(), rng=SEED, **run)
            for impl in ("pallas_tiled", "pallas")]
    for a, b in zip(runs[0][:2], runs[1][:2]):
        _assert_tree_equal(convert.to_numpy(a), convert.to_numpy(b),
                           "pallas_tiled vs pallas")
    # a float tile above the reference's 16 MiB untiled estimate is the
    # tiled kernel's: impl="pallas" routes it there and it runs
    big = make_rastrigin(1000)
    big_cfg = EAConfig(**dict(CFG, max_pop=800))
    assert ga_ops.route(800, 1000, ga_ops.make_spec(big_cfg, big.genome,
                                                    big.fused)) == "tiled"
    pop = torch.rand((1, 800, 1000), generator=torch.Generator().manual_seed(
        0)) * 10 - 5
    args = (rand.key(0)[None], pop, torch.zeros((1, 800)),
            torch.tensor([800]), big_cfg, big.genome, big.fused)
    new_pop, fit = get_kernel("generation_eval", "float", "pallas")(*args)
    want_pop, want_fit = get_kernel("generation_eval", "float",
                                    "pallas_ref")(*args)
    assert new_pop.shape == (1, 800, 1000) and fit.shape == (1, 800)
    assert torch.equal(new_pop, want_pop) and torch.equal(fit, want_fit)
    assert bool(torch.isfinite(fit).all())


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_reference():
    bad = []
    for path in _port_files():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_import_scan_covers_every_subpackage():
    """The scan above walks the model-land subpackages too."""
    walked = {os.path.relpath(os.path.dirname(p), os.path.join(
        REPO, "src", "repro_torch")) for p in _port_files()}
    for sub in ("models", "configs", "launch", os.path.join("kernels",
                                                            "rwkv6"),
                os.path.join("kernels", "flash_attention"),
                "core", "obs", os.path.join("kernels", "ga"), "checkpoint",
                "runtime", "server"):
        assert sub in walked, sub
