"""The port's tiled generation (``impl='pallas_tiled'``) against the
reference's, on the CPU.

On CPU tensors the tiled wrapper runs the plain version, which the tiled
CUDA kernel equals bit for bit on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3c). Here the port's ``pallas_tiled`` entry is held
against the reference's ``pallas_tiled`` (Pallas interpret mode, explicit
tiles) on ragged shapes and padded ``pop_size``, and ``run_fused`` under
``impl='pallas_tiled'`` against the reference's run. Binary genomes are
exact. Float genes are held to 2e-6 and fitness to rtol 2e-4, atol 1e-3,
the tolerances of ROADMAP Queue C (XLA's ``log``/``cos`` and sum orders).

Also the routing of ``impl='pallas'`` (a pure function), the roulette plan
above the reference's 4096-lane selection block (a count of differing rows,
Queue C), and the autotune cache. The reference's ``best_tiles`` rewrites
its committed cache on a miss, so every reference call here passes its
tiles or points the cache at ``tmp_path``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import island as j_island
from repro.core import make_trap as j_trap
from repro.core import pool as j_pool
from repro.core import run_fused as j_run_fused
from repro.core.problems import make_f15_consts
from repro.core.types import ExperimentState as JExperimentState
from repro.core.types import GenomeSpec as JGenomeSpec
from repro.kernels import ga as j_ga
from repro.kernels.ga.common import GenerationSpec as JSpec
from repro.kernels.ga.common import selection_plan as j_plan
from repro_torch import convert, rand
from repro_torch.core import EAConfig, MigrationConfig, make_trap, run_fused
from repro_torch.core.types import GenomeSpec
from repro_torch.kernels.ga import autotune, get_kernel, ops
from repro_torch.kernels.ga.common import GenerationSpec as TSpec
from repro_torch.kernels.ga.common import selection_plan as t_plan
from repro_torch.kernels.ga.generation import untiled_smem_bytes

GENE_ATOL, FIT_RTOL, FIT_ATOL = 2e-6, 2e-4, 1e-3
TRAP = {"eval": "trap", "a": 1.0, "b": 2.0, "z": 3.0, "l": 4}

# (kind, length, crossover, tile_pop, tile_len, fused eval): a subset of
# the reference's TILED_CASES (tests/test_ga_kernels.py), grids of at least
# 2 x 2 x 2 where the shape allows, ragged genomes, and one fused eval of
# each kind
CASES = [
    ("binary", 23, "two_point", 16, 16, None),
    ("binary", 24, "uniform", 8, 24, TRAP),
    ("float", 16, "blend", 8, 8, None),
    ("float", 19, "uniform", 16, 8, None),
    ("float", 16, "blend", 8, 8, "f15"),
]


def _inputs(kind, n, length, seed):
    g = np.random.default_rng(seed)
    if kind == "binary":
        pop = (g.random((n, length)) < 0.5).astype(np.int8)
    else:
        pop = g.uniform(-5, 5, (n, length)).astype(np.float32)
    fit = (g.normal(size=n) * 10).astype(np.float32)
    return pop, fit


def _f15_fused(length, m):
    consts = {k: np.asarray(v) for k, v in make_f15_consts(
        jax.random.key(length), length, m).items()}
    return {"eval": "f15", "m": m, "n_groups": length // m}, consts


@pytest.mark.parametrize("n,pop_size", [(32, 19), (37, 30)])
@pytest.mark.parametrize("kind,length,crossover,tile_pop,tile_len,fused",
                         CASES)
def test_tiled_entry_matches_reference(kind, length, crossover, tile_pop,
                                       tile_len, fused, n, pop_size):
    jg = JGenomeSpec(kind, length, -5.0, 5.0)
    tg = GenomeSpec(kind, length, -5.0, 5.0)
    cfg = dict(max_pop=n, min_pop=8, crossover=crossover, mutation_rate=0.1)
    consts = None
    if fused == "f15":
        fused, consts = _f15_fused(length, 8)
    pop, fit = _inputs(kind, n, length, n + length)
    op = "generation" if fused is None else "generation_eval"
    extra = () if fused is None else (fused,)
    tiles = dict(tile_pop=tile_pop, tile_len=tile_len)

    j_kern = j_ga.get_kernel(op, kind, "pallas_tiled")
    want = j_kern(jax.random.key(11), jnp.asarray(pop), jnp.asarray(fit),
                  jnp.int32(pop_size), JEAConfig(**cfg), jg, *extra,
                  consts=(None if consts is None else
                          {k: jnp.asarray(v) for k, v in consts.items()}),
                  **tiles)
    t_kern = get_kernel(op, kind, "pallas_tiled")
    got = t_kern(rand.key(11)[None], torch.from_numpy(pop)[None],
                 torch.from_numpy(fit)[None], torch.tensor([pop_size]),
                 EAConfig(**cfg), tg, *extra,
                 consts=(None if consts is None
                         else convert.f15_consts_from_numpy(consts)),
                 **tiles)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    genes, j_genes = got[0][0].numpy(), np.asarray(want[0])
    if kind == "binary":
        np.testing.assert_array_equal(genes, j_genes)
    else:
        np.testing.assert_allclose(genes, j_genes, rtol=0, atol=GENE_ATOL)
    if fused is not None:
        np.testing.assert_allclose(got[1][0].numpy(), np.asarray(want[1]),
                                   rtol=FIT_RTOL, atol=FIT_ATOL)


N_ISLANDS, MAX_EPOCHS, SEED = 4, 3, 7
RUN_CFG = dict(max_pop=32, min_pop=16, generations_per_epoch=5)


def _jax_islands_np(islands):
    return jax.tree.map(np.asarray,
                        islands._replace(rng=jax.random.key_data(
                            islands.rng)))


def test_run_fused_pallas_tiled_matches_reference(tmp_path, monkeypatch):
    """trap 40x4, pool, W²: the port under impl='pallas_tiled' equals the
    reference's run under the same impl, field for field."""
    monkeypatch.setenv("REPRO_GA_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_ga.json"))
    cfg = dict(RUN_CFG, impl="pallas_tiled")
    with jax.threefry_partitionable(True):
        problem = j_trap(40, 4)
        jcfg = JEAConfig(**cfg)
        mig = JMigrationConfig(topology="pool")
        key = jax.random.key(SEED)
        k_init, k_loop = jax.random.split(key)
        islands0 = j_island.init_islands(k_init, N_ISLANDS, problem, jcfg)
        pool0 = j_pool.pool_init(mig.pool_capacity, problem.genome)
        j_isl, j_pool_s, j_epochs, j_stats = j_run_fused(
            problem, jcfg, mig, n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS,
            rng=key, w2=True, return_stats=True)
    init = JExperimentState(
        islands=_jax_islands_np(islands0),
        pool=jax.tree.map(np.asarray, pool0), astate=(),
        key=np.asarray(jax.random.key_data(k_loop)), epoch=np.int32(0),
        stopped=np.bool_(False), stats=(), next_uuid=np.int32(N_ISLANDS))

    islands, pool, epochs, stats = run_fused(
        make_trap(40, 4), EAConfig(**cfg), MigrationConfig(topology="pool"),
        n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS, w2=True,
        return_stats=True, device="cpu",
        state=convert.experiment_from_numpy(init))
    assert int(epochs) == int(j_epochs)
    for what, got, want in (
            ("islands", convert.to_numpy(islands), _jax_islands_np(j_isl)),
            ("pool", convert.to_numpy(pool),
             jax.tree.map(np.asarray, j_pool_s)),
            ("stats", convert.to_numpy(stats),
             jax.tree.map(np.asarray, j_stats))):
        for name, g, w in zip(want._fields, got, want):
            if name == "mean_best":   # an f32 mean: XLA's order
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=f"{what}.{name}")


def _spec(kind, length, fused=None, selection="tournament"):
    return TSpec(kind=kind, length=length, elite=2, selection=selection,
                 tournament_k=2,
                 crossover="blend" if kind == "float" else "two_point",
                 crossover_rate=0.9, mutation_rate=1.0 / length,
                 mutation_sigma=0.3,
                 fused_eval=(None if fused is None
                             else tuple(sorted(fused.items()))))


F15_1000 = {"eval": "f15", "m": 50, "n_groups": 20}
# the card's opt-in shared memory per block (H100)
H100_SMEM = 232_448


@pytest.mark.parametrize("n,length,fused,want", [
    (10_000, 1000, F15_1000, "tiled"),
    (1228, 160, TRAP, "tiled"),
    (1227, 160, TRAP, "untiled"),
    (365, 1000, F15_1000, "untiled"),
])
def test_route_follows_the_reference_budget(n, length, fused, want):
    kind = "binary" if fused is TRAP else "float"
    spec = _spec(kind, length, fused)
    assert ops.route(n, length, spec) == want
    # the reference's own estimate agrees
    from repro.kernels.ga import ops as j_ops
    assert (j_ops.untiled_vmem_bytes(n, length, JSpec(**{
        f: getattr(spec, f) for f in spec.__dataclass_fields__}))
        > j_ops.VMEM_BUDGET_BYTES) == (want == "tiled")


def test_route_sends_what_the_binary_kernel_cannot_hold_to_tiled():
    """The binary kernel holds both int8 tiles (348 B per row at L = 160):
    668-1227 rows overflow 232,448 B and go tiled on such a card."""
    spec = _spec("binary", 160, TRAP)
    assert untiled_smem_bytes(667, 160, spec) <= H100_SMEM
    assert untiled_smem_bytes(668, 160, spec) > H100_SMEM
    assert ops.route(667, 160, spec, H100_SMEM) == "untiled"
    for n in (668, 900, 1227):
        assert ops.route(n, 160, spec, H100_SMEM) == "tiled"
        assert ops.route(n, 160, spec) == "untiled"
    # the float kernel keeps a few rows only: the reference's budget rules
    fspec = _spec("float", 1000, F15_1000)
    assert untiled_smem_bytes(365, 1000, fspec) < H100_SMEM


def test_roulette_plan_above_the_selection_block():
    """n = 4200 > the reference's SELECTION_BLOCK (4096): the reference's
    blocked ``tril @ w`` CDF and the port's left-to-right scan differ by
    ulps, so a few parents differ (ROADMAP Queue C); the elite, cuts and
    gate are exact."""
    n = 4200
    fit = (np.random.default_rng(0).normal(size=n) * 10).astype(np.float32)
    kw = dict(kind="binary", length=160, elite=2, selection="roulette",
              tournament_k=2, crossover="two_point", crossover_rate=0.9,
              mutation_rate=1.0 / 160, mutation_sigma=0.3)
    want = jax.jit(lambda f: j_plan(jnp.uint32(0x1234), jnp.uint32(0x5678),
                                    f, jnp.int32(n), JSpec(**kw), n))(
        jnp.asarray(fit))
    got = t_plan(torch.tensor([[0x1234, 0x5678]]),
                 torch.from_numpy(fit)[None], torch.tensor([n]), TSpec(**kw),
                 n)
    for name, g, w in zip(got._fields, got, want):
        g, w = g[0].numpy(), np.asarray(w)
        if name in ("idx_a", "idx_b"):
            differ = int((g != w).sum())
            assert differ <= n * 0.005, (name, differ)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_autotune_cache_roundtrip(tmp_path):
    path = tmp_path / "autotune_ga.json"
    rows, tl = autotune.best_tiles(4096, 1024, "float", cache_path=path)
    assert rows in autotune.CANDIDATES and tl == 1024
    cache = autotune.load_cache(path)
    entry = cache[autotune.device_kind()][autotune.shape_key(4096, 1024,
                                                             "float")]
    assert (entry["tile_pop"], entry["tile_len"]) == (rows, tl)
    # the second call is served from the file
    assert autotune.best_tiles(4096, 1024, "float",
                               cache_path=path) == (rows, tl)
    summary = autotune.cache_summary(path)
    assert summary["path"] == str(path)
    assert autotune.device_kind() in summary["entries"]


def test_autotune_force_resweeps(tmp_path):
    path = tmp_path / "autotune_ga.json"
    autotune.save_cache({autotune.device_kind(): {
        autotune.shape_key(256, 256, "float"): {
            "tile_pop": 3, "tile_len": 256, "timed": False,
            "library": autotune.library_tag()}}}, path)
    assert autotune.best_tiles(256, 256, "float", cache_path=path) == (3, 256)
    rows, tl = autotune.best_tiles(256, 256, "float", cache_path=path,
                                   force=True)
    assert rows in autotune.CANDIDATES and tl == 256
    assert autotune.load_cache(path)[autotune.device_kind()][
        autotune.shape_key(256, 256, "float")]["tile_pop"] == rows


def test_autotune_redoes_an_entry_of_other_kernel_sources(tmp_path):
    """An entry recorded under another kernel library is chosen again and
    rewritten with this library's hash."""
    path = tmp_path / "autotune_ga.json"
    key = autotune.shape_key(256, 160, "binary")
    autotune.save_cache({autotune.device_kind(): {key: {
        "tile_pop": 3, "tile_len": 160, "timed": False,
        "library": "0" * 16}}}, path)
    rows, tl = autotune.best_tiles(256, 160, "binary", cache_path=path)
    assert (rows, tl) != (3, 160) and rows in autotune.CANDIDATES
    entry = autotune.load_cache(path)[autotune.device_kind()][key]
    assert entry["library"] == autotune.library_tag()
    assert entry["tile_pop"] == rows


def test_autotune_heuristic_gives_each_thread_work():
    assert autotune.heuristic_rows(160) == 8
    assert autotune.heuristic_rows(1000) == 2
    assert autotune.heuristic_rows(4) == autotune.CANDIDATES[-1]
