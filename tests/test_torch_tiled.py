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
from repro_torch.kernels.ga import autotune, common, get_kernel, ops, tiling
from repro_torch.kernels.ga.common import GenerationSpec as TSpec
from repro_torch.kernels.ga.common import masked_fitness
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
                         else convert.f15_consts_from_numpy(consts,
                                                              "cpu")),
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


# (kind, length, crossover, fused eval): genomes whose rows are not a
# multiple of the tiled kernel's 16-byte pack (1003 f32, 157 int8), so the
# card takes its scalar route
EDGE_CASES = [
    ("float", 1003, "blend", None),
    ("float", 1003, "uniform", {"eval": "rastrigin"}),
    ("binary", 157, "two_point", {"eval": "onemax"}),
    ("binary", 157, "uniform", None),
]


@pytest.mark.parametrize("selection", ["tournament", "roulette"])
@pytest.mark.parametrize("kind,length,crossover,fused", EDGE_CASES)
def test_tiled_entry_edges_match_reference(kind, length, crossover, fused,
                                           selection):
    """The tiled entry at the tiled kernel's edges against the reference's:
    rows off the 16-byte pack, 3 elite rows (over blocks of 1 and 2 rows
    on the card), pop_size below n, tournament and roulette."""
    n, pop_size = 24, 19
    jg = JGenomeSpec(kind, length, -5.0, 5.0)
    tg = GenomeSpec(kind, length, -5.0, 5.0)
    cfg = dict(max_pop=n, min_pop=8, crossover=crossover, mutation_rate=0.05,
               elite=3, selection=selection)
    pop, fit = _inputs(kind, n, length, length + n)
    fit[4:7] = fit[2]                                # ties at the elite
    op = "generation" if fused is None else "generation_eval"
    extra = () if fused is None else (fused,)
    tiles = dict(tile_pop=8, tile_len=256)

    j_kern = j_ga.get_kernel(op, kind, "pallas_tiled")
    want = jax.jit(lambda p, f: j_kern(
        jax.random.key(5), p, f, jnp.int32(pop_size), JEAConfig(**cfg), jg,
        *extra, interpret=True, **tiles))(jnp.asarray(pop), jnp.asarray(fit))
    got = get_kernel(op, kind, "pallas_tiled")(
        rand.key(5)[None], torch.from_numpy(pop)[None],
        torch.from_numpy(fit)[None], torch.tensor([pop_size]),
        EAConfig(**cfg), tg, *extra, **tiles)
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


def _block_plan(seed, size, fit, spec, rows):
    """The selection plan as the tiled kernel's blocks draw it: block b
    takes output rows [b rows, (b + 1) rows); only a block whose rows start
    below ``elite`` finds the elite (the iterative masked arg-max); each
    child row elite + c draws plan_rows.cuh::child_row_plan's counters (c k
    + j per tournament, c for a roulette draw and the gate, 2c and 2c + 1
    for the cuts) from the island's masked fitness, or searches the CDF of
    the CDF kernel's wrapper under roulette."""
    n_isl, n = fit.shape
    k0, k1 = seed[:, 0].reshape(-1, 1, 1), seed[:, 1].reshape(-1, 1, 1)
    masked = masked_fitness(fit, size)
    maxval = torch.clamp(size, min=1).to(torch.int64).reshape(-1, 1, 1)
    cum = tiling.roulette_cdf(size, fit)
    isl = torch.arange(n_isl)[:, None]
    blocks = []
    for row0 in range(0, n, rows):
        rr = range(row0, min(row0 + rows, n))
        elite = []
        if row0 < spec.elite:
            tmp = masked.clone()
            for _ in range(spec.elite):
                elite.append(tmp.argmax(-1))
                tmp[torch.arange(n_isl), elite[-1]] = float("-inf")
        e_rows = [r for r in rr if r < spec.elite]
        c0, n_c = max(row0, spec.elite) - spec.elite, len(rr) - len(e_rows)
        par = []
        for salt in (common.SALT_SELECT_A, common.SALT_SELECT_B):
            if spec.selection == "tournament":
                cand = rand.randint(k0, k1, (n_c, spec.tournament_k), maxval,
                                    salt, offset=(c0, 0)).long()
                f = masked[isl[:, :, None], cand]
                par.append(torch.gather(cand, 2, f.argmax(-1, keepdim=True))
                           [..., 0])
            else:
                u = rand.uniform(k0, k1, (n_c, 1), salt,
                                 offset=(c0, 0))[..., 0] * cum[:, -1:]
                idx = (cum[:, None, :] <= u[:, :, None]).sum(-1)
                par.append(torch.minimum(idx, maxval[:, :, 0] - 1))
        if spec.crossover == "two_point":
            cuts = rand.randint(k0, k1, (n_c, 2), spec.length + 1,
                                common.SALT_CROSSOVER, offset=(c0, 0))
            c1, c2 = cuts.amin(-1), cuts.amax(-1)
        else:
            c1 = c2 = torch.zeros((n_isl, n_c), dtype=torch.int32)
        gate = rand.bernoulli(k0, k1, (n_c, 1), spec.crossover_rate,
                              common.SALT_CROSSOVER_GATE,
                              offset=(c0, 0))[..., 0]
        e = torch.stack([elite[r] for r in e_rows], -1) if e_rows else \
            torch.zeros((n_isl, 0), dtype=torch.int64)
        z = torch.zeros_like(e)
        blocks.append([torch.cat([a, b.to(torch.int64)], 1) for a, b in (
            (e, par[0]), (e, par[1]), (z, c1), (z, c2), (z, gate))])
    return common.SelectionPlan(*(torch.cat(f, 1).to(torch.int32)
                                  for f in zip(*blocks)))


@pytest.mark.parametrize("selection,crossover", [("tournament", "two_point"),
                                                 ("roulette", "uniform")])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_block_decomposition_draws_the_whole_plan(rows, selection,
                                                  crossover):
    """Each block's rows' plan, the elite only in blocks below it, is the
    whole-island plan (``common.selection_plan``), bit for bit: 3 elite
    rows over 3 blocks of 1 row or 2 blocks of 3, ties at the elite, lanes
    past pop_size, and a 0-size island."""
    g = torch.Generator().manual_seed(rows)
    n_isl, n = 3, 29
    spec = TSpec(kind="binary", length=40, elite=3, selection=selection,
                 tournament_k=3, crossover=crossover, crossover_rate=0.9,
                 mutation_rate=0.05, mutation_sigma=0.3)
    fit = torch.randn(n_isl, n, generator=g) * 10
    fit[0, 4:8] = fit[0, 1]
    size = torch.tensor([20, n, 0], dtype=torch.int32)
    seed = torch.randint(0, 2**32, (n_isl, 2), generator=g,
                         dtype=torch.int64)
    got = _block_plan(seed, size, fit, spec, rows)
    want = t_plan(seed, fit, size, spec, n)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


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
        state=convert.experiment_from_numpy(init, device="cpu"))
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
    """Each CTA of the binary kernel holds the island's int8 tile (about
    1 kB per row at L = 1000, and the plan of its rows): 231-584 rows
    overflow 232,448 B and go tiled on such a card, where the reference's
    budget alone would run them untiled. At L = 160 the kernel holds every
    island the budget leaves untiled (up to 1227 rows)."""
    spec = _spec("binary", 1000, TRAP)
    assert untiled_smem_bytes(229, 1000, spec) <= H100_SMEM
    assert untiled_smem_bytes(231, 1000, spec) > H100_SMEM
    assert ops.route(229, 1000, spec, H100_SMEM) == "untiled"
    for n in (231, 400, 584):
        assert ops.route(n, 1000, spec, H100_SMEM) == "tiled"
        assert ops.route(n, 1000, spec) == "untiled"
    assert ops.route(585, 1000, spec) == "tiled"
    spec = _spec("binary", 160, TRAP)
    for n in (667, 668, 1227):
        assert untiled_smem_bytes(n, 160, spec) <= H100_SMEM
        assert ops.route(n, 160, spec, H100_SMEM) == "untiled"
    # the float kernel keeps a few rows only: the reference's budget rules
    fspec = _spec("float", 1000, F15_1000)
    assert untiled_smem_bytes(365, 1000, fspec) < H100_SMEM


def test_roulette_plan_above_the_selection_block():
    """n = 4200 > the reference's SELECTION_BLOCK (4096): the reference's
    blocked ``tril @ w`` CDF and the port's segmented scan
    (``common.prefix_sum``) differ by ulps, so a parent may differ (ROADMAP
    Queue C); the elite, cuts and gate are exact."""
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
