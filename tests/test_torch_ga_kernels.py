"""The port's plain GA generation against the reference's, bit for bit.

Same seed words, same population, same padded ``pop_size`` per island:
the new population and the fused fitness must be equal for every
selection x crossover x fused eval, against ``repro.kernels.ga.ref``
(jitted and vmapped over islands, the way the drivers run it) and, for two
cases, against the Pallas kernel itself in interpret mode. The roulette
prefix sum is XLA's jitted ``tril @ w`` in the reference and the
segmented scan of ``common.prefix_sum`` in the port, which is the
left-to-right scan up to 64 lanes: the two orders agreed below 50 lanes
on five seeds (ROADMAP Queue C), which covers the 32-lane populations
here.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import EAConfig as JEAConfig
from repro.core.types import GenomeSpec as JGenomeSpec
from repro.kernels.ga import ops as j_ops
from repro.kernels.ga import ref as j_ref
from repro.kernels.ga.common import GenerationSpec as JSpec
from repro.kernels.ga.generation import generation_kernel as j_kernel
from repro_torch.core.types import EAConfig, GenomeSpec
from repro_torch.kernels.ga import get_kernel, make_spec, registry
from repro_torch.kernels.ga import ref as t_ref
from repro_torch.kernels.ga.common import GenerationSpec as TSpec
from repro_torch.kernels.ga.generation import generation_kernel

N_ISLANDS, N = 3, 32
FUSED = {
    "none": None,
    "trap": (("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4), ("z", 3.0)),
    "onemax": (("eval", "onemax"),),
    "royal_road": (("eval", "royal_road"), ("r", 8)),
}


def _spec_kwargs(selection, crossover, fused, length=40, k=3):
    return dict(kind="binary", length=length, elite=2, selection=selection,
                tournament_k=k, crossover=crossover, crossover_rate=0.9,
                mutation_rate=1.0 / length, mutation_sigma=0.3,
                fused_eval=FUSED[fused])


def _inputs(seed, length):
    g = np.random.default_rng(seed)
    pop = (g.random((N_ISLANDS, N, length)) < 0.5).astype(np.int8)
    fit = (g.normal(size=(N_ISLANDS, N)) * 10).astype(np.float32)
    fit[0, :4] = fit[0, 4]                       # ties at the elite
    sizes = np.array([N, N // 2, 17], np.int32)  # padded lanes
    seeds = g.integers(0, 2**32, size=(N_ISLANDS, 2),
                       dtype=np.uint64).astype(np.uint32)
    return seeds, sizes, pop, fit


def _port(seeds, sizes, pop, fit, spec):
    out = t_ref.generation(torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(sizes), torch.from_numpy(pop),
                           torch.from_numpy(fit), spec)
    return tuple(t.numpy() for t in (out if isinstance(out, tuple)
                                     else (out,)))


def _assert_equal(got, want):
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("selection,crossover,fused", list(itertools.product(
    ("tournament", "roulette"), ("two_point", "uniform"), sorted(FUSED))))
def test_plain_generation_matches_reference(selection, crossover, fused):
    kw = _spec_kwargs(selection, crossover, fused)
    seeds, sizes, pop, fit = _inputs(len(selection) * 7 + len(crossover), 40)
    js = JSpec(**kw)
    run = jax.jit(jax.vmap(
        lambda s, z, p, f: j_ref.generation(s, z.reshape(1), p, f, js)))
    want = run(jnp.asarray(seeds), jnp.asarray(sizes), jnp.asarray(pop),
               jnp.asarray(fit))
    _assert_equal(_port(seeds, sizes, pop, fit, TSpec(**kw)), want)


@pytest.mark.parametrize("selection,crossover,fused", [
    ("tournament", "two_point", "trap"), ("roulette", "uniform", "none")])
def test_plain_generation_matches_interpret_kernel(selection, crossover,
                                                   fused):
    kw = _spec_kwargs(selection, crossover, fused, length=16, k=2)
    seeds, sizes, pop, fit = _inputs(5, 16)
    js = JSpec(**kw)
    want = [j_kernel(
        jnp.asarray(seeds[i]), jnp.asarray(sizes[i:i + 1]),
        jnp.asarray(pop[i]), jnp.asarray(fit[i]), js, interpret=True)
        for i in range(N_ISLANDS)]
    want = (tuple(np.stack([np.asarray(w[j]) for w in want])
                  for j in range(2)) if js.fused_eval is not None
            else np.stack([np.asarray(w) for w in want]))
    _assert_equal(_port(seeds, sizes, pop, fit, TSpec(**kw)), want)


def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    kw = _spec_kwargs("tournament", "uniform", "onemax")
    seeds, sizes, pop, fit = _inputs(11, 40)
    args = (torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(sizes),
            torch.from_numpy(pop), torch.from_numpy(fit), TSpec(**kw))
    for got, want in zip(generation_kernel(*args), t_ref.generation(*args)):
        assert torch.equal(got, want)


def test_make_spec_matches_reference():
    cfg = dict(max_pop=32, min_pop=16, selection="roulette",
               crossover="uniform", tournament_k=4)
    fused = {"eval": "trap", "a": 1.0, "b": 2.0, "z": 3.0, "l": 4}
    want = j_ops.make_spec(JEAConfig(**cfg), JGenomeSpec("binary", 40), fused)
    got = make_spec(EAConfig(**cfg), GenomeSpec("binary", 40), fused)
    assert dataclass_fields(got) == dataclass_fields(want)


def dataclass_fields(spec):
    return {f: getattr(spec, f) for f in spec.__dataclass_fields__}


def test_registry_names_what_is_not_ported():
    from repro_torch.core import ga as core_ga
    from repro_torch.core import migration
    from repro_torch.core.pool import pool_init
    for kind in ("binary", "float"):
        for op in ("generation", "generation_eval"):
            assert callable(get_kernel(op, kind, "pallas_tiled"))
        assert registry.available_impls("generation_eval", kind) == [
            "pallas", "pallas_ref", "pallas_tiled"]
        # the classic impl (Queue A item 8) is the table's "jnp" entry
        assert registry.available_impls("generation", kind) == [
            "jnp", "pallas", "pallas_ref", "pallas_tiled"]
        assert get_kernel("generation", kind,
                          "jnp") is core_ga.next_generation_jnp
    new_pop = get_kernel("generation", "binary", "jnp")(
        torch.zeros((2, 2), dtype=torch.int64),
        torch.zeros((2, 6, 8), dtype=torch.int8), torch.zeros((2, 6)),
        torch.tensor([6, 3], dtype=torch.int32), EAConfig(),
        GenomeSpec("binary", 8))
    assert new_pop.shape == (2, 6, 8) and new_pop.dtype == torch.int8
    # the async runtime's per-island fire mask (Queue A item 10) runs:
    # only the firing island PUTs and GETs, as in the reference
    from repro.core import migration as j_migration
    from repro.core import pool as j_pool
    from repro_torch import convert
    genome = GenomeSpec("binary", 8)
    bests = np.array([[1, 0, 1, 1, 0, 0, 1, 0], [0] * 8], np.int8)
    fits = np.array([3.0, 5.0], np.float32)
    got = migration.migrate(pool_init(4, genome, device="cpu"),
                            torch.from_numpy(bests), torch.from_numpy(fits),
                            torch.zeros(2, dtype=torch.int64),
                            migration.MigrationConfig(),
                            available=torch.tensor([True, False]))
    with jax.threefry_partitionable(True):
        want = j_migration.migrate(
            j_pool.pool_init(4, JGenomeSpec("binary", 8)),
            jnp.asarray(bests), jnp.asarray(fits),
            jax.random.wrap_key_data(jnp.zeros(2, jnp.uint32)),
            j_migration.MigrationConfig(),
            available=jnp.asarray([True, False]))
    assert int(got[0].count) == int(want[0].count) == 1
    for g, w in zip(convert.to_numpy(got[0]) + tuple(
            convert.to_numpy(t) for t in got[1:]),
            tuple(want[0]) + tuple(want[1:])):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(KeyError):
        get_kernel("generation", "binary", "no_such_impl")
    spec = TSpec(kind="float", length=8, elite=1, selection="tournament",
                 tournament_k=2, crossover="blend", crossover_rate=0.9,
                 mutation_rate=0.1, mutation_sigma=0.3,
                 fused_eval=(("eval", "f15"), ("m", 4), ("n_groups", 2)))
    with pytest.raises(ValueError, match="needs problem consts"):
        t_ref.generation(torch.zeros((1, 2), dtype=torch.int64),
                         torch.ones(1, dtype=torch.int32),
                         torch.zeros((1, 4, 8)), torch.zeros((1, 4)), spec)


# ---------------------------------------------------------------------------
# float genomes: blend crossover, gaussian mutation, the float fused evals
# ---------------------------------------------------------------------------
F_LEN, F_M = 64, 8
FLOAT_FUSED = {
    "none": None,
    "rastrigin": (("eval", "rastrigin"),),
    "sphere": (("eval", "sphere"),),
    "f15": (("eval", "f15"), ("m", F_M), ("n_groups", F_LEN // F_M)),
}
# genes: FMA contraction and XLA's log/cos against PyTorch's (Queue C);
# fitness: the reference's own fused-eval tolerance
GENE_ATOL = 2e-6
FIT_RTOL, FIT_ATOL = 2e-4, 1e-3


def _float_spec_kwargs(selection, crossover, fused):
    return dict(kind="float", length=F_LEN, elite=2, selection=selection,
                tournament_k=2, crossover=crossover, crossover_rate=0.9,
                mutation_rate=0.1, mutation_sigma=0.3, low=-5.0, high=5.0,
                fused_eval=FLOAT_FUSED[fused])


def _float_inputs(seed):
    g = np.random.default_rng(seed)
    pop = g.uniform(-5, 5, (N_ISLANDS, N, F_LEN)).astype(np.float32)
    fit = (g.normal(size=(N_ISLANDS, N)) * 100).astype(np.float32)
    fit[1, :3] = fit[1, 3]                       # ties at the elite
    sizes = np.array([N, N // 2, 17], np.int32)  # padded lanes
    seeds = g.integers(0, 2**32, size=(N_ISLANDS, 2),
                       dtype=np.uint64).astype(np.uint32)
    return seeds, sizes, pop, fit


@pytest.fixture(scope="module")
def f15_consts():
    from repro.core.problems import make_f15_consts
    c = make_f15_consts(jax.random.key(15), F_LEN, F_M)
    return {k: np.asarray(v) for k, v in c.items()}


@pytest.mark.parametrize("selection,crossover,fused", list(itertools.product(
    ("tournament", "roulette"), ("two_point", "uniform", "blend"),
    sorted(FLOAT_FUSED))))
def test_plain_float_generation_matches_reference(selection, crossover,
                                                  fused, f15_consts):
    from repro.kernels.ga.common import selection_plan as j_plan
    from repro_torch import convert
    from repro_torch.kernels.ga.common import selection_plan as t_plan
    kw = _float_spec_kwargs(selection, crossover, fused)
    seeds, sizes, pop, fit = _float_inputs(len(selection) + len(crossover))
    js, ts = JSpec(**kw), TSpec(**kw)
    consts = f15_consts if fused == "f15" else None
    jc = None if consts is None else {k: jnp.asarray(v)
                                      for k, v in consts.items()}
    tc = None if consts is None else convert.f15_consts_from_numpy(
        consts, "cpu")
    run = jax.jit(jax.vmap(lambda s, z, p, f: j_ref.generation(
        s, z.reshape(1), p, f, js, consts=jc)))
    want = run(jnp.asarray(seeds), jnp.asarray(sizes), jnp.asarray(pop),
               jnp.asarray(fit))
    want = want if isinstance(want, tuple) else (want,)
    t_seeds = torch.from_numpy(seeds.astype(np.int64))
    got = t_ref.generation(t_seeds, torch.from_numpy(sizes),
                           torch.from_numpy(pop), torch.from_numpy(fit), ts,
                           tc)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)

    # the plan and its integer fields: exact (the plan does not depend on
    # the fused eval, so one case of each selection x crossover holds it)
    plan_t = t_plan(t_seeds, torch.from_numpy(fit), torch.from_numpy(sizes),
                    ts, N)
    if fused == "none":
        plan_j = jax.jit(jax.vmap(lambda s, f, z: j_plan(
            s[0], s[1], f, z, js, N)))(jnp.asarray(seeds), jnp.asarray(fit),
                                       jnp.asarray(sizes))
        for name, a, b in zip(plan_t._fields, plan_t, plan_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"plan.{name}")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=GENE_ATOL)
    if fused != "none":
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    # elite rows pass through; child rows stay in bounds
    idx = plan_t.idx_a.long()[:, :2, None].expand(-1, -1, F_LEN)
    assert torch.equal(got[0][:, :2], torch.gather(torch.from_numpy(pop), 1,
                                                   idx))
    assert float(got[0].abs().max()) <= 5.0


# ---------------------------------------------------------------------------
# the elite: what the kernels' parallel arg-max must reproduce
# ---------------------------------------------------------------------------
def _elite_inputs(seed):
    """Five islands of N lanes: every lane masked (pop_size 0), one valid
    lane (pop_size 1), the whole population tied, every valid lane -inf,
    and random fitness with runs of ties and -inf lanes among the valid."""
    g = np.random.default_rng(seed)
    fit = (g.normal(size=(5, N)) * 10).astype(np.float32)
    fit[2] = 3.5
    fit[3] = -np.inf
    fit[4, 3:9] = fit[4, 20]
    fit[4, [1, 11]] = -np.inf
    sizes = np.array([0, 1, N, N, N - 5], np.int32)
    seeds = g.integers(0, 2**32, size=(5, 2),
                       dtype=np.uint64).astype(np.uint32)
    return seeds, sizes, fit


@pytest.mark.parametrize("selection", ["tournament", "roulette"])
@pytest.mark.parametrize("elite", [0, 1, 2, 3, 4])
def test_elite_plan_matches_reference(selection, elite):
    """The port's plain selection plan, the elite rows first, against the
    reference's: all-masked islands (row 0 picked again and again), ties
    across the whole population (the lowest rows), pop_size 1, elite
    0-4."""
    from repro.kernels.ga.common import selection_plan as j_plan
    from repro_torch.kernels.ga.common import selection_plan as t_plan
    kw = dict(_spec_kwargs(selection, "two_point", "none"), elite=elite)
    seeds, sizes, fit = _elite_inputs(elite * 2 + len(selection))
    want = jax.jit(jax.vmap(lambda s, f, z: j_plan(
        s[0], s[1], f, z, JSpec(**kw), N)))(
            jnp.asarray(seeds), jnp.asarray(fit), jnp.asarray(sizes))
    got = t_plan(torch.from_numpy(seeds.astype(np.int64)),
                 torch.from_numpy(fit), torch.from_numpy(sizes), TSpec(**kw),
                 N)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"plan.{name}")
    top = got.idx_a[:, :elite].numpy()
    if elite:
        assert (top[0] == 0).all() and (top[3] == 0).all()
        assert (top[1] == 0).all()
        assert top[2].tolist() == list(range(elite))


# ---------------------------------------------------------------------------
# the untiled kernels' launch shapes and shared memory (pure Python)
# ---------------------------------------------------------------------------
H100_SMEM = 232_448


def _first_design_smem(kind, n, length, elite):
    """The first untiled kernels' shared memory: both int8 tiles and seven
    words a row (binary); four rows of two f32 buffers (float)."""
    if kind == "binary":
        return n * 7 * 4 + 2 * n * length
    return (2 * n + elite + 20) * 4 + 2 * 4 * length * 4


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_untiled_islands_of_the_first_design_stay_untiled(kind):
    """Every (n, L) the first design ran untiled on an H100 still routes
    untiled, within 232,448 B of shared memory."""
    import importlib

    from repro_torch.kernels.ga import ops
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    lengths = list(range(1, 70)) + list(range(70, 130_000, 251))
    sizes = list(range(1, 40)) + list(range(40, 1300, 13))
    checked = 0
    for length in lengths:
        for n in sizes:
            elite = min(n, 2)
            spec = TSpec(kind=kind, length=length, elite=elite,
                         selection="tournament", tournament_k=2,
                         crossover="two_point", crossover_rate=0.9,
                         mutation_rate=0.1, mutation_sigma=0.3)
            if (_first_design_smem(kind, n, length, elite) > H100_SMEM
                    or ops.route(n, length, spec) == "tiled"):
                continue
            checked += 1
            assert gen_k.untiled_smem_bytes(n, length, spec,
                                            H100_SMEM) <= H100_SMEM, \
                (n, length)
            assert ops.route(n, length, spec, H100_SMEM) == "untiled"
    assert checked > 1000


def test_launch_shapes():
    """The binary kernel's CTAs per island and the float kernel's rows per
    block, and the shared memory the C launchers size for them."""
    import importlib
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    assert gen_k.cluster_size(256) == gen_k.CLUSTER == 16
    assert gen_k.cluster_size(17) == gen_k.cluster_size(16) == 16
    assert gen_k.cluster_size(5) == 5
    assert gen_k.cluster_size(1) == 1
    # paper-8's island at 16 CTAs: 16 rows each; the barrier, masked, cum,
    # the elite, the arg-max scratch and the plan (626 words), then the
    # 40,960-byte tile and its 32 bytes of slack
    assert gen_k.binary_smem_bytes(256, 160, 2) == 2512 + 40960 + 32
    # a 5-row island: 5 CTAs of one row each (49 words, 208 bytes)
    assert gen_k.binary_smem_bytes(5, 40, 2) == 208 + 200 + 32
    # paper-f15-8's block at 4 rows: two 4 x 1000 f32 buffers and 566 words
    assert gen_k.float_rows(256, 1000, 2, H100_SMEM) == gen_k.FLOAT_ROWS == 4
    assert gen_k.float_smem_bytes(256, 1000, 2, 4) == 32000 + 4 * (
        512 + 2 + 32 + 20)
    # wide genomes take fewer rows on the card: two rows x L f32 buffers
    # fill at most its shared memory per block; without a card, no limit
    for length, rows in ((3000, 4), (7000, 4), (7300, 2), (14000, 2),
                         (14600, 1), (28000, 1)):
        assert gen_k.float_rows(64, length, 2, H100_SMEM) == rows
        assert gen_k.float_smem_bytes(64, length, 2, rows) <= H100_SMEM
        assert gen_k.float_rows(64, length, 2, None) == gen_k.FLOAT_ROWS
    # the card's own limit decides: a smaller one halves sooner
    assert gen_k.float_rows(64, 3000, 2, 90_000) == 2
