"""The classic operators (``repro_torch.core.ga``, ``impl="jnp"``) against
the reference's ``repro.core.ga``, vmapped over the islands and jitted as
its drivers run it.

The inputs are 3 islands of 64 lanes with pop_sizes 64, 29 and 0 (the
last all masked), seeded numpy key words, genomes and fitness; the
fitness is drawn from a few integer levels so that ties are common.
Tolerances:

* bit for bit: ``mask_fitness``, tournament selection, two-point and
  uniform crossover, the crossover rate gate, bit-flip mutation, blend
  crossover (one fused multiply-add in both), the elite, and
  ``next_generation_jnp`` on binary genomes under tournament;
* roulette (Gumbel, two ``log``s of which XLA's CPU code rounds about 6 %
  an ulp away from the correctly rounded value the port computes): at
  most 0.5 % of the drawn parents differ, as tests/test_torch_tiled.py
  holds the kernels' roulette;
  ``roulette_logits`` within 1 ulp (rtol 1.2e-7);
* gaussian mutation (``erf_inv`` through ``log1p``): genes within atol
  1e-6 (an ulp of a gene near the bounds is 4.8e-7); the hit mask is
  exact.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ga as j_ga
from repro.core.types import EAConfig as JEAConfig
from repro.core.types import GenomeSpec as JGenomeSpec
from repro_torch.core import ga
from repro_torch.core.types import EAConfig, GenomeSpec
from repro_torch.kernels.ga import get_kernel, registry

I, N, L_BIN, L_FLT = 3, 64, 40, 24
POP_SIZES = np.array([64, 29, 0], np.int32)
ROULETTE_MAX_FRACTION = 0.005
GAUSS_ATOL = 1e-6
LOGIT_RTOL = 1.2e-7


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


def _inputs(seed, kind):
    g = np.random.default_rng(seed)
    words = g.integers(0, 2**32, (I, 2), dtype=np.uint64).astype(np.uint32)
    if kind == "binary":
        pop = g.integers(0, 2, (I, N, L_BIN)).astype(np.int8)
    else:
        pop = g.uniform(-5, 5, (I, N, L_FLT)).astype(np.float32)
    fit = (g.integers(0, 6, (I, N)) * 1.5).astype(np.float32)
    fit[1, :5] = 9.0          # a tie at the top of island 1
    return words, pop, fit


def _jkeys(words):
    return jax.random.wrap_key_data(jnp.asarray(words))


def _tkeys(words):
    return torch.from_numpy(words.astype(np.int64))


def _vmapped(fn):
    return jax.jit(jax.vmap(fn))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_mask_fitness_bit_equal():
    _, _, fit = _inputs(0, "binary")
    want = _vmapped(j_ga.mask_fitness)(fit, POP_SIZES)
    got = ga.mask_fitness(_t(fit), _t(POP_SIZES))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(torch.isinf(got[2]).all())


@pytest.mark.parametrize("k", [2, 3])
def test_tournament_select_bit_equal(k):
    words, _, fit = _inputs(1, "binary")
    masked = np.asarray(_vmapped(j_ga.mask_fitness)(fit, POP_SIZES))
    want = _vmapped(lambda key, f, s: j_ga.tournament_select(
        key, f, s, N - 2, k))(_jkeys(words), masked, POP_SIZES)
    got = ga.tournament_select(_tkeys(words), _t(masked), _t(POP_SIZES),
                               N - 2, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[2] == 0).all())       # all masked: lane 0


def test_roulette_within_stated_count():
    words, _, _ = _inputs(2, "binary")
    g = np.random.default_rng(2)
    fit = (g.normal(size=(I, N)) * 10).astype(np.float32)
    want_l = np.asarray(_vmapped(j_ga.roulette_logits)(fit, POP_SIZES))
    got_l = ga.roulette_logits(_t(fit), _t(POP_SIZES)).numpy()
    np.testing.assert_array_equal(np.isinf(got_l), np.isinf(want_l))
    fin = np.isfinite(want_l)
    np.testing.assert_allclose(got_l[fin], want_l[fin], rtol=LOGIT_RTOL)
    draws = 4000
    want = np.asarray(_vmapped(lambda key, f, s: j_ga.roulette_select(
        key, f, s, draws))(_jkeys(words), fit, POP_SIZES))
    got = ga.roulette_select(_tkeys(words), _t(fit), _t(POP_SIZES),
                             draws).numpy()
    differ = int((got != want).sum())
    assert differ <= ROULETTE_MAX_FRACTION * want.size, differ
    assert (got[1] < POP_SIZES[1]).all() and (got[2] == 0).all()


@pytest.mark.parametrize("op", ["two_point", "uniform"])
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_crossover_bit_equal(op, kind):
    words, pa, _ = _inputs(3, kind)
    _, pb, _ = _inputs(4, kind)
    fn = {"two_point": (j_ga.two_point_crossover, ga.two_point_crossover),
          "uniform": (j_ga.uniform_crossover, ga.uniform_crossover)}[op]
    want = _vmapped(fn[0])(_jkeys(words), pa, pb)
    got = fn[1](_tkeys(words), _t(pa), _t(pb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blend_crossover_bit_equal():
    words, pa, _ = _inputs(5, "float")
    _, pb, _ = _inputs(6, "float")
    want = _vmapped(j_ga.blend_crossover)(_jkeys(words), pa, pb)
    got = ga.blend_crossover(_tkeys(words), _t(pa), _t(pb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op,kind", [("two_point", "binary"),
                                     ("uniform", "binary"),
                                     ("blend", "float")])
def test_crossover_rate_gate_bit_equal(op, kind):
    words, pa, _ = _inputs(7, kind)
    _, pb, _ = _inputs(8, kind)
    length = pa.shape[-1]
    kw = dict(crossover=op, crossover_rate=0.5)
    jg, tg = JGenomeSpec(kind, length), GenomeSpec(kind, length)
    want = np.asarray(_vmapped(lambda key, a, b: j_ga.crossover(
        key, a, b, JEAConfig(**kw), jg))(_jkeys(words), pa, pb))
    got = ga.crossover(_tkeys(words), _t(pa), _t(pb), EAConfig(**kw),
                       tg).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (got == pa).all(-1)
    assert 0 < kept.mean() < 1          # the gate is on for some rows only


def test_bit_flip_mutation_bit_equal():
    words, pop, _ = _inputs(9, "binary")
    jg, tg = JGenomeSpec("binary", L_BIN), GenomeSpec("binary", L_BIN)
    kw = dict(mutation_rate=0.1)
    want = _vmapped(lambda key, p: j_ga.mutate(key, p, JEAConfig(**kw), jg))(
        _jkeys(words), pop)
    got = ga.mutate(_tkeys(words), _t(pop), EAConfig(**kw), tg)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gaussian_mutation_within_atol():
    words, pop, _ = _inputs(10, "float")
    pop[0, 0, :4] = [5.0, -5.0, 4.99, -4.99]       # clipped at the bounds
    jg, tg = JGenomeSpec("float", L_FLT), GenomeSpec("float", L_FLT)
    kw = dict(mutation_rate=0.3, mutation_sigma=0.3)
    want = np.asarray(_vmapped(lambda key, p: j_ga.mutate(
        key, p, JEAConfig(**kw), jg))(_jkeys(words), pop))
    got = ga.mutate(_tkeys(words), _t(pop), EAConfig(**kw), tg).numpy()
    np.testing.assert_array_equal(got == pop, want == pop)   # the hit mask
    np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_ATOL)
    assert got.min() >= -5.0 and got.max() <= 5.0


def _generation(words, pop, fit, kw, kind):
    length = pop.shape[-1]
    jg, tg = JGenomeSpec(kind, length), GenomeSpec(kind, length)
    want = np.asarray(_vmapped(lambda key, p, f, s: j_ga.next_generation_jnp(
        key, p, f, s, JEAConfig(**kw), jg))(_jkeys(words), pop, fit,
                                           POP_SIZES))
    got = ga.next_generation_jnp(_tkeys(words), _t(pop), _t(fit),
                                 _t(POP_SIZES), EAConfig(**kw), tg).numpy()
    return got, want


@pytest.mark.parametrize("crossover", ["two_point", "uniform"])
@pytest.mark.parametrize("elite", [0, 2, 5])
def test_next_generation_binary_tournament_bit_equal(crossover, elite):
    words, pop, fit = _inputs(11 + elite, "binary")
    got, want = _generation(words, pop, fit, dict(
        crossover=crossover, elite=elite, tournament_k=2), "binary")
    np.testing.assert_array_equal(got, want)


def test_elite_takes_the_lowest_index_on_ties():
    words, pop, fit = _inputs(20, "binary")
    fit[0] = 3.0                                     # every lane tied
    pop = np.broadcast_to(np.arange(N, dtype=np.int8)[None, :, None],
                          pop.shape).copy()           # a lane's id as genes
    got, want = _generation(words, pop, fit, dict(elite=4), "binary")
    np.testing.assert_array_equal(got, want)
    assert got[0, :4, 0].tolist() == [0, 1, 2, 3]
    assert got[1, :4, 0].tolist() == [0, 1, 2, 3]    # the 9.0 tie on 0-4
    assert got[2, :4, 0].tolist() == [0, 1, 2, 3]    # all masked


@pytest.mark.parametrize("kind", ["binary", "float"])
def test_next_generation_roulette_within_stated_count(kind):
    words, pop, _ = _inputs(21, kind)
    fit = (np.random.default_rng(21).normal(size=(I, N)) * 10).astype(
        np.float32)
    kw = dict(selection="roulette", crossover="uniform")
    if kind == "float":
        kw.update(mutation_rate=0.0)      # gaussian genes held elsewhere
    got, want = _generation(words, pop, fit, kw, kind)
    rows = (got != want).any(-1)
    assert rows.sum() <= 2 * ROULETTE_MAX_FRACTION * rows.size + 2, rows.sum()


def test_next_generation_float_tournament_within_atol():
    words, pop, fit = _inputs(22, "float")
    got, want = _generation(words, pop, fit, dict(
        crossover="blend", mutation_sigma=0.3, mutation_rate=0.2), "float")
    np.testing.assert_allclose(got, want, rtol=0, atol=GAUSS_ATOL)


def test_registry_holds_the_classic_path():
    for kind in ("binary", "float"):
        assert get_kernel("generation", kind, "jnp") is ga.next_generation_jnp
        assert ("generation", kind, "jnp") in registry.registered_kernels()
    assert "jnp" in registry.available_impls("generation", "binary")

    @registry.register_kernel("generation", "binary", "test_custom")
    def custom(rng, pop, fitness, pop_size, cfg, genome):
        return pop

    try:
        words, pop, fit = _inputs(23, "binary")
        out = ga.next_generation(_tkeys(words), _t(pop), _t(fit),
                                 _t(POP_SIZES), EAConfig(impl="test_custom"),
                                 GenomeSpec("binary", L_BIN))
        assert torch.equal(out, _t(pop))
    finally:
        registry.KERNELS.pop(("generation", "binary", "test_custom"))
