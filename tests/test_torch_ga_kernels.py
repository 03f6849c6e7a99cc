"""The port's plain GA generation against the reference's, bit for bit.

Same seed words, same population, same padded ``pop_size`` per island:
the new population and the fused fitness must be equal for every
selection x crossover x fused eval, against ``repro.kernels.ga.ref``
(jitted and vmapped over islands, the way the drivers run it) and, for two
cases, against the Pallas kernel itself in interpret mode. The roulette
prefix sum is XLA's jitted ``tril @ w`` in the reference and a
left-to-right scan in the port: the two orders agree up to 33 lanes, which
covers the 32-lane populations here.
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
    for kind in ("binary", "float"):
        for op in ("generation", "generation_eval"):
            assert registry.available_impls(op, kind) == [
                "pallas", "pallas_ref", "pallas_tiled"]
            assert callable(get_kernel(op, kind, "pallas_tiled"))
        with pytest.raises(NotImplementedError, match="Queue A item 8"):
            get_kernel("generation", kind, "jnp")
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
    tc = None if consts is None else convert.f15_consts_from_numpy(consts)
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
