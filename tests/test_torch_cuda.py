"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel must be bit-equal to its plain version: trap fitness, F15,
and the generation kernel on binary and on float genomes.
"""
import importlib
import itertools

import pytest
import torch

from repro_torch.kernels.ga import ref as gen_ref
from repro_torch.kernels.ga.common import GenerationSpec
from repro_torch.kernels.rastrigin import f15 as f15_k
from repro_torch.kernels.rastrigin import ref as f15_ref
from repro_torch.kernels.trap import ref as trap_ref
from repro_torch.kernels.trap import trap as trap_k

pytestmark = pytest.mark.cuda
CONSTS = {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return torch.device("cuda")


@pytest.mark.parametrize("n,n_traps", [(2048, 40), (1000, 40), (77, 8)])
def test_trap_kernel_bit_equal(card, n, n_traps):
    g = torch.Generator().manual_seed(n)
    pop = (torch.rand(n, n_traps * 4, generator=g) < 0.6).to(torch.int8)
    pop = pop.to(card)
    got = trap_k.trap_fitness(CONSTS, pop, n_traps=n_traps)
    want = trap_ref.trap_fitness(pop, n_traps=n_traps, l=4, a=1.0, b=2.0,
                                 z=3.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("selection", ["tournament", "roulette"])
@pytest.mark.parametrize("crossover", ["two_point", "uniform"])
def test_generation_kernel_bit_equal(card, selection, crossover):
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    g = torch.Generator().manual_seed(7)
    n_isl, n, length = 4, 64, 40
    spec = GenerationSpec(
        kind="binary", length=length, elite=2, selection=selection,
        tournament_k=3, crossover=crossover, crossover_rate=0.9,
        mutation_rate=1.0 / length, mutation_sigma=0.3,
        fused_eval=(("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4),
                    ("z", 3.0)))
    pop = (torch.rand(n_isl, n, length, generator=g) < 0.5).to(torch.int8)
    fit = torch.randn(n_isl, n, generator=g)
    size = torch.randint(32, n + 1, (n_isl,), generator=g, dtype=torch.int32)
    seed = torch.randint(0, 2**32, (n_isl, 2), generator=g,
                         dtype=torch.int64)
    args = [t.to(card) for t in (seed, size, pop, fit)]
    got = gen_k.generation_kernel(*args, spec)
    want = gen_ref.generation(*args, spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _f15_consts(dim, m, g, card):
    q, _ = torch.linalg.qr(torch.randn(dim // m, m, m, generator=g,
                                       dtype=torch.float64))
    return {"o": (torch.rand(dim, generator=g) * 10 - 5).to(card),
            "perm": torch.randperm(dim, generator=g).to(torch.int32).to(card),
            "M": q.to(torch.float32).contiguous().to(card)}


@pytest.mark.parametrize("n,dim,m", [(1000, 1000, 50), (256, 200, 20),
                                     (7, 64, 8)])
def test_f15_kernel_bit_equal(card, n, dim, m):
    g = torch.Generator().manual_seed(n + dim)
    consts = _f15_consts(dim, m, g, card)
    x = (torch.rand(n, dim, generator=g) * 10 - 5).to(card)
    assert torch.equal(f15_k.f15(consts, x), f15_ref.f15(consts, x))


FLOAT_EVALS = {"none": None, "rastrigin": (("eval", "rastrigin"),),
               "sphere": (("eval", "sphere"),),
               "f15": (("eval", "f15"), ("m", 10), ("n_groups", 10))}


@pytest.mark.parametrize("selection,crossover,fused", list(itertools.product(
    ("tournament", "roulette"), ("two_point", "uniform", "blend"),
    sorted(FLOAT_EVALS))))
def test_float_generation_kernel_bit_equal(card, selection, crossover, fused):
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    g = torch.Generator().manual_seed(11)
    n_isl, n, length = 4, 64, 100
    spec = GenerationSpec(
        kind="float", length=length, elite=2, selection=selection,
        tournament_k=2, crossover=crossover, crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=FLOAT_EVALS[fused])
    consts = _f15_consts(length, 10, g, card) if fused == "f15" else None
    pop = torch.rand(n_isl, n, length, generator=g) * 10 - 5
    fit = torch.randn(n_isl, n, generator=g)
    size = torch.randint(32, n + 1, (n_isl,), generator=g, dtype=torch.int32)
    seed = torch.randint(0, 2**32, (n_isl, 2), generator=g,
                         dtype=torch.int64)
    args = [t.to(card) for t in (seed, size, pop, fit)]
    got = gen_k.generation_kernel(*args, spec, consts)
    want = gen_ref.generation(*args, spec, consts)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
