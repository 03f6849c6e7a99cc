"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Both kernels must be bit-equal to their plain versions.
"""
import importlib

import pytest
import torch

from repro_torch.kernels.ga import ref as gen_ref
from repro_torch.kernels.ga.common import GenerationSpec
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
