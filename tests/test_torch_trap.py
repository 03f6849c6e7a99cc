"""The port's trap fitness (plain version, and its wrapper on CPU tensors)
against the reference's Pallas kernel in interpret mode and its jnp
``trap_ref``. The port sums the block scores in a fixed grouped order
(``ordered_sum``) that is XLA's order up to 64 traps, so every comparison
here is exact, ragged N and the all-ones / all-zeros extremes included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problems import trap_fitness_ref as j_trap_fitness_ref
from repro.kernels.trap import ops as j_trap_ops
from repro.kernels.trap import ref as j_trap_ref
from repro_torch.core.problems import make_trap
from repro_torch.kernels.trap import ref as t_ref
from repro_torch.kernels.trap import trap as t_trap

CONSTS = {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4}


def _pop(n, n_traps, p, seed, l=4):
    g = np.random.default_rng(seed)
    return (g.random((n, n_traps * l)) < p).astype(np.int8)


# (n, n_traps, l); the first five keep their ids from when l was always 4;
# 64 traps and 13 blocks of 5 are the trap kernel's edges on the card
@pytest.mark.parametrize("n,n_traps,l", [
    pytest.param(256, 40, 4, id="256-40"),
    pytest.param(100, 40, 4, id="100-40"),
    pytest.param(37, 8, 4, id="37-8"),
    pytest.param(64, 50, 4, id="64-50"),
    pytest.param(300, 33, 4, id="300-33"),
    pytest.param(128, 64, 4, id="128-64"),
    pytest.param(100, 13, 5, id="100-13-l5")])
def test_plain_matches_reference(n, n_traps, l):
    consts = dict(CONSTS, l=l)
    for seed, p in enumerate((0.5, 0.8, 0.95)):
        pop = _pop(n, n_traps, p, seed, l)
        got = t_ref.trap_fitness(torch.from_numpy(pop), n_traps=n_traps, l=l,
                                 a=1.0, b=2.0, z=3.0).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(j_trap_ref.trap_fitness(
                jnp.asarray(pop), n_traps=n_traps, l=l, a=1.0, b=2.0,
                z=3.0)))
        np.testing.assert_array_equal(
            got, np.asarray(j_trap_fitness_ref(consts, jnp.asarray(pop))))


@pytest.mark.parametrize("n", [256, 100])
def test_wrapper_matches_interpret_kernel(n):
    pop = _pop(n, 40, 0.7, n)
    want = np.asarray(j_trap_ops.trap_fitness(CONSTS, jnp.asarray(pop),
                                              n_traps=40))
    got = t_trap.trap_fitness(CONSTS, torch.from_numpy(pop), n_traps=40)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extremes():
    ones = torch.ones((3, 160), dtype=torch.int8)
    zeros = torch.zeros((5, 160), dtype=torch.int8)
    np.testing.assert_array_equal(
        t_trap.trap_fitness(CONSTS, ones, n_traps=40).numpy(), 80.0)
    np.testing.assert_array_equal(
        t_trap.trap_fitness(CONSTS, zeros, n_traps=40).numpy(), 40.0)


def test_problem_routes_pallas_to_the_wrapper():
    kernel, plain = make_trap(40, 4, impl="pallas"), make_trap(40, 4)
    pop = torch.from_numpy(_pop(64, 40, 0.6, 3))
    np.testing.assert_array_equal(kernel.evaluate(kernel.consts, pop).numpy(),
                                  plain.evaluate(plain.consts, pop).numpy())
    assert kernel.fused == {"a": 1.0, "b": 2.0, "z": 3.0, "l": 4,
                            "eval": "trap"}
    assert kernel.optimum == 80.0


@pytest.mark.parametrize("n_terms,group", [(1, 1), (32, 32), (33, 17),
                                           (40, 20), (64, 32)])
def test_sum_group(n_terms, group):
    assert t_ref.sum_group(n_terms) == group
