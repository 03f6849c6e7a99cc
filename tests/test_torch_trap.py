"""The port's trap fitness (plain version, and its wrapper on CPU tensors)
against the reference's Pallas kernel in interpret mode and its jnp
``trap_ref``. The port sums the block scores in XLA's window order
(``ordered_sum``), so every comparison here is exact, ragged N, 65-1000
traps and the all-ones / all-zeros extremes included; sphere's sums are
exact at 65-2000 genes too, and rastrigin's are held to the tolerance of
its ``cos``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problems import make_rastrigin as j_make_rastrigin
from repro.core.problems import make_sphere as j_make_sphere
from repro.core.problems import make_trap as j_make_trap
from repro.core.problems import trap_fitness_ref as j_trap_fitness_ref
from repro.kernels.trap import ops as j_trap_ops
from repro.kernels.trap import ref as j_trap_ref
from repro_torch.core.problems import make_problem, make_trap
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
                                           (40, 20), (64, 32), (65, 17),
                                           (96, 32), (100, 18), (128, 32),
                                           (1025, 17)])
def test_sum_group(n_terms, group):
    """The first window of ordered_sum's order; up to 64 terms it is the
    first group of the earlier grouped order."""
    assert t_ref.window_lead(n_terms) == group
    edges = t_ref.window_edges(n_terms)
    assert edges[1] == group and edges[-1] == n_terms
    assert all(b - a == 32 for a, b in zip(edges[1:-2], edges[2:-1]))


# rows of 1-299 terms and the second level's edges, against jnp.sum under
# jit on the CPU
@pytest.mark.parametrize("n_terms", list(range(1, 300, 7))
                         + [64, 65, 96, 128, 640, 1024, 1025, 2000, 4000])
def test_ordered_sum_is_xlas_row_sum(n_terms):
    import jax
    x = (np.random.default_rng(n_terms).standard_normal((64, n_terms))
         * 3.3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: v.sum(-1))(x))
    got = t_ref.ordered_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_traps", [40, 65, 80, 100, 200, 300, 1000])
def test_trap_past_64_traps_matches_both_reference_routes(n_traps):
    """The reference's trap evaluate, impl "jnp" and "pallas" (interpret
    mode), bit for bit at the paper's 40 traps and past 64."""
    pop = _pop(256, n_traps, 0.55, n_traps)
    got = make_trap(n_traps, 4).evaluate(
        make_trap(n_traps, 4).consts, torch.from_numpy(pop)).numpy()
    for impl in ("jnp", "pallas"):
        problem = j_make_trap(n_traps, 4, impl=impl)
        want = np.asarray(problem.evaluate(problem.consts, jnp.asarray(pop)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [65, 100, 1000, 2000])
def test_sphere_past_64_genes_is_bit_exact(dim):
    pop = np.random.default_rng(dim).uniform(-5.12, 5.12, (128, dim)).astype(
        np.float32)
    problem = j_make_sphere(dim)
    want = np.asarray(problem.evaluate(problem.consts, jnp.asarray(pop)))
    port = make_problem("sphere", dim=dim)
    got = port.evaluate(port.consts, torch.from_numpy(pop)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [50, 100, 1000])
def test_rastrigin_past_64_genes_within_its_cos_tolerance(dim):
    """Only cos differs (Queue C: 1 ulp of a term); the sums are in XLA's
    order, so rtol 2e-6 holds where the earlier order needed more."""
    pop = np.random.default_rng(dim).uniform(-5.12, 5.12, (128, dim)).astype(
        np.float32)
    problem = j_make_rastrigin(dim)
    want = np.asarray(problem.evaluate(problem.consts, jnp.asarray(pop)))
    port = make_problem("rastrigin", dim=dim)
    got = port.evaluate(port.consts, torch.from_numpy(pop)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def _sum_order_report():
    """The numbers ROADMAP Queue C logs: rows of the port's plain versions
    that differ from the reference's, and by how much."""
    import jax
    from repro.core.problems import f15_ref as j_f15_ref
    from repro.core.problems import make_f15_consts
    from repro.kernels.rastrigin import ops as j_f15_ops
    from repro_torch import convert
    from repro_torch.kernels.rastrigin import ref as f15_plain
    for name, make in (("sphere", j_make_sphere),
                       ("rastrigin", j_make_rastrigin)):
        for dim in (50, 65, 100, 1000, 2000):
            pop = np.random.default_rng(dim).uniform(
                -5.12, 5.12, (2048, dim)).astype(np.float32)
            problem = make(dim)
            want = np.asarray(problem.evaluate(problem.consts,
                                               jnp.asarray(pop)))
            port = make_problem(name, dim=dim)
            got = port.evaluate(port.consts, torch.from_numpy(pop)).numpy()
            print(f"{name} D {dim}: {int((got != want).sum())} of 2048 rows "
                  f"differ, max rel "
                  f"{np.max(np.abs(got - want) / np.abs(want)):.3e}")
    for n_traps in (40, 65, 80, 100, 200, 300, 1000):
        pop = _pop(2048, n_traps, 0.55, n_traps)
        got = make_trap(n_traps, 4).evaluate(
            make_trap(n_traps, 4).consts, torch.from_numpy(pop)).numpy()
        problem = j_make_trap(n_traps, 4)
        want = np.asarray(problem.evaluate(problem.consts, jnp.asarray(pop)))
        print(f"trap {n_traps} traps: {int((got != want).sum())} of 2048 "
              f"rows differ")
    for dim, group, n in ((1000, 50, 32), (130, 65, 64), (300, 100, 64),
                          (1000, 10, 64)):
        consts = {k: np.asarray(v) for k, v in make_f15_consts(
            jax.random.key(dim + n), dim, group).items()}
        pop = np.random.default_rng(n).uniform(-5, 5, (n, dim)).astype(
            np.float32)
        got = f15_plain.f15(convert.f15_consts_from_numpy(consts, "cpu"),
                            torch.from_numpy(pop)).numpy()
        jc = {k: jnp.asarray(v) for k, v in consts.items()}
        for route, want in (("pallas", j_f15_ops.f15(jc, jnp.asarray(pop))),
                            ("jnp", j_f15_ref(jc, jnp.asarray(pop)))):
            want = np.asarray(want)
            diff = got != want
            first = int(np.argmax(diff))
            print(f"f15 D {dim} m {group} ({route}): {int(diff.sum())} of "
                  f"{n} rows differ, max rel "
                  f"{np.max(np.abs(got - want) / np.abs(want)):.3e}; first "
                  f"row {first}: port {got[first]!r}, reference "
                  f"{want[first]!r}")


if __name__ == "__main__":
    import sys
    if "--report" in sys.argv:
        _sum_order_report()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
