"""The port's CEC2010-F15 (plain version, its wrapper on CPU tensors, the
problem and its shipped constants) against the JAX reference.

The reference's F15 runs its Pallas kernel in interpret mode
(``repro.kernels.rastrigin.ops.f15``) and its jnp ``f15_ref``, both with a
BLAS-ordered rotation; the port sums the rotation left to right, so the
two are held to the reference's own kernel tolerance, rtol 3e-5 and atol
2e-2 (``tests/test_kernels.py``). The shipped constants
``src/repro_torch/core/data/f15_d1000_m50.npz`` are the reference's
``make_f15_consts(jax.random.key(2010), 1000, 50)``; after a deliberate
change to that recipe, rewrite them with

    PYTHONPATH=src python tests/test_torch_f15.py --regen
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.problems import f15_ref as j_f15_ref
from repro.core.problems import make_f15_consts
from repro.kernels.rastrigin import ops as j_f15_ops
from repro_torch import convert
from repro_torch.core import make_f15, make_problem
from repro_torch.core.problems import F15_DEFAULT_CONSTS
from repro_torch.kernels.rastrigin import f15 as t_f15
from repro_torch.kernels.rastrigin import ref as t_ref
from repro_torch.kernels.trap.ref import WINDOW, window_edges, window_lead

RTOL, ATOL = 3e-5, 2e-2


def _np_consts(consts):
    return {k: np.asarray(v) for k, v in consts.items()}


def _case(dim, group, n, shared=False):
    consts = _np_consts(make_f15_consts(jax.random.key(dim + n), dim, group,
                                        shared_rotation=shared))
    pop = np.random.default_rng(n).uniform(-5, 5, (n, dim)).astype(
        np.float32)
    return consts, pop


@pytest.mark.parametrize("dim,group,n,shared", [
    (1000, 50, 32, False), (200, 20, 64, False), (100, 10, 100, False),
    (64, 8, 1, False), (100, 10, 16, True)])
def test_plain_matches_reference(dim, group, n, shared):
    consts, pop = _case(dim, group, n, shared)
    got = t_ref.f15(convert.f15_consts_from_numpy(consts, "cpu"),
                    torch.from_numpy(pop)).numpy()
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    for want in (j_f15_ops.f15(jc, jnp.asarray(pop)),
                 j_f15_ref(jc, jnp.asarray(pop))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("group,n_groups", [(7, 13), (13, 7), (50, 3),
                                            (7, 2)])
def test_plain_matches_reference_at_group_sizes_off_four(group, n_groups):
    """Group sizes that are not a multiple of the kernels' 4-column
    micro-tiles (m = 7, 13, 50), with several groups."""
    dim = group * n_groups
    consts, pop = _case(dim, group, 9)
    got = t_ref.f15(convert.f15_consts_from_numpy(consts, "cpu"),
                    torch.from_numpy(pop)).numpy()
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    for want in (j_f15_ops.f15(jc, jnp.asarray(pop)),
                 j_f15_ref(jc, jnp.asarray(pop))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


# the sum order past 64 terms: m 65 and 100 (a group's terms), 100 groups
# of 10 (the group sums); held to Queue C's F15 tolerance
@pytest.mark.parametrize("dim,group", [(130, 65), (300, 100), (1000, 10)])
def test_plain_matches_reference_past_64_terms(dim, group):
    consts, pop = _case(dim, group, 16)
    got = t_ref.f15(convert.f15_consts_from_numpy(consts, "cpu"),
                    torch.from_numpy(pop)).numpy()
    jc = {k: jnp.asarray(v) for k, v in consts.items()}
    for want in (j_f15_ops.f15(jc, jnp.asarray(pop)),
                 j_f15_ref(jc, jnp.asarray(pop))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_group_total_is_ordered_sum_over_groups_and_terms():
    """Up to 32 groups the group sums add left to right from 0, as before;
    past that they take ordered_sum's windows."""
    terms = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 40, (8, 100, 10)).astype(np.float32))
    sums = t_ref.ordered_sum(terms)
    assert torch.equal(t_ref.group_total(terms), t_ref.ordered_sum(sums))
    ltr = torch.zeros(8)
    for g in range(20):
        ltr = ltr + sums[:, g]
    assert torch.equal(t_ref.group_total(terms[:, :20]), ltr)


def test_wrapper_on_cpu_runs_the_plain_version_and_optimum_is_zero():
    consts, pop = _case(200, 20, 24)
    tc = convert.f15_consts_from_numpy(consts, "cpu")
    x = torch.from_numpy(pop)
    assert torch.equal(t_f15.f15(tc, x), t_ref.f15(tc, x))
    at_o = t_f15.f15(tc, tc["o"][None, :].repeat(3, 1))
    assert torch.equal(at_o, torch.zeros(3))


def test_shipped_constants_are_the_references_default():
    want = _np_consts(make_f15_consts(jax.random.key(2010), 1000, 50))
    with np.load(F15_DEFAULT_CONSTS) as got:
        np.testing.assert_array_equal(got["perm"], want["perm"])
        for k in ("o", "M"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        assert got["perm"].dtype == np.int32
        assert got["o"].dtype == got["M"].dtype == np.float32


def test_make_f15_carries_the_constants():
    problem = make_f15(device="cpu")
    assert problem.name == "f15_d1000m50"
    assert problem.fused == {"eval": "f15", "m": 50, "n_groups": 20}
    assert (problem.genome.kind, problem.genome.length) == ("float", 1000)
    assert problem.consts["perm"].dtype == torch.int32
    assert tuple(problem.consts["M"].shape) == (20, 50, 50)

    consts, pop = _case(64, 8, 5)
    plain = make_problem("f15", consts=consts, dim=64, group=8, device="cpu")
    kernel = make_f15(consts, dim=64, group=8, impl="pallas", device="cpu")
    x = torch.from_numpy(pop)
    want = -t_ref.f15(plain.consts, x)
    assert torch.equal(plain.evaluate(plain.consts, x), want)
    assert torch.equal(kernel.evaluate(kernel.consts, x), want)

    shared = _np_consts(make_f15_consts(jax.random.key(3), 64, 8,
                                        shared_rotation=True))
    one = dict(shared, M=shared["M"][:1])
    a = make_f15(one, dim=64, group=8, shared_rotation=True, device="cpu")
    b = make_f15(shared, dim=64, group=8, device="cpu")
    assert torch.equal(a.evaluate(a.consts, x), b.evaluate(b.consts, x))


def test_make_f15_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="hand them over"):
        make_f15(dim=200, group=20, device="cpu")
    with pytest.raises(ValueError, match="hand them over"):
        make_f15(shared_rotation=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_f15()


def _kernel_rows(n, shape):
    """How often each row is written by the kernel's loop (csrc/f15.cu):
    block b takes tiles b, b + grid, ... of ``shape.rows`` rows."""
    tiles = -(-n // shape.rows)
    seen = np.zeros(n, np.int64)
    for b in range(shape.grid):
        for t in range(b, tiles, shape.grid):
            seen[t * shape.rows:(t + 1) * shape.rows] += 1
    return seen


@pytest.mark.parametrize("dim,m", [(14, 7), (91, 7), (91, 13), (200, 20),
                                   (1000, 50), (1024, 64), (8000, 50)])
@pytest.mark.parametrize("n", [1, 7, 100, 1000, 2048, 3433, 10000])
def test_launch_shape_covers_every_row_once_in_whole_waves(n, dim, m):
    """The launch shape on an H100's limits (132 SMs): every row in one
    tile of one block, every group in one batch; the grid every tile, or as
    many blocks as the card holds at once, each looping over tiles; the
    block's shared memory within the card's."""
    limits = t_f15.H100
    shape = t_f15.launch_shape(n, dim, m, limits)
    assert 1 <= shape.rows <= min(t_f15.HELPERS, n)
    assert t_f15.tasks(shape.rows, m, shape.groups) <= t_f15.COMPUTE
    assert 1 <= shape.groups <= dim // m
    assert shape.smem == t_f15.smem_bytes(shape.rows, dim, m, shape.groups)
    assert shape.smem <= limits.smem_per_block
    per_sm = t_f15.blocks_per_sm(shape.smem, limits)
    assert per_sm >= 1
    tiles = -(-n // shape.rows)
    assert shape.grid == min(tiles, limits.sms * per_sm)
    np.testing.assert_array_equal(_kernel_rows(n, shape), 1)
    batches = [list(range(g0, min(g0 + shape.groups, dim // m)))
               for g0 in range(0, dim // m, shape.groups)]
    assert sum(batches, []) == list(range(dim // m))


def test_launch_shape_shrinks_to_one_row_then_gathers_z():
    """Wide rows shrink the tiled route's tile to one row; where not even
    one row fits its shared memory, the helpers gather z from device
    memory (no rows staged) instead of the launch raising."""
    limits = t_f15.H100
    assert t_f15.launch_shape(10, 40000, 50, limits).rows == 1
    assert not t_f15.launch_shape(10, 40000, 50, limits).gather
    assert t_f15.shape_for_rows(10, 40000, 50, 1, limits).groups >= 1
    wide = t_f15.launch_shape(10, 60000, 50, limits)
    assert wide.gather and wide.cols == 0
    assert wide == t_f15.shape_for_rows(10, 60000, 50, wide.rows, limits,
                                        gather=True)
    with pytest.raises(ValueError, match="shared memory"):
        t_f15.shape_for_rows(10, 60000, 50, 1, limits)
    with pytest.raises(ValueError, match="shared memory"):
        t_f15.shape_for_rows(10000, 1000, 50, 64, limits)
    with pytest.raises(ValueError, match="rows per tile"):
        t_f15.shape_for_rows(10, 14, 7, t_f15.HELPERS + 1, limits)


# shapes whose staged row does not fit beside the rotations: rows wider
# than 51,900 genes at m = 50, and m = 169 (the first m whose two rotations
# leave no room for a row; 169 does not divide 1000, so D = 6 x 169)
GATHER_CASES = [(2048, 51950, 50), (2048, 60000, 50), (2048, 100000, 50),
                (10, 60000, 50), (2048, 1014, 169), (3, 2000000, 50)]


@pytest.mark.parametrize("n,dim,m", GATHER_CASES)
def test_launch_shape_gathers_z_where_no_row_fits(n, dim, m):
    """The tiled route with z gathered from device memory, on an H100's
    limits: the same checks as the staged launch's, its shared memory
    counted without the rows."""
    limits = t_f15.H100
    with pytest.raises(ValueError, match="shared memory"):
        t_f15.shape_for_rows(n, dim, m, 1, limits)
    shape = t_f15.launch_shape(n, dim, m, limits)
    assert shape.gather and shape.cols == 0
    assert 1 <= shape.rows <= min(t_f15.HELPERS, n)
    assert t_f15.tasks(shape.rows, m, shape.groups) <= t_f15.COMPUTE
    assert shape.smem == t_f15.smem_bytes(shape.rows, dim, m, shape.groups,
                                          gather=True)
    assert shape.smem <= limits.smem_per_block
    per_sm = t_f15.blocks_per_sm(shape.smem, limits)
    assert shape.grid == min(-(-n // shape.rows), limits.sms * per_sm)
    np.testing.assert_array_equal(_kernel_rows(n, shape), 1)


# shapes whose two rotations do not fit the ring, staged or gathered:
# m above 169 at D 1000 (200, 250, 500, 1000), m above 1536 (more
# micro-tiles than compute threads), and rows whose group sums alone
# outgrow shared memory (D 3,000,000 at m 50)
SLICED_CASES = [(2048, 1000, 200), (2048, 1000, 250), (2048, 1000, 500),
                (2048, 1000, 1000), (1, 1000, 1000), (2048, 1020, 170),
                (300, 2000, 2000), (7, 4000, 4000), (5, 3000000, 50)]


@pytest.mark.parametrize("n,dim,m", SLICED_CASES)
def test_launch_shape_takes_the_sliced_route_where_rotations_do_not_fit(
        n, dim, m):
    """The sliced route's launch on an H100's limits: a slice's
    micro-tiles within the block's threads, slices that start windows of
    ordered_sum's order (so the terms sum in the plain version's order),
    shared memory within the card's, every row in one tile of one block."""
    limits = t_f15.H100
    for gather in (False, True):
        with pytest.raises(ValueError, match="shared memory"):
            t_f15.shape_for_rows(n, dim, m, 1, limits, gather)
    shape = t_f15.launch_shape(n, dim, m, limits)
    assert shape.cols > 0 and shape.groups == 1 and not shape.gather
    assert shape.rows % t_f15.MICRO_ROWS == 0
    micro = (shape.rows // t_f15.MICRO_ROWS) * -(-shape.cols
                                                 // t_f15.MICRO_COLS)
    assert micro <= t_f15.SLICED_THREADS
    assert shape.cols == m or (shape.cols < m and shape.cols % WINDOW == 0)
    # the kernel's slices: the first C - 32 + window_lead(m) columns, then
    # C each; each starts a window
    starts = [0] if shape.cols >= m else [0] + list(
        range(shape.cols - WINDOW + window_lead(m), m, shape.cols))
    assert set(starts) <= set(window_edges(m))
    assert shape.smem == t_f15.sliced_smem_bytes(shape.rows, shape.cols)
    assert shape.smem <= limits.smem_per_block
    tiles = -(-n // shape.rows)
    per_sm = min(t_f15.SLICED_BLOCKS_PER_SM,
                 limits.smem_per_sm // (shape.smem
                                        + limits.reserved_per_block))
    assert shape.grid == min(tiles, limits.sms * per_sm)
    np.testing.assert_array_equal(_kernel_rows(n, shape), 1)


@pytest.mark.parametrize("n,dim,m,want", [
    (10000, 1000, 50, t_f15.Shape(26, 4, 132, 227760)),
    (2048, 1000, 50, t_f15.Shape(16, 6, 128, 223760))])
def test_fig4_and_island_batch_keep_their_launch_shapes(n, dim, m, want):
    """The sliced route changes nothing where the tiled route fits: Fig.
    4's row and the island batch keep the launches they were timed at."""
    assert t_f15.launch_shape(n, dim, m, t_f15.H100) == want


@pytest.mark.parametrize("group", [200, 1000])
def test_make_f15_matches_reference_at_wide_groups(group):
    """The reference's make_f15(group=200 and 1000, impl="pallas"), its
    Pallas kernel in interpret mode, against the port's on the plain
    version, at the reference's kernel tolerance."""
    from repro.core.problems import make_f15 as j_make_f15
    key = jax.random.key(group)
    want_p = j_make_f15(key, dim=1000, group=group, impl="pallas")
    got_p = make_f15(_np_consts(want_p.consts), dim=1000, group=group,
                     impl="pallas", device="cpu")
    assert got_p.fused == {"eval": "f15", "m": group,
                           "n_groups": 1000 // group}
    pop = np.random.default_rng(group).uniform(-5, 5, (6, 1000)).astype(
        np.float32)
    want = want_p.evaluate(want_p.consts, jnp.asarray(pop))
    got = got_p.evaluate(got_p.consts, torch.from_numpy(pop))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _regen():
    consts = make_f15_consts(jax.random.key(2010), 1000, 50)
    np.savez(F15_DEFAULT_CONSTS, o=np.asarray(consts["o"], np.float32),
             perm=np.asarray(consts["perm"], np.int32),
             M=np.asarray(consts["M"], np.float32))
    print(f"wrote {F15_DEFAULT_CONSTS}")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        _regen()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
