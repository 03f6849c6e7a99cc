"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The island kernels must be bit-equal to their plain versions: trap
fitness, F15, and the generation kernels on binary and on float genomes.
WKV6 and flash attention are held to the reference's kernel tolerances.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses
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
                                     (7, 64, 8), (333, 91, 7), (5, 91, 13),
                                     (3, 150, 50)])
def test_f15_kernel_bit_equal(card, n, dim, m):
    g = torch.Generator().manual_seed(n + dim)
    consts = _f15_consts(dim, m, g, card)
    x = (torch.rand(n, dim, generator=g) * 10 - 5).to(card)
    assert torch.equal(f15_k.f15(consts, x), f15_ref.f15(consts, x))


# the trap kernel's edges: (n, n_traps, l, bytes the population starts off
# a 16-byte boundary): one row, 64 and 65 traps (two rounds of 32 lanes),
# rows of 65 bytes, and an (n, L) view of a flat buffer 3 bytes in
@pytest.mark.parametrize("n,n_traps,l,offset", [
    (1, 40, 4, 0), (2048, 64, 4, 0), (1000, 65, 4, 0), (1000, 13, 5, 0),
    (333, 40, 4, 3), (77, 13, 5, 3)])
def test_trap_kernel_edges_bit_equal(card, n, n_traps, l, offset):
    g = torch.Generator().manual_seed(n + n_traps)
    flat = (torch.rand(offset + n * n_traps * l, generator=g) < 0.6).to(
        torch.int8).to(card)
    pop = flat[offset:].view(n, n_traps * l)
    assert pop.is_contiguous() and pop.data_ptr() % 16 == offset
    got = trap_k.trap_fitness(dict(CONSTS, l=l), pop, n_traps=n_traps)
    want = trap_ref.trap_fitness(pop, n_traps=n_traps, l=l, a=1.0, b=2.0,
                                 z=3.0)
    assert torch.equal(got, want)


def _f15_edge(case, card):
    """(n, dim, m) of an F15 kernel edge on this card: one row, 7, one
    tile and one more row, a whole wave of tiles and one more row (D 1000,
    m 50), odd and wide m, and a D so wide that a tile is one row."""
    fig4 = f15_k.card_shape(10000, 1000, 50, card)
    return {"n1": (1, 1000, 50), "n7": (7, 1000, 50),
            "tile": (fig4.rows, 1000, 50), "tile+1": (fig4.rows + 1, 1000, 50),
            "wave+1": (fig4.grid * fig4.rows + 1, 1000, 50),
            "m7": (1000, 91, 7), "m13": (1000, 91, 13),
            "m64": (1000, 1024, 64), "wide": (5, 40000, 50)}[case]


@pytest.mark.parametrize("case", ["n1", "n7", "tile", "tile+1", "wave+1",
                                  "m7", "m13", "m64", "wide"])
def test_f15_kernel_edges_bit_equal(card, case):
    n, dim, m = _f15_edge(case, card)
    g = torch.Generator().manual_seed(n + dim + m)
    consts = _f15_consts(dim, m, g, card)
    x = (torch.rand(n, dim, generator=g) * 10 - 5).to(card)
    if case == "wide":
        assert f15_k.card_shape(n, dim, m, card).rows == 1
    assert torch.equal(f15_k.f15(consts, x), f15_ref.f15(consts, x))


@pytest.mark.parametrize("rows", [1, 2, 5, 8, 16, 26, 38, 44])
def test_f15_kernel_any_rows_per_tile_bit_equal(card, rows):
    """Every tile height the builder's sweep tries gives the plain
    version's bits; the kernel's shared memory is the wrapper's count."""
    from repro_torch import _build
    g = torch.Generator().manual_seed(rows)
    consts = _f15_consts(1000, 50, g, card)
    x = (torch.rand(3000, 1000, generator=g) * 10 - 5).to(card)
    shape = f15_k.card_shape(3000, 1000, 50, card, rows=rows)
    assert _build.library().f15_smem_bytes(rows, 1000, 50, shape.groups,
                                           0, 0) == shape.smem
    assert torch.equal(f15_k.launch(consts, x, shape),
                       f15_ref.f15(consts, x))


# the routes for the shapes whose rows the tiled route cannot stage, (n, D,
# m, route): z gathered from device memory for rows wider than its shared
# memory and at m = 169 (D = 6 x 169); the sliced route where two rotations
# do not fit (m = 200, 500, 1000; m = 1000 in slices of 512 and 488), with
# a ragged last tile and one row
@pytest.mark.parametrize("n,dim,m,route", [
    (2048, 1000, 200, "sliced"), (2048, 1000, 1000, "sliced"),
    (2048, 60000, 50, "gather"), (333, 1014, 169, "gather"),
    (7, 51950, 50, "gather"), (1, 1000, 1000, "sliced"),
    (45, 1000, 500, "sliced")])
def test_f15_kernel_wide_routes_bit_equal(card, n, dim, m, route):
    """Each shape runs its route, one launch, and gives the plain version's
    bits; the kernel's shared memory is the wrapper's count."""
    from repro_torch import _build, kernels
    g = torch.Generator().manual_seed(n + dim + m)
    consts = _f15_consts(dim, m, g, card)
    x = (torch.rand(n, dim, generator=g) * 10 - 5).to(card)
    shape = f15_k.card_shape(n, dim, m, card)
    assert (shape.cols > 0, shape.gather) == (route == "sliced",
                                              route == "gather")
    assert _build.library().f15_smem_bytes(
        shape.rows, dim, m, shape.groups, shape.cols,
        int(shape.gather)) == shape.smem
    before = kernels.LAUNCHES["f15"]
    got = f15_k.f15(consts, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["f15"] == before + 1
    assert torch.equal(got, f15_ref.f15(consts, x))


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


# ---------------------------------------------------------------------------
# the untiled generation kernels at their edges
# ---------------------------------------------------------------------------
BINARY_EVALS = {"none": None,
                "trap": (("a", 1.0), ("b", 2.0), ("eval", "trap"), ("l", 4),
                         ("z", 3.0)),
                "onemax": (("eval", "onemax"),),
                "royal_road": (("eval", "royal_road"), ("r", 3))}


def _edge_inputs(kind, n_isl, n, length, fitness, g):
    """seed words, size, pop and fit of an edge case. ``fitness``:
    "random" (normal, with -inf lanes and a run of ties), "tied" (one
    value everywhere), "masked" (pop_size 0 and 1 on the first islands,
    every lane -inf on the last)."""
    if kind == "binary":
        pop = (torch.rand(n_isl, n, length, generator=g) < 0.5).to(
            torch.int8)
    else:
        pop = torch.rand(n_isl, n, length, generator=g) * 10 - 5
    fit = torch.randn(n_isl, n, generator=g) * 10
    size = torch.randint(max(1, n // 2), n + 1, (n_isl,), generator=g,
                         dtype=torch.int32)
    if fitness == "random":
        fit[:, 1:4] = float("-inf")
        fit[:, 5:9] = fit[:, 10:11]
    elif fitness == "tied":
        fit[:] = 2.5
    else:
        size[0], size[1 % n_isl] = 0, 1
        fit[-1] = float("-inf")
    seed = torch.randint(0, 2**32, (n_isl, 2), generator=g,
                         dtype=torch.int64)
    return seed, size, pop, fit


# (n_isl, n, L, fused eval, fitness, byte offset, elite): the kernel runs
# min(16, n) CTAs per island, so n = 1, 3, 5 and 8 run clusters of 1, 3, 5
# and 8 CTAs and the rest 16; n not a multiple of 16 (CTAs with fewer rows
# or none), L not a multiple of 4 or 16, islands off 16 bytes (odd n * L
# and an odd start), all-masked and all-tied fitness, a tile under 16 bytes
# (no bulk copy), 4 elite rows over several CTAs, and the largest island at
# L = 160 that routes untiled
BINARY_EDGES = [
    (3, 250, 160, "trap", "random", 0, 2),
    (3, 100, 157, "onemax", "tied", 0, 2),
    (4, 37, 39, "royal_road", "masked", 1, 2),
    (2, 61, 13, "none", "random", 3, 4),
    (2, 3, 4, "onemax", "masked", 5, 2),
    (2, 5, 40, "trap", "tied", 0, 1),
    (3, 8, 40, "trap", "tied", 1, 2),
    (3, 1, 40, "onemax", "masked", 3, 1),
    (2, 1227, 160, "trap", "random", 0, 2),
]


@pytest.mark.parametrize("case", range(len(BINARY_EDGES)))
@pytest.mark.parametrize("selection,crossover", [("tournament", "two_point"),
                                                 ("roulette", "uniform")])
def test_generation_kernel_edges(card, case, selection, crossover):
    """The binary kernel equals its plain version at its edges, over
    clusters of 1, 3, 5, 8 and 16 CTAs per island."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    n_isl, n, length, fused, fitness, offset, elite = BINARY_EDGES[case]
    g = torch.Generator().manual_seed(100 + case)
    spec = GenerationSpec(
        kind="binary", length=length, elite=elite, selection=selection,
        tournament_k=3, crossover=crossover, crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3,
        fused_eval=BINARY_EVALS[fused])
    args = [t.to(card) for t in _edge_inputs("binary", n_isl, n, length,
                                             fitness, g)]
    # pop starts `offset` bytes into its buffer
    args[2] = torch.empty(offset + args[2].numel(), dtype=torch.int8,
                          device=card)[offset:].view(n_isl, n, length) \
        .copy_(args[2])
    assert args[2].data_ptr() % 16 == offset % 16
    want = _as_tuple(gen_ref.generation(*args, spec))
    got = _as_tuple(gen_k.generation_kernel(*args, spec))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b), gen_k.cluster_size(n)


# (n_isl, n, L, m, fitness, elite): n not a multiple of the rows per block,
# m = 7 and 13 (not a multiple of the tail's 4 columns) with several
# groups, all-masked and all-tied fitness, the largest island at L = 1000
# under fused F15 that routes untiled, and genomes wide enough that the
# wrapper takes 2 rows per block (L = 7300) and 1 (L = 14600)
FLOAT_EDGES = [
    (3, 250, 91, 7, "random", 2),
    (2, 61, 91, 13, "tied", 4),
    (4, 37, 35, 7, "masked", 2),
    (2, 365, 1000, 50, "random", 2),
    (2, 9, 7300, 50, "tied", 2),
    (2, 5, 14600, 50, "masked", 2),
]


@pytest.mark.parametrize("case", range(len(FLOAT_EDGES)))
@pytest.mark.parametrize("selection", ["tournament", "roulette"])
def test_float_generation_kernel_edges(card, case, selection):
    """The float kernel with fused F15 equals its plain version at its
    edges, at 4, 2 and 1 rows per block."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    n_isl, n, length, m, fitness, elite = FLOAT_EDGES[case]
    g = torch.Generator().manual_seed(200 + case)
    spec = GenerationSpec(
        kind="float", length=length, elite=elite, selection=selection,
        tournament_k=2, crossover="blend", crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=(("eval", "f15"), ("m", m), ("n_groups", length // m)))
    consts = _f15_consts(length, m, g, card)
    args = [t.to(card) for t in _edge_inputs("float", n_isl, n, length,
                                             fitness, g)]
    want = _as_tuple(gen_ref.generation(*args, spec, consts))
    got = _as_tuple(gen_k.generation_kernel(*args, spec, consts))
    rows = gen_k.float_rows(n, length, elite, gen_k.max_smem_bytes(0))
    assert rows == {7300: 2, 14600: 1}.get(length, gen_k.FLOAT_ROWS)
    for a, b in zip(got, want):
        assert torch.equal(a, b), rows


@pytest.mark.parametrize("m,n_groups", [(7, 13), (50, 4)])
def test_tiled_kernel_fused_f15_bit_equal(card, m, n_groups):
    """The tiled path's F15 (the tiled kernel, then the F15 kernel and its
    register-blocked tail) equals the plain version and the untiled
    kernel at m = 7 and 50."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    from repro_torch.kernels.ga import tiling
    length = m * n_groups
    g = torch.Generator().manual_seed(m)
    spec = GenerationSpec(
        kind="float", length=length, elite=2, selection="tournament",
        tournament_k=2, crossover="blend", crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=(("eval", "f15"), ("m", m), ("n_groups", n_groups)))
    consts = _f15_consts(length, m, g, card)
    args = [t.to(card) for t in _edge_inputs("float", 2, 203, length,
                                             "random", g)]
    want = _as_tuple(gen_ref.generation(*args, spec, consts))
    untiled = _as_tuple(gen_k.generation_kernel(*args, spec, consts))
    for rows in (1, 7, 32):
        got = _as_tuple(tiling.generation_tiled(*args, spec, tile_pop=rows,
                                                consts=consts))
        for a, b, c in zip(got, want, untiled):
            assert torch.equal(a, b) and torch.equal(a, c), rows


# ---------------------------------------------------------------------------
# the tiled generation kernel and the roulette-CDF kernel
# ---------------------------------------------------------------------------
TILED_EVALS = {"binary": {"none": None,
                          "trap": (("a", 1.0), ("b", 2.0), ("eval", "trap"),
                                   ("l", 4), ("z", 3.0)),
                          "onemax": (("eval", "onemax"),),
                          "royal_road": (("eval", "royal_road"), ("r", 8))},
               "float": FLOAT_EVALS}


def _tiled_case(kind, selection, crossover, fused, n_isl, n, length, seed):
    g = torch.Generator().manual_seed(seed)
    spec = GenerationSpec(
        kind=kind, length=length, elite=2, selection=selection,
        tournament_k=2, crossover=crossover, crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=TILED_EVALS[kind][fused])
    if kind == "binary":
        pop = (torch.rand(n_isl, n, length, generator=g) < 0.5).to(
            torch.int8)
    else:
        pop = torch.rand(n_isl, n, length, generator=g) * 10 - 5
    fit = torch.randn(n_isl, n, generator=g) * 10
    size = torch.randint(n // 2, n + 1, (n_isl,), generator=g,
                         dtype=torch.int32)
    seed_w = torch.randint(0, 2**32, (n_isl, 2), generator=g,
                           dtype=torch.int64)
    return spec, (seed_w, size, pop, fit), g


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("n_isl", [3, 8])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 256, 4097, 5000, 10000,
                               16385])
@pytest.mark.parametrize("fitness", ["random", "tied", "masked"])
def test_roulette_cdf_kernel_bit_equal(card, fitness, n, n_isl):
    """The CDF kernel equals the plain CDF (the segmented f32 scan of the
    masked fitness, ``common.prefix_sum``): one lane, a segment's edges,
    above the reference's 4096-lane block, Fig. 4's 10,000 lanes, past the
    kernel's 16,384-lane chunk; -inf lanes, ties and all-masked islands
    included. The CDF never decreases."""
    from repro_torch.kernels.ga import common, tiling
    g = torch.Generator().manual_seed(n)
    _, size, _, fit = _edge_inputs("binary", n_isl, n, 4, fitness, g)
    size, fit = size.to(card), fit.to(card)
    got = tiling.roulette_cdf(size, fit)
    want = common.roulette_cdf(common.masked_fitness(fit, size))
    assert torch.equal(got, want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("selection", ["tournament", "roulette"])
@pytest.mark.parametrize("crossover", ["two_point", "uniform"])
@pytest.mark.parametrize("n", [64, 5000])
def test_tiled_one_launch_bit_equal(card, selection, crossover, n):
    """The tiled kernel, drawing its rows' plan itself, equals the plain
    version with ties at the elite, for 1, 3 and 8 rows per block: one
    launch under tournament, the CDF kernel first under roulette. Rows of
    160 genes take the 16-byte route."""
    from repro_torch import kernels
    from repro_torch.kernels.ga import tiling
    spec, args, _ = _tiled_case("binary", selection, crossover, "trap", 3, n,
                                160, n)
    args[3][0, :5] = args[3][0, 5]               # ties at the elite
    args = [t.to(card) for t in args]
    want = gen_ref.generation(*args, spec)
    for rows in (1, 3, 8):
        kernels.reset_launches()
        got = tiling.generation_tiled(*args, spec, tile_pop=rows)
        assert kernels.LAUNCHES["generation_tiled"] == 1
        assert kernels.LAUNCHES["roulette_cdf"] == (selection == "roulette")
        for a, b in zip(got, want):
            assert torch.equal(a, b), rows


# (kind, L, crossover, fused eval, fitness, offset in elements): rows off
# the 16-byte pack (1003 f32, 157 int8) and packed rows of a population
# that starts 4 or 5 bytes off 16, all on the scalar route; packed rows on
# the 16-byte route beside them; all-masked and tied fitness
TILED_EDGES = [
    ("float", 1003, "blend", "rastrigin", "random", 0),
    ("float", 1003, "uniform", "none", "tied", 0),
    ("binary", 157, "two_point", "onemax", "random", 0),
    ("binary", 157, "uniform", "none", "masked", 0),
    ("float", 1000, "blend", "sphere", "masked", 1),
    ("binary", 160, "two_point", "trap", "random", 5),
    ("binary", 160, "uniform", "royal_road", "tied", 0),
]


@pytest.mark.parametrize("case", range(len(TILED_EDGES)))
@pytest.mark.parametrize("selection", ["tournament", "roulette"])
def test_tiled_kernel_edges(card, case, selection):
    """The tiled kernel at its edges equals its plain version and the
    untiled kernel, with 3 elite rows over blocks of 1 and 2 rows (and 8)
    and pop_size below n."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    from repro_torch.kernels.ga import tiling
    kind, length, crossover, fused, fitness, offset = TILED_EDGES[case]
    g = torch.Generator().manual_seed(300 + case)
    spec = GenerationSpec(
        kind=kind, length=length, elite=3, selection=selection,
        tournament_k=2, crossover=crossover, crossover_rate=0.9,
        mutation_rate=0.05, mutation_sigma=0.3, low=-5.0, high=5.0,
        fused_eval=TILED_EVALS[kind][fused])
    args = [t.to(card) for t in _edge_inputs(kind, 2, 37, length, fitness,
                                             g)]
    pop = args[2]
    args[2] = torch.empty(offset + pop.numel(), dtype=pop.dtype,
                          device=card)[offset:].view(pop.shape).copy_(pop)
    want = _as_tuple(gen_ref.generation(*args, spec))
    untiled = _as_tuple(gen_k.generation_kernel(*args, spec))
    for rows in (1, 2, 8):
        got = _as_tuple(tiling.generation_tiled(*args, spec, tile_pop=rows))
        assert len(got) == len(want)
        for a, b, c in zip(got, want, untiled):
            assert torch.equal(a, b) and torch.equal(a, c), rows


@pytest.mark.parametrize("kind,selection,crossover,fused", [
    ("binary", "tournament", "two_point", "trap"),
    ("binary", "roulette", "uniform", "onemax"),
    ("binary", "tournament", "uniform", "royal_road"),
    ("binary", "roulette", "two_point", "none"),
    ("float", "tournament", "blend", "rastrigin"),
    ("float", "roulette", "blend", "f15"),
    ("float", "tournament", "uniform", "sphere"),
    ("float", "roulette", "two_point", "none")])
def test_tiled_kernel_bit_equal(card, kind, selection, crossover, fused):
    """The tiled kernel equals its plain version and the untiled kernel,
    genes and fitness, for every rows per block."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    from repro_torch.kernels.ga import tiling
    length = 160 if kind == "binary" else 100
    spec, args, g = _tiled_case(kind, selection, crossover, fused, 4, 64,
                                length, 17)
    consts = _f15_consts(length, 10, g, card) if fused == "f15" else None
    args = [t.to(card) for t in args]
    want = _as_tuple(gen_ref.generation(*args, spec, consts))
    untiled = _as_tuple(gen_k.generation_kernel(*args, spec, consts))
    for rows in (1, 3, 8, 64):
        got = _as_tuple(tiling.generation_tiled(*args, spec, tile_pop=rows,
                                                consts=consts))
        assert len(got) == len(want)
        for a, b, c in zip(got, want, untiled):
            assert torch.equal(a, b) and torch.equal(a, c), rows


def test_untiled_smem_formula_is_the_kernels(card):
    """The routing's shared-memory formula is the C launchers' own, up to
    the largest islands that route untiled (1227 x 160 and 230 x 1000
    binary, 365 x 1000 float under fused F15) and the wide genomes that
    take fewer rows per block."""
    from repro_torch import _build
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    lib = _build.library()
    limit = gen_k.max_smem_bytes(0)
    for kind, n, length in (("binary", 256, 160), ("binary", 668, 160),
                            ("binary", 1227, 160), ("binary", 230, 1000),
                            ("binary", 5, 40), ("float", 256, 1000),
                            ("float", 37, 64), ("float", 365, 1000),
                            ("float", 64, 7000), ("float", 64, 7300),
                            ("float", 64, 28000)):
        spec, _, _ = _tiled_case(kind, "tournament", "two_point", "none", 1,
                                 n, length, 0)
        want = (lib.generation_smem_bytes(n, length, spec.elite)
                if kind == "binary"
                else lib.generation_float_smem_bytes(
                    n, length, spec.elite,
                    gen_k.float_rows(n, length, spec.elite, limit)))
        assert gen_k.untiled_smem_bytes(n, length, spec, limit) == want
        assert want <= limit


def test_pallas_routes_large_binary_islands_to_the_tiled_kernel(card):
    """300 rows of 1000 genes overflow the binary kernel's shared memory:
    impl='pallas' runs them tiled, equal to the plain version."""
    from repro_torch import kernels
    from repro_torch.kernels.ga import ops
    spec, args, _ = _tiled_case("binary", "tournament", "two_point", "trap",
                                2, 300, 1000, 3)
    args = [t.to(card) for t in args]
    limit = importlib.import_module(
        "repro_torch.kernels.ga.generation").max_smem_bytes(card.index or 0)
    assert ops.route(300, 1000, spec, limit) == "tiled"
    kernels.reset_launches()
    got = ops._pallas(*args, spec, None)
    assert kernels.LAUNCHES["generation"] == 0
    assert kernels.LAUNCHES["generation_tiled"] == 1
    assert kernels.LAUNCHES["roulette_cdf"] == 0
    for a, b in zip(got, gen_ref.generation(*args, spec)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the WKV6 kernel
# ---------------------------------------------------------------------------
def _wkv_inputs(b, seq, h, hd, g, lo=-4.0, hi=1.0):
    """r, k, v ~ N(0, 1), w = exp(-exp(U(lo, hi))), u ~ 0.5 N(0, 1), s0 ~
    0.1 N(0, 1), as the reference's kernel test draws them, in the model's
    layout: (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd)."""
    r, k, v = (torch.randn(b, seq, h, hd, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, seq, h, hd, generator=g)
                             * (hi - lo) + lo))
    u = torch.randn(h, hd, generator=g) * 0.5
    s0 = torch.randn(b, h, hd, hd, generator=g) * 0.1
    return r, k, v, w, u, s0


def _wkv_plain_chunked(r, k, v, w, u, s0, chunk, form="wkv_chunked"):
    """A plain chunked form in the model's layout: wkv_chunked (the
    reference's formulation) or wkv_subchunked (the kernel's)."""
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    b, seq, h, hd = r.shape
    y, s = getattr(wkv_ref, form)(
        *(a.float().transpose(1, 2).reshape(b * h, seq, hd)
          for a in (r, k, v, w)),
        u.float()[None].expand(b, h, hd).reshape(b * h, hd),
        s0.reshape(b * h, hd, hd), chunk=chunk)
    return y.reshape(b, h, seq, hd).transpose(1, 2), s.reshape(b, h, hd, hd)


# (B, S, H, hd, chunk): the shapes of tests/test_kernels.py's WKV6 test
# (S = 37 padded to 64), B and H both above 1 in the first, and one
# batch row of three heads of the serve shape at full length
WKV_SHAPES = [(2, 64, 3, 16, 32), (1, 128, 2, 64, 32), (2, 64, 1, 8, 32),
              (1, 32, 4, 32, 8), (1, 1024, 3, 64, 32)]
WKV_TOL = {"rwkv": dict(atol=1e-3, rtol=2e-3),
           "strong": dict(atol=1e-2, rtol=2e-3)}


def _wkv_case(b, seq, h, hd, decay, dtype, card, seed):
    lo, hi = (-4.0, 1.0) if decay == "rwkv" else (2.0, 4.0)
    r, k, v, w, u, s0 = _wkv_inputs(b, seq, h, hd,
                                    torch.Generator().manual_seed(seed),
                                    lo, hi)
    return [t.to(card) for t in (r.to(dtype), k.to(dtype), v.to(dtype), w,
                                 u.to(dtype), s0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,seq,h,hd,chunk", WKV_SHAPES)
@pytest.mark.parametrize("decay", ["rwkv", "strong"])
def test_wkv_kernel_matches_plain(card, b, seq, h, hd, chunk, decay, dtype):
    """The kernel on the model's layout (r, k, v and u in f32 or bf16)
    against wkv_chunked, wkv_subchunked (its own formulation) and the
    sequential oracle, all on the same values. With RWKV's decays, at the
    reference's kernel tolerance (atol 1e-3, rtol 2e-3): the same f32
    function, summed in another order and with the products in 3xTF32.
    With strong decays the chunk's cumsum of log w reaches about -1760,
    where an f32 ulp is 1.2e-4, so the pairwise exponents L_prev - L carry
    that much absolute error in the reference's own formulation (on the
    CPU, wkv_chunked is 2.7e-3 from an f64 oracle where the sequential
    recurrence is 3.7e-5): atol 1e-2 there."""
    from repro_torch.kernels.rwkv6 import ref as wkv_ref
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_k
    tol = WKV_TOL[decay]
    args = _wkv_case(b, seq, h, hd, decay, dtype, card, seq + hd)
    y, s = wkv_k.wkv_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert y.shape == (b, seq, h, hd) and y.dtype == torch.float32
    assert y.is_contiguous() and s.shape == (b, h, hd, hd)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for want in (_wkv_plain_chunked(*args, chunk),
                 _wkv_plain_chunked(*args, chunk, "wkv_subchunked"),
                 wkv_ref.wkv(*(a.float() for a in args[:4]), args[4].float(),
                             args[5])):
        torch.testing.assert_close(y, want[0], **tol)
        torch.testing.assert_close(s, want[1], **tol)


def test_wkv_kernel_reads_views(card):
    """Views with B and H above 1, as TMA takes them: a head slice, an S
    slice off the base and a bf16 u beside f32 ones; a wrong head or
    batch stride would read another head's rows."""
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_k
    g = torch.Generator().manual_seed(3)
    b, seq, h, hd = 2, 64, 3, 32
    big = [torch.randn(b, seq + 32, 2 * h, hd, generator=g).to(card)
           for _ in range(3)]
    r = big[0].bfloat16()[:, 32:, 2:h + 2]
    k = big[1].bfloat16()[:, :seq, :h]
    v = big[2].bfloat16()[:, 16:16 + seq, h:]
    _, _, _, w, u, s0 = (t.to(card) for t in _wkv_inputs(b, seq, h, hd, g))
    assert not r.is_contiguous()
    y, s = wkv_k.wkv_kernel(r, k, v, w, u, s0)
    want = wkv_k._plain(r, k, v, w, u, s0, wkv_k.CHUNK)
    torch.testing.assert_close(y, want[0], **WKV_TOL["rwkv"])
    torch.testing.assert_close(s, want[1], **WKV_TOL["rwkv"])
    y2, s2 = wkv_k.wkv_kernel(r.contiguous(), k.contiguous(),
                              v.contiguous(), w, u.bfloat16(), s0)
    want = wkv_k._plain(r, k, v, w, u.bfloat16(), s0, wkv_k.CHUNK)
    torch.testing.assert_close(y2, want[0], **WKV_TOL["rwkv"])


def test_wkv_state_carry_composes(card):
    """Two halves run back to back through the kernel equal one run."""
    from repro_torch.kernels.rwkv6 import rwkv6 as wkv_k
    r, k, v, w, u, s0 = [t.to(card) for t in _wkv_inputs(
        2, 64, 3, 16, torch.Generator().manual_seed(7))]
    y, s = wkv_k.wkv_kernel(r, k, v, w, u, s0)
    y1, s1 = wkv_k.wkv_kernel(r[:, :32], k[:, :32], v[:, :32], w[:, :32],
                              u, s0)
    y2, s2 = wkv_k.wkv_kernel(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:],
                              u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-3,
                               rtol=2e-3)
    torch.testing.assert_close(s2, s, atol=1e-3, rtol=2e-3)


def test_wkv_launches_once_per_layer_of_a_prefill(card):
    """One prefill through the kernel launches it once per layer, decode
    never; the plain route agrees (f32 reduced config, S = 37 padded). On
    inputs as the model makes them (bf16 r, k, v and u, f32 w and state, S
    a multiple of the chunk) ops.wkv launches the kernel and nothing else
    on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.models import Model
    cfg = get_config("rwkv6-3b", smoke=True)
    model = Model(cfg, device=card,
                  generator=torch.Generator(device=card).manual_seed(0))
    with torch.no_grad():
        for block in model.segments[0]:
            tm = block[0].mixer
            tm.mix_B.normal_(0.0, 0.1)
            tm.decay_B.normal_(0.0, 0.1)
            tm.decay_base.uniform_(-5.0, 1.0)
    tok = torch.randint(0, cfg.vocab_size, (2, 37), device=card)
    kernels.reset_launches()
    logits, caches, _ = model.prefill({"tokens": tok},
                                      use_rwkv_kernel=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["wkv"] == cfg.n_layers
    want, want_caches, _ = model.prefill({"tokens": tok})
    model.decode(logits.argmax(-1)[:, None], 37, caches)
    assert kernels.LAUNCHES["wkv"] == cfg.n_layers
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[0][0]["wkv"], want_caches[0][0]["wkv"],
                               atol=1e-3, rtol=2e-3)
    args = _wkv_case(2, 64, 4, 64, "rwkv", torch.bfloat16, card, 9)
    wkv_ops.wkv(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wkv_ops.wkv(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "wkv_kernel" in names[0], names


# ---------------------------------------------------------------------------
# the flash-attention kernel
# ---------------------------------------------------------------------------
# (B, S, H, Kv, hd): tests/test_kernels.py's five shapes (MHA, GQA 4:1,
# MQA, S = 50 ragged, hd 64), and the yi-9b serve shape
FLASH_SHAPES = [(1, 64, 4, 4, 16), (2, 96, 8, 2, 32), (1, 64, 4, 1, 16),
                (1, 50, 4, 2, 16), (2, 64, 6, 3, 64), (4, 2048, 32, 4, 128)]
# the reference's tolerances (tests/test_kernels.py)
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
             torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _flash_inputs(b, sq, sk, h, kv, hd, dtype, card, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(card)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_SHAPES)
def test_flash_kernel_matches_plain(card, b, s, h, kv, hd, dtype):
    """Each kernel against ref.attention on the card, causal: f32 through
    the 3xTF32 kernel, bf16 through the bf16 tensor-core one, which rounds p
    to bf16 as the plain version does (the reference's tolerances)."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    q, k, v = _flash_inputs(b, s, s, h, kv, hd, dtype, card, s + h + kv)
    scale = 1.0 / hd ** 0.5
    before = kernels.LAUNCHES["flash_attention"]
    got = fa_k.flash_attention_kernel(q, k, v, scale=scale, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    want = fa_ref.attention(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(50, 50), (17, 200), (200, 17), (129, 65)])
def test_flash_kernel_ragged_and_noncausal(card, causal, sq, sk, dtype):
    """Sq != Sk and lengths off the q and key tiles: each kernel masks the
    ragged edges itself; strided (B, S, H, hd) views are read in place
    (in bf16 by TMA: the views' offsets and strides are multiples of 16
    bytes)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    q, k, v = _flash_inputs(2, sq, sk, 8, 2, 32, dtype, card, sq + sk)
    got = fa_k.flash_attention_kernel(q, k, v, scale=0.2, causal=causal)
    want = fa_ref.attention(q, k, v, causal=causal, scale=0.2)
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
    qs = torch.randn(2, sq, 8, 64, device=card).to(dtype)[..., 16:48]
    wide = torch.randn(2, sk, 2, 64, device=card).to(dtype)
    kt, vt = wide[..., :32], wide[..., 32:]          # last dim contiguous
    got = fa_k.flash_attention_kernel(qs, kt, vt, scale=0.2, causal=causal)
    want = fa_ref.attention(qs, kt, vt, causal=causal, scale=0.2)
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])


# the bf16 (tensor-core) kernel's edges, (B, Sq, Sk, H, Kv, hd, causal):
# every head dim at S <= 128, where only the diagonal tile runs; Sk off the
# 128-key tiles; MQA and GQA 8:1 at hd 128; Sq > Sk causal, where the first
# key tile a block takes (the frontier's) holds 2 keys and rows past Sk
# see every key
FLASH_TC_CASES = [
    (2, 100, 100, 4, 2, 16, True), (2, 100, 100, 4, 2, 32, True),
    (2, 100, 100, 4, 2, 64, True), (2, 100, 100, 4, 2, 128, True),
    (1, 128, 128, 4, 4, 128, True), (1, 300, 300, 4, 2, 64, True),
    (2, 200, 333, 4, 1, 128, False), (1, 300, 300, 8, 8, 16, False),
    (2, 256, 256, 8, 1, 128, True), (1, 384, 384, 16, 2, 128, True),
    (1, 300, 130, 4, 2, 128, True), (2, 200, 17, 8, 2, 32, True),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", FLASH_TC_CASES)
def test_flash_tc_kernel_edges(card, b, sq, sk, h, kv, hd, causal):
    """The bf16 kernel against ref.attention at the reference's bf16
    tolerance, one launch each."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    q, k, v = _flash_inputs(b, sq, sk, h, kv, hd, torch.bfloat16, card,
                            sq + 7 * sk + hd)
    scale = 1.0 / hd ** 0.5
    before = kernels.LAUNCHES["flash_attention"]
    got = fa_k.flash_attention_kernel(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert bool(torch.isfinite(got).all())
    want = fa_ref.attention(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


# the f32 (3xTF32) kernel's edges, (B, Sq, Sk, H, Kv, hd, causal): every
# head dim at S <= 128, one q tile; Sk off the 32-key tiles; MQA and GQA 8:1
# at hd 128; Sq > Sk causal, where rows past Sk see every key; non-causal
FLASH_F32_CASES = [
    (2, 100, 100, 4, 2, 16, True), (2, 100, 100, 4, 2, 32, True),
    (2, 100, 100, 4, 2, 64, True), (2, 100, 100, 4, 2, 128, True),
    (1, 128, 128, 4, 4, 128, True), (1, 300, 300, 4, 2, 64, True),
    (2, 200, 333, 4, 1, 128, False), (1, 300, 300, 8, 8, 16, False),
    (2, 256, 256, 8, 1, 128, True), (1, 384, 384, 16, 2, 128, True),
    (1, 300, 130, 4, 2, 128, True), (2, 200, 17, 8, 2, 32, True),
    (1, 129, 161, 4, 1, 64, False), (3, 33, 33, 2, 2, 128, True),
]


def _flash_f32_case(q, k, v, scale, causal):
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    before = kernels.LAUNCHES["flash_attention"]
    got = fa_k.flash_attention_kernel(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want = fa_ref.attention(q, k, v, causal=causal, scale=scale)
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.float32])


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,causal", FLASH_F32_CASES)
def test_flash_f32_kernel_edges(card, b, sq, sk, h, kv, hd, causal):
    """The f32 kernel (both products in 3xTF32 on the tensor cores)
    against ref.attention at the reference's f32 tolerance, one launch
    each."""
    q, k, v = _flash_inputs(b, sq, sk, h, kv, hd, torch.float32, card,
                            sq + 5 * sk + hd)
    _flash_f32_case(q, k, v, 1.0 / hd ** 0.5, causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_reads_misaligned_views(card, causal):
    """Views 4 bytes off 16 with odd strides, read in place by 4-byte
    loads (the strided views on 16 bytes are
    test_flash_kernel_ragged_and_noncausal's)."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 150, 8, 33, generator=g).to(card)[..., 1:]
    wide = torch.randn(2, 97, 2, 65, generator=g).to(card)
    k, v = wide[..., 1:33], wide[..., 33:]
    assert q.data_ptr() % 16 == k.data_ptr() % 16 == v.data_ptr() % 16 == 4
    _flash_f32_case(q, k, v, 0.2, causal)


def test_flash_launches_once_per_layer_of_a_dense_prefill(card):
    """One prefill through the kernel launches it once per layer, decode
    never; the plain route agrees (f32 reduced yi-9b, S = 37)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("yi-9b", smoke=True)
    model = Model(cfg, device=card,
                  generator=torch.Generator(device=card).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 37), device=card)
    kernels.reset_launches()
    logits, caches, _ = model.prefill({"tokens": tok}, use_flash=True,
                                      max_seq=40)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    want, want_caches, _ = model.prefill({"tokens": tok}, max_seq=40)
    torch.testing.assert_close(logits, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(caches[0][0]["k"], want_caches[0][0]["k"])
    model.decode(logits.argmax(-1)[:, None], 37, caches)
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers


# ---------------------------------------------------------------------------
# The asynchronous runtime and its snapshots on the card
# ---------------------------------------------------------------------------
ASYNC_HETERO = dict(min_rate=0.3, max_rate=1.0, staleness=2,
                    churn_fraction=0.5, seed=3)


def _async_run(card, impl, topology, **kw):
    from repro_torch.core import (AsyncConfig, EAConfig, MigrationConfig,
                                  make_trap, run_fused_async)
    problem = make_trap(8, 4, impl="pallas" if impl != "pallas_ref"
                        else "jnp")
    cfg = EAConfig(max_pop=64, min_pop=32, generations_per_epoch=3,
                   impl=impl)
    return run_fused_async(problem, cfg, MigrationConfig(
        topology=topology, pool_capacity=16), AsyncConfig(**ASYNC_HETERO),
        n_islands=6, max_ticks=5, rng=0, w2=True, return_stats=True,
        return_astate=True, return_obs=True, device=card, **kw)


@pytest.mark.parametrize("topology", ["pool", "ring", "broadcast_best"])
def test_async_kernel_family_bit_equal_under_fire_masks(card, topology):
    """``run_fused_async`` under heterogeneous clocks and churn: the
    kernels (untiled and tiled) equal the plain versions bit for bit, the
    async state and the ledger included."""
    from repro_torch import kernels
    kernels.reset_launches()
    k = _async_run(card, "pallas", topology)
    assert kernels.LAUNCHES["generation"] > 0
    for impl in ("pallas_tiled", "pallas_ref"):
        other = _async_run(card, impl, topology)
        for a, b in zip(k[:2] + k[3:5], other[:2] + other[3:5]):
            for name, u, v in zip(a._fields, a, b):
                assert torch.equal(u, v), f"{impl}: {name}"
        assert int(k[2]) == int(other[2]) and k[5] == other[5]


def test_async_resume_on_the_card_equals_uninterrupted(card, tmp_path):
    """Snapshots of card tensors (copied to the host before the writer
    thread starts) restore onto the card, and the resumed run is the
    uninterrupted one."""
    full = _async_run(card, "pallas", "pool", snapshot_every=2,
                      snapshot_dir=str(tmp_path))
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_00000002", "step_00000004", "step_00000005"]
    import shutil
    shutil.rmtree(tmp_path / steps[-1])
    res = _async_run(card, "pallas", "pool", snapshot_every=2,
                     snapshot_dir=str(tmp_path), resume=True)
    for a, b in zip(full[:2] + full[3:5], res[:2] + res[3:5]):
        for name, u, v in zip(a._fields, a, b):
            assert u.device.type == "cuda" and torch.equal(u, v), name
    assert full[5] == res[5]


def test_async_tick_adds_no_host_sync(card):
    """``fused_scan_async`` waits for the device no more often than
    ``fused_scan`` (once per tick, for the early-stop latch): the
    synchronizing calls ``torch.cuda.set_sync_debug_mode`` reports over 3
    ticks are at most those of 3 sync epochs."""
    import warnings

    from repro_torch import rand
    from repro_torch.core import (AsyncConfig, EAConfig, MigrationConfig,
                                  make_trap)
    from repro_torch.core import island as island_lib
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.async_migration import (fused_scan_async,
                                                  init_async_state)
    from repro_torch.core.evolution import fused_scan
    problem = make_trap(8, 4, impl="pallas")
    cfg = EAConfig(max_pop=64, min_pop=32, generations_per_epoch=3,
                   impl="pallas")
    mig = MigrationConfig(pool_capacity=16)
    k = rand.key(0, device=card)
    islands = island_lib.init_islands(k, 6, problem, cfg, device=card)
    pool = pool_lib.pool_init(16, problem.genome, device=card)
    astate = init_async_state(k, 6, AsyncConfig(**ASYNC_HETERO), 3,
                              problem.genome)
    kw = dict(problem=problem, cfg=cfg, mig=mig, w2=False,
              with_stats=False)

    def syncs(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message).lower() for w in caught)

    n_sync = syncs(lambda: fused_scan(islands, pool, k, max_epochs=3, **kw))
    n_async = syncs(lambda: fused_scan_async(
        islands, pool, astate, k, acfg=AsyncConfig(**ASYNC_HETERO),
        max_ticks=3, **kw))
    assert n_sync >= 3 and n_async <= n_sync, (n_sync, n_async)


# ordered_sum's window order past 64 terms (kernels/trap/csrc/
# ordered_sum.cuh): every kernel that sums a row, bit-equal to its plain
# version, with one launch
@pytest.mark.parametrize("n,n_traps", [(2048, 65), (2048, 100), (1000, 200),
                                       (300, 1000), (257, 1025)])
def test_trap_kernel_sum_order_past_64_traps(card, n, n_traps):
    from repro_torch import kernels
    g = torch.Generator().manual_seed(n_traps)
    pop = (torch.rand(n, n_traps * 4, generator=g) < 0.55).to(
        torch.int8).to(card)
    before = kernels.LAUNCHES["trap_fitness"]
    got = trap_k.trap_fitness(CONSTS, pop, n_traps=n_traps)
    assert kernels.LAUNCHES["trap_fitness"] == before + 1
    assert torch.equal(got, trap_ref.trap_fitness(pop, n_traps=n_traps, l=4,
                                                  a=1.0, b=2.0, z=3.0))


@pytest.mark.parametrize("n,dim,m", [(1000, 130, 65), (1000, 300, 100),
                                     (1000, 1000, 10), (300, 2000, 2000),
                                     (64, 4200, 100)])
def test_f15_kernel_sum_order_past_64_terms(card, n, dim, m):
    """m 65 and 100 (a group's terms), 100 and 42 groups (the group sums),
    and the sliced route at m 2000 (slices that start windows)."""
    g = torch.Generator().manual_seed(n + dim + m)
    consts = _f15_consts(dim, m, g, card)
    x = (torch.rand(n, dim, generator=g) * 10 - 5).to(card)
    assert torch.equal(f15_k.f15(consts, x), f15_ref.f15(consts, x))


@pytest.mark.parametrize("length", [65, 100, 1000, 2000])
@pytest.mark.parametrize("fused", ["rastrigin", "sphere"])
def test_fused_sums_past_64_genes_untiled_and_tiled(card, length, fused):
    """The float generation kernel and the tiled kernel (2 and 8 rows per
    block) with the fused rastrigin or sphere sum, bit-equal to the plain
    version."""
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    from repro_torch.kernels.ga import tiling
    spec, args, g = _tiled_case("float", "tournament", "blend", fused, 2, 24,
                                length, length)
    args = [t.to(card) for t in args]
    want = _as_tuple(gen_ref.generation(*args, spec))
    runs = [_as_tuple(gen_k.generation_kernel(*args, spec))]
    runs += [_as_tuple(tiling.generation_tiled(*args, spec, tile_pop=rows))
             for rows in (2, 8)]
    for got in runs:
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("length,m", [(130, 65), (1000, 10)])
def test_fused_f15_sum_order_past_64_terms(card, length, m):
    gen_k = importlib.import_module("repro_torch.kernels.ga.generation")
    spec, args, g = _tiled_case("float", "tournament", "blend", "f15", 2, 24,
                                length, m)
    spec = dataclasses.replace(spec, fused_eval=(
        ("eval", "f15"), ("m", m), ("n_groups", length // m)))
    consts = _f15_consts(length, m, g, card)
    args = [t.to(card) for t in args]
    got = _as_tuple(gen_k.generation_kernel(*args, spec, consts))
    want = _as_tuple(gen_ref.generation(*args, spec, consts))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the host tier on the card: pool_insert_host into a card pool, and a
# bridged host loop through the kernels against the plain run on the CPU
@pytest.mark.parametrize("policy", ["always", "elitist"])
def test_pool_insert_host_on_a_card_pool(card, policy):
    import numpy as np

    from repro_torch import rand
    from repro_torch.core import AcceptanceConfig
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.types import GenomeSpec
    gen = np.random.default_rng(3)
    pools = {d: pool_lib.pool_init(6, GenomeSpec("binary", 12), device=d)
             for d in ("cpu", card)}
    for epoch in range(1, 5):
        genomes = [gen.integers(0, 2, 12) for _ in range(3)]
        fits = [float(x) for x in gen.integers(0, 9, 3)]
        for d in pools:
            pools[d] = pool_lib.pool_insert_host(
                pools[d], genomes, fits, acc=AcceptanceConfig(policy=policy),
                rng=rand.fold_in(rand.key(17, device=d), epoch))
    assert pools[card].genomes.device.type == "cuda"
    assert pools[card].genomes.dtype == torch.int8
    for a, b in zip(pools[card], pools["cpu"]):
        assert torch.equal(a.cpu(), b)


def test_bridged_run_on_the_card_equals_the_plain_run_on_the_cpu(card):
    from repro_torch.core import (EAConfig, HostBridge, MigrationConfig,
                                  PoolServer, make_trap, run_experiment)
    out = {}
    for device, impl in ((card, "pallas"), ("cpu", "pallas_ref")):
        server = PoolServer(capacity=256, seed=1)
        bridge = HostBridge(server, pull=4)

        def up(epoch):
            server.revive() if epoch != 2 else server.kill()
            return epoch != 2
        res = run_experiment(
            make_trap(12, 4, impl="pallas"),
            EAConfig(impl=impl, max_pop=32, min_pop=16,
                     generations_per_epoch=5),
            MigrationConfig(), n_islands=4, max_epochs=4, rng=2, w2=True,
            server_up=up, host_bridge=bridge, device=device)
        server.revive()
        entries, _, _ = server.get_since(-1, limit=1000)
        out[device if device == "cpu" else "card"] = (
            res, bridge.stats(),
            [(e.seq, e.uuid, e.fitness, e.genome.tobytes()) for e in entries])
    (a, sa, ea), (b, sb, eb) = out["card"], out["cpu"]
    for x, y in zip(a.islands, b.islands):
        assert torch.equal(x.cpu(), y)
    for x, y in zip(a.pool, b.pool):
        assert torch.equal(x.cpu(), y)
    assert sa == sb and sa["lost"] > 0 and ea == eb


# ---------------------------------------------------------------------------
# the kernels refuse autograd; training on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_inputs_that_require_grad(card, dtype):
    """Neither kernel has a backward: under grad mode an input that
    requires grad raises (naming the plain version); under no_grad, or
    with no input requiring grad, both launch."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, 64, generator=g, device=card,
                           dtype=dtype) for _ in range(3))
    r, kk, vv = (torch.randn(1, 64, 2, 64, generator=g, device=card,
                             dtype=dtype) for _ in range(3))
    w = torch.rand(1, 64, 2, 64, generator=g, device=card) * 0.5 + 0.4
    u = torch.randn(2, 64, generator=g, device=card)
    s0 = torch.zeros(1, 2, 64, 64, device=card)
    for t in (q, r, w):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ref.py::attention"):
        flash_ops.flash_attention(q, k, v, scale=0.125)
    with pytest.raises(RuntimeError, match="ref.py::wkv"):
        wkv_ops.wkv(r, kk, vv, w, u, s0)
    before = dict(LAUNCHES)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v, scale=0.125)
        wkv_ops.wkv(r, kk, vv, w, u, s0)
    flash_ops.flash_attention(q.detach(), k, v, scale=0.125)
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert LAUNCHES["wkv"] == before["wkv"] + 1


# card against CPU over the steps (the tolerances of chip_smoke.py's
# CARD_CPU_TOL): ce and gnorm relative, final parameters absolute
CARD_CPU_TOL = {"minicpm-2b": dict(ce=1e-5, gnorm=1e-4, params=1e-5),
                "rwkv6-3b": dict(ce=1e-5, gnorm=1e-3, params=1e-3)}


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-3b"])
def test_train_step_on_the_card_matches_the_cpu(card, arch):
    """Smoke f32 from the same state and batches, 3 steps: ce, gnorm and
    the parameters within :data:`CARD_CPU_TOL` (other sum orders on the
    card; RWKV6's zero-started LoRA factors make Adam amplify them)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import make_schedule
    tol = CARD_CPU_TOL[arch]
    cfg = get_config(arch, smoke=True)
    state = init_train_state(Model(cfg, device="cpu"))
    sched = make_schedule("wsd", 3e-3, 10, 2)
    steps = {d: make_train_step(Model(cfg, device="meta"), schedule=sched)
             for d in ("cpu", "cuda")}
    states = {"cuda": convert.to_device(state, card), "cpu": state}
    for i in range(3):
        ms = {}
        for d in states:
            batch = SyntheticLM(256, 64, 8, device=d).batch_for_step(i)
            states[d], ms[d] = steps[d](states[d], batch)
        torch.testing.assert_close(ms["cuda"]["ce"].cpu(), ms["cpu"]["ce"],
                                   rtol=tol["ce"], atol=0)
        torch.testing.assert_close(ms["cuda"]["grad_norm"].cpu(),
                                   ms["cpu"]["grad_norm"],
                                   rtol=tol["gnorm"], atol=0)
    for k, v in states["cpu"].params.items():
        torch.testing.assert_close(states["cuda"].params[k].cpu(), v,
                                   rtol=0, atol=tol["params"])


def test_fma_on_the_card_is_rand_fma(card):
    """``models.common.fma`` on the card (``torch.addcmul``) against
    ``rand.fma``'s exact emulation, bit for bit: random triples, products
    that cancel the addend, and the SSM scan's range."""
    from repro_torch import rand
    from repro_torch.models.common import fma
    g = torch.Generator(device=card).manual_seed(7)
    a = torch.randn(1 << 22, generator=g, device=card)
    b = torch.randn(1 << 22, generator=g, device=card)
    c = torch.randn(1 << 22, generator=g, device=card)
    for c_ in (c, -(a * b) * (1 + 2 ** -20 * c), c * 1e-8,
               torch.rand(1 << 22, generator=g, device=card)):
        assert torch.equal(fma(a, b, c_), rand.fma(a, b, c_))


def test_moe_routing_on_the_card_equals_the_cpu(card):
    """olmoe-1b-7b reduced in f32, the same weights and a 1024-token
    prompt (two SEQ_CHUNK slices, drops at capacity factor 0.3) on the
    card and on the CPU: expert indices, positions, keep equal; logits
    close."""
    import copy
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              capacity_factor=0.3)
    cpu = Model(cfg, device="cpu")
    dev = copy.deepcopy(cpu).to(card)
    tok = torch.randint(0, 256, (2, 1024),
                        generator=torch.Generator().manual_seed(3))
    with moe.recording() as r_cpu:
        want, _, _ = cpu.prefill({"tokens": tok})
    with moe.recording() as r_card:
        got, _, _ = dev.prefill({"tokens": tok.to(card)}, use_flash=True)
    assert len(r_card) == len(r_cpu) == 2 * cfg.n_layers
    for a, b in zip(r_card, r_cpu):
        assert torch.equal(a.experts.cpu(), b.experts)
        assert torch.equal(a.position.cpu(), b.position)
        assert torch.equal(a.keep.cpu(), b.keep)
    assert not all(bool(r.keep.all()) for r in r_cpu)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
