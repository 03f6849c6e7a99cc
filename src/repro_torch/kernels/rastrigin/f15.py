"""F15 wrapper: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor.

Replaces ``repro/kernels/rastrigin/ops.py::f15`` and the Pallas kernel
behind it (``rastrigin.py::f15_kernel``). The reference shifts, permutes
and pads the population into a copy in device memory before its kernel;
here the kernel reads the shift and the permutation itself, so one launch
takes the population as it is.

The kernel (``csrc/f15.cu``) takes tiles of ``rows`` rows and the groups
in batches of ``groups``, and loops over the tiles with ``grid`` blocks.
Where not even one row fits its shared memory beside the rotations (D
above 51,900 at m 50), its helpers gather z from device memory instead
(``gather``). Where two rotations do not fit (m above 169), or a group's
micro-tiles outnumber its compute threads (m above 1536), it runs its
sliced route: each rotation in slices of ``cols`` columns, z gathered
from device memory, any (n, D, m). :func:`launch_shape` picks
the route and the shape, a plain function of the shape and the card's
limits (:class:`Limits`), so the CPU tests can check it; on the card
:func:`card_shape` feeds it the card's limits and sets the grid from the
occupancy the runtime reports.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from ... import _build
from .. import LAUNCHES
from ..trap.ref import sum_group
from . import ref as _ref

# csrc/f15.cu: compute and helper threads of a block (a compute thread
# takes at most one micro-tile of a batch, a helper at most one row of a
# tile) and a thread's micro-tile (rows x columns)
COMPUTE, HELPERS = 384, 128
MICRO_ROWS, MICRO_COLS = 4, 4
# an SM issues one warp instruction per scheduler and clock: 4 warps, 128
# lanes of micro-tiles per round
LANES_PER_ROUND = 128
# a batch's own cost besides its rounds (its barriers and the compute
# warps' term stores; the helpers' sums and gather overlap the rounds), in
# rounds
BATCH_ROUNDS = 0.15
# csrc/f15.cu's sliced route: threads of a block (a thread takes at most
# one micro-tile of a slice, so rows x cols <= 4096), rows of M staged per
# chunk, the pitch of z, and the blocks an SM holds by threads
SLICED_THREADS = 256
SLICE_J = 32
SLICE_ZP = SLICE_J + 1
SLICED_BLOCKS_PER_SM = 2048 // SLICED_THREADS
SLICED_ROWS = (64, 32, 16, 8, 4)


@dataclasses.dataclass(frozen=True)
class Limits:
    """What the launch shape depends on: the card's SMs, its shared memory
    per SM, per block (opt-in) and reserved per block, and the blocks an SM
    holds by threads and registers alone."""
    sms: int
    smem_per_sm: int
    smem_per_block: int
    reserved_per_block: int
    blocks_per_sm: int


# an NVIDIA H100 SXM's: 132 SMs, 228 KB per SM, 227 KB per block, 1 KB
# reserved; one block of 512 threads at the 85 registers ptxas gives the
# kernel (nvcc 12.9)
H100 = Limits(132, 233472, 232448, 1024, 1)


@dataclasses.dataclass(frozen=True)
class Shape:
    rows: int      # rows per tile
    groups: int    # groups per batch (the sliced route: 1)
    grid: int      # blocks, each looping over tiles
    smem: int      # shared memory per block, bytes
    cols: int = 0  # columns per slice on the sliced route; 0: tiled route
    gather: bool = False  # tiled route: z gathered from device memory


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(rows: int, dim: int, m: int, groups: int,
               gather: bool = False) -> int:
    """Shared memory of a block (``csrc/f15.cu::layout``): three mbarriers,
    the rows (and 16 bytes for their offset; none where z is gathered from
    device memory), a ring of two halves of groups rotations, two buffers
    of rows x groups x m f32 (a batch's z, then its terms), the tile's
    group sums (rows x D / m f32)."""
    return (32 + (0 if gather else _align16(rows * dim * 4 + 16))
            + 2 * _align16(groups * m * m * 4 + 16)
            + 2 * _align16(rows * groups * m * 4)
            + _align16(rows * (dim // m) * 4))


def sliced_smem_bytes(rows: int, cols: int) -> int:
    """Shared memory of a block of the sliced route
    (``csrc/f15.cu::sliced_bytes``): z (rows x 33 f32), a chunk of M's
    slice (32 x cols rounded up to 4 f32) and the slice's terms
    (rows x (cols + 1) f32)."""
    return 4 * (rows * SLICE_ZP + SLICE_J * ((cols + 3) & ~3)
                + rows * (cols + 1))


def sliced_shape(n: int, dim: int, m: int, limits: Limits) -> Shape:
    """The sliced route's launch: the tallest tile (64 rows down to 4)
    that still leaves no SM without a tile, then the widest slice its 256
    threads cover (rows x cols <= 4096), whole groups of ordered_sum's
    order (``sum_group(m)`` columns) unless it is the whole rotation.
    Takes every shape: shared memory stays under 150 KB."""
    rows = next((r for r in SLICED_ROWS if -(-n // r) >= limits.sms),
                SLICED_ROWS[-1])
    cap = SLICED_THREADS * MICRO_ROWS * MICRO_COLS // rows
    k = sum_group(m)
    cols = m if m <= cap else cap // k * k
    smem = sliced_smem_bytes(rows, cols)
    per_sm = min(SLICED_BLOCKS_PER_SM,
                 limits.smem_per_sm // (smem + limits.reserved_per_block))
    return Shape(rows, 1, grid_of(n, rows, limits.sms, per_sm), smem, cols)


def tasks(rows: int, m: int, groups: int) -> int:
    """Micro-tiles of a batch: groups x row blocks x column blocks."""
    return groups * -(-rows // MICRO_ROWS) * -(-m // MICRO_COLS)


def blocks_per_sm(smem: int, limits: Limits) -> int:
    """Blocks of ``smem`` bytes an SM holds (0 if one does not fit)."""
    if smem > limits.smem_per_block:
        return 0
    return min(limits.blocks_per_sm,
               limits.smem_per_sm // (smem + limits.reserved_per_block))


def grid_of(n: int, rows: int, sms: int, per_sm: int) -> int:
    """Blocks of a launch: every tile, or as many as the card holds at once
    (each block then loops over tiles)."""
    return min(-(-n // rows), sms * per_sm)


def _rounds(n_groups: int, rows: int, m: int, groups: int) -> float:
    """Rounds of micro-tiles of one tile: each batch's tasks over 128
    lanes, and each batch's own cost."""
    full, rest = divmod(n_groups, groups)
    rounds = full * (-(-tasks(rows, m, groups) // LANES_PER_ROUND)
                     + BATCH_ROUNDS)
    if rest:
        rounds += -(-tasks(rows, m, rest) // LANES_PER_ROUND) + BATCH_ROUNDS
    return rounds


def _cost(n: int, dim: int, m: int, rows: int, groups: int,
          limits: Limits, gather: bool = False
          ) -> Optional[Tuple[float, int, int, int]]:
    """(the busiest SM's rounds, its rows, the grid, smem), or None where
    the block does not fit."""
    smem = smem_bytes(rows, dim, m, groups, gather)
    per_sm = blocks_per_sm(smem, limits)
    if per_sm == 0 or tasks(rows, m, groups) > COMPUTE:
        return None
    tiles = -(-n // rows)
    grid = grid_of(n, rows, limits.sms, per_sm)
    # blocks an SM runs at once, and tiles of the block with the most
    stacked = -(-grid // limits.sms) * -(-tiles // grid)
    return (stacked * _rounds(dim // m, rows, m, groups), stacked * rows,
            grid, smem)


def shape_for_rows(n: int, dim: int, m: int, rows: int,
                   limits: Limits, gather: bool = False) -> Shape:
    """The cheapest launch of tiles of ``rows`` rows (their rows staged, or
    z gathered from device memory): the groups per batch that give the
    busiest SM the fewest rounds (then the fewest groups)."""
    if not 1 <= rows <= HELPERS:
        raise ValueError(f"f15: rows per tile must be in [1, {HELPERS}], "
                         f"got {rows}")
    best = None
    for groups in range(1, dim // m + 1):
        cost = _cost(n, dim, m, rows, groups, limits, gather)
        if cost is None:
            break
        if best is None or cost[0] < best[0][0]:
            best = (cost, groups)
    if best is None:
        raise ValueError(
            f"f15: {rows} rows of D = {dim} with m = {m} need "
            f"{smem_bytes(rows, dim, m, 1, gather)} bytes of shared memory "
            f"(the card has {limits.smem_per_block} per block) and "
            f"{tasks(rows, m, 1)} micro-tiles a group (a block computes "
            f"{COMPUTE} at once)")
    (_, _, grid, smem), groups = best
    return Shape(rows, groups, grid, smem, gather=gather)


@functools.lru_cache(maxsize=256)
def launch_shape(n: int, dim: int, m: int, limits: Limits) -> Shape:
    """Rows per tile, groups per batch and grid for an (n, dim) population
    with groups of m: the fewest rounds of micro-tiles on the busiest SM
    (the grid counted in whole waves, blocks an SM holds at once from the
    shared memory they need), then the fewest rows on it, then the largest
    tile. Where not even one staged row fits, the same search with z
    gathered from device memory (no rows in shared memory); where not even
    two rotations fit, the sliced route's :func:`sliced_shape`. No shape
    the plain version takes is refused."""
    if n < 1 or m < 1 or dim % m:
        raise ValueError(f"f15: no launch for n = {n}, D = {dim}, m = {m}")
    for gather in (False, True):
        best = None
        for rows in range(1, min(HELPERS, n) + 1):
            if smem_bytes(rows, dim, m, 1, gather) > limits.smem_per_block \
                    or tasks(rows, m, 1) > COMPUTE:
                break
            shape = shape_for_rows(n, dim, m, rows, limits, gather)
            cost = _cost(n, dim, m, rows, shape.groups, limits, gather)
            key = (round(cost[0], 6), cost[1], -rows)
            if best is None or key < best[0]:
                best = (key, shape)
        if best is not None:
            return best[1]
    return sliced_shape(n, dim, m, limits)


@functools.lru_cache(maxsize=None)
def device_limits(device_index: int) -> Limits:
    """The card's :class:`Limits`, queried once per card."""
    lib = _build.library()
    vals = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        _build.check(lib.f15_device_limits(ctypes.addressof(vals)),
                     "f15_device_limits")
        per_sm = lib.f15_blocks_per_sm(0, 0, 0)
    if per_sm < 1:
        raise RuntimeError(f"f15: the occupancy query failed ({per_sm})")
    return Limits(*vals, per_sm)


def card_shape(n: int, dim: int, m: int, device: torch.device,
               rows: Optional[int] = None) -> Shape:
    """:func:`launch_shape` on this card (:func:`shape_for_rows` where
    ``rows`` is given, as the builder's sweep runs it), its grid from the
    occupancy that ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports for the chosen shared memory."""
    limits = device_limits(device.index)
    shape = (launch_shape(n, dim, m, limits) if rows is None
             else shape_for_rows(n, dim, m, rows, limits))
    with torch.cuda.device(device):
        per_sm = _build.library().f15_blocks_per_sm(
            shape.smem, shape.cols, int(shape.gather))
    if per_sm < 1:
        raise RuntimeError(f"f15: no block of {shape.smem} bytes fits an SM "
                           f"({per_sm})")
    return dataclasses.replace(
        shape, grid=grid_of(n, shape.rows, limits.sms, per_sm))


def check_consts(consts: Dict[str, torch.Tensor], dim: int,
                 device: torch.device, what: str) -> None:
    """Raise unless ``o`` (D,) f32, ``perm`` (D,) int32 and ``M``
    (G, m, m) f32 with G*m = D lie contiguous on ``device``."""
    o, perm, M = consts["o"], consts["perm"], consts["M"]
    if M.dim() != 3 or M.shape[1] != M.shape[2] \
            or M.shape[0] * M.shape[1] != dim:
        raise ValueError(f"{what}: M must be (G, m, m) with G*m = {dim}, "
                         f"got {tuple(M.shape)}")
    for name, t, dtype, shape in (("o", o, torch.float32, (dim,)),
                                  ("perm", perm, torch.int32, (dim,)),
                                  ("M", M, torch.float32, tuple(M.shape))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{device}, got {t.device}")


def f15(consts: Dict[str, torch.Tensor], pop: torch.Tensor) -> torch.Tensor:
    """CEC2010-F15 (minimised) of an (N, D) f32 population -> (N,) f32."""
    if pop.device.type == "cpu":
        return _ref.f15(consts, pop)
    if pop.device.type != "cuda":
        raise ValueError(f"f15: no kernel for device {pop.device}")
    if pop.dtype != torch.float32 or pop.dim() != 2:
        raise ValueError(f"f15: want a 2-D f32 population, got {pop.dtype} "
                         f"{tuple(pop.shape)}")
    if not pop.is_contiguous():
        raise ValueError("f15: the population must be contiguous")
    n, dim = pop.shape
    check_consts(consts, dim, pop.device, "f15")
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=pop.device)
    m = consts["M"].shape[1]
    return launch(consts, pop, card_shape(n, dim, m, pop.device))


def launch(consts: Dict[str, torch.Tensor], pop: torch.Tensor,
           shape: Shape) -> torch.Tensor:
    """The kernel on inputs :func:`f15` has checked, at ``shape``."""
    n, dim = pop.shape
    n_groups, m, _ = consts["M"].shape
    out = torch.empty(n, dtype=torch.float32, device=pop.device)
    lib = _build.library()
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.f15_launch(
            pop.data_ptr(), consts["o"].data_ptr(), consts["perm"].data_ptr(),
            consts["M"].data_ptr(), out.data_ptr(), n, dim, m, n_groups,
            sum_group(m), shape.rows, shape.groups, shape.cols,
            int(shape.gather), shape.grid, stream)
    _build.check(err, "f15")
    LAUNCHES["f15"] += 1
    return out
