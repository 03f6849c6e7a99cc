"""Generation kernel wrapper: the CUDA kernels for CUDA tensors, the plain
version for CPU tensors.

Replaces ``repro/kernels/ga/generation.py::generation_kernel``. Binary
genomes go to ``csrc/generation.cu``: a cluster of ``min(CLUSTER, n)``
CTAs per island, each holding the island's int8 tile (one TMA bulk copy
multicast to the cluster) and making its share of the rows, so above the
card's opt-in shared memory per block the wrapper raises. Float genomes go
to ``csrc/generation_float.cu``: a grid of (row blocks, islands) that
reads parents from device memory and keeps only a few rows in shared
memory, with the fused F15 register-blocked over them. Larger islands are
the tiled kernel's (:mod:`.tiling`), where ``ops.route`` sends
``impl='pallas'``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from ... import _build
from .. import LAUNCHES
from ..rastrigin.f15 import check_consts
from ..trap.ref import sum_group
from . import ref as _ref
from .common import GenerationSpec, f15_consts, spec_needs_consts

EVAL_KINDS = {None: 0, "trap": 1, "onemax": 2, "royal_road": 3,
              "rastrigin": 4, "sphere": 5, "f15": 6}
BINARY_EVALS = (None, "trap", "onemax", "royal_road")
FLOAT_EVALS = (None, "rastrigin", "sphere", "f15")
CROSSOVERS = {"two_point": 0, "uniform": 1, "blend": 2}


# the binary kernel's most CTAs per island (csrc/generation.cu
# MAX_CLUSTER, a non-portable cluster size) and the float kernel's rows
# per block (csrc/generation_float.cu, ROWS), halved to 2 or 1 where a
# block would not fit the card's shared memory (PERF.md has the timings
# in turns that chose both)
CLUSTER = 16
FLOAT_ROWS = 4
# the warps of each kernel's elite arg-max (csrc/plan_rows.cuh elite_rows)
BINARY_ELITE_WARPS = 7
FLOAT_ELITE_WARPS = 8


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def cluster_size(n: int) -> int:
    """CTAs per island of the binary kernel (``cluster_size`` in
    csrc/generation.cu): one per row, at most CLUSTER."""
    return max(1, min(CLUSTER, n))


def binary_smem_bytes(n: int, length: int, elite: int) -> int:
    """Shared memory of one CTA of the binary kernel
    (``generation_smem_bytes`` in csrc/generation.cu): the tile's mbarrier,
    masked fitness, CDF, elite, the arg-max scratch and the plan of its
    ``ceil(n / cluster_size(n))`` rows, in 16-byte units, then the tile
    with 32 bytes of slack for its offset."""
    rows = -(-n // cluster_size(n))
    words = 4 + 2 * n + elite + 4 * BINARY_ELITE_WARPS + 5 * rows
    return _align16(4 * words) + n * length + 32


def float_smem_bytes(n: int, length: int, elite: int, rows: int) -> int:
    """Shared memory of one block of the float kernel
    (``float_smem_bytes`` in csrc/generation_float.cu): two ``rows`` x L
    f32 buffers, masked fitness, CDF, elite, the arg-max scratch and the
    plan of ``rows`` rows."""
    return (2 * rows * length * 4
            + (2 * n + elite + 4 * FLOAT_ELITE_WARPS + 5 * rows) * 4)


def float_rows(n: int, length: int, elite: int,
               smem_limit: Optional[int]) -> int:
    """Rows per block of the float kernel: FLOAT_ROWS, halved until a
    block fits the card's ``smem_limit`` bytes per block (at least 1;
    None: no card, no such limit)."""
    r = FLOAT_ROWS
    while (r > 1 and smem_limit is not None
           and float_smem_bytes(n, length, elite, r) > smem_limit):
        r //= 2
    return r


def untiled_smem_bytes(n: int, length: int, spec: GenerationSpec,
                       smem_limit: Optional[int] = None) -> int:
    """Shared memory of one block of the untiled kernel for an (n, L)
    island at the launch shape the wrapper picks on a card that allows
    ``smem_limit`` bytes per block, as the C launchers size it
    (``generation_smem_bytes``, ``generation_float_smem_bytes``)."""
    if spec.kind == "binary":
        return binary_smem_bytes(n, length, spec.elite)
    return float_smem_bytes(n, length, spec.elite,
                            float_rows(n, length, spec.elite, smem_limit))


@functools.lru_cache(maxsize=None)
def max_smem_bytes(device_index: int) -> int:
    """The card's opt-in shared memory per block, queried once per card."""
    with torch.cuda.device(device_index):
        return int(_build.library().generation_max_smem_bytes())


def check_inputs(seed, size, pop, fitness, genes):
    """Raise unless pop (I, n, L) of ``genes``, fitness (I, n) f32, seed
    (I, 2) int64 words with unit stride and size (I,) int32 lie contiguous
    on one device."""
    n_isl, n, _ = pop.shape
    if pop.dtype != genes:
        raise ValueError(f"generation kernel: want {genes} genomes, got "
                         f"{pop.dtype}")
    if fitness.dtype != torch.float32 or tuple(fitness.shape) != (n_isl, n):
        raise ValueError(f"generation kernel: fitness must be f32 "
                         f"{(n_isl, n)}, got {fitness.dtype} "
                         f"{tuple(fitness.shape)}")
    if tuple(seed.shape) != (n_isl, 2) or tuple(size.shape) != (n_isl,):
        raise ValueError("generation kernel: want seed (I, 2) and size (I,)")
    if seed.dtype != torch.int64 or seed.stride(-1) != 1:
        raise ValueError(f"generation kernel: seed must be int64 words with "
                         f"unit stride, got {seed.dtype} strides "
                         f"{seed.stride()}")
    if size.dtype != torch.int32:
        raise ValueError(f"generation kernel: size must be int32, got "
                         f"{size.dtype}")
    for name, t in (("seed", seed), ("size", size), ("fitness", fitness)):
        if t.device != pop.device:
            raise ValueError(f"generation kernel: {name} is on {t.device}, "
                             f"pop on {pop.device}")
    if not (pop.is_contiguous() and fitness.is_contiguous()
            and size.is_contiguous()):
        raise ValueError("generation kernel: inputs must be contiguous")


def _check_smem(need: int, limit: int, n: int, length: int) -> None:
    if need > limit:
        raise ValueError(
            f"generation kernel: a {n}x{length} island needs {need} B of "
            f"shared memory, the card allows {limit} B per block; "
            "impl='pallas' routes such islands to the tiled kernel "
            "(tiling.py)")


def generation_kernel(seed: torch.Tensor, size: torch.Tensor,
                      pop: torch.Tensor, fitness: torch.Tensor,
                      spec: GenerationSpec, consts=None):
    """seed (I, 2) words, size (I,) int32, pop (I, n, L) int8 or f32,
    fitness (I, n) f32 -> new pop (I, n, L) [+ (I, n) f32 raw fitness when
    ``spec.fused_eval`` is set]. A fused f15 eval reads ``consts``
    (``o``, ``perm``, ``M`` on the population's device)."""
    if pop.dim() != 3:
        raise ValueError(f"generation kernel: want (I, n, L), got "
                         f"{tuple(pop.shape)}")
    if pop.device.type == "cpu":
        return _ref.generation(seed, size, pop, fitness, spec, consts)
    if pop.device.type != "cuda":
        raise ValueError(f"generation kernel: no kernel for {pop.device}")
    n_isl, n, length = pop.shape
    if length != spec.length:
        raise ValueError(f"population has {length} genes, spec {spec.length}")
    kind = (spec.eval_spec or {}).get("eval")
    evals = BINARY_EVALS if spec.kind == "binary" else FLOAT_EVALS
    if kind not in evals:
        raise ValueError(f"generation kernel: no fused {kind!r} eval for "
                         f"{spec.kind} genomes")
    if spec.kind == "binary":
        return _launch_binary(seed, size, pop, fitness, spec)
    return _launch_float(seed, size, pop, fitness, spec, consts)


def _launch_binary(seed, size, pop, fitness, spec):
    check_inputs(seed, size, pop, fitness, torch.int8)
    n_isl, n, length = pop.shape
    ev = spec.eval_spec or {}
    kind = ev.get("eval")
    trap_l = int(ev.get("l", 1))
    royal_r = int(ev.get("r", 1))
    if kind == "trap" and length % trap_l:
        raise ValueError(f"trap blocks of {trap_l} do not tile {length}")
    if kind == "royal_road" and length % royal_r:
        raise ValueError(f"royal_road blocks of {royal_r} do not tile "
                         f"{length}")
    lib = _build.library()
    _check_smem(binary_smem_bytes(n, length, spec.elite),
                max_smem_bytes(pop.device.index), n, length)
    new_pop = torch.empty_like(pop)
    fit_out = (torch.empty((n_isl, n), dtype=torch.float32, device=pop.device)
               if kind is not None else None)
    if n_isl == 0 or n == 0:
        return new_pop if fit_out is None else (new_pop, fit_out)
    z = float(ev.get("z", 0.0))
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.generation_launch(
            pop.data_ptr(), fitness.data_ptr(), seed.data_ptr(),
            seed.stride(0), size.data_ptr(), new_pop.data_ptr(),
            None if fit_out is None else fit_out.data_ptr(),
            n_isl, n, length, spec.elite,
            0 if spec.selection == "tournament" else 1, spec.tournament_k,
            CROSSOVERS[spec.crossover],
            float(spec.crossover_rate), float(spec.mutation_rate),
            EVAL_KINDS[kind], trap_l, sum_group(length // trap_l),
            float(ev.get("a", 0.0)), float(ev.get("b", 0.0)), z,
            float(trap_l - z), royal_r, stream)
    _build.check(err, "generation kernel")
    LAUNCHES["generation"] += 1
    return new_pop if fit_out is None else (new_pop, fit_out)


def _launch_float(seed, size, pop, fitness, spec, consts):
    check_inputs(seed, size, pop, fitness, torch.float32)
    n_isl, n, length = pop.shape
    ev = spec.eval_spec or {}
    kind = ev.get("eval")
    m = n_groups = 1
    o = perm = M = None
    if spec_needs_consts(spec):
        consts = f15_consts(ev, consts)
        check_consts(consts, length, pop.device, "generation kernel")
        m, n_groups = int(ev["m"]), int(ev["n_groups"])
        o, perm, M = (consts[k].data_ptr() for k in ("o", "perm", "M"))
    lib = _build.library()
    limit = max_smem_bytes(pop.device.index)
    r = float_rows(n, length, spec.elite, limit)
    _check_smem(float_smem_bytes(n, length, spec.elite, r), limit, n,
                length)
    new_pop = torch.empty_like(pop)
    fit_out = (torch.empty((n_isl, n), dtype=torch.float32, device=pop.device)
               if kind is not None else None)
    if n_isl == 0 or n == 0:
        return new_pop if fit_out is None else (new_pop, fit_out)
    a = spec.blend_alpha
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.generation_float_launch(
            pop.data_ptr(), fitness.data_ptr(), seed.data_ptr(),
            seed.stride(0), size.data_ptr(), o, perm, M, new_pop.data_ptr(),
            None if fit_out is None else fit_out.data_ptr(),
            n_isl, n, length, spec.elite,
            0 if spec.selection == "tournament" else 1, spec.tournament_k,
            CROSSOVERS[spec.crossover], float(spec.crossover_rate),
            float(spec.mutation_rate), float(spec.mutation_sigma),
            float(spec.low), float(spec.high), float(1.0 + 2.0 * a),
            float(a), EVAL_KINDS[kind], sum_group(length), m, n_groups,
            sum_group(m), r, stream)
    _build.check(err, "generation kernel (float)")
    LAUNCHES["generation_float"] += 1
    return new_pop if fit_out is None else (new_pop, fit_out)
