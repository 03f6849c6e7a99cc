"""Tiled generation wrapper: the tiled kernel (and, under roulette, the
CDF kernel) for CUDA tensors, the plain version for CPU tensors.

Replaces ``repro/kernels/ga/tiling.py::generation_tiled``: one GA
generation for any population size. On the card it runs
``csrc/generation_tiled.cu``, whose blocks each draw the selection plan of
their own few rows (elite, parents, cuts, gate: the reference's
``selection_plan``, computed outside its ``pallas_call``) and make those
children, with the fused separable fitness summed per row. Under tournament
selection that is the generation's one launch; under roulette
``csrc/roulette_cdf.cu`` first writes each island's CDF (in
:func:`.common.prefix_sum`'s segmented order, as the untiled kernels build
it), which the tiled kernel's blocks search. A fused F15 goes as the tiled generation and then
the F15 kernel (``kernels/rastrigin/f15.py``), as in the reference. Every
draw is addressed by the absolute (row, gene), so the result is the
untiled kernels' and the plain version's, bit for bit, whatever the rows
per block: the plain version (``ref.generation``) is its exact
counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ... import _build
from .. import LAUNCHES
from ..rastrigin import f15 as _f15
from ..trap.ref import window_lead
from . import autotune as _autotune
from . import generation as _k
from . import ref as _ref
from .common import f15_consts, masked_fitness, roulette_cdf as _plain_cdf, \
    spec_needs_consts

TILED_EVALS = {"binary": ("trap", "onemax", "royal_road"),
               "float": ("rastrigin", "sphere")}


@functools.lru_cache(maxsize=None)
def tiled_smem_bytes(rows: int, length: int, elite: int, float_genes: bool,
                     eval_kind: int) -> int:
    """Shared memory of one block of the tiled kernel."""
    return int(_build.library().generation_tiled_smem_bytes(
        rows, length, elite, int(float_genes), eval_kind))


def roulette_cdf(size: torch.Tensor, fitness: torch.Tensor) -> torch.Tensor:
    """size (I,) int32, fitness (I, n) f32 -> the (I, n) f32 roulette CDF
    of the masked fitness: the CDF kernel for CUDA tensors,
    :func:`~.common.roulette_cdf` for CPU tensors."""
    if fitness.device.type == "cpu":
        return _plain_cdf(masked_fitness(fitness, size))
    if fitness.device.type != "cuda":
        raise ValueError(f"roulette CDF: no kernel for {fitness.device}")
    if fitness.dtype != torch.float32 or fitness.dim() != 2:
        raise ValueError(f"roulette CDF: fitness must be f32 (I, n), got "
                         f"{fitness.dtype} {tuple(fitness.shape)}")
    if (size.dtype != torch.int32 or tuple(size.shape) != fitness.shape[:1]
            or size.device != fitness.device):
        raise ValueError("roulette CDF: want int32 sizes (I,) beside the "
                         "fitness")
    if not (fitness.is_contiguous() and size.is_contiguous()):
        raise ValueError("roulette CDF: inputs must be contiguous")
    cum = torch.empty_like(fitness)
    if fitness.numel():
        launch_cdf(size, fitness, cum)
        LAUNCHES["roulette_cdf"] += 1
    return cum


def launch_cdf(size, fitness, cum: torch.Tensor) -> None:
    """The CDF kernel's launch into ``cum``, uncounted and unchecked: the
    counting wrapper is :func:`roulette_cdf`; the autotune sweep calls
    this."""
    n_isl, n = fitness.shape
    lib = _build.library()
    with torch.cuda.device(fitness.device):
        stream = torch.cuda.current_stream(fitness.device).cuda_stream
        err = lib.roulette_cdf_launch(fitness.data_ptr(), size.data_ptr(),
                                      cum.data_ptr(), n_isl, n, stream)
    _build.check(err, "roulette CDF kernel")


@functools.lru_cache(maxsize=None)
def max_rows(length: int, spec, limit: int) -> int:
    """The most rows per block of the tiled kernel that ``limit`` bytes of
    shared memory hold for ``spec`` (its shared memory grows with the
    rows)."""
    ev = spec.eval_spec or {}
    args = (length, spec.elite, spec.kind == "float",
            _k.EVAL_KINDS[ev.get("eval")])
    lo, hi = 0, limit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if tiled_smem_bytes(mid, *args) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def generation_tiled(seed: torch.Tensor, size: torch.Tensor,
                     pop: torch.Tensor, fitness: torch.Tensor, spec, *,
                     tile_pop: Optional[int] = None,
                     tile_len: Optional[int] = None, consts=None):
    """Same contract as :func:`.generation.generation_kernel`, any n: seed
    (I, 2) words, size (I,) int32, pop (I, n, L) int8 or f32, fitness
    (I, n) f32 -> new pop [+ (I, n) f32 raw fitness when
    ``spec.fused_eval`` is set; ``consts`` for f15].

    ``tile_pop`` is the tiled kernel's rows per block: from
    :func:`.autotune.best_tiles` when None (capped at what shared memory
    holds under the fused eval); a value above what it holds raises.
    ``tile_len`` is taken for the reference's signature: this design does
    not tile genes, so it changes no bit of the result, nor does
    ``tile_pop``."""
    del tile_len
    if pop.dim() != 3:
        raise ValueError(f"tiled generation: want (I, n, L), got "
                         f"{tuple(pop.shape)}")
    if pop.device.type == "cpu":
        return _ref.generation(seed, size, pop, fitness, spec, consts)
    if pop.device.type != "cuda":
        raise ValueError(f"tiled generation: no kernel for {pop.device}")
    n_isl, n, length = pop.shape
    if length != spec.length:
        raise ValueError(f"population has {length} genes, spec {spec.length}")
    if spec_needs_consts(spec):
        consts = f15_consts(spec.eval_spec, consts)
        new_pop = generation_tiled(
            seed, size, pop, fitness,
            dataclasses.replace(spec, fused_eval=None), tile_pop=tile_pop)
        fit = _f15.f15(consts, new_pop.reshape(n_isl * n, length))
        return new_pop, -fit.reshape(n_isl, n)

    _k.check_inputs(seed, size, pop, fitness,
                    torch.int8 if spec.kind == "binary" else torch.float32)
    return child_kernel(seed, size, pop, fitness, spec, tile_pop)


def child_kernel(seed: torch.Tensor, size: torch.Tensor, pop: torch.Tensor,
                 fitness: torch.Tensor, spec,
                 tile_pop: Optional[int] = None):
    """The tiled kernel on CUDA tensors (after the CDF kernel under
    roulette): seed (I, 2) words, size (I,) int32, pop (I, n, L), fitness
    (I, n) f32 -> new pop [+ (I, n) f32 raw fitness under a separable
    fused eval]. ``tile_pop`` as in :func:`generation_tiled`; the caller
    checks the inputs."""
    n_isl, n, length = pop.shape
    ev = spec.eval_spec or {}
    kind = ev.get("eval")
    if kind is not None and kind not in TILED_EVALS[spec.kind]:
        raise ValueError(f"tiled generation: no fused {kind!r} eval for "
                         f"{spec.kind} genomes")
    trap_l, royal_r = int(ev.get("l", 1)), int(ev.get("r", 1))
    if (kind == "trap" and length % trap_l) or (kind == "royal_road"
                                                and length % royal_r):
        raise ValueError(f"{kind} blocks do not tile {length} genes")
    limit = _k.max_smem_bytes(pop.device.index)
    fit_rows = max_rows(length, spec, limit)
    if tile_pop is None:
        tile_pop = min(_autotune.best_tiles(n, length, spec.kind,
                                            n_islands=n_isl, spec=spec)[0],
                       fit_rows)
    if tile_pop > fit_rows:
        raise ValueError(
            f"tiled generation: {tile_pop} rows of {length} genes per block "
            f"need more than the card's {limit} B of shared memory per block"
            f" (it holds {fit_rows})")
    if tile_pop < 1:
        raise ValueError(f"tiled generation: tile_pop must be at least 1, "
                         f"got {tile_pop}")

    new_pop = torch.empty_like(pop)
    fit_out = (torch.empty((n_isl, n), dtype=torch.float32, device=pop.device)
               if kind is not None else None)
    if n_isl and n:
        cum = (roulette_cdf(size, fitness) if spec.selection == "roulette"
               else None)
        launch_child(seed, size, pop, fitness, cum, spec, tile_pop, new_pop,
                     fit_out)
        LAUNCHES["generation_tiled"] += 1
    return new_pop if fit_out is None else (new_pop, fit_out)


def launch_child(seed, size, pop, fitness, cum: Optional[torch.Tensor],
                 spec, rows: int, new_pop: torch.Tensor,
                 fit_out: Optional[torch.Tensor]) -> None:
    """The tiled kernel's launch into ``new_pop`` (and ``fit_out`` under a
    fused eval), ``rows`` per block, ``cum`` the CDF of :func:`roulette_cdf`
    under roulette, uncounted and unchecked: the counting wrapper is
    :func:`child_kernel`; the autotune sweep calls this."""
    n_isl, n, length = pop.shape
    ev = spec.eval_spec or {}
    trap_l, royal_r = int(ev.get("l", 1)), int(ev.get("r", 1))
    z = float(ev.get("z", 0.0))
    a = spec.blend_alpha
    lib = _build.library()
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.generation_tiled_launch(
            pop.data_ptr(), fitness.data_ptr(), seed.data_ptr(),
            seed.stride(0), size.data_ptr(),
            None if cum is None else cum.data_ptr(), new_pop.data_ptr(),
            None if fit_out is None else fit_out.data_ptr(),
            int(spec.kind == "float"), n_isl, n, length, spec.elite,
            # repro-lint: disable=PAL01 -- rows is the launch shape's Python int, not a device value
            int(rows), 0 if spec.selection == "tournament" else 1,
            spec.tournament_k, _k.CROSSOVERS[spec.crossover],
            float(spec.crossover_rate), float(spec.mutation_rate),
            float(spec.mutation_sigma), float(spec.low), float(spec.high),
            float(1.0 + 2.0 * a), float(a), _k.EVAL_KINDS[ev.get("eval")],
            window_lead(length), trap_l, window_lead(length // trap_l),
            float(ev.get("a", 0.0)), float(ev.get("b", 0.0)), z,
            float(trap_l - z), royal_r, stream)
    _build.check(err, "tiled generation kernel")
