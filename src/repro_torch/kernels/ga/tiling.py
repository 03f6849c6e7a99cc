"""Tiled generation wrapper: the plan and child kernels for CUDA tensors,
the plain version for CPU tensors.

Replaces ``repro/kernels/ga/tiling.py::generation_tiled``: one GA
generation for any population size. On the card it runs two kernels:
``csrc/plan.cu`` writes the selection plan (elite, parents, cuts, gate:
five (I, n) int32 vectors, the reference's ``selection_plan`` outside its
``pallas_call``), and ``csrc/generation_tiled.cu`` makes the children from
it, a few whole rows per block, with the fused separable fitness summed per
row. A fused F15 goes as the tiled generation and then the F15 kernel
(``kernels/rastrigin/f15.py``), as in the reference. Every draw is
addressed by the absolute (row, gene), so the result is the untiled
kernels' and the plain version's, bit for bit, whatever the rows per
block: the plain version (``ref.generation``) is its exact counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ... import _build
from .. import LAUNCHES
from ..rastrigin import f15 as _f15
from ..trap.ref import sum_group
from . import autotune as _autotune
from . import generation as _k
from . import ref as _ref
from .common import SelectionPlan, f15_consts, selection_plan, \
    spec_needs_consts

PLAN_FIELDS = 5
TILED_EVALS = {"binary": ("trap", "onemax", "royal_road"),
               "float": ("rastrigin", "sphere")}


@functools.lru_cache(maxsize=None)
def tiled_smem_bytes(rows: int, length: int, float_genes: bool,
                     eval_kind: int, group: int) -> int:
    """Shared memory of one block of the child kernel."""
    return int(_build.library().generation_tiled_smem_bytes(
        rows, length, int(float_genes), eval_kind, group))


def plan_buffer(seed, size, fitness, spec) -> torch.Tensor:
    """The (5, I, n) int32 plan of CUDA tensors (the fields of
    :class:`~.common.SelectionPlan` in order), by the plan kernel."""
    n_isl, n = fitness.shape
    plan = torch.empty((PLAN_FIELDS, n_isl, n), dtype=torch.int32,
                       device=fitness.device)
    if n_isl and n:
        launch_plan(seed, size, fitness, spec, plan)
        LAUNCHES["selection_plan"] += 1
    return plan


def launch_plan(seed, size, fitness, spec, plan: torch.Tensor) -> None:
    """The plan kernel's launch into ``plan``, uncounted: the counting
    wrapper is :func:`plan_buffer`; the autotune sweep calls this."""
    n_isl, n = fitness.shape
    masked = torch.empty((n_isl, n), dtype=torch.float32,
                         device=fitness.device)
    cum = torch.empty_like(masked)
    lib = _build.library()
    with torch.cuda.device(fitness.device):
        stream = torch.cuda.current_stream(fitness.device).cuda_stream
        err = lib.selection_plan_launch(
            fitness.data_ptr(), seed.data_ptr(), seed.stride(0),
            size.data_ptr(), masked.data_ptr(), cum.data_ptr(),
            plan.data_ptr(), n_isl, n, spec.length, spec.elite,
            0 if spec.selection == "tournament" else 1, spec.tournament_k,
            _k.CROSSOVERS[spec.crossover], float(spec.crossover_rate),
            stream)
    _build.check(err, "selection plan kernel")


def plan_kernel(seed: torch.Tensor, size: torch.Tensor,
                fitness: torch.Tensor, spec) -> SelectionPlan:
    """seed (I, 2) words, size (I,) int32, fitness (I, n) f32 -> the
    :class:`~.common.SelectionPlan` of one generation: the plan kernel for
    CUDA tensors, :func:`~.common.selection_plan` for CPU tensors."""
    if fitness.device.type == "cpu":
        return selection_plan(seed, fitness, size, spec, fitness.shape[-1])
    if fitness.device.type != "cuda":
        raise ValueError(f"selection plan: no kernel for {fitness.device}")
    _k.check_plan_inputs(seed, size, fitness)
    return SelectionPlan(*plan_buffer(seed, size, fitness, spec).unbind(0))


def max_rows(length: int, spec, limit: int) -> int:
    """The most rows per block of the child kernel that ``limit`` bytes of
    shared memory hold for ``spec`` (it grows linearly in the rows)."""
    ev = spec.eval_spec or {}
    kind = _k.EVAL_KINDS[ev.get("eval")]
    return limit // tiled_smem_bytes(1, length, spec.kind == "float", kind,
                                     sum_group(length))


def generation_tiled(seed: torch.Tensor, size: torch.Tensor,
                     pop: torch.Tensor, fitness: torch.Tensor, spec, *,
                     tile_pop: Optional[int] = None,
                     tile_len: Optional[int] = None, consts=None):
    """Same contract as :func:`.generation.generation_kernel`, any n: seed
    (I, 2) words, size (I,) int32, pop (I, n, L) int8 or f32, fitness
    (I, n) f32 -> new pop [+ (I, n) f32 raw fitness when
    ``spec.fused_eval`` is set; ``consts`` for f15].

    ``tile_pop`` is the child kernel's rows per block: from
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
    return child_kernel(seed, pop, plan_buffer(seed, size, fitness, spec),
                        spec, tile_pop)


def child_kernel(seed: torch.Tensor, pop: torch.Tensor, plan: torch.Tensor,
                 spec, tile_pop: Optional[int] = None):
    """The child kernel alone on CUDA tensors: seed (I, 2) words, pop
    (I, n, L) and the (5, I, n) ``plan`` of :func:`plan_buffer` -> new pop
    [+ (I, n) f32 raw fitness under a separable fused eval]. ``tile_pop``
    as in :func:`generation_tiled`; the caller checks seed and pop."""
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
    if (plan.dtype != torch.int32 or plan.device != pop.device
            or tuple(plan.shape) != (PLAN_FIELDS, n_isl, n)
            or not plan.is_contiguous()):
        raise ValueError(f"tiled generation: want a contiguous int32 plan "
                         f"{(PLAN_FIELDS, n_isl, n)} on {pop.device}")
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
        launch_child(seed, pop, plan, spec, tile_pop, new_pop, fit_out)
        LAUNCHES["generation_tiled"] += 1
    return new_pop if fit_out is None else (new_pop, fit_out)


def launch_child(seed, pop, plan, spec, rows: int, new_pop: torch.Tensor,
                 fit_out: Optional[torch.Tensor]) -> None:
    """The child kernel's launch into ``new_pop`` (and ``fit_out`` under a
    fused eval), ``rows`` per block, uncounted and unchecked: the counting
    wrapper is :func:`child_kernel`; the autotune sweep calls this."""
    n_isl, n, length = pop.shape
    ev = spec.eval_spec or {}
    trap_l, royal_r = int(ev.get("l", 1)), int(ev.get("r", 1))
    z = float(ev.get("z", 0.0))
    a = spec.blend_alpha
    lib = _build.library()
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.generation_tiled_launch(
            pop.data_ptr(), plan.data_ptr(), seed.data_ptr(), seed.stride(0),
            new_pop.data_ptr(),
            None if fit_out is None else fit_out.data_ptr(),
            int(spec.kind == "float"), n_isl, n, length, spec.elite,
            int(rows), _k.CROSSOVERS[spec.crossover],
            float(spec.mutation_rate), float(spec.mutation_sigma),
            float(spec.low), float(spec.high), float(1.0 + 2.0 * a),
            float(a), _k.EVAL_KINDS[ev.get("eval")], sum_group(length),
            trap_l, sum_group(length // trap_l), float(ev.get("a", 0.0)),
            float(ev.get("b", 0.0)), z, float(trap_l - z), royal_r, stream)
    _build.check(err, "tiled generation kernel")
