"""Generation kernel wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors.

Replaces ``repro/kernels/ga/generation.py::generation_kernel`` for binary
genomes. One CUDA block runs one island; the island axis that the reference
gets from ``vmap`` is the grid. Both of the island's tiles (the population
and the new population) sit in shared memory, which bounds the tile: above
the card's opt-in shared memory per block the wrapper raises (the tiled
kernel, ROADMAP Queue B item 4, is the route for larger tiles).
"""
from __future__ import annotations

import functools

import torch

from ... import _build
from .. import LAUNCHES
from ..trap.ref import sum_group
from . import ref as _ref
from .common import GenerationSpec, check_supported

EVAL_KINDS = {None: 0, "trap": 1, "onemax": 2, "royal_road": 3}


@functools.lru_cache(maxsize=None)
def smem_bytes(n: int, length: int) -> int:
    return int(_build.library().generation_smem_bytes(n, length))


@functools.lru_cache(maxsize=None)
def max_smem_bytes(device_index: int) -> int:
    """The card's opt-in shared memory per block, queried once per card."""
    with torch.cuda.device(device_index):
        return int(_build.library().generation_max_smem_bytes())


def _check(seed, size, pop, fitness):
    n_isl, n, _ = pop.shape
    dev = pop.device
    if pop.dtype != torch.int8:
        raise ValueError(f"generation kernel: binary genomes are int8, got "
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
    for name, t in (("seed", seed), ("size", size), ("pop", pop),
                    ("fitness", fitness)):
        if t.device != dev:
            raise ValueError(f"generation kernel: {name} is on {t.device}, "
                             f"pop on {dev}")
    if not (pop.is_contiguous() and fitness.is_contiguous()
            and size.is_contiguous()):
        raise ValueError("generation kernel: inputs must be contiguous")


def generation_kernel(seed: torch.Tensor, size: torch.Tensor,
                      pop: torch.Tensor, fitness: torch.Tensor,
                      spec: GenerationSpec):
    """seed (I, 2) words, size (I,) int32, pop (I, n, L) int8, fitness
    (I, n) f32 -> new pop (I, n, L) int8 [+ (I, n) f32 raw fitness when
    ``spec.fused_eval`` is set]."""
    check_supported(spec)
    if pop.dim() != 3:
        raise ValueError(f"generation kernel: want (I, n, L), got "
                         f"{tuple(pop.shape)}")
    if pop.device.type == "cpu":
        return _ref.generation(seed, size, pop, fitness, spec)
    if pop.device.type != "cuda":
        raise ValueError(f"generation kernel: no kernel for {pop.device}")
    _check(seed, size, pop, fitness)
    n_isl, n, length = pop.shape
    if length != spec.length:
        raise ValueError(f"population has {length} genes, spec {spec.length}")
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
    need, limit = smem_bytes(n, length), max_smem_bytes(pop.device.index)
    if need > limit:
        raise ValueError(
            f"generation kernel: a {n}x{length} island needs {need} B of "
            f"shared memory, the card allows {limit} B per block; larger "
            "tiles go to the tiled kernel (ROADMAP, Queue B item 4)")
    new_pop = torch.empty_like(pop)
    fit_out = (torch.empty((n_isl, n), dtype=torch.float32, device=pop.device)
               if kind is not None else None)
    if n_isl == 0:
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
            0 if spec.crossover == "two_point" else 1,
            float(spec.crossover_rate), float(spec.mutation_rate),
            EVAL_KINDS[kind], trap_l, sum_group(length // trap_l),
            float(ev.get("a", 0.0)), float(ev.get("b", 0.0)), z,
            float(trap_l - z), royal_r, stream)
    _build.check(err, "generation kernel")
    LAUNCHES["generation"] += 1
    return new_pop if fit_out is None else (new_pop, fit_out)
