"""Public wrappers and the built-in entries of the kernel table.

Adapts the driver's contract (key words, ``EAConfig`` + ``GenomeSpec``,
per-island ``pop_size``, the problem's ``consts``) to the kernel's (two
seed words per island, a :class:`~.common.GenerationSpec`), and fills the
table:

* ``pallas`` - the untiled kernels (:mod:`.generation`), routed by
  :func:`route` to the tiled kernel where the reference's ``impl='pallas'``
  goes tiled (its 16 MiB working-set estimate) or where the untiled
  kernel's shared memory does not hold the island;
* ``pallas_tiled`` - the tiled kernel (:mod:`.tiling`), rows per block
  from :mod:`.autotune` unless given; the same bits as ``pallas``;
* ``pallas_ref`` - the plain version.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ... import rand
from . import generation as _k
from . import ref as _ref
from . import tiling as _tiling
from .common import GenerationSpec, spec_needs_consts
from .registry import KERNELS

# The reference's budget for one untiled tile (repro/kernels/ga/ops.py):
# above it, its impl='pallas' runs the tiled kernel instead.
VMEM_BUDGET_BYTES = 16 * 2**20


def untiled_vmem_bytes(n: int, L: int,
                       spec: Optional[GenerationSpec] = None) -> int:
    """The reference's working-set estimate of one untiled (n, L) tile: 6
    f32 copies of the tile and two (n, n) selection blocks, plus the f15
    permutation one-hot and rotated copies."""
    est = n * L * 4 * 6 + n * n * 4 * 2
    if spec is not None and spec_needs_consts(spec):
        est += L * L * 4 + 2 * n * L * 4
    return est


def route(n: int, L: int, spec: GenerationSpec,
          smem_limit: Optional[int] = None) -> str:
    """``"tiled"`` or ``"untiled"``: where ``impl='pallas'`` runs an (n, L)
    island. Tiled above the reference's untiled budget, as the reference
    routes, and where the untiled kernel needs more shared memory than the
    card's ``smem_limit`` per block (None: no card, no such limit)."""
    if untiled_vmem_bytes(n, L, spec) > VMEM_BUDGET_BYTES:
        return "tiled"
    if (smem_limit is not None
            and _k.untiled_smem_bytes(n, L, spec, smem_limit) > smem_limit):
        return "tiled"
    return "untiled"


def make_spec(cfg, genome,
              fused: Optional[Dict[str, Any]] = None) -> GenerationSpec:
    """Freeze the (EAConfig, GenomeSpec[, Problem.fused]) statics."""
    return GenerationSpec(
        kind=genome.kind,
        length=genome.length,
        elite=cfg.elite,
        selection=cfg.selection,
        tournament_k=cfg.tournament_k,
        crossover=cfg.crossover,
        crossover_rate=cfg.crossover_rate,
        mutation_rate=cfg.mut_rate(genome),
        mutation_sigma=cfg.mutation_sigma,
        low=genome.low,
        high=genome.high,
        fused_eval=(tuple(sorted(fused.items()))
                    if fused is not None else None),
    )


def _seed_words(rng: torch.Tensor) -> torch.Tensor:
    """(..., 2) key words -> the (..., 2) words seeding the counter RNG.
    A threefry key is two words already; this is the reference's
    ``key_data`` step."""
    return rand.key_data(rng)


def _size_vec(pop_size) -> torch.Tensor:
    return torch.as_tensor(pop_size, dtype=torch.int32).reshape(-1)


def _pallas(seed, size, pop, fitness, spec, consts):
    """impl='pallas': the untiled kernel, or the tiled one by :func:`route`
    (the card's shared memory counts only for CUDA tensors)."""
    limit = (_k.max_smem_bytes(pop.device.index)
             if pop.device.type == "cuda" else None)
    if route(pop.shape[-2], pop.shape[-1], spec, limit) == "tiled":
        return _tiling.generation_tiled(seed, size, pop, fitness, spec,
                                        consts=consts)
    return _k.generation_kernel(seed, size, pop, fitness, spec, consts)


def _tiled(seed, size, pop, fitness, spec, consts, *, tile_pop=None,
           tile_len=None):
    return _tiling.generation_tiled(seed, size, pop, fitness, spec,
                                    tile_pop=tile_pop, tile_len=tile_len,
                                    consts=consts)


def _entry(callee):
    """The table's callable for one generation body. ``fused`` is the
    problem's spec for ``generation_eval`` and left out for
    ``generation``; ``consts`` carries f15's arrays; the tiled entry also
    takes ``tile_pop`` and ``tile_len``."""
    def op(rng, pop, fitness, pop_size, cfg, genome, fused=None, *,
           consts=None, **tiles):
        spec = make_spec(cfg, genome, fused=fused)
        return callee(_seed_words(rng), _size_vec(pop_size), pop, fitness,
                      spec, consts, **tiles)
    return op


generation = generation_eval = _entry(_pallas)
generation_tiled = generation_eval_tiled = _entry(_tiled)
generation_ref = generation_eval_ref = _entry(_ref.generation)

for _kind in ("binary", "float"):
    for _op in ("generation", "generation_eval"):
        KERNELS.update({(_op, _kind, "pallas"): generation,
                        (_op, _kind, "pallas_tiled"): generation_tiled,
                        (_op, _kind, "pallas_ref"): generation_ref})
