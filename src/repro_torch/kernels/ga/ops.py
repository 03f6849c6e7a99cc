"""Public wrappers and the built-in entries of the kernel table.

Adapts the driver's contract (key words, ``EAConfig`` + ``GenomeSpec``,
per-island ``pop_size``, the problem's ``consts``) to the kernel's (two
seed words per island, a :class:`~.common.GenerationSpec`). There is no
routing: where the reference's ``impl='pallas'`` hands a tile above its
16 MiB working-set estimate to the tiled kernel, the port raises
``NotImplementedError`` until that kernel is ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ... import rand
from . import generation as _k
from . import ref as _ref
from .common import GenerationSpec, spec_needs_consts
from .registry import KERNELS, NOT_PORTED

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


def _entry(callee, untiled_only: bool):
    """The table's callable for one generation body: the kernel wrapper or
    the plain version. ``fused`` is the problem's spec for
    ``generation_eval`` and left out for ``generation``; ``consts`` carries
    f15's arrays. With ``untiled_only``, a tile above the reference's
    untiled budget raises."""
    def op(rng, pop, fitness, pop_size, cfg, genome, fused=None, *,
           consts=None):
        spec = make_spec(cfg, genome, fused=fused)
        n, length = pop.shape[-2:]
        if untiled_only and (untiled_vmem_bytes(n, length, spec)
                             > VMEM_BUDGET_BYTES):
            raise NotImplementedError(
                f"a {n}x{length} tile is above the untiled budget of "
                f"{VMEM_BUDGET_BYTES} B; {NOT_PORTED['pallas_tiled']}")
        return callee(_seed_words(rng), _size_vec(pop_size), pop, fitness,
                      spec, consts)
    return op


generation = generation_eval = _entry(_k.generation_kernel, True)
generation_ref = generation_eval_ref = _entry(_ref.generation, False)

for _kind in ("binary", "float"):
    KERNELS.update({
        ("generation", _kind, "pallas"): generation,
        ("generation", _kind, "pallas_ref"): generation_ref,
        ("generation_eval", _kind, "pallas"): generation_eval,
        ("generation_eval", _kind, "pallas_ref"): generation_eval_ref,
    })
