"""Public wrappers and the built-in entries of the kernel table.

Adapts the driver's contract (key words, ``EAConfig`` + ``GenomeSpec``,
per-island ``pop_size``) to the kernel's (two seed words per island, a
:class:`~.common.GenerationSpec`). There is no routing: a tile too large
for the kernel raises rather than going elsewhere.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ... import rand
from . import generation as _k
from . import ref as _ref
from .common import GenerationSpec
from .registry import KERNELS


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


def _entry(callee):
    """The table's callable for one generation body: the kernel wrapper or
    the plain version. ``fused`` is the problem's spec for
    ``generation_eval`` and left out for ``generation``."""
    def op(rng, pop, fitness, pop_size, cfg, genome, fused=None, *,
           consts=None):
        return callee(_seed_words(rng), _size_vec(pop_size), pop, fitness,
                      make_spec(cfg, genome, fused=fused))
    return op


generation = generation_eval = _entry(_k.generation_kernel)
generation_ref = generation_eval_ref = _entry(_ref.generation)

KERNELS.update({
    ("generation", "binary", "pallas"): generation,
    ("generation", "binary", "pallas_ref"): generation_ref,
    ("generation_eval", "binary", "pallas"): generation_eval,
    ("generation_eval", "binary", "pallas_ref"): generation_eval_ref,
})
