"""GA generation kernels: one fused generation per island.

Modules:
    common.py     - the plain generation (selection plan, crossover,
                    mutation, fused fitness), batched over islands
    ref.py        - the plain version as ``impl='pallas_ref'``
    generation.py - the untiled CUDA kernels' wrapper (``impl='pallas'``)
    tiling.py     - the tiled kernel's wrapper (``impl='pallas_tiled'``,
                    and ``impl='pallas'`` for large islands)
    autotune.py   - the tiled kernel's rows per block, cached per card
    csrc/         - the CUDA sources: generation.cu (binary genomes),
                    generation_float.cu (float genomes), plan.cu (the
                    selection plan), generation_tiled.cu (the tiled
                    kernel), and the headers they share
    registry.py   - the (op, genome_kind, impl) table
    ops.py        - the public wrappers that fill the table, and the
                    routing of ``impl='pallas'``
"""
from .common import GenerationSpec, fused_fitness, generation_math
from .ops import (generation, generation_eval, generation_eval_ref,
                  generation_ref, make_spec)
from .registry import available_impls, get_kernel, has_kernel

__all__ = [
    "GenerationSpec", "available_impls", "fused_fitness", "generation",
    "generation_eval", "generation_eval_ref", "generation_math",
    "generation_ref", "get_kernel", "has_kernel", "make_spec",
]
