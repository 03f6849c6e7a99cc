"""The plain version of the generation kernels (``impl='pallas_ref'``).

Runs :func:`repro_torch.kernels.ga.common.generation_math` as ordinary
PyTorch on any device; the CUDA kernels must match it bit for bit, binary
and float genomes alike.
"""
from __future__ import annotations

import torch

from .common import GenerationSpec, generation_math


def generation(seed: torch.Tensor, size: torch.Tensor, pop: torch.Tensor,
               fitness: torch.Tensor, spec: GenerationSpec, consts=None):
    """Same contract as :func:`.generation.generation_kernel`: seed (I, 2)
    words, size (I,) int32, pop (I, n, L), fitness (I, n) f32, and f15's
    ``consts`` for a fused f15 eval."""
    return generation_math(seed, pop, fitness, size, spec, consts)
