"""The plain version of the generation kernel (``impl='pallas_ref'``).

Runs :func:`repro_torch.kernels.ga.common.generation_math` as ordinary
PyTorch on any device; the CUDA kernel must match it bit for bit on binary
genomes.
"""
from __future__ import annotations

import torch

from .common import GenerationSpec, generation_math


def generation(seed: torch.Tensor, size: torch.Tensor, pop: torch.Tensor,
               fitness: torch.Tensor, spec: GenerationSpec):
    """Same contract as :func:`.generation.generation_kernel`: seed (I, 2)
    words, size (I,) int32, pop (I, n, L), fitness (I, n) f32."""
    return generation_math(seed, pop, fitness, size, spec)
