"""Hand-written CUDA kernels of the port, each beside its plain version.

Each kernel package holds ``ref.py`` (the plain PyTorch version), the
wrapper module (checks device, dtype, shape and contiguity, launches and
counts) and ``csrc/*.cu`` (the kernel, built by :mod:`repro_torch._build`).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.

Kernels: ``trap`` (trap fitness), ``rastrigin`` (CEC2010-F15) and ``ga``
(one GA generation per island, optionally with the fitness fused in: one
untiled kernel for binary genomes, one for float genomes, and the tiled
kernel for both, which runs after the selection-plan kernel).

:data:`LAUNCHES` counts the kernel launches of each wrapper; a run sets the
counts to 0 with :func:`reset_launches` and reads them afterwards to show
that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"trap_fitness": 0, "generation": 0,
                            "generation_float": 0, "f15": 0,
                            "generation_tiled": 0, "selection_plan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
