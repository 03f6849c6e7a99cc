"""Trap fitness wrapper: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

Replaces ``repro/kernels/trap/ops.py::trap_fitness`` and the Pallas kernel
behind it (``trap.py::trap_fitness_kernel``). The kernel takes ragged N as
it is: no padding to a block on the host.
"""
from __future__ import annotations

from typing import Dict

import torch

from ... import _build
from .. import LAUNCHES
from . import ref as _ref


def trap_fitness(consts: Dict[str, float], pop: torch.Tensor, *,
                 n_traps: int) -> torch.Tensor:
    """Drop-in for ``problems.trap_fitness_ref``: (N, n_traps*l) int8 ->
    (N,) f32. ``consts`` holds python scalars ``a``, ``b``, ``z``, ``l``."""
    a, b, z, l = (float(consts["a"]), float(consts["b"]),
                  float(consts["z"]), int(consts["l"]))
    if pop.device.type == "cpu":
        return _ref.trap_fitness(pop, n_traps=n_traps, l=l, a=a, b=b, z=z)
    if pop.device.type != "cuda":
        raise ValueError(f"trap_fitness: no kernel for device {pop.device}")
    if pop.dtype != torch.int8 or pop.dim() != 2:
        raise ValueError(f"trap_fitness: want a 2-D int8 population, got "
                         f"{pop.dtype} {tuple(pop.shape)}")
    if pop.shape[1] != n_traps * l:
        raise ValueError(f"trap_fitness: {pop.shape[1]} genes is not "
                         f"{n_traps} traps of {l}")
    if not pop.is_contiguous():
        raise ValueError("trap_fitness: the population must be contiguous")
    n = pop.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=pop.device)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.trap_fitness_launch(
            pop.data_ptr(), out.data_ptr(), n, n_traps, l,
            _ref.window_lead(n_traps), a, b, z, float(l - z), stream)
    _build.check(err, "trap_fitness")
    LAUNCHES["trap_fitness"] += 1
    return out
