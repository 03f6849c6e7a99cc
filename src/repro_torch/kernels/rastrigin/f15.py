"""F15 wrapper: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor.

Replaces ``repro/kernels/rastrigin/ops.py::f15`` and the Pallas kernel
behind it (``rastrigin.py::f15_kernel``). The reference shifts, permutes
and pads the population into a copy in device memory before its kernel;
here the kernel reads the shift and the permutation itself, so one launch
takes the population as it is.
"""
from __future__ import annotations

from typing import Dict

import torch

from ... import _build
from .. import LAUNCHES
from ..trap.ref import sum_group
from . import ref as _ref


def check_consts(consts: Dict[str, torch.Tensor], dim: int,
                 device: torch.device, what: str) -> None:
    """Raise unless ``o`` (D,) f32, ``perm`` (D,) int32 and ``M``
    (G, m, m) f32 with G*m = D lie contiguous on ``device``."""
    o, perm, M = consts["o"], consts["perm"], consts["M"]
    if M.dim() != 3 or M.shape[1] != M.shape[2] \
            or M.shape[0] * M.shape[1] != dim:
        raise ValueError(f"{what}: M must be (G, m, m) with G*m = {dim}, "
                         f"got {tuple(M.shape)}")
    for name, t, dtype, shape in (("o", o, torch.float32, (dim,)),
                                  ("perm", perm, torch.int32, (dim,)),
                                  ("M", M, torch.float32, tuple(M.shape))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{device}, got {t.device}")


def f15(consts: Dict[str, torch.Tensor], pop: torch.Tensor) -> torch.Tensor:
    """CEC2010-F15 (minimised) of an (N, D) f32 population -> (N,) f32."""
    if pop.device.type == "cpu":
        return _ref.f15(consts, pop)
    if pop.device.type != "cuda":
        raise ValueError(f"f15: no kernel for device {pop.device}")
    if pop.dtype != torch.float32 or pop.dim() != 2:
        raise ValueError(f"f15: want a 2-D f32 population, got {pop.dtype} "
                         f"{tuple(pop.shape)}")
    if not pop.is_contiguous():
        raise ValueError("f15: the population must be contiguous")
    n, dim = pop.shape
    check_consts(consts, dim, pop.device, "f15")
    out = torch.empty(n, dtype=torch.float32, device=pop.device)
    if n == 0:
        return out
    lib = _build.library()
    n_groups, m, _ = consts["M"].shape
    with torch.cuda.device(pop.device):
        stream = torch.cuda.current_stream(pop.device).cuda_stream
        err = lib.f15_launch(
            pop.data_ptr(), consts["o"].data_ptr(), consts["perm"].data_ptr(),
            consts["M"].data_ptr(), out.data_ptr(), n, dim, m, n_groups,
            sum_group(m), stream)
    _build.check(err, "f15")
    LAUNCHES["f15"] += 1
    return out
