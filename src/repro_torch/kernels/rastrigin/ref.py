"""Plain PyTorch CEC2010-F15: the version beside the CUDA kernel.

F15 of a row x is ``sum_g sum_k t(rot[g, k])`` with ``z = x - o``, the
groups ``z[perm]`` of ``m`` genes, ``rot[g] = z_g @ M[g]`` and the Rastrigin
term ``t(r) = r*r - 10*cos(f32(2*pi)*r) + 10``. Every f32 step is fixed so
that the CUDA kernels (``csrc/f15.cu`` and the fused tail of
``kernels/ga/csrc/generation_float.cu``) give the same bits:

* the permutation is a gather (``index_select``), exact;
* the rotation is a left-to-right sum over ``j`` of separate multiplies and
  adds, starting from the ``j = 0`` product (not ``torch.matmul``, whose
  order is the BLAS library's);
* the terms of a group are summed in the window order of
  :func:`repro_torch.kernels.trap.ref.ordered_sum`, XLA's CPU order for a
  row reduction (two halves of 25 at m = 50);
* the group sums are summed in the same order (left to right from 0 up to
  32 groups).

No lane padding: the reference pads m to 128 lanes for the TPU's matrix
unit (``repro/kernels/rastrigin/ops.py``), which changes nothing here.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..trap.ref import ordered_sum

TWO_PI = 2.0 * math.pi


def rastrigin_terms(z: torch.Tensor) -> torch.Tensor:
    """Element-wise ``z*z - 10*cos(f32(2*pi)*z) + 10`` in f32."""
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32, device=z.device)
    return z * z - 10.0 * torch.cos(two_pi * z) + 10.0


def shift_permute(pop: torch.Tensor, o: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
    """``(pop - o)[..., perm]``: (..., D) -> (..., D)."""
    return torch.index_select(pop - o, -1, perm)


def rotate(zg: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(..., G, m) groups times their (m, m) rotations, summed over ``j``
    left to right from the ``j = 0`` product."""
    acc = zg[..., 0:1] * M[:, 0, :]
    for j in range(1, M.shape[1]):
        acc = acc + zg[..., j:j + 1] * M[:, j, :]
    return acc


def group_total(terms: torch.Tensor) -> torch.Tensor:
    """(..., G, m) terms -> (...): each group's sum, then the group sums,
    in ordered_sum's order."""
    return ordered_sum(ordered_sum(terms))


def f15(consts: Dict[str, torch.Tensor], pop: torch.Tensor) -> torch.Tensor:
    """F15 (minimised) of (..., D) f32 rows -> (...). ``consts`` holds
    ``o`` (D,) f32, ``perm`` (D,) int32 and ``M`` (G, m, m) f32 on the
    population's device."""
    M = consts["M"]
    n_groups, m, _ = M.shape
    z = shift_permute(pop, consts["o"], consts["perm"])
    zg = z.reshape(*pop.shape[:-1], n_groups, m)
    return group_total(rastrigin_terms(rotate(zg, M)))
