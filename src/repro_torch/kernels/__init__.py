"""Hand-written CUDA kernels of the port, each beside its plain version.

Each kernel package holds ``ref.py`` (the plain PyTorch version), the
wrapper module (checks device, dtype, shape and contiguity, launches and
counts) and ``csrc/*.cu`` (the kernel, built by :mod:`repro_torch._build`).
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.

Kernels: ``trap`` (trap fitness), ``rastrigin`` (CEC2010-F15) and ``ga``
(one GA generation per island, optionally with the fitness fused in: one
untiled kernel for binary genomes, one for float genomes, and the tiled
kernel for both, which draws its own selection plan and, under roulette
selection, runs after the roulette-CDF kernel), ``rwkv6``
(the chunked WKV6 recurrence of the RWKV6 time mix) and
``flash_attention`` (causal attention with an online softmax, GQA by
index, the prefill of the dense models).

:data:`LAUNCHES` counts the kernel launches of each wrapper; a run sets the
counts to 0 with :func:`reset_launches` and reads them afterwards to show
that its path went through the kernels.

No kernel has a backward: the kernels' inputs carry no autograd graph
through the launch, so :func:`refuse_autograd` makes the wrappers raise
on CUDA tensors that require grad under grad mode, rather than return
outputs whose gradient would be silently zero.
"""
from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"trap_fitness": 0, "generation": 0,
                            "generation_float": 0, "f15": 0,
                            "generation_tiled": 0, "roulette_cdf": 0,
                            "wkv": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def refuse_autograd(kernel: str, plain: str, *tensors: torch.Tensor) -> None:
    """Raise when a kernel would launch on CUDA tensors that need a
    gradient (grad mode on and an input requiring grad). ``plain`` names
    the plain version, which autograd can differentiate."""
    if not torch.is_grad_enabled():
        return
    if any(t.is_cuda and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the CUDA kernel has no "
            f"backward kernel, so its gradient would be silently zero; run "
            f"the plain version {plain} for training, or call the kernel "
            f"under torch.no_grad()")
