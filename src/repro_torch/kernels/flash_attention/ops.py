"""Flash attention in the model's layout.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention``. The
reference moves the heads ahead of the sequence and pads both sequences
to its block sizes for the TPU, and falls back to the plain version for
non-causal attention with padded keys; the kernel here reads the model's
layout in place and masks the ragged edges itself, so this is a
pass-through.
"""
from __future__ import annotations

import torch

from .. import refuse_autograd
from . import flash_attention as _k
from . import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = 1.0,
                    force_ref: bool = False) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Kv, hd) -> (B, Sq, H, hd).
    ``force_ref`` runs the plain version on any device. On the card it
    refuses inputs that require grad under grad mode: the kernel has no
    backward, so their gradient would be silently zero."""
    if force_ref:
        return _ref.attention(q, k, v, causal=causal, scale=scale)
    refuse_autograd("flash_attention", "kernels/flash_attention/ref.py::"
                    "attention (use_flash=False)", q, k, v)
    return _k.flash_attention_kernel(q, k, v, scale=scale, causal=causal)
