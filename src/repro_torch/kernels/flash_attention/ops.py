"""Flash attention in the model's layout.

Replaces ``repro/kernels/flash_attention/ops.py::flash_attention``. The
reference moves the heads ahead of the sequence and pads both sequences
to its block sizes for the TPU, and falls back to the plain version for
non-causal attention with padded keys; the kernel here reads the model's
layout in place and masks the ragged edges itself, so this is a
pass-through.

The kernel is called through the custom op ``repro_torch::flash_attention``
(the CUDA kernel on the card, the plain version on the CPU, no fallback),
whose fake implementation allocates the output alone and whose FLOP
formula (:func:`flops`, ``chip_smoke.py::flash_work``'s) counts the
visible pairs: under ``FakeTensorMode`` the dry run
(:mod:`repro_torch.launch.dryrun`) then sees the kernel's memory and work,
not the plain version's (B, H, Sq, Sk) scores.
"""
from __future__ import annotations

import torch

from ... import compat
from .. import refuse_autograd
from . import flash_attention as _k
from . import ref as _ref


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           causal: bool) -> torch.Tensor:
    return _k.flash_attention_kernel(q, k, v, scale=scale, causal=causal)


@_flash.register_fake
def _flash_fake(q, k, v, scale, causal):
    return q.new_empty(q.shape)


def flops(q_shape, k_shape, causal: bool) -> int:
    """2 operations per multiply-add of the two products over the visible
    (row, key) pairs (``chip_smoke.py::flash_work``)."""
    b, rows, h, hd = q_shape
    cols = k_shape[1]
    if causal:
        # sum over rows i of min(i + 1, cols)
        near = min(rows, cols)
        pairs = near * (near + 1) // 2 + max(0, rows - cols) * cols
    else:
        pairs = rows * cols
    return 4 * b * h * hd * pairs


_, _register_flop_formula = compat.flop_counter()


@_register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, scale, causal, *args, **kw):
    return flops(q_shape, k_shape, causal)


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
    # repro-lint: disable=JIT01 -- scale and causal are the caller's Python float and bool (the softmax scale, the mask), not device values
    return _flash(q, k, v, float(scale), bool(causal))
