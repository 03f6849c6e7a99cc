"""WKV6 in the model's layout (B, S, H, hd), which the kernel reads as it
is.

Replaces ``repro/kernels/rwkv6/ops.py::wkv``. The kernel is called
through the custom op ``repro_torch::wkv`` (the CUDA kernel on the card,
the plain version on the CPU), whose fake implementation allocates the
outputs alone and whose FLOP formula is :func:`flops`, so the dry run
traces the kernel, not the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ... import compat
from .. import refuse_autograd
from . import ref as _ref
from . import rwkv6 as _k


@torch.library.custom_op("repro_torch::wkv", mutates_args=())
def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    y, s = _k.wkv_kernel(r, k, v, w, u, state, chunk=chunk)
    return y, (s.clone() if s is state else s)


@_wkv.register_fake
def _wkv_fake(r, k, v, w, u, state, chunk):
    return (r.new_empty(r.shape, dtype=torch.float32),
            state.new_empty(state.shape, dtype=torch.float32))


def flops(r_shape, chunk: int) -> int:
    """The chunked recurrence's multiply-adds at 2 operations each, per
    chunk of T tokens and head (K = V = D): r~ S and k^T v (TKV each),
    the intra-chunk pairs (T(T + 1) / 2 rows of K, then of V) and the
    decay of S (KV)."""
    b, seq, h, d = r_shape
    t = chunk
    per = 2 * (2 * t * d * d + t * (t + 1) // 2 * 2 * d + d * d)
    return b * h * (-(-seq // t)) * per


_, _register_flop_formula = compat.flop_counter()


@_register_flop_formula(torch.ops.repro_torch.wkv)
def _wkv_flops(r_shape, *args, **kw):
    chunk = kw.get("chunk", args[5] if len(args) > 5 else _k.CHUNK)
    return flops(r_shape, chunk)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor, *, chunk: int = _k.CHUNK,
        force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6. r, k, v, w: (B, S, H, hd); u: (H, hd); state:
    (B, H, hd, hd) f32. Returns y (B, S, H, hd) f32 and the final state
    (B, H, hd, hd) f32.

    The inputs go to the kernel as the model makes them (r, k, v in one
    dtype, bf16 or f32; w and state f32; u bf16 or f32), so for S a
    multiple of the chunk nothing but the kernel is launched
    (:func:`rwkv6.wkv_kernel` names what it refuses). A ragged sequence is
    right-padded to a chunk multiple with w = 1 and r = k = v = 0: log 1 =
    0 and k = 0 leave the state as it was, and the padded rows are cut
    from y. ``force_ref`` runs the sequential oracle instead. On the card
    it refuses inputs that require grad under grad mode: the kernel has no
    backward, so their gradient would be silently zero."""
    if force_ref:
        return _ref.wkv(r, k, v, w, u, state)
    refuse_autograd("wkv", "kernels/rwkv6/ref.py::wkv (use_rwkv_kernel="
                    "False)", r, k, v, w, u, state)
    seq = r.shape[1]
    pad = (-seq) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    y, s_out = _wkv(r, k, v, w, u, state, chunk)
    return (y[:, :seq] if pad else y), s_out
