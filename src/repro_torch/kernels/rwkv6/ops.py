"""WKV6 in the model's layout: (B, S, H, hd) <-> the kernel's (BH, S, hd).

Replaces ``repro/kernels/rwkv6/ops.py::wkv``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import ref as _ref
from . import rwkv6 as _k


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor, *, chunk: int = _k.CHUNK,
        force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6. r, k, v, w: (B, S, H, hd); u: (H, hd); state:
    (B, H, hd, hd) f32. Returns y (B, S, H, hd) f32 and the final state
    (B, H, hd, hd) f32.

    The sequence is right-padded to a chunk multiple with w = 1 and
    r = k = v = 0: log 1 = 0 and k = 0 leave the state as it was, and the
    padded rows are cut from y. ``force_ref`` runs the sequential oracle
    instead."""
    if force_ref:
        return _ref.wkv(r, k, v, w, u, state)
    b, seq, h, hd = r.shape
    pad = (-seq) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    seq_p = seq + pad

    def to_bh(a):
        return a.float().transpose(1, 2).reshape(b * h, seq_p,
                                                  hd).contiguous()

    rb, kb, vb, wb = map(to_bh, (r, k, v, w))
    ub = u.float()[None].expand(b, h, hd).reshape(b * h, hd).contiguous()
    s0 = state.float().reshape(b * h, hd, hd).contiguous()
    y, s_out = _k.wkv_kernel(rb, kb, vb, wb, ub, s0, chunk=chunk)
    y = y.reshape(b, h, seq_p, hd).transpose(1, 2)[:, :seq]
    return y, s_out.reshape(b, h, hd, hd)
