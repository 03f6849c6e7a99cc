"""WKV6 kernel wrapper: the CUDA kernel for CUDA tensors, the plain chunked
version for CPU tensors.

Replaces ``repro/kernels/rwkv6/rwkv6.py::wkv_kernel``. The kernel
(``csrc/wkv.cu``) runs a (BH, D / VB) grid: each block loops over the
chunks of one (batch x head) and keeps VB = min(32, D) columns of the
state in shared memory.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ... import _build
from .. import LAUNCHES
from . import ref as _ref

CHUNK = 32
HEAD_DIMS = (8, 16, 32, 64)
CHUNKS = (8, 16, 32)


def _check(r, k, v, w, u, s0, chunk: int) -> None:
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "s0": s0}
    device = r.device
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"wkv_kernel: {name} must be f32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"wkv_kernel: {name} is on {t.device}, r on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"wkv_kernel: {name} must be contiguous")
    if r.dim() != 3:
        raise ValueError(f"wkv_kernel: want r of (BH, S, D), got "
                         f"{tuple(r.shape)}")
    bh, seq, d = r.shape
    for name, t, shape in (("k", k, (bh, seq, d)), ("v", v, (bh, seq, d)),
                           ("w", w, (bh, seq, d)), ("u", u, (bh, d)),
                           ("s0", s0, (bh, d, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"wkv_kernel: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv_kernel: head size {d} is not one of "
                         f"{HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"wkv_kernel: chunk {chunk} is not one of {CHUNKS}")
    if seq % chunk:
        raise ValueError(f"wkv_kernel: S = {seq} is not a multiple of the "
                         f"chunk {chunk}")


def wkv_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (BH, S, D) f32; u: (BH, D); s0: (BH, D, D) f32, all
    contiguous on one device, S % chunk == 0. Returns y (BH, S, D) and
    s_out (BH, D, D), f32."""
    _check(r, k, v, w, u, s0, chunk)
    if r.device.type == "cpu":
        return _ref.wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_kernel: no kernel for device {r.device}")
    bh, seq, d = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(s0)
    if bh == 0:
        return y, s_out
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                             y.data_ptr(), s_out.data_ptr(), bh, seq, d,
                             chunk, stream)
    _build.check(err, "wkv_kernel")
    LAUNCHES["wkv"] += 1
    return y, s_out
