"""WKV6 kernel wrapper: the CUDA kernel for CUDA tensors, the plain
chunked version (:func:`ref.wkv_chunked`) for CPU tensors.

Replaces ``repro/kernels/rwkv6/rwkv6.py::wkv_kernel``. The kernel
(``csrc/wkv.cuh``; ``wkv.cu`` for bf16 r, k, v and ``wkv_f32.cu`` for f32)
reads the model's layout, r, k, v, w (B, S, H, hd) through their strides
by TMA tensor maps and u as (H, hd), and writes y (B, S, H, hd) f32 and
the final state: no transposes, casts or copies around it. What bounded
the first port was work, not bytes: scalar f32 loops over shared memory,
a head's state-independent work done once per column block, loads
exposed between chunks, and layout copies around the call. So one CTA of
256 threads owns one head; the chunk's state-independent work is done
once there, with the intra-chunk pairs exact only inside sub-chunks of 8
tokens (:func:`ref.wkv_subchunked` is that form in plain PyTorch, held
against the kernel in the tests); its products run on the tensor cores
in 3xTF32 (f32 grade), the state in registers; a ring of 2 TMA stages
keeps the next chunk's loads in flight.

TMA takes a base address and batch, sequence and head strides that are
multiples of 16 bytes, with hd contiguous; the wrapper refuses other
views, and any input it cannot take, rather than copying.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ... import _build
from .. import LAUNCHES
from . import ref as _ref

CHUNK = 32
HEAD_DIMS = (8, 16, 32, 64)
CHUNKS = (8, 16, 32)
DTYPES = (torch.float32, torch.bfloat16)   # of r, k and v (one), and of u
TMA_ALIGN = 16   # bytes: base address and strides of a TMA tensor map


def _check(r, k, v, w, u, s0, chunk: int) -> None:
    if r.dim() != 4:
        raise ValueError(f"wkv_kernel: want r of (B, S, H, hd), got "
                         f"{tuple(r.shape)}")
    b, seq, h, hd = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (h, hd)),
                           ("s0", s0, (b, h, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv_kernel: {name} must be {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if t.device != r.device:
            raise ValueError(f"wkv_kernel: {name} is on {t.device}, r on "
                             f"{r.device}")
    if not (r.dtype == k.dtype == v.dtype and r.dtype in DTYPES):
        raise ValueError(f"wkv_kernel: r, k and v must share one dtype of "
                         f"{DTYPES}, got {r.dtype}, {k.dtype}, {v.dtype}")
    if u.dtype not in DTYPES:
        raise ValueError(f"wkv_kernel: u must be one of {DTYPES}, got "
                         f"{u.dtype}")
    for name, t in (("w", w), ("s0", s0)):
        if t.dtype != torch.float32:
            raise ValueError(f"wkv_kernel: {name} must be f32, got "
                             f"{t.dtype}")
    for name, t in (("u", u), ("s0", s0)):
        if not t.is_contiguous():
            raise ValueError(f"wkv_kernel: {name} must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv_kernel: head size {hd} is not one of "
                         f"{HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"wkv_kernel: chunk {chunk} is not one of {CHUNKS}")
    if seq % chunk:
        raise ValueError(f"wkv_kernel: S = {seq} is not a multiple of the "
                         f"chunk {chunk}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv_kernel: {name}'s last dim must be "
                             f"contiguous")
        nbytes = [t.data_ptr()] + [st * t.element_size()
                                   for st in t.stride()[:3]]
        if any(n % TMA_ALIGN for n in nbytes):
            raise ValueError(
                f"wkv_kernel: {name}'s base address and its batch, sequence "
                f"and head strides must be multiples of {TMA_ALIGN} bytes "
                f"(TMA), got address {t.data_ptr() % TMA_ALIGN} past a "
                f"multiple and strides {tuple(t.stride()[:3])}")


def _plain(r, k, v, w, u, s0, chunk: int):
    """The kernel's plain version, :func:`ref.wkv_chunked` (the reference's
    form of the same function), in the model's layout."""
    b, seq, h, hd = r.shape

    def to_bh(a):
        return a.float().transpose(1, 2).reshape(b * h, seq, hd)

    ub = u.float()[None].expand(b, h, hd).reshape(b * h, hd)
    y, s = _ref.wkv_chunked(*map(to_bh, (r, k, v, w)), ub,
                            s0.reshape(b * h, hd, hd), chunk=chunk)
    return (y.reshape(b, h, seq, hd).transpose(1, 2).contiguous(),
            s.reshape(b, h, hd, hd))


def _launch(r, k, v, w, u, s0, chunk: int):
    """Launch the kernel on checked CUDA tensors, one CTA per head."""
    b, seq, h, hd = r.shape
    y = torch.empty((b, seq, h, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(s0)
    lib = _build.library()
    launch = (lib.wkv_launch if r.dtype == torch.bfloat16
              else lib.wkv_f32_launch)
    strides = (ctypes.c_int * 12)(*(st for t in (r, k, v, w)
                                    for st in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), s0.data_ptr(), y.data_ptr(),
                     s_out.data_ptr(), b, seq, h, hd, chunk,
                     int(u.dtype == torch.bfloat16), strides, stream)
    _build.check(err, "wkv_kernel")
    LAUNCHES["wkv"] += 1
    return y, s_out


def wkv_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
               chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, hd) in one dtype of :data:`DTYPES`, w (B, S, H,
    hd) f32, each with hd contiguous and 16-byte aligned strides; u (H, hd)
    f32 or bf16; s0 (B, H, hd, hd) f32; u and s0 contiguous; all on one
    device, S % chunk == 0. Returns y (B, S, H, hd) and s_out (B, H, hd,
    hd), f32, contiguous."""
    _check(r, k, v, w, u, s0, chunk)
    if r.device.type == "cpu":
        return _plain(r, k, v, w, u, s0, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_kernel: no kernel for device {r.device}")
    b, seq, h, hd = r.shape
    if b * h == 0 or seq == 0:
        return (torch.empty((b, seq, h, hd), dtype=torch.float32,
                            device=r.device), s0.clone())
    return _launch(r, k, v, w, u, s0, chunk)
