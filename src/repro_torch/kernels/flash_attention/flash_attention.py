"""Flash-attention kernel wrapper: a CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

Replaces ``repro/kernels/flash_attention/flash_attention.py
::flash_attention_kernel``. Two kernels, one per dtype, both reading the
model's layout, q (B, Sq, H, hd) and k, v (B, Sk, Kv, hd), through their
strides and writing o (B, Sq, H, hd) contiguous in q's dtype: no
transposes and no padding. The query head h reads KV head h // (H / Kv).

- bf16: ``csrc/flash_tc.cu``, on the tensor cores (wgmma), k and v tiles
  by TMA. A block owns one (b, h, 128-row q tile) and walks the 128-key
  tiles down from the causal frontier. TMA takes a base address and
  batch, sequence and head strides that are multiples of 16 bytes; the
  wrapper refuses others.
- f32: ``csrc/flash_3xtf32.cu``, both products on the tensor cores in
  3xTF32 (mma.sync; each operand split into tf32 hi and lo parts, f32
  sums: f32 grade, never plain TF32), 128-row q tiles over 32-key tiles.
  It takes any view whose last dim is contiguous (16-byte loads where the
  base and strides allow, 4-byte ones otherwise).

Neither falls back to the other or to the plain version.
"""
from __future__ import annotations

import torch

from ... import _build
from .. import LAUNCHES
from . import ref as _ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16   # bytes: base address and strides of a TMA tensor map


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: q, k and v must share one "
                             f"dtype of {DTYPES}, got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: want k and v of (B, Sk, Kv, "
                         f"{hd}) with B = {b}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {kv} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {hd} is not one of "
                         f"{HEAD_DIMS}")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty sequence")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            nbytes = [t.data_ptr()] + [st * t.element_size()
                                       for st in t.stride()[:3]]
            if any(n % TMA_ALIGN for n in nbytes):
                raise ValueError(
                    f"flash_attention: in bf16, {name}'s base address and "
                    f"its batch, sequence and head strides must be multiples "
                    f"of {TMA_ALIGN} bytes (TMA), got address "
                    f"{t.data_ptr() % TMA_ALIGN} past a multiple and strides "
                    f"{tuple(t.stride()[:3])}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, scale: float,
                           causal: bool) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Kv, hd), f32 or bf16 with the last
    dim contiguous, on one device -> (B, Sq, H, hd) in q's dtype. The
    causal mask is qpos >= kpos with both counted from 0. bf16 launches
    the bf16 tensor-core kernel, f32 the 3xTF32 one."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return _ref.attention(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.library()
    launch = (lib.flash_attention_tc_launch if q.dtype == torch.bfloat16
              else lib.flash_attention_f32_launch)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kv,
            sq, sk, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(causal), stream)
    _build.check(err, "flash_attention_kernel")
    LAUNCHES["flash_attention"] += 1
    return o
