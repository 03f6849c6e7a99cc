"""Plain PyTorch attention: the version beside the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ref.py::attention``: grouped
einsum, a -1e30 causal mask, the softmax in f32, the probabilities
rounded to v's dtype before the second product, which sums in f32; the
output in q's dtype.
"""
from __future__ import annotations

import torch

NEG = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, scale: float) -> torch.Tensor:
    """q (B, Sq, H, hd), k and v (B, Sk, Kv, hd) -> (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full((), NEG,
                                                      device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of an f32 tensor as ``hopper/csrc/tf32x3.cuh::split`` makes
    them: hi is x rounded to tf32 (half an ulp added, the low 13 bits
    cleared), lo the rest x - hi as the tensor core reads it (its low 13
    bits cut)."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = _f32_of_bits((bits + 0x1000) & 0xFFFFE000)
    rest = (x.float() - hi).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return hi, _f32_of_bits(rest & 0xFFFFE000)


def _f32_of_bits(bits: torch.Tensor) -> torch.Tensor:
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(
        torch.int32).view(torch.float32)


def _einsum_tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor):
    """einsum of f32 a and b as 3xTF32: lo hi + hi lo + hi hi (lo lo left
    out), the products exact and summed in f64, rounded once to f32."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    out = sum(torch.einsum(eq, x.double(), y.double())
              for x, y in ((al, bh), (ah, bl), (ah, bh)))
    return out.float()


def attention_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, scale: float) -> torch.Tensor:
    """:func:`attention` in f32 with both products in 3xTF32, the split of
    ``csrc/flash_3xtf32.cu``: what that kernel's products lose against f32
    ones, for tests on the CPU (no route of the port calls it). Its sums are
    exact where the card's are f32, so it shows the split's error alone."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, hd)
    logits = _einsum_tf32x3("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        logits = torch.where(mask, logits, torch.full((), NEG,
                                                      device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = _einsum_tf32x3("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(b, sq, h, hd)
