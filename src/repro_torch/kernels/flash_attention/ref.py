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
