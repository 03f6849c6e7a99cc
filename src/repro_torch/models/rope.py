"""Rotary position embeddings (half-rotation convention).

Port of ``repro/models/rope.py``: the angles and the rotation in f32, the
rotated tensor cast back to its dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10_000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin tables for integer positions: (...,) int ->
    (..., head_dim // 2) f32 each."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[..., :half], x[..., half:]). x: (..., S, H, hd);
    cos and sin: (S, hd // 2), broadcast over the batch and the heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., :, None, :], sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
