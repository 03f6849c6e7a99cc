"""Step functions for serving: prefill and decode.

Port of ``repro/launch/steps.py:90-107``. The parameters live in the
model, so a step takes the batch alone. The train step is not ported yet
(ROADMAP Queue A item 17).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models import Model


def make_prefill_step(model: Model, *, max_seq: Optional[int] = None,
                      use_flash: bool = False,
                      use_rwkv_kernel: bool = False
                      ) -> Callable[[Dict], Tuple[torch.Tensor, List]]:
    """prefill(batch) -> (last-position logits (B, V), caches). With
    ``use_flash`` every attention layer runs the flash-attention kernel,
    with ``use_rwkv_kernel`` every RWKV layer the WKV kernel; each is
    ignored by the blocks without its mixer."""

    def prefill(batch: Dict) -> Tuple[torch.Tensor, List]:
        return model.prefill(batch, use_flash=use_flash,
                             use_rwkv_kernel=use_rwkv_kernel,
                             max_seq=max_seq)

    return prefill


def make_decode_step(model: Model
                     ) -> Callable[[Dict], Tuple[torch.Tensor, List]]:
    """decode({'token', 'index', 'caches'}) -> (logits (B, V), caches)."""

    def decode(batch: Dict) -> Tuple[torch.Tensor, List]:
        return model.decode(batch["token"], batch["index"], batch["caches"])

    return decode
