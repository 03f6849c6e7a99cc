"""Architecture configs of the port.

``get_config(name)`` returns the published configuration and
``get_config(name, smoke=True)`` the reduced same-family variant, as
``repro/configs/__init__.py`` does. ``ARCHS`` lists all ten ids; only
``rwkv6-3b`` is ported so far, and the others raise
``NotImplementedError`` naming the ROADMAP item that brings their layers.
"""
from __future__ import annotations

from typing import Dict, List

from ..models.common import ModelConfig

ARCHS: List[str] = [
    "seamless-m4t-large-v2",
    "dbrx-132b",
    "olmoe-1b-7b",
    "granite-34b",
    "yi-9b",
    "qwen3-32b",
    "minicpm-2b",
    "llama-3.2-vision-90b",
    "rwkv6-3b",
    "hymba-1.5b",
]

_ATTENTION = ("ROADMAP 'Next, in order' item 1: models/attention.py, "
              "rope.py and mlp.py with the flash-attention kernel (Queue B "
              "item 6)")
_QUEUE_A = "ROADMAP Queue A item 14"
# what each unported arch waits for
UNPORTED: Dict[str, str] = {
    "seamless-m4t-large-v2": f"{_QUEUE_A}: the encoder-decoder plan, after "
                             f"{_ATTENTION}",
    "dbrx-132b": f"{_QUEUE_A}: models/moe.py, after {_ATTENTION}",
    "olmoe-1b-7b": f"{_QUEUE_A}: models/moe.py, after {_ATTENTION}",
    "granite-34b": _ATTENTION,
    "yi-9b": _ATTENTION,
    "qwen3-32b": _ATTENTION,
    "minicpm-2b": _ATTENTION,
    "llama-3.2-vision-90b": f"{_QUEUE_A}: the cross-attention plan, after "
                            f"{_ATTENTION}",
    "hymba-1.5b": f"{_QUEUE_A}: models/ssm.py and the hybrid plan, after "
                  f"{_ATTENTION}",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    if name in UNPORTED:
        raise NotImplementedError(f"{name} is not ported yet: "
                                  f"{UNPORTED[name]}")
    from .rwkv6_3b import CONFIG
    return CONFIG.reduced() if smoke else CONFIG
