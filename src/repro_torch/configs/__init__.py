"""Architecture configs of the port.

``get_config(name)`` returns the published configuration and
``get_config(name, smoke=True)`` the reduced same-family variant, as
``repro/configs/__init__.py`` does. ``ARCHS`` lists all ten ids. Ported:
``rwkv6-3b`` (the ``ssm`` family) and the ``dense`` family, ``yi-9b``,
``qwen3-32b``, ``granite-34b`` and ``minicpm-2b``; the others raise
``NotImplementedError`` naming the ROADMAP item that brings their layers.
"""
from __future__ import annotations

import importlib
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

_QUEUE_A = "ROADMAP Queue A item 14"
# what each unported arch waits for
UNPORTED: Dict[str, str] = {
    "seamless-m4t-large-v2": f"{_QUEUE_A}: the encoder-decoder plan and "
                             f"cross-attention",
    "dbrx-132b": f"{_QUEUE_A}: models/moe.py",
    "olmoe-1b-7b": f"{_QUEUE_A}: models/moe.py",
    "llama-3.2-vision-90b": f"{_QUEUE_A}: the cross-attention plan",
    "hymba-1.5b": f"{_QUEUE_A}: models/ssm.py and the hybrid plan",
}
# arch id -> module of its CONFIG
_MODULES: Dict[str, str] = {
    "granite-34b": "granite_34b",
    "yi-9b": "yi_9b",
    "qwen3-32b": "qwen3_32b",
    "minicpm-2b": "minicpm_2b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    if name in UNPORTED:
        raise NotImplementedError(f"{name} is not ported yet: "
                                  f"{UNPORTED[name]}")
    cfg = importlib.import_module(f".{_MODULES[name]}", __name__).CONFIG
    return cfg.reduced() if smoke else cfg
