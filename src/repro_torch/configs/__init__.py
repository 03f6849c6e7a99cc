"""Architecture configs of the port.

``get_config(name)`` returns the published configuration and
``get_config(name, smoke=True)`` the reduced same-family variant, as
``repro/configs/__init__.py`` does. ``ARCHS`` lists all ten ids, every
one ported: the ``dense`` family (``yi-9b``, ``qwen3-32b``,
``granite-34b``, ``minicpm-2b``), the ``moe`` one (``olmoe-1b-7b``,
``dbrx-132b``), ``rwkv6-3b`` (``ssm``), ``hymba-1.5b`` (``hybrid``),
``seamless-m4t-large-v2`` (``encdec``) and ``llama-3.2-vision-90b``
(``vlm``).
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

# arch id -> module of its CONFIG
_MODULES: Dict[str, str] = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-34b": "granite_34b",
    "yi-9b": "yi_9b",
    "qwen3-32b": "qwen3_32b",
    "minicpm-2b": "minicpm_2b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "rwkv6-3b": "rwkv6_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    cfg = importlib.import_module(f".{_MODULES[name]}", __name__).CONFIG
    return cfg.reduced() if smoke else cfg
