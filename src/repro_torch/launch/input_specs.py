"""The assigned input shapes and their stand-ins per (arch x shape): the
port of ``repro/launch/input_specs.py``.

Shapes (the LM family, sequence x global batch):

    train_4k      4,096 x 256   a training step
    prefill_32k  32,768 x 32    an inference prefill
    decode_32k   32,768 x 128   one decode token against a 32k KV cache
    long_500k   524,288 x 1     long-context decode (sub-quadratic archs)

``long_500k`` runs only for the archs whose state is bounded in the
context (rwkv6-3b, hymba-1.5b); the full-attention archs skip it.

The encoder-decoder arch (seamless) reads the context length as its
encoder's source (precomputed frame embeddings from the stub frontend);
its decoder sees a 128-token prompt at prefill and a 4,096-entry cross
cache at decode. The vision arch's stub frontend supplies (B, 1024,
d_model) patch embeddings.

The stand-ins are ``meta`` tensors (:func:`~repro_torch.models.common.
shape_maker`), the axes trees the logical axes of each input's dims.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..models import Model, ModelConfig
from ..models.common import axes_maker, shape_maker

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

ENCDEC_DECODER_PROMPT = 128
ENCDEC_DECODE_CROSS = 4096


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k decode skipped per "
                       "assignment (KV cache unbounded / quadratic prefill)")
    return True, ""


def _i32(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, model: Model, shape: str, *,
                batch: Optional[int] = None, seq: Optional[int] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(stand-ins, logical axes) of every input of the cell's step;
    ``batch`` and ``seq`` shrink the shape (small meshes in tests)."""
    info = SHAPES[shape]
    S = seq if seq is not None else info["seq"]
    B = batch if batch is not None else info["batch"]
    kind = info["kind"]
    d = cfg.d_model
    adt = cfg.activation_dtype
    mk_shape = shape_maker(adt)
    mk_axes = axes_maker()
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}

    if kind in ("train", "prefill"):
        tok_len = S
        if kind == "prefill" and cfg.n_encoder_layers:
            tok_len = ENCDEC_DECODER_PROMPT      # 32k is the source's
        specs["tokens"] = _i32((B, tok_len))
        axes["tokens"] = ("batch", None)
        if kind == "train":
            specs["labels"] = _i32((B, tok_len))
            axes["labels"] = ("batch", None)
        if cfg.n_encoder_layers:
            specs["src_embed"] = torch.empty((B, S, d), dtype=adt,
                                             device="meta")
            axes["src_embed"] = ("batch", None, "embed")
        if cfg.family == "vlm":
            specs["vision_embed"] = torch.empty((B, cfg.vision_seq, d),
                                                dtype=adt, device="meta")
            axes["vision_embed"] = ("batch", None, "embed")
        return specs, axes

    total_ctx = S + cfg.n_meta_tokens
    specs["token"] = _i32((B, 1))
    axes["token"] = ("batch", None)
    specs["index"] = _i32(())
    axes["index"] = ()
    specs["caches"] = model.cache_specs(mk_shape, B, total_ctx)
    axes["caches"] = model.cache_specs(mk_axes, B, total_ctx)
    src_len = cross_len(cfg)
    if src_len is not None:
        xkv_shape = model.cross_kv_specs(mk_shape, B, src_len)
        if xkv_shape is not None:
            specs["cross_kvs"] = xkv_shape
            axes["cross_kvs"] = model.cross_kv_specs(mk_axes, B, src_len)
    return specs, axes


def cross_len(cfg: ModelConfig) -> Optional[int]:
    """The decode step's cross-attention source length, or None."""
    if cfg.n_encoder_layers:
        return ENCDEC_DECODE_CROSS
    if cfg.family == "vlm":
        return cfg.vision_seq
    return None


def cells(archs: Sequence[str], shapes: Optional[Sequence[str]] = None
          ) -> Iterator[Tuple[str, str, bool, str]]:
    """Every assigned (arch, shape) cell with its skip status."""
    from ..configs import get_config
    shapes = shapes or list(SHAPES)
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = cell_supported(cfg, shape)
            yield arch, shape, ok, why
