"""Dense feed-forward blocks: SwiGLU (the llama family) and GeLU (granite).

Port of ``repro/models/mlp.py``. :class:`MLP` holds the parameters under
the reference's keys; :func:`apply` computes from its ``tree()``. The
activations round as the reference's do in bf16: ``jax.nn.silu`` is
``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``
(:func:`~repro_torch.models.common.sigmoid`), and the tanh GeLU takes its
constants in the input's dtype, one rounding per operation; ``F.silu``
and ``F.gelu`` compute in f32 and round once, which differs in about 40 %
of bf16 values.
"""
from __future__ import annotations

import math

import torch

from .common import Maker, ModelConfig, Params, Tree, sigmoid


class MLP(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp not in ("swiglu", "gelu"):
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
        if cfg.mlp == "swiglu":
            self._param("wg", mk(f"{prefix}.wg", (d, f), ("embed", "ff")))
        self._param("wu", mk(f"{prefix}.wu", (d, f), ("embed", "ff")))
        self._param("wd", mk(f"{prefix}.wd", (f, d), ("ff", "embed")))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: its constants are weakly typed,
    so they round to the input's dtype first. They are device fills, not
    copies from host memory, so a CUDA graph captures them."""
    def const(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=x.dtype, device=x.device)

    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * x ** 3)
    return x * (const(0.5) * (const(1.0) + torch.tanh(inner)))


def apply(p: Tree, cfg: ModelConfig, x: torch.Tensor,
          product=None) -> torch.Tensor:
    """The FFN; ``product(h, wd)`` takes the last product's place where
    given (a mesh's ``Shards.product``)."""
    if cfg.mlp == "swiglu":
        gate = x @ p["wg"]
        h = gate * sigmoid(gate) * (x @ p["wu"])
    else:
        h = gelu_tanh(x @ p["wu"])
    return h @ p["wd"] if product is None else product(h, p["wd"])


def apply_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor, sh
                  ) -> torch.Tensor:
    """:func:`apply` on a mesh: the ``ff`` dim over ``model`` where it
    divides (each rank's columns of ``wg``/``wu`` and rows of ``wd``, the
    parts summed in rank order), else the layer whole from gathered
    weights."""
    f = cfg.d_ff
    if not sh.splits(f):
        return apply({k: sh.w(v) for k, v in p.items()}, cfg, x)
    lo, hi = sh.chunk(f)
    local = {k: sh.cols(v, lo, hi, dim=0 if k == "wd" else -1)
             for k, v in p.items()}
    return sh.leave(apply(local, cfg, sh.enter(x), sh.product), x.dtype)
