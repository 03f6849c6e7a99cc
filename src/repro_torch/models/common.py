"""Model configuration, parameter makers and normalisations.

Port of ``repro/models/common.py``: :class:`ModelConfig` with every field
of the reference (its dtypes as torch dtypes), the makers that build a
parameter, ``rmsnorm``, ``rmsnorm_1d`` and ``groupnorm_heads``, and what
the blocks share: :class:`Params`, which holds a block's parameters under
the reference's keys, and :func:`sigmoid` as the reference rounds it in
bf16.

A maker is called as ``mk(name, shape, axes, scale=None,
dtype_override=None)`` by the modules' constructors, ``axes`` naming each
dim's logical axis as the reference's call site names it (``("embed",
"heads")`` for ``wq``; :mod:`repro_torch.launch.shardings` maps them to
mesh axes). :func:`init_maker` draws like the reference's ``init_maker``:
zeros where ``scale == 0.0``, ones for names ending in ``norm.scale``,
otherwise a normal truncated to [-3, 3] times ``scale`` (``1 /
sqrt(fan_in)`` when ``scale`` is None), drawn in f32 and cast. The draws
come from a ``torch.Generator``, so they are not the reference's bits;
the tests carry the reference's weights across with
:mod:`repro_torch.convert`. :func:`meta_maker` and :func:`shape_maker`
build the same shapes on the ``meta`` device, with no storage;
:func:`axes_maker` returns the axes tuple itself (for the caches' specs).
A tensor a maker returns carries its axes as ``.axes``, and
:func:`param` keeps them on the parameter, so ``Model.param_axes()``
reads them off a meta model.

The reference pins intermediates with ``constrain`` (a sharding
constraint under GSPMD). The port's execution over ranks is explicit
(:mod:`repro_torch.launch.partition`), so it has no such call; each
reference site has its counterpart there: the chunked-attention keys and
values of ``attention.py:160-162`` are a rank's heads
(``partition.head_split`` in :func:`~repro_torch.models.attention.
attend_sharded`), or the whole layer where the heads do not split; the
MoE dispatch buffers of ``moe.py:187-226`` are a rank's experts in
:func:`~repro_torch.models.moe.apply_sharded` (expert parallelism), or
the rows gathered over the batch's axes for the scatter path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import rand

Maker = Callable[..., torch.Tensor]
Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    mlp: str = "swiglu"             # swiglu | gelu
    norm_eps: float = 1e-5
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    rwkv_decay_lora: int = 64
    # --- hybrid (hymba) ---
    sliding_window: int = 0         # 0 -> full attention everywhere
    global_layers: Tuple[int, ...] = ()
    n_meta_tokens: int = 0
    # --- encoder-decoder (seamless) ---
    n_encoder_layers: int = 0
    source_is_embeddings: bool = False
    # --- VLM (llama-3.2-vision) ---
    cross_attn_every: int = 0
    vision_seq: int = 1024
    # --- dtypes ---
    param_dtype: Any = torch.bfloat16
    activation_dtype: Any = torch.bfloat16
    # --- schedule hint (minicpm WSD) ---
    schedule: str = "cosine"        # cosine | wsd

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch's state is bounded in the context (an SSM state
        or a sliding window)."""
        return self.family in ("ssm", "hybrid")

    def window_for_layer(self, i: int) -> int:
        """Attention window of layer i (0: the whole sequence)."""
        if self.sliding_window == 0 or i in self.global_layers:
            return 0
        return self.sliding_window

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's
        ``reduced``: f32, 2 layers, d_model 64, 4 heads of 16)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            rwkv_decay_lora=8,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            global_layers=tuple(g for g in self.global_layers if g < 2),
            n_meta_tokens=min(self.n_meta_tokens, 8),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            cross_attn_every=2 if self.cross_attn_every else 0,
            vision_seq=16,
            param_dtype=torch.float32,
            activation_dtype=torch.float32,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter counts, analytic, as the reference
        counts them."""
        d, hd = self.d_model, self.hd
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        ffn_one = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        if self.is_moe:
            ffn_tot = self.n_experts * ffn_one + d * self.n_experts
            ffn_act = self.experts_per_token * ffn_one + d * self.n_experts
        else:
            ffn_tot = ffn_act = ffn_one
        if self.family == "ssm":
            tm = 5 * d * d + self.rwkv_decay_lora * 2 * d * 6
            cm = d * self.d_ff + self.d_ff * d + d * d
            per_layer_tot = per_layer_act = tm + cm
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            ssm = (d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state + 1)
                   + self.conv_width * d_in)
            per_layer_tot = per_layer_act = attn + ffn_tot + ssm
        else:
            per_layer_tot = attn + ffn_tot
            per_layer_act = attn + ffn_act
        total = self.n_layers * per_layer_tot
        active = self.n_layers * per_layer_act
        if self.n_encoder_layers:
            enc = self.n_encoder_layers * (attn + ffn_tot)
            total += enc + self.n_layers * attn
            active += enc + self.n_layers * attn
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * attn
            active += n_cross * attn
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + emb, active + emb


# ---------------------------------------------------------------------------
# Parameter makers
# ---------------------------------------------------------------------------
Axes = Tuple[Optional[str], ...]


def _tagged(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    x.axes = tuple(axes)
    return x


def init_maker(generator: torch.Generator, dtype: torch.dtype,
               device: torch.device,
               cut: Optional[Callable[[torch.Tensor, Axes], torch.Tensor]]
               = None) -> Maker:
    """Maker of initialised parameters on ``device``, drawn from
    ``generator`` (which lies on ``device``). With ``cut(x, axes)`` each
    parameter is drawn whole, as without it, and only the tensor ``cut``
    returns is kept (a rank's block: the global one is freed before the
    next is drawn)."""

    def draw(name, shape, dt, scale):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=device)
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        if name.endswith("norm.scale"):
            return torch.ones(shape, dtype=dt, device=device)
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return (x * scale).to(dt)

    def mk(name: str, shape: Sequence[int], axes: Sequence[Optional[str]],
           scale: Optional[float] = None, dtype_override=None
           ) -> torch.Tensor:
        x = draw(name, tuple(shape), dtype_override or dtype, scale)
        return _tagged(x if cut is None else cut(x, tuple(axes)), axes)

    return mk


def meta_maker(dtype: torch.dtype) -> Maker:
    """Maker of storage-free parameters of the right shapes."""

    def mk(name: str, shape: Sequence[int], axes: Sequence[Optional[str]],
           scale: Optional[float] = None, dtype_override=None
           ) -> torch.Tensor:
        return _tagged(torch.empty(tuple(shape), dtype=dtype_override or dtype,
                                   device="meta"), axes)

    return mk


def shape_maker(dtype: torch.dtype) -> Maker:
    """The reference's ``shape_maker``: storage-free stand-ins (meta
    tensors of the shape and dtype)."""
    return meta_maker(dtype)


def axes_maker() -> Maker:
    """The reference's ``axes_maker``: each call returns its axes tuple."""

    def mk(name, shape, axes, scale=None, dtype_override=None) -> Axes:
        return tuple(axes)

    return mk


def param(value: torch.Tensor) -> nn.Parameter:
    """``nn.Parameter(value)`` keeping the maker's ``.axes``."""
    p = nn.Parameter(value)
    if hasattr(value, "axes"):
        p.axes = value.axes
    return p


def norm_param(mk: Maker, prefix: str, d: int) -> nn.Parameter:
    """A norm's scale: ``prefix.norm.scale`` (d,) on ``("embed",)``."""
    return param(mk(prefix + ".norm.scale", (d,), ("embed",), 1.0))


# ---------------------------------------------------------------------------
# Normalisation (f32 inside, the input's dtype out, as the reference)
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim. The reference rounds ``y`` only at the
    end, after the scale, so does this."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm_1d(scale: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim with a bare scale vector (qk-norm etc.)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def groupnorm_heads(scale: torch.Tensor, x: torch.Tensor, n_heads: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with one group per head over (..., H * hd), the RWKV wkv
    output's norm. The group is ``d // n_heads`` wide."""
    *lead, d = x.shape
    xf = x.float().reshape(*lead, n_heads, d // n_heads)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter holders and the reference's bf16 sigmoid
# ---------------------------------------------------------------------------
class Params(nn.Module):
    """Parameters registered under the reference's keys (a dot in a key is
    an underscore in the attribute name)."""

    def __init__(self):
        super().__init__()
        self._keys: List[str] = []

    def _param(self, key: str, value: torch.Tensor) -> None:
        self.register_parameter(key.replace(".", "_"), param(value))
        self._keys.append(key)

    def tree(self) -> Tree:
        """The parameters as a dict with the reference's keys."""
        return {k: getattr(self, k.replace(".", "_")) for k in self._keys}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, one rounding per operation: how the reference
    lowers ``jax.nn.sigmoid``, which in bf16 rounds differently from
    ``torch.sigmoid`` in about a third of the values."""
    return 1 / (1 + torch.exp(-x))


class _FusedMulAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return rand.fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors of one shape, rounded once, as XLA's
    compiled form fuses a product into its add, with the gradient of the
    unfused expression. On the card ``torch.addcmul``, whose kernel the
    compiler contracts into one ``fmaf`` (``chip_smoke.py`` phase 14 and
    ``tests/test_torch_cuda.py`` hold it bit for bit against
    :func:`repro_torch.rand.fma`); elsewhere ``rand.fma``, exact in f64
    with a round-to-odd sum."""
    if a.is_cuda:
        return torch.addcmul(c, a, b)
    return _FusedMulAdd.apply(a, b, c)
