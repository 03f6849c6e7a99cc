"""Random bits for the port: the GA counter RNG and the keyed recipes.

Two families live here, both built on one 20-round Threefry-2x32:

* **The counter RNG** of the generation kernel (``threefry2x32``,
  ``random_bits``, ``uniform``, ``randint``, ``bernoulli``, ``normal``),
  ported from ``repro.kernels.ga.prng``. Every draw is a pure function of
  ``(k0, k1, salt, counter)``: the counter of local element ``(r, c)`` is
  ``(row0 + r) * row_stride + (col0 + c)`` in wrapping uint32 arithmetic,
  with negative offsets wrapping as two's complement, and the salt is the
  second counter word. The CUDA kernel in ``kernels/ga/csrc`` draws the same
  bits from the same counters.
* **The keyed recipes** that the island model draws from outside the kernel
  (``key``, ``key_data``, ``split``, ``fold_in``, ``keyed_bits``,
  ``keyed_randint``, ``keyed_uniform``, ``keyed_bernoulli``,
  ``keyed_permutation``, ``keyed_gumbel``, ``keyed_categorical``,
  ``keyed_normal``). They follow ``jax.random`` under
  ``jax_threefry_partitionable=True``, so the port and the reference walk
  the same streams from the same seed: bit for bit where a recipe is
  integer arithmetic and exactly rounded f32 steps, and within an ulp or
  so of XLA's ``log``/``log1p`` where it goes through them (gumbel,
  categorical, normal). Those use the correctly rounded f32 result
  (:func:`log_f32`, :func:`log1p_f32`, :func:`sqrt_f32`: the f64
  function rounded once), which the CPU and the card give alike.

A key is a tensor of shape ``(..., 2)`` holding its two uint32 words in
int64. PyTorch on the CPU has no uint32 add, shift or modulo, so every
function here computes in int64 and masks with ``& 0xFFFFFFFF``; products
of two words are split into 16-bit halves so that no intermediate leaves
int64's range. The leading axes of a key are a batch: each function maps
over them, as ``vmap`` does in the reference.
"""
from __future__ import annotations

import math
import numbers
import operator
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _u32(x: Word, device: torch.device) -> Word:
    """A word as int64 in [0, 2**32): negative int32 values wrap. A Python
    word stays a Python int, which the ops take as a kernel argument (a
    tensor made from it would be a host-to-device copy, which a CUDA
    graph's capture refuses)."""
    if isinstance(x, numbers.Integral):
        return operator.index(x) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float. An f32 tensor compared
    with or scaled by it computes as with the f32 tensor of ``x``."""
    return float(np.float32(x))


def const(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of a Python value, filled on ``device`` (the value
    rounds to ``dtype`` as ``torch.tensor(value, dtype=dtype)`` rounds
    it); a CUDA graph captures the fill, where it refuses the copy from
    host memory that ``torch.tensor`` makes."""
    return torch.full((), value, dtype=dtype, device=device)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for words ``a``, ``b`` without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap an int64 tensor to int32 as a two's-complement cast would."""
    return (((x + 2**31) & MASK32) - 2**31).to(torch.int32)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors with one rounding, as a fused
    multiply-add (``__fmaf_rn`` on the card) computes it. The product is
    exact in f64; the f64 sum is rounded to odd (TwoSum gives its error,
    and an inexact sum with an even last bit steps one ulp toward the
    exact value), so the final rounding to f32 is the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).float()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word,
                 x1: Word) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32 of counter block ``(x0, x1)`` under key
    ``(k0, k1)``. Inputs broadcast; outputs are int64 words."""
    dev = _device_of(k0, k1, x0, x1)
    k0, k1, x0, x1 = (_u32(v, dev) for v in (k0, k1, x0, x1))
    if not isinstance(k0, torch.Tensor):
        k0 = const(k0, torch.int64, dev)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        rots = _ROTATIONS[:4] if block % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK32
    return x0, x1


# ---------------------------------------------------------------------------
# The GA counter RNG (repro.kernels.ga.prng)
# ---------------------------------------------------------------------------
def _counters(shape: Tuple[int, int], offset=(0, 0), row_stride=None,
              device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """(R, C) counters ``(row0 + r) * row_stride + (col0 + c)`` mod 2**32;
    the defaults give the whole-array linear counters."""
    if len(shape) != 2:
        raise ValueError(f"counter draws are 2-D, got {shape}")
    rows_n, cols_n = shape
    row0, col0 = offset
    stride = cols_n if row_stride is None else row_stride
    rows = torch.arange(rows_n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(cols_n, dtype=torch.int64, device=device)[None, :]
    rows = (rows + _u32(row0, device)) & MASK32
    cols = (cols + _u32(col0, device)) & MASK32
    return (_mul32(rows, _u32(stride, device)) + cols) & MASK32


def random_bits(k0: Word, k1: Word, shape: Tuple[int, int], salt: int,
                offset=(0, 0), row_stride=None) -> torch.Tensor:
    """Words of stream ``salt``; a batched key ``k0``/``k1`` (shape
    ``(..., 1, 1)``) broadcasts against the (R, C) counter grid."""
    cnt = _counters(shape, offset, row_stride, _device_of(k0, k1))
    out, _ = threefry2x32(k0, k1, cnt, salt)
    return out


def uniform(k0, k1, shape, salt, offset=(0, 0), row_stride=None):
    """f32 in [0, 1): the top 24 bits times 2**-24, exact in f32."""
    bits = random_bits(k0, k1, shape, salt, offset, row_stride)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def randint(k0, k1, shape, maxval, salt, offset=(0, 0), row_stride=None):
    """int32 in [0, maxval) as ``bits % maxval`` (its small modulo bias is
    part of the stream's contract)."""
    bits = random_bits(k0, k1, shape, salt, offset, row_stride)
    return (bits % _u32(maxval, bits.device)).to(torch.int32)


def bernoulli(k0, k1, shape, p, salt, offset=(0, 0), row_stride=None):
    """``uniform < p`` with ``p`` rounded to f32 first."""
    u = uniform(k0, k1, shape, salt, offset, row_stride)
    return u < f32(p)


def normal(k0, k1, shape, salt, offset=(0, 0), row_stride=None):
    """Standard normals by Box-Muller from both words of one call."""
    dev = _device_of(k0, k1)
    cnt = _counters(shape, offset, row_stride, dev)
    b0, b1 = threefry2x32(k0, k1, cnt, salt)
    u1 = (b0 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    u2 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(1.0 - u1))
    return r * torch.cos(f32(2.0 * math.pi) * u2)


# ---------------------------------------------------------------------------
# Keyed recipes (jax.random, partitionable Threefry layout)
# ---------------------------------------------------------------------------
def key(seed: int, device=None) -> torch.Tensor:
    """The key of an int32 seed: words ``(0, seed)``, as ``jax.random.key``
    gives them with 64-bit mode off."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """A key's words. Keys already are their words; this names the step
    that ``jax.random.key_data`` takes in the reference."""
    return k


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``(..., 2) -> (..., n, 2)``: child ``i`` is Threefry of counter
    block ``(0, i)``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], 0, i)
    return torch.stack([y0, y1], dim=-1)


def fold_in(k: torch.Tensor, data: Word) -> torch.Tensor:
    """Threefry of counter block ``(0, data)``; ``data`` broadcasts over
    the key's batch axes."""
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def _batch_view(k: torch.Tensor, ndim: int) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    shape = k.shape[:-1] + (1,) * ndim
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def keyed_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit words of shape ``(..., *shape)``: element ``i`` of the
    flattened shape is ``x0 ^ x1`` of counter block ``(0, i)``."""
    shape = tuple(shape)
    cnt = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=k.device).reshape(shape)
    k0, k1 = _batch_view(k, len(shape))
    y0, y1 = threefry2x32(k0, k1, 0, cnt)
    return y0 ^ y1


def _batched_scalar(v, k: torch.Tensor, ndim: int) -> torch.Tensor:
    if isinstance(v, numbers.Integral):
        return const(operator.index(v), torch.int64, k.device)
    t = torch.as_tensor(v, dtype=torch.int64, device=k.device)
    if t.dim() == 0:
        return t
    return t.reshape(t.shape + (1,) * ndim)


def keyed_randint(k: torch.Tensor, shape: Sequence[int], minval,
                  maxval) -> torch.Tensor:
    """int32 in [minval, maxval) by the two-draw recipe: ``hi`` and ``lo``
    words from the two children of ``k``, combined modulo the span with
    ``2**32 mod span`` as the multiplier. ``minval``/``maxval`` are int32
    values, scalars or one per key."""
    shape = tuple(shape)
    children = split(k, 2)
    hi = keyed_bits(children[..., 0, :], shape)
    lo = keyed_bits(children[..., 1, :], shape)
    lo_v = _batched_scalar(minval, k, len(shape))
    hi_v = _batched_scalar(maxval, k, len(shape))
    span = (hi_v - lo_v) & MASK32
    span = torch.where(hi_v <= lo_v, torch.ones_like(span), span)
    mult = (2**16) % span
    mult = _mul32(mult, mult) % span
    off = ((_mul32(hi % span, mult) + lo % span) & MASK32) % span
    return _to_i32(lo_v + off)


def keyed_uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """f32 in [minval, maxval): the top 23 bits as the mantissa of a float
    in [1, 2), minus one, scaled.

    The scaling ``floats * (hi - lo) + lo`` is one fused multiply-add in
    the reference (XLA's CPU backend contracts it), so it is :func:`fma`
    here."""
    bits = keyed_bits(k, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = _to_i32(fbits).view(torch.float32) - 1.0
    lo = const(minval, torch.float32, k.device)
    hi = const(maxval, torch.float32, k.device)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def keyed_bernoulli(k: torch.Tensor, p: float,
                    shape: Sequence[int]) -> torch.Tensor:
    """``keyed_uniform < p`` with ``p`` rounded to f32."""
    u = keyed_uniform(k, shape)
    return u < f32(p)


# ---------------------------------------------------------------------------
# Keyed recipes through transcendental functions
# ---------------------------------------------------------------------------
F32_TINY = 1.1754943508222875e-38          # numpy.finfo(float32).tiny
# nextafter(-1, 0) in f32, the low end of jax.random.normal's uniform
_NORMAL_LOW = -0.99999994039535522
_SQRT2_F32 = 1.4142135381698608            # numpy.float32(sqrt(2))
# XLA's f32 ErfInv (Giles' approximation): Horner coefficients, highest
# degree first, for w = -log1p(-x*x) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 ``log`` (PyTorch's f32 CPU ``log`` and
    ``sqrt`` are not: they miss by an ulp on some inputs)."""
    return torch.log(x.double()).float()


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(x.double()).float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function as XLA lowers ``lax.erf_inv``: Giles'
    polynomial in w = -log1p(-x*x) (w - 2.5 below 5, sqrt(w) - 3 above),
    each Horner step one fused multiply-add as XLA's CPU code contracts it,
    and ``x * inf`` at |x| = 1."""
    w = -log1p_f32(x * -x)
    lt = w < 5.0
    t = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)

    def coef(i):
        return torch.where(lt, const(_ERFINV_LT5[i], torch.float32, x.device),
                           const(_ERFINV_GE5[i], torch.float32, x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, t, coef(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def keyed_permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: ``arange(n)`` sorted by fresh
    32-bit words in each of ``ceil(3 ln n / ln(2**32 - 1))`` rounds, a
    round's key being the second child of ``split`` and the next round's
    the first. The sort is stable; XLA's sort need not be, which could
    matter only where two of a round's words collide."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    x = torch.arange(n, device=k.device).expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        children = split(k, 2)
        k, sub = children[..., 0, :], children[..., 1, :]
        order = torch.sort(keyed_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def keyed_gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel f32, ``jax.random.gumbel``'s ``"low"`` mode:
    ``-log(-log(u))`` of u uniform in [tiny, 1)."""
    return -log_f32(-log_f32(keyed_uniform(k, shape, F32_TINY, 1.0)))


def keyed_categorical(k: torch.Tensor, logits: torch.Tensor,
                      shape: Sequence[int]) -> torch.Tensor:
    """Draws of ``shape`` from the categorical over ``logits``' last axis,
    with replacement: ``argmax(gumbel(shape + (lanes,)) + logits)`` (the
    first index on ties, as ``jnp.argmax``). ``logits`` carries the key's
    batch axes in front of its lanes."""
    shape = tuple(shape)
    lanes = logits.shape[-1]
    g = keyed_gumbel(k, shape + (lanes,))
    lg = logits.reshape(logits.shape[:-1] + (1,) * len(shape) + (lanes,))
    return torch.argmax(g + lg, dim=-1)


def keyed_normal(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal f32, ``jax.random.normal``: ``sqrt(2) *
    erf_inv(u)`` of u uniform in [nextafter(-1, 0), 1)."""
    u = keyed_uniform(k, shape, _NORMAL_LOW, 1.0)
    return const(_SQRT2_F32, torch.float32, u.device) * erf_inv(u)
