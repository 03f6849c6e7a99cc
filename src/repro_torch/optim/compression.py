"""Gradient compression for the mean across a group of ranks, with error
feedback.

Port of ``repro/optim/compression.py`` on the port's
:class:`~repro_torch.core.sharded.ShardGroup` (the reference calls it
inside a ``shard_map`` over a mesh axis). Each method sends less than an
f32 sum would:

* ``"bf16"``: the gradient plus its carried error, cast to bf16, summed
  in bf16 in rank order (the bits travel as bytes), over the world size;
  the cast's residual is the next error.
* ``"int8"``: a per-tensor scale (``max|x| / 127``) and int8 values; every
  rank gathers every rank's ``q`` and scale and contracts them in f32 (a
  chain of FMAs ``scale_r * q_r + acc`` in rank order, as XLA's CPU dot
  computes it), over the world size; the quantisation's residual is the
  next error.
* ``"none"``: the f32 sum in rank order, over the world size; the error
  passes through.

The error feedback makes the series of updates converge to the
uncompressed series (Karimireddy et al., 2019).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import rand

Tree = Dict[str, torch.Tensor]
# XLA divides by a constant as a product with its f32 reciprocal
_INV_127 = 1.0 / 127.0


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``round(x / scale)`` (half to even, as ``jnp.round``)
    clipped to [-127, 127] as int8, and the f32 scale ``max|x| / 127``,
    taken as the reference's compiled code takes it: times the f32
    reciprocal of 127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) * torch.tensor(
        _INV_127, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _one(g: torch.Tensor, e: torch.Tensor, group, method: str
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = torch.tensor(float(group.world), dtype=torch.float32,
                     device=g.device)
    gf = g.to(torch.float32) + e
    if method == "bf16":
        sent = gf.to(torch.bfloat16)
        new_e = gf - sent.to(torch.float32)
        # the bits travel as bytes (gloo has no 16-bit types)
        got = group.gather_stack(sent.reshape(-1).view(torch.uint8))
        got = [got[r].view(torch.bfloat16).reshape(g.shape)
               for r in range(group.world)]
        total = got[0]
        for r in range(1, group.world):
            total = total + got[r]
        return (total.to(torch.float32) / n).to(g.dtype), new_e
    if method == "int8":
        q, scale = _quant_int8(gf)
        # gf - q * scale, contracted into one FMA as XLA contracts it
        new_e = rand.fma(-q.to(torch.float32), scale.expand(gf.shape), gf)
        qs = group.gather_stack(q)                    # (n, ...) int8
        ss = group.gather_stack(scale)                # (n,) f32
        # the contraction over ranks: a chain of FMAs in rank order
        total = ss[0] * qs[0].to(torch.float32)
        for r in range(1, group.world):
            total = rand.fma(ss[r].expand(gf.shape),
                             qs[r].to(torch.float32), total)
        return (total / n).to(g.dtype), new_e
    if method == "none":
        return (group.sum_in_order(gf) / n).to(g.dtype), e
    raise ValueError(f"unknown compression {method!r}")


def compress_psum(grads: Tree, err: Tree, group, method: str = "int8"
                  ) -> Tuple[Tree, Tree]:
    """The group's mean of ``grads`` (a dict of tensors) with error
    feedback ``err`` (f32, as :func:`init_error` makes it). Every rank
    calls it with its own gradients. Returns ``(synced, new_err)``."""
    out = {k: _one(g, err[k], group, method) for k, g in grads.items()}
    return ({k: s for k, (s, _) in out.items()},
            {k: e for k, (_, e) in out.items()})


def init_error(grads_like: Tree) -> Tree:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}
