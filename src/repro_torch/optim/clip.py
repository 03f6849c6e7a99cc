"""Global-norm gradient clipping.

Port of ``repro/optim/clip.py``. The reference sums ``sum(x**2)`` leaf by
leaf over ``jax.tree.leaves`` of its parameter tree: dict keys sorted,
each segment's leaf stacked over the layers. The port holds one tensor a
layer, so a leaf here is a tensor or a sequence of tensors (one reference
leaf, its layers in order): its square-sum is its layers' square-sums
added in layer order. The leaves are added left to right, as Python's
``sum`` adds the reference's, and the root is the f64 ``sqrt`` rounded
once (XLA's f32 ``sqrt`` is correctly rounded; PyTorch's CPU one is not
always). Within a leaf the order of the sum is PyTorch's, not XLA's
(ROADMAP Queue C).

On a mesh (:func:`global_norm_sharded`) each tensor's square-sum is its
local block's, summed over the mesh axes that cut it in rank order, and
the leaves are then added as on one device.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .. import rand

Leaf = Union[torch.Tensor, Sequence[torch.Tensor]]


def _square_sum(leaf: Leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return torch.sum(torch.square(leaf.float()))
    total = None
    for x in leaf:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return total


def global_norm(leaves: Sequence[Leaf]) -> torch.Tensor:
    """f32 0-d: the root of the leaves' square-sums, added in order."""
    total = None
    for leaf in leaves:
        s = _square_sum(leaf)
        total = s if total is None else total + s
    return rand.sqrt_f32(total)


def leaves_of(tree: Dict[str, torch.Tensor],
              order: Optional[Sequence[Sequence[str]]] = None
              ) -> list:
    """``tree``'s tensors as :func:`global_norm`'s leaves: ``order`` names
    each leaf's tensors (a list of names per leaf); by default every
    tensor is a leaf, in the sorted order of its name, as
    ``jax.tree.leaves`` orders a flat dict."""
    if order is None:
        order = [[k] for k in sorted(tree)]
    return [[tree[n] for n in names] for names in order]


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float,
                        order: Optional[Sequence[Sequence[str]]] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``(clipped, norm)``. Each tensor is cast to f32, scaled and cast
    back to its dtype, as the reference does (so a bf16 gradient is
    rounded again before AdamW casts it to f32)."""
    norm = global_norm(leaves_of(tree, order))
    scale = clip_scale(norm, max_norm)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, norm


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))`` in f32."""
    top = rand.const(max_norm, torch.float32, norm.device)
    return torch.clamp(top / torch.clamp(norm, min=1e-12), max=1.0)


def global_norm_sharded(tree: Dict[str, torch.Tensor],
                        order: Sequence[Sequence[str]], layout
                        ) -> torch.Tensor:
    """:func:`global_norm` of a tree of local blocks (``layout``, a
    :class:`~repro_torch.launch.partition.Layout`, cuts each tensor): a
    tensor's square-sum is its block's summed over the axes that cut it;
    the ranks along the others hold the same block."""
    from ..launch import partition
    from ..launch.shardings import spec_axes
    total = None
    for names in order:
        leaf = None
        for n in names:
            s = torch.sum(torch.square(tree[n].float()))
            s = partition.sum_axes(layout.mesh, spec_axes(layout.specs[n]), s)
            leaf = s if leaf is None else leaf + s
        total = leaf if total is None else total + leaf
    return rand.sqrt_f32(total)
