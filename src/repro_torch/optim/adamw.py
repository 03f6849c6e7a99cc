"""AdamW with mixed precision: bf16 params, f32 master copy and moments.

Port of ``repro/optim/adamw.py``. The state mirrors the parameters, a
dict of tensors by name:

    m, v     f32 first and second moments
    master   f32 copy of the parameters, only when some parameter is not
             f32 (otherwise None)
    step     int32 0-d

Plain per-parameter tensor operations, in place on the state, in the
reference's order and dtypes: the bias corrections ``1 - b ** step`` in
f32 (the power is the f64 one rounded once), the update on the master
and the decoupled decay ``weight_decay * master`` inside it, the new
parameters the master cast to their dtype.

On a mesh (``layout``, a :class:`~repro_torch.launch.partition.Layout`)
the gradients and parameters are each rank's blocks and the state lies
on the ZeRO-1 layout (``layout.opt``): each ``data`` rank updates its
slice of the moments and the master, and the new parameters are
all-gathered over ``data``. The global norm is
:func:`clip.global_norm_sharded`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import rand
from .._device import as_device
from .clip import clip_scale, global_norm, global_norm_sharded, leaves_of

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Params
    v: Params
    master: Optional[Params]   # f32 copy, or None when every param is f32
    step: torch.Tensor


def _needs_master(params: Params) -> bool:
    return any(x.dtype != torch.float32 for x in params.values())


def adamw_init(params: Params) -> AdamWState:
    m = {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
         for k, x in params.items()}
    v = {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
         for k, x in params.items()}
    master = ({k: x.detach().float().clone() for k, x in params.items()}
              if _needs_master(params) else None)
    dev = next(iter(params.values())).device
    return AdamWState(m=m, v=v, master=master,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(v, device) -> torch.Tensor:
    """``v`` (a Python number or a tensor) as an f32 tensor on ``device``:
    a number is filled there (a CUDA graph captures the fill)."""
    return as_device(v, torch.float32, device)


def _correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in f32, ``b`` rounded to f32 first."""
    b32 = rand.const(b, torch.float32, step.device).double()
    return 1.0 - torch.pow(b32, step.double()).float()


def adamw_update(grads: Params, state: AdamWState, params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay=0.1, max_grad_norm: Optional[float] = 1.0,
                 order: Optional[Sequence[Sequence[str]]] = None,
                 layout=None
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new params, new state, metrics
    ``grad_norm`` and ``lr``). ``order`` groups the gradients into the
    reference's leaves for the global norm (:func:`clip.leaves_of`).

    The step updates ``state``'s tensors and ``params`` in place and
    returns them (the reference's compiled step donates its state), so
    the state and parameters passed in are consumed: at minicpm-2b's size
    new moments and a new master beside the old ones would not fit the
    card. In-place or not, each value is rounded as the reference rounds
    it. The gradients are clipped one parameter at a time, as
    :func:`clip_by_global_norm` clips them."""
    dev = state.step.device
    gnorm = torch.zeros((), dtype=torch.float32, device=dev)
    scale = None
    if max_grad_norm is not None:
        gnorm = (global_norm(leaves_of(grads, order)) if layout is None
                 else global_norm_sharded(grads, order, layout))
        scale = clip_scale(gnorm, max_grad_norm)
    lr = _f32(lr, dev)
    wd = _f32(weight_decay, dev)
    step = state.step + 1
    c1 = _correction(b1, step)
    c2 = _correction(b2, step)
    b1_, b2_ = _f32(b1, dev), _f32(b2, dev)
    one_b1, one_b2 = _f32(1 - b1, dev), _f32(1 - b2, dev)
    eps_ = _f32(eps, dev)
    for k, p in params.items():
        g = grads[k]
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        g = g.float()
        zd = None if layout is None else layout.zero_dim(k)
        own = p
        if zd is not None:
            g = _zero_block(layout, g, zd)
            own = _zero_block(layout, p, zd)
        # f32 parameters are their own master: p.float() is p itself
        pm = state.master[k] if state.master is not None else own.float()
        m, v = state.m[k], state.v[k]
        m.mul_(b1_).add_(one_b1 * g)
        v.mul_(b2_).add_(one_b2 * torch.square(g))
        pm.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + eps_) + wd * pm))
        if zd is not None:
            from ..launch import partition
            p.copy_(partition.gather_dim(layout.mesh, "data",
                                         pm.to(p.dtype), zd))
        elif state.master is not None:
            p.copy_(pm)
    new_state = AdamWState(m=state.m, v=state.v, master=state.master,
                           step=step)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _zero_block(layout, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This ``data`` rank's ZeRO-1 slice (a view) of a local block."""
    n = layout.mesh.shape["data"]
    size = x.shape[dim] // n
    return x.narrow(dim, layout.mesh.coord["data"] * size, size)


def adamw_init_sharded(params: Params, layout) -> AdamWState:
    """The AdamW state of local blocks ``params`` on ``layout``'s ZeRO-1
    layout: zero moments, and the f32 master of each rank's slice."""
    def block(k, x):
        zd = layout.zero_dim(k)
        return x if zd is None else _zero_block(layout, x, zd)

    m = {k: torch.zeros(block(k, x).shape, dtype=torch.float32,
                        device=x.device) for k, x in params.items()}
    v = {k: torch.zeros_like(t) for k, t in m.items()}
    master = ({k: block(k, x).detach().float().clone()
               for k, x in params.items()}
              if _needs_master(params) else None)
    dev = next(iter(params.values())).device
    return AdamWState(m=m, v=v, master=master,
                      step=torch.zeros((), dtype=torch.int32, device=dev))
