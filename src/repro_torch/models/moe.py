"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter
dispatch (dbrx 16 experts top-4, olmoe 64 experts top-8).

Port of ``repro/models/moe.py``: on one device the scatter path of
``apply`` (``_apply_tokens``, by ``SEQ_CHUNK`` slices of long sequences);
on a mesh :func:`apply_sharded`, the reference's expert-parallel
``_apply_ep`` where ``USE_EP`` and the mesh allow it (:func:`ep_applies`),
else the scatter path on the gathered rows. :class:`MoE` holds the
parameters under the reference's keys, each expert's matrices stacked on
a leading expert axis; :func:`apply` computes from its ``tree()``.

Where the reference's bits come from, step by step:

- the router's logits ``xt @ router`` in the activations' dtype, then
  f32, then the f32 softmax;
- the top-k of the probabilities as ``lax.top_k`` takes it, the lowest
  expert first among ties: a stable descending sort (``torch.topk``
  promises no order among ties);
- each choice's position in its expert: an exclusive int32 cumsum over
  the flattened (N * K) choices in token-major order (token n's k-th
  choice is n * K + k), so the same choices overflow the capacity C and
  drop;
- the dispatch into the (E, C, d) buffer: each (e, c) slot takes at most
  one token, so an ``index_put_`` without accumulation is exact; dropped
  choices go to a spare expert row that is cut off (:func:`dispatch`: no
  shape depends on the data, so the dry run traces it);
- the experts: batched products over the stacked buffer, as the
  reference's einsums;
- the combine: each token's K outputs scaled by ``(gate * keep)`` in the
  activations' dtype and summed k = 0 .. K-1 from zero, rounded to that
  dtype after every add, which is what the reference's ``y.at[tok].add``
  gives (an ``index_add_`` on the card adds in no fixed order).

:func:`recording` collects each call's :class:`Routing` (the chip check
compares routings between routes and devices).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from .common import Maker, ModelConfig, Params, Tree, sigmoid
from .mlp import gelu_tanh

# Long sequences are routed in slices of this many positions, each with
# its own capacity (the reference's local routing).
SEQ_CHUNK = 512


class MoE(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self._param("router", mk(f"{prefix}.router", (d, e),
                                 ("embed", None)))
        if cfg.mlp == "swiglu":
            self._param("wg", mk(f"{prefix}.wg", (e, d, f),
                                 ("experts", "embed", None)))
        self._param("wu", mk(f"{prefix}.wu", (e, d, f),
                             ("experts", "embed", None)))
        self._param("wd", mk(f"{prefix}.wd", (e, f, d),
                             ("experts", None, "embed")))


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the capacity factor's
    share, rounded up to 8, at least 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One slice's routing: ``logits`` and ``probs`` (N, E) f32, ``gate``
    (N, K) f32 renormalised, ``experts`` (N, K) int64, ``position``
    (N * K,) int64 in the expert, ``keep`` (N * K,) bool, ``capacity``."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    experts: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    capacity: int


_RECORD: Optional[List[Routing]] = None


@contextlib.contextmanager
def recording() -> Iterator[List[Routing]]:
    """Collect the :class:`Routing` of every slice routed inside the block,
    in call order (layer by layer, slice by slice)."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def route(p: Tree, cfg: ModelConfig, xt: torch.Tensor) -> Routing:
    """Route the tokens ``xt`` (N, d)."""
    n = xt.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    c = capacity(cfg, n)
    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: largest first, the lowest index first among ties
    gate, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, experts = gate[:, :k], experts[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    flat = experts.reshape(-1)
    # (E, N * K) one-hot in int32, its cumsum along the choices (a scan
    # of contiguous rows: along dim 0 of the (N * K, E) layout an H100
    # took 3 ms a call at olmoe's 16,384 choices); a choice's inclusive
    # count less its own one is its exclusive position
    choice = torch.arange(flat.shape[0], device=xt.device)
    onehot = (flat[None, :] == torch.arange(e, device=xt.device)[:, None]
              ).to(torch.int32)
    position = torch.cumsum(onehot, dim=1, dtype=torch.int32)[
        flat, choice].long() - 1
    keep = position < c
    r = Routing(logits, probs, gate, experts, position, keep, c)
    if _RECORD is not None:
        _RECORD.append(r)
    return r


def _experts(p: Tree, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """The stacked expert FFNs over (E, C, d) -> (E, C, d)."""
    if cfg.mlp == "swiglu":
        g = torch.bmm(buf, p["wg"])
        h = g * sigmoid(g) * torch.bmm(buf, p["wu"])
    else:
        h = gelu_tanh(torch.bmm(buf, p["wu"]))
    return torch.bmm(h, p["wd"])


def dispatch(xt: torch.Tensor, experts: torch.Tensor,
             position: torch.Tensor, keep: torch.Tensor, n_experts: int,
             capacity: int) -> torch.Tensor:
    """The (E, C, d) buffer of the kept choices: choice i (token i // K)
    at (experts[i], position[i]); the dropped ones are written to a spare
    row E, cut off."""
    k = experts.shape[0] // xt.shape[0]
    tok = torch.arange(xt.shape[0], device=xt.device).repeat_interleave(k)
    e = torch.where(keep, experts, torch.full_like(experts, n_experts))
    c = torch.where(keep, position, torch.zeros_like(position))
    buf = torch.zeros((n_experts + 1, capacity, xt.shape[1]),
                      dtype=xt.dtype, device=xt.device)
    buf.index_put_((e, c), xt[tok])
    return buf[:n_experts]


def combine(picked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k picked[:, k] * w[:, k] over (N, K, d) and (N, K), from zero,
    k = 0 .. K-1, each product and each add rounded to ``picked``'s dtype:
    the reference's ``zeros.at[tok].add(picked * w)`` bit for bit."""
    prod = picked * w[..., None]
    y = torch.zeros_like(prod[:, 0])
    for k in range(prod.shape[1]):
        y = y + prod[:, k]
    return y


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n).float()`` by a compare with ``arange(n)``: the
    same values, and no host read (off the card ``one_hot`` reads the
    indices' min and max on the host to check them)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _apply_tokens(p: Tree, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(n, d)
    r = route(p, cfg, xt)
    flat = r.experts.reshape(-1)
    kept = r.keep
    out = _experts(p, cfg, dispatch(xt, flat, r.position, kept, e,
                                    r.capacity))
    slot = torch.where(kept, r.position, torch.zeros_like(r.position))
    picked = out[flat, slot].reshape(n, k, d)
    w = (r.gate * kept.reshape(n, k)).to(x.dtype)
    y = combine(picked, w)
    top1 = _one_hot(r.experts[:, 0], e)
    aux = {
        "load_balance": e * torch.sum(r.probs.mean(0) * top1.mean(0)),
        "router_z": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - kept.float().mean(),
    }
    return y.reshape(b, s, d), aux


def apply(p: Tree, cfg: ModelConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (B, S, d) and the aux losses. Sequences longer than
    ``SEQ_CHUNK`` (and a multiple of it) are routed slice by slice, each
    with its own capacity; the aux terms are then the slices' mean."""
    b, s, d = x.shape
    if s > SEQ_CHUNK and s % SEQ_CHUNK == 0:
        ys, auxs = zip(*(_apply_tokens(p, cfg, x[:, i:i + SEQ_CHUNK])
                         for i in range(0, s, SEQ_CHUNK)))
        aux = {key: torch.stack([a[key] for a in auxs]).mean()
               for key in auxs[0]}
        return torch.cat(ys, dim=1), aux
    return _apply_tokens(p, cfg, x)


# ---------------------------------------------------------------------------
# On a mesh: expert parallelism (the reference's USE_EP / _apply_ep)
# ---------------------------------------------------------------------------
# Take the expert-parallel path on (data, model) meshes, as the
# reference's USE_EP.
USE_EP = True


def ep_applies(cfg: ModelConfig, sh, global_batch: int) -> bool:
    """The reference's test: a mesh with ``data`` and ``model``, the
    experts dividing ``model``, the global batch dividing ``data``."""
    mesh = sh.mesh
    return (USE_EP and {"data", "model"} <= set(mesh.axis_names)
            and cfg.n_experts % mesh.shape["model"] == 0
            and global_batch % mesh.shape["data"] == 0)


def _ep_local(p: Tree, cfg: ModelConfig, x: torch.Tensor, sh, tp: bool
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One rank's part of the expert-parallel layer: its tokens routed
    (replicated over ``model``), dispatched to its ``E / model`` local
    experts only, with the capacity of its own token count; the combine
    of its experts' outputs (zeros for the others)."""
    mesh = sh.mesh
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    m = mesh.shape["model"]
    el = e // m
    e0 = mesh.coord["model"] * el
    xt = x.reshape(n, d)
    r = route({"router": sh.w(p["router"], tp=tp)}, cfg, xt)
    flat = r.experts.reshape(-1)
    local = flat - e0
    mine = (local >= 0) & (local < el)
    keep = mine & r.keep
    buf = dispatch(xt, local, r.position, keep, el, r.capacity)
    wl = {name: sh.w(p[name], (0, e0, e0 + el), tp=tp)
          for name in ("wg", "wu", "wd") if name in p}
    out = _experts(wl, cfg, buf)
    slot = torch.where(keep, r.position, torch.zeros_like(r.position))
    picked = out[torch.where(keep, local, torch.zeros_like(local)),
                 slot].reshape(n, k, d)
    w = (r.gate * keep.reshape(n, k)).to(x.dtype)
    y = combine(picked, w)
    from ..launch import partition
    kept = partition.sum_axes(mesh, ("model",),
                              keep.sum().to(torch.int32)[None])[0]
    top1 = _one_hot(r.experts[:, 0], e)
    aux = {
        "load_balance": e * torch.sum(r.probs.mean(0) * top1.mean(0)),
        "router_z": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "dropped_frac": 1.0 - kept.float() / (n * k),
    }
    return y.reshape(b, s, d), aux


def apply_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor, sh
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`apply` on a mesh.

    Expert parallelism where :func:`ep_applies` (the reference's
    ``_apply_ep``): each rank routes its data shard's tokens and runs
    only its local experts, and ``y`` is summed over ``model`` in rank
    order. The aux terms are the rank's own: the reference's shard_map
    returns them unreduced as if replicated, so its gradient of them is
    their mean over the mesh's devices, which each rank's share
    (``1 / |mesh|`` of its own) sums to; ``dropped_frac`` counts every
    rank's kept choices. Under ``train_dp`` the rows are first gathered
    over ``model`` (the reference's shard_map cuts its input over
    ``data`` alone) and each rank keeps its own rows of the sum.

    Otherwise the scatter path of :func:`apply` on the global batch (the
    rows gathered over the batch's axes, every rank computing every
    expert) and each rank keeps its rows; the aux terms, global, count
    once in the gradient."""
    from ..launch import partition
    n_rows = sh.batch_count()
    if ep_applies(cfg, sh, x.shape[0] * n_rows):
        share = 1.0 / sh.mesh.size
        if sh.tp:
            y, aux = _ep_local(p, cfg, sh.enter(x), sh, tp=True)
            y = sh.leave(y)
        else:
            y, aux = _ep_local(p, cfg, sh.gather_rows(x, ("model",)), sh,
                               tp=False)
            y = sh.sum_own_rows(y, ("model",))
        return y, {k: partition.scale_grad(v, share) for k, v in aux.items()}
    full = {k: sh.w(v) for k, v in p.items()}
    if n_rows == 1:
        return apply(full, cfg, x)
    y, aux = apply(full, cfg, sh.gather_rows(x, sh.batch_axes))
    y = partition.own_rows(sh.mesh, sh.batch_axes, y)
    return y, {k: partition.scale_grad(v, 1.0 / n_rows)
               for k, v in aux.items()}
