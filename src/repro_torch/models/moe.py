"""Mixture-of-Experts FFN: top-k routing with capacity-bounded scatter
dispatch (dbrx 16 experts top-4, olmoe 64 experts top-8).

Port of ``repro/models/moe.py`` on one device: the scatter path of
``apply`` (``_apply_tokens``, by ``SEQ_CHUNK`` slices of long sequences);
the reference's expert-parallel ``_apply_ep`` needs its device mesh and is
not ported. :class:`MoE` holds the parameters under the reference's keys,
each expert's matrices stacked on a leading expert axis; :func:`apply`
computes from its ``tree()``.

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
  choices are masked out, not written;
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
import torch.nn.functional as F

from .common import Maker, ModelConfig, Params, Tree, sigmoid
from .mlp import gelu_tanh

# Long sequences are routed in slices of this many positions, each with
# its own capacity (the reference's local routing).
SEQ_CHUNK = 512


class MoE(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self._param("router", mk(f"{prefix}.router", (d, e)))
        if cfg.mlp == "swiglu":
            self._param("wg", mk(f"{prefix}.wg", (e, d, f)))
        self._param("wu", mk(f"{prefix}.wu", (e, d, f)))
        self._param("wd", mk(f"{prefix}.wd", (e, f, d)))


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


def combine(picked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k picked[:, k] * w[:, k] over (N, K, d) and (N, K), from zero,
    k = 0 .. K-1, each product and each add rounded to ``picked``'s dtype:
    the reference's ``zeros.at[tok].add(picked * w)`` bit for bit."""
    prod = picked * w[..., None]
    y = torch.zeros_like(prod[:, 0])
    for k in range(prod.shape[1]):
        y = y + prod[:, k]
    return y


def _apply_tokens(p: Tree, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(n, d)
    r = route(p, cfg, xt)
    flat = r.experts.reshape(-1)
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, r.capacity, d), dtype=x.dtype, device=x.device)
    kept = r.keep
    buf.index_put_((flat[kept], r.position[kept]), xt[tok[kept]])
    out = _experts(p, cfg, buf)
    slot = torch.where(kept, r.position, torch.zeros_like(r.position))
    picked = out[flat, slot].reshape(n, k, d)
    w = (r.gate * kept.reshape(n, k)).to(x.dtype)
    y = combine(picked, w)
    top1 = F.one_hot(r.experts[:, 0], e).float()
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
