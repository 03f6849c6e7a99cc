"""Attention: GQA, MQA and MHA, qk-norm, sliding windows with meta tokens,
cross-attention, the ring-buffer KV cache.

Port of ``repro/models/attention.py``. GQA groups the query heads as
(B, S, Kv, G, hd), G = H / Kv; the query head h reads KV head h // G.
:class:`Attention` holds the parameters under the reference's keys;
:func:`attend` (a full sequence) and :func:`decode_step` (one token over
the ring cache) compute from its ``tree()``.

The causal full-sequence path goes through the flash-attention kernel
with ``use_flash=True`` (:mod:`repro_torch.kernels.flash_attention`), as
the reference routes it (``attention.py:251``): causal, self-attention,
no window. Otherwise sequences of ``CHUNKED_THRESHOLD`` or more tokens
take the q-chunked path and shorter ones the whole score matrix.
Cross-attention (``cross_src``, or a precomputed ``cross_cache`` in
decode) reads its keys and values from a source sequence, without rope
and without a causal mask; ``Attention(cross=True)`` adds the tanh
``gate`` (zero at init) of the vision model's cross layers.

The ring cache: slot = position % W, with ``pos`` holding each slot's
position (-1 for an empty slot), so the mask is exact; full attention is
W = max_seq. Unlike the reference, which returns a new cache,
:func:`decode_step` writes the new key and value into the cache in place
and returns it: a new cache would copy every layer's keys and values per
token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .._device import as_device
from ..kernels.flash_attention import ops as flash_ops
from .common import Maker, ModelConfig, Params, Tree, rmsnorm_1d
from .rope import apply_rope, rope_angles

NEG = -1e30
# Sequences at or above this length take the q-chunked path, whose score
# memory is (B, Kv, G, Q_CHUNK, Sk) rather than (B, Kv, G, Sq, Sk).
CHUNKED_THRESHOLD = 2048
Q_CHUNK = 512


class Attention(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        h, kv = cfg.n_heads, cfg.n_kv_heads
        self._param("wq", mk(f"{prefix}.wq", (d, h * hd), ("embed", "heads")))
        self._param("wk", mk(f"{prefix}.wk", (d, kv * hd), ("embed", "kv")))
        self._param("wv", mk(f"{prefix}.wv", (d, kv * hd), ("embed", "kv")))
        self._param("wo", mk(f"{prefix}.wo", (h * hd, d), ("heads", "embed")))
        if cfg.qk_norm:
            self._param("q_norm.scale", mk(f"{prefix}.q_norm.scale", (hd,),
                                           (None,), 1.0))
            self._param("k_norm.scale", mk(f"{prefix}.k_norm.scale", (hd,),
                                           (None,), 1.0))
        if cross:
            # the vision model's tanh gate, zero at init
            self._param("gate", mk(f"{prefix}.gate", (1,), (None,), 0.0))


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def blank_cache(cfg: ModelConfig, batch: int, cache_window: int,
                layers: Optional[int], device) -> Tree:
    """Empty ring cache: ``k`` and ``v`` (B, W, Kv, hd) zeros in the
    activations' dtype, ``pos`` (W,) int32 -1, with a leading layer axis
    when ``layers`` is given."""
    lead = () if layers is None else (layers,)
    shape = lead + (batch, cache_window, cfg.n_kv_heads, cfg.hd)
    act = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=act, device=device),
            "v": torch.zeros(shape, dtype=act, device=device),
            "pos": torch.full(lead + (cache_window,), -1, dtype=torch.int32,
                              device=device)}


def cache_specs(cfg: ModelConfig, mk: Maker, batch: int, cache_window: int,
                layers: Optional[int], name: str = "cache") -> Dict:
    """The reference's ``init_cache``: the ring cache's leaves through a
    maker (shapes with :func:`~.common.shape_maker`, logical axes with
    :func:`~.common.axes_maker`)."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    lead = () if layers is None else (layers,)
    la = () if layers is None else ("layers",)
    kv_axes = la + ("batch", "cache_seq", "kv_head", None)
    return {
        "k": mk(f"{name}.k", lead + (batch, cache_window, kv, hd), kv_axes,
                0.0),
        "v": mk(f"{name}.v", lead + (batch, cache_window, kv, hd), kv_axes,
                0.0),
        "pos": mk(f"{name}.pos", lead + (cache_window,), la + (None,), 0.0,
                  dtype_override=torch.int32),
    }


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------
def _slot(pos, W: int, n_meta: int):
    """Ring slot of a position (an int or an int tensor). Meta tokens are
    pinned in slots [0, n_meta); the others ring over the remaining
    W - n_meta slots, so the meta tokens are never evicted."""
    if n_meta <= 0:
        return pos % W
    if isinstance(pos, torch.Tensor):
        return torch.where(pos < n_meta, pos,
                           n_meta + (pos - n_meta) % (W - n_meta))
    return pos if pos < n_meta else n_meta + (pos - n_meta) % (W - n_meta)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window: int, n_meta: int) -> torch.Tensor:
    """(Sq, Sk) bool validity from integer positions: window 0 is
    unlimited, kv_pos < 0 an empty slot, kv_pos < n_meta always visible.
    (The reference's ``k_pos``: the repo's lint reads ``k_*`` names as
    PRNG keys.)"""
    qp, kp = q_pos[:, None], kv_pos[None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        in_window = kp > qp - window
        if n_meta > 0:
            in_window = in_window | (kp < n_meta)
        ok = ok & in_window
    return ok


def _scores(qg: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
            scale: float) -> torch.Tensor:
    """Softmax probabilities (B, Kv, G, Sq, Sk) in f32 of the grouped
    queries qg (B, Sq, Kv, G, hd) over k (B, Sk, Kv, hd)."""
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    logits = torch.where(mask, logits, torch.full((), NEG,
                                                  device=logits.device))
    return torch.softmax(logits, dim=-1)


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, Sq, Kv, G, hd) f32: the probabilities rounded to v's dtype, as
    the reference rounds them, times v, summed in f32."""
    return torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(),
                        v.float())


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped scaled-dot-product attention. q (B, Sq, H, hd), k and v
    (B, Sk, Kv, hd), mask (Sq, Sk) -> (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    out = _weighted(_scores(qg, k, mask, scale), v)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                  window: int, n_meta: int, scale: float,
                  chunk: int = Q_CHUNK) -> torch.Tensor:
    """The same attention over query chunks of ``chunk`` rows: the score
    memory peaks at (B, Kv, G, chunk, Sk). The reference pads the last
    chunk; a shorter last chunk gives the same rows."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    out = []
    for start in range(0, sq, chunk):
        qb = q[:, start:start + chunk]
        qg = qb.reshape(b, qb.shape[1], kv, h // kv, hd)
        mask = _mask(q_pos[start:start + chunk], kv_pos, causal, window,
                     n_meta)
        ob = _weighted(_scores(qg, k, mask, scale), v)
        out.append(ob.reshape(b, qb.shape[1], h, hd).to(q.dtype))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------
def _project_qkv(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                 kv_src: torch.Tensor, q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, use_rope: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    sk = kv_src.shape[1]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (kv_src @ p["wk"]).reshape(b, sk, kv, hd)
    v = (kv_src @ p["wv"]).reshape(b, sk, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm_1d(p["q_norm.scale"], q, cfg.norm_eps)
        k = rmsnorm_1d(p["k_norm.scale"], k, cfg.norm_eps)
    if use_rope:
        q_angles = rope_angles(q_pos, hd, cfg.rope_theta)
        # self-attention: the reference computes the same table twice
        k_angles = (q_angles if kv_pos is q_pos
                    else rope_angles(kv_pos, hd, cfg.rope_theta))
        q = apply_rope(q, *q_angles)
        k = apply_rope(k, *k_angles)
    return q, k, v


def _out(p: Tree, y: torch.Tensor, product=None) -> torch.Tensor:
    b, s, h, hd = y.shape
    y = y.reshape(b, s, h * hd)
    o = y @ p["wo"] if product is None else product(y, p["wo"])
    if "gate" in p:
        o = torch.tanh(p["gate"].float()).to(o.dtype) * o
    return o


# ---------------------------------------------------------------------------
# Full-sequence attention (train and prefill)
# ---------------------------------------------------------------------------
def attend(p: Tree, cfg: ModelConfig, x: torch.Tensor, *,
           causal: bool = True, window: int = 0, n_meta: int = 0,
           positions: Optional[torch.Tensor] = None,
           cross_src: Optional[torch.Tensor] = None, use_rope: bool = True,
           use_flash: bool = False, make_cache: int = 0, product=None
           ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Attention over x (B, S, d): self-attention, or cross-attention over
    ``cross_src`` (B, S_src, d) (no rope, not causal). ``make_cache`` > 0
    also returns a ring cache of that window holding the last positions
    (prefill). Returns (out, cache or None). ``product(y, wo)`` takes the
    output projection's place where given (a mesh's
    ``Shards.product``)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    if cross_src is not None:
        kv_src = cross_src
        kv_pos = torch.arange(kv_src.shape[1], dtype=torch.int32,
                              device=x.device)
        causal, use_rope = False, False
    else:
        kv_src, kv_pos = x, positions
    q, k, v = _project_qkv(p, cfg, x, kv_src, positions, kv_pos, use_rope)
    scale = 1.0 / cfg.hd ** 0.5
    if use_flash and causal and cross_src is None and window == 0:
        y = flash_ops.flash_attention(q, k, v, causal=True, scale=scale)
    elif s >= CHUNKED_THRESHOLD:
        y = _sdpa_chunked(q, k, v, q_pos=positions, kv_pos=kv_pos,
                          causal=causal, window=window, n_meta=n_meta,
                          scale=scale)
    else:
        y = _sdpa(q, k, v, _mask(positions, kv_pos, causal, window,
                                 n_meta), scale)
    out = _out(p, y, product)
    if not make_cache:
        return out, None
    W = make_cache
    if s <= W:
        keep = torch.arange(s, device=x.device)
    else:   # the meta tokens, and the last W - n_meta positions
        keep = torch.cat([torch.arange(n_meta, device=x.device),
                          torch.arange(s - (W - n_meta), s,
                                       device=x.device)])
    slots = _slot(keep, W, n_meta)
    cache = blank_cache(cfg, b, W, None, x.device)
    cache["k"][:, slots] = k[:, keep].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, keep].to(cache["v"].dtype)
    cache["pos"][slots] = keep.to(torch.int32)
    return out, cache


# ---------------------------------------------------------------------------
# Single-token decode over the ring cache
# ---------------------------------------------------------------------------
def decode_step(p: Tree, cfg: ModelConfig, x: torch.Tensor, cache: Tree,
                index, *, window: int = 0, n_meta: int = 0,
                cross_cache: Optional[Dict] = None, use_rope: bool = True,
                product=None) -> Tuple[torch.Tensor, Tree]:
    """One decode step. x (B, 1, d); ``index`` (a 0-d int32 device tensor,
    or an int made one) the position of this token. Writes its key, value
    and position into ``cache`` in place by tensor-indexed copies, so the
    step reads nothing on the host and can be captured in a CUDA graph
    (a replay reads the index from its device scalar), and returns (out,
    cache). The step writes the slot before it reads it, so calling it
    twice on one cache gives the same bits. With ``cross_cache``
    (``{'k', 'v'}`` (B, S_src, Kv, hd), from :func:`precompute_cross_kv`)
    it attends over the source instead and returns ``cache`` as it
    came."""
    if cross_cache is not None:
        b = x.shape[0]
        q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm_1d(p["q_norm.scale"], q, cfg.norm_eps)
        k, v = cross_cache["k"], cross_cache["v"]
        mask = torch.ones((1, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        return _out(p, _sdpa(q, k, v, mask, 1.0 / cfg.hd ** 0.5),
                    product), cache
    pos = as_device(index, torch.int32, x.device).reshape(1)
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos, use_rope)
    slot = _slot(pos, cache["k"].shape[1], n_meta).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, slot, pos)
    mask = _mask(pos, cache["pos"], True, window, n_meta)
    y = _sdpa(q, cache["k"], cache["v"], mask, 1.0 / cfg.hd ** 0.5)
    return _out(p, y, product), cache


def precompute_cross_kv(p: Tree, cfg: ModelConfig, src: torch.Tensor
                        ) -> Tree:
    """The source's keys and values (B, S_src, Kv, hd) for a
    cross-attention layer's decode steps."""
    b, s, _ = src.shape
    k = (src @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (src @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rmsnorm_1d(p["k_norm.scale"], k, cfg.norm_eps)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# On a mesh (launch/partition.py): the heads over ``model``
# ---------------------------------------------------------------------------
def _local_cfg(cfg: ModelConfig, h: int, kv: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=kv,
                               head_dim=cfg.hd)


def _local_tree(p: Tree, cfg: ModelConfig, sh, split) -> Tree:
    """The weights of a rank's heads (``split``), or the whole layer
    (``split`` None)."""
    hd = cfg.hd
    if split is None:
        return {k: sh.w(v) for k, v in p.items() if k != "gate"}
    out = {"wq": sh.cols(p["wq"], split.q0 * hd, split.q1 * hd),
           "wk": sh.cols(p["wk"], split.k0 * hd, split.k1 * hd),
           "wv": sh.cols(p["wv"], split.k0 * hd, split.k1 * hd),
           "wo": sh.cols(p["wo"], split.q0 * hd, split.q1 * hd, dim=0)}
    for k in ("q_norm.scale", "k_norm.scale"):
        if k in p:
            out[k] = sh.w(p[k], tp=True)
    return out


def _gated(p: Tree, sh, o: torch.Tensor) -> torch.Tensor:
    if "gate" in p:
        o = torch.tanh(sh.w(p["gate"]).float()).to(o.dtype) * o
    return o


def cache_cut(cfg: ModelConfig, sh, window: int):
    """How a ring cache of ``window`` slots is stored on the mesh (the
    serve rules): ``("kv", k0, k1)``, this rank's kv heads; ``("seq", s0,
    s1)``, its slots (the kv heads do not divide ``model``); or
    ``("full",)``."""
    m = sh.m
    if m == 1 or cfg.n_kv_heads % m == 0:
        k0, k1 = sh.chunk(cfg.n_kv_heads)
        return ("kv", k0, k1)
    if window % m == 0:
        return ("seq",) + sh.chunk(window)
    return ("full",)


def attend_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor, sh, *,
                   causal: bool = True, window: int = 0, n_meta: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   cross_src: Optional[torch.Tensor] = None,
                   use_rope: bool = True, use_flash: bool = False,
                   make_cache: int = 0) -> Tuple[torch.Tensor, Optional[Tree]]:
    """:func:`attend` on a mesh (``sh``: the step's
    :class:`~repro_torch.launch.partition.Shards`). The query heads split
    over ``model`` where :func:`partition.head_split` allows (each rank
    attends with its heads, through the flash kernel on its local heads,
    and the output projection's parts are summed in rank order);
    otherwise every rank computes the layer whole from gathered weights.
    ``make_cache`` stores the ring cache as :func:`cache_cut` cuts it."""
    split = sh.head_split(cfg.n_heads, cfg.n_kv_heads)
    lp = _local_tree(p, cfg, sh, split)
    if split is None:
        lcfg, xi, src = cfg, x, cross_src
    else:
        lcfg = _local_cfg(cfg, split.q1 - split.q0, split.k1 - split.k0)
        xi = sh.enter(x)
        src = None if cross_src is None else sh.enter(cross_src)
    out, cache = attend(lp, lcfg, xi, causal=causal, window=window,
                        n_meta=n_meta, positions=positions, cross_src=src,
                        use_rope=use_rope, use_flash=use_flash,
                        make_cache=make_cache,
                        product=None if split is None else sh.product)
    if split is not None:
        out = sh.leave(out, x.dtype)
    out = _gated(p, sh, out)
    if not make_cache:
        return out, None
    cut = cache_cut(cfg, sh, make_cache)
    if cut[0] == "kv" and split is not None:
        return out, cache
    # the cache holds every kv head: project them whole
    b, s, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    k = (x @ sh.w(p["wk"])).reshape(b, s, kv, hd)
    v = (x @ sh.w(p["wv"])).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        k = rmsnorm_1d(sh.w(p["k_norm.scale"]), k, cfg.norm_eps)
    if use_rope:
        k = apply_rope(k, *rope_angles(positions, hd, cfg.rope_theta))
    cache = _ring_cache(cfg, k, v, make_cache, n_meta, x.device)
    if cut[0] == "seq":
        # a copy: with one row a rank the slice is contiguous, and
        # .contiguous() would return it, holding every slot of the ring
        cache = dict(cache, k=cache["k"][:, cut[1]:cut[2]].clone(),
                     v=cache["v"][:, cut[1]:cut[2]].clone())
    return out, cache


def _ring_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, W: int,
                n_meta: int, device) -> Tree:
    """A ring cache of ``W`` slots holding the last positions of k, v
    (B, S, Kv, hd), as :func:`attend` builds it."""
    b, s = k.shape[:2]
    if s <= W:
        keep = torch.arange(s, device=device)
    else:
        keep = torch.cat([torch.arange(n_meta, device=device),
                          torch.arange(s - (W - n_meta), s, device=device)])
    slots = _slot(keep, W, n_meta)
    cache = blank_cache(cfg, b, W, None, device)
    cache["k"][:, slots] = k[:, keep].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, keep].to(cache["v"].dtype)
    cache["pos"][slots] = keep.to(torch.int32)
    return cache


def _merge_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, scale: float, sh) -> torch.Tensor:
    """Softmax attention of q (B, 1, H, hd) over keys cut by slot across
    ``model``: each rank's (max, sum, weighted values) over its slots,
    merged in rank order. Returns (B, 1, H, hd) f32."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    logits = torch.where(mask, logits, torch.full((), NEG,
                                                  device=logits.device))
    mx = logits.amax(-1, keepdim=True)
    pr = torch.where(mask, torch.exp(logits - mx), torch.zeros((),
                                                               device=q.device))
    part = torch.einsum("bkgst,btkh->bskgh", pr, v.float())
    ssum = pr.sum(-1)                                      # (B, Kv, G, Sq)
    from ..launch import partition
    mxs = partition.gather_dim(sh.mesh, "model", mx[None], 0)
    sums = partition.gather_dim(sh.mesh, "model", ssum[None], 0)
    parts = partition.gather_dim(sh.mesh, "model", part[None], 0)
    top = mxs.amax(0)
    num, den = None, None
    for r in range(mxs.shape[0]):
        c = torch.exp(mxs[r] - top)                        # (B, Kv, G, Sq, 1)
        wr = parts[r] * c[..., 0].permute(0, 3, 1, 2)[..., None]
        dr = sums[r] * c[..., 0]
        num = wr if num is None else num + wr
        den = dr if den is None else den + dr
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, hd)


def decode_step_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                        cache: Tree, index, sh, *, window: int = 0,
                        n_meta: int = 0, cross_cache: Optional[Dict] = None,
                        use_rope: bool = True) -> Tuple[torch.Tensor, Tree]:
    """:func:`decode_step` on a mesh, over a cache stored as
    :func:`cache_cut` cuts it: its kv heads (the query heads over
    ``model``, the parts of the output summed in rank order), its slots
    (every head on every rank, each rank's partial softmax over its slots
    merged in rank order) or whole (the layer computed whole).

    ``index`` is read on the card only (a 0-d int32 device tensor, or an
    int made one), as :func:`decode_step` reads it: under the slot cut
    every rank writes its slice at the slot clamped into it, the old
    value where the slot is another rank's, so a cut graph's replay
    writes where the index says."""
    scale = 1.0 / cfg.hd ** 0.5
    if cross_cache is not None:
        b = x.shape[0]
        kv_cut = cfg.n_kv_heads % sh.m == 0
        split = sh.head_split(cfg.n_heads, cfg.n_kv_heads) if kv_cut else None
        lp = _local_tree(p, cfg, sh, split)
        lcfg = cfg if split is None else _local_cfg(
            cfg, split.q1 - split.q0, split.k1 - split.k0)
        q = (x @ lp["wq"]).reshape(b, 1, lcfg.n_heads, cfg.hd)
        if cfg.qk_norm:
            q = rmsnorm_1d(lp["q_norm.scale"], q, cfg.norm_eps)
        k, v = cross_cache["k"], cross_cache["v"]
        mask = torch.ones((1, k.shape[1]), dtype=torch.bool,
                          device=x.device)
        if split is None:
            return _gated(p, sh, _out(lp, _sdpa(q, k, v, mask, scale))), cache
        o = _out(lp, _sdpa(q, k, v, mask, scale), sh.product)
        return _gated(p, sh, sh.leave(o, x.dtype)), cache
    W = cache["pos"].shape[0]
    cut = cache_cut(cfg, sh, W)
    if cut[0] == "kv":
        split = sh.head_split(cfg.n_heads, cfg.n_kv_heads)
        lp = _local_tree(p, cfg, sh, split)
        lcfg = _local_cfg(cfg, split.q1 - split.q0, split.k1 - split.k0)
        o, cache = decode_step(lp, lcfg, x, cache, index, window=window,
                               n_meta=n_meta, use_rope=use_rope,
                               product=sh.product)
        return _gated(p, sh, sh.leave(o, x.dtype)), cache
    pos = as_device(index, torch.int32, x.device).reshape(1)
    slot = _slot(pos, W, n_meta).long()
    lp = _local_tree(p, cfg, sh, None)
    q, k_new, v_new = _project_qkv(lp, cfg, x, x, pos, pos, use_rope)
    cache["pos"].index_copy_(0, slot, pos)
    if cut[0] == "full":
        cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
        mask = _mask(pos, cache["pos"], True, window, n_meta)
        y = _sdpa(q, cache["k"], cache["v"], mask, scale)
        return _gated(p, sh, _out(lp, y)), cache
    s0, s1 = cut[1], cut[2]
    local = slot - s0
    mine = (local >= 0) & (local < s1 - s0)
    at = local.clamp(0, s1 - s0 - 1)
    for name, new in (("k", k_new), ("v", v_new)):
        old = cache[name].index_select(1, at)
        cache[name].index_copy_(1, at, torch.where(
            mine, new.to(cache[name].dtype), old))
    mask = _mask(pos, cache["pos"][s0:s1], True, window, n_meta)
    y = _merge_partial(q, cache["k"], cache["v"], mask, scale, sh)
    return _gated(p, sh, _out(lp, y.to(q.dtype))), cache


def cross_kv_sharded(p: Tree, cfg: ModelConfig, src: torch.Tensor, sh
                     ) -> Tree:
    """:func:`precompute_cross_kv` as the mesh stores it: this rank's kv
    heads where they divide ``model``, else every head."""
    if cfg.n_kv_heads % sh.m == 0:
        k0, k1 = sh.chunk(cfg.n_kv_heads)
        hd = cfg.hd
        lp = {"wk": sh.cols(p["wk"], k0 * hd, k1 * hd),
              "wv": sh.cols(p["wv"], k0 * hd, k1 * hd)}
        lcfg = _local_cfg(cfg, k1 - k0, k1 - k0)
    else:
        lp = {"wk": sh.w(p["wk"]), "wv": sh.w(p["wv"])}
        lcfg = cfg
    if "k_norm.scale" in p:
        lp["k_norm.scale"] = sh.w(p["k_norm.scale"])
    return precompute_cross_kv(lp, lcfg, src)
