"""Layer-stack assembly: the block plan, its parameters, caches and
application.

Port of ``repro/models/transformer.py``. A model is a *plan*: a list of
:class:`Segment`s, each ``n`` repeats of a *pattern* of :class:`BlockCfg`
(one block, or the vision model's superblock of self-attention blocks
and a gated cross-attention block). Mixers: ``attn`` (causal
self-attention, window and meta tokens static per segment), ``bidir``
(the encoder's), ``cross`` (gated cross-attention over a source),
``rwkv`` (RWKV6 TimeMix) and ``hybrid`` (hymba's attention and SSM heads
in parallel); FFNs: ``mlp``, ``moe`` and ``rwkv_cm``; an encoder-decoder
block (``has_cross``) adds cross-attention between its mixer and its FFN.
Every block is pre-norm residual; an MoE block also returns its
router's auxiliary losses (the reference's other blocks return zeros,
which add nothing to the sum).

Parameters are one :class:`Block` per layer (the reference stacks them on
a leading ``layers`` axis and scans); caches keep the reference's stacked
layout, per segment a tuple (one entry per pattern position) of dicts of
(L, ...) tensors, ``None`` at cross positions (their keys and values are
the model's ``cross_kvs``). :func:`plan_apply` is a loop over the layers
(no scan); in train mode it recomputes each layer's activations in the
backward pass (``remat_mode="layer"``, the reference's ``remat=True``) or
also groups of layers (``"nested"``), through ``torch.utils.checkpoint``.
``mode`` is train | prefill | decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention, mlp, moe, rwkv, ssm
from .common import (Maker, ModelConfig, fma, norm_param, param, rmsnorm,
                     rmsnorm_1d)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    mixer: str = "attn"        # attn | bidir | cross | rwkv | hybrid
    window: int = 0            # sliding window (0 = full)
    ffn: str = "mlp"           # mlp | moe | rwkv_cm
    has_cross: bool = False    # enc-dec decoder block
    use_rope: bool = True


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[BlockCfg, ...]
    n: int


# the auxiliary losses a block returns (the MoE router's)
AUX_KEYS = ("load_balance", "router_z", "dropped_frac")
REMAT_MODES = ("none", "layer", "nested")


def make_plan(cfg: ModelConfig) -> List[Segment]:
    """Decoder (or backbone) plan for the configured family."""
    if cfg.family == "ssm":
        return [Segment((BlockCfg(mixer="rwkv", ffn="rwkv_cm"),),
                        cfg.n_layers)]
    ffn = "moe" if cfg.is_moe else "mlp"
    if cfg.family == "hybrid":
        # one segment per run of layers with the same window
        segs: List[Segment] = []
        i = 0
        while i < cfg.n_layers:
            w = cfg.window_for_layer(i)
            j = i
            while j < cfg.n_layers and cfg.window_for_layer(j) == w:
                j += 1
            segs.append(Segment((BlockCfg(mixer="hybrid", window=w,
                                          ffn=ffn),), j - i))
            i = j
        return segs
    if cfg.family == "vlm" and cfg.cross_attn_every:
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"{cfg.n_layers} layers do not divide into "
                             f"superblocks of {k}")
        pattern = tuple([BlockCfg(mixer="attn", ffn=ffn)] * (k - 1)
                        + [BlockCfg(mixer="cross", ffn=ffn)])
        return [Segment(pattern, cfg.n_layers // k)]
    if cfg.family == "encdec":
        return [Segment((BlockCfg(mixer="attn", ffn=ffn, has_cross=True),),
                        cfg.n_layers)]
    return [Segment((BlockCfg(mixer="attn", ffn=ffn,
                              window=cfg.sliding_window),), cfg.n_layers)]


def make_encoder_plan(cfg: ModelConfig) -> List[Segment]:
    ffn = "moe" if cfg.is_moe else "mlp"
    return [Segment((BlockCfg(mixer="bidir", ffn=ffn, use_rope=True),),
                    cfg.n_encoder_layers)]


def plan_layers(plan: List[Segment]) -> int:
    return sum(len(s.pattern) * s.n for s in plan)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Hybrid(nn.Module):
    """hymba's mixer: attention and SSM heads over the same input, the
    attention output normalised, the two averaged with weights ``beta``."""

    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        self.attn = attention.Attention(cfg, mk, f"{prefix}.attn")
        self.ssm = ssm.SSM(cfg, mk, f"{prefix}.ssm")
        self.attn_norm = param(mk(f"{prefix}.attn_norm.scale",
                                  (cfg.d_model,), ("embed",), 1.0))
        self.beta = param(mk(f"{prefix}.beta", (2,), (None,), 1.0))

    def tree(self) -> Dict[str, Any]:
        return {"attn": self.attn.tree(), "ssm": self.ssm.tree(),
                "attn_norm.scale": self.attn_norm, "beta": self.beta}


class Block(nn.Module):
    """The parameters of one pre-norm residual block (ln1, mixer, the
    cross-attention of an encoder-decoder block, ln2, ffn);
    :func:`block_apply` computes it from :meth:`tree`."""

    def __init__(self, cfg: ModelConfig, bc: BlockCfg, mk: Maker,
                 prefix: str):
        super().__init__()
        d = cfg.d_model
        self.ln1 = norm_param(mk, f"{prefix}.ln1", d)
        if bc.mixer in ("attn", "bidir"):
            self.mixer = attention.Attention(cfg, mk, f"{prefix}.attn")
        elif bc.mixer == "cross":
            self.mixer = attention.Attention(cfg, mk, f"{prefix}.xattn",
                                             cross=True)
        elif bc.mixer == "rwkv":
            self.mixer = rwkv.TimeMix(cfg, mk, f"{prefix}.tm")
        elif bc.mixer == "hybrid":
            self.mixer = Hybrid(cfg, mk, prefix)
        else:
            raise ValueError(bc.mixer)
        if bc.has_cross:
            self.ln_cross = norm_param(mk, f"{prefix}.ln_cross", d)
            self.cross = attention.Attention(cfg, mk, f"{prefix}.cross")
        self.ln2 = norm_param(mk, f"{prefix}.ln2", d)
        if bc.ffn == "mlp":
            self.ffn = mlp.MLP(cfg, mk, f"{prefix}.mlp")
        elif bc.ffn == "moe":
            self.ffn = moe.MoE(cfg, mk, f"{prefix}.moe")
        elif bc.ffn == "rwkv_cm":
            self.ffn = rwkv.ChannelMix(cfg, mk, f"{prefix}.cm")
        else:
            raise ValueError(bc.ffn)

    def tree(self) -> Dict[str, Any]:
        """The parameters under the reference's keys."""
        t = {"ln1": {"scale": self.ln1}, "mixer": self.mixer.tree(),
             "ln2": {"scale": self.ln2}, "ffn": self.ffn.tree()}
        if hasattr(self, "cross"):
            t["ln_cross"] = {"scale": self.ln_cross}
            t["cross"] = self.cross.tree()
        return t


def plan_params(cfg: ModelConfig, plan: List[Segment], mk: Maker,
                prefix: str) -> nn.ModuleList:
    """Per segment, per layer, per pattern position: a :class:`Block`."""
    return nn.ModuleList(
        nn.ModuleList(
            nn.ModuleList(Block(cfg, bc, mk, f"{prefix}.seg{i}.pos{j}")
                          for j, bc in enumerate(seg.pattern))
            for _ in range(seg.n))
        for i, seg in enumerate(plan))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def _cache_window(bc: BlockCfg, cfg: ModelConfig, max_seq: int) -> int:
    if bc.window > 0:
        return min(bc.window + cfg.n_meta_tokens, max_seq)
    return max_seq


def blank_plan_cache(cfg: ModelConfig, plan: List[Segment], batch: int,
                     max_seq: int, device) -> List[Tuple[Any, ...]]:
    """Decode caches mirroring the plan (stacked per segment): ring caches
    of ``max_seq`` slots (or the window and the meta tokens) for
    attention, the recurrent state for RWKV and the SSM, None for
    cross-attention."""
    out = []
    for seg in plan:
        caches = []
        for bc in seg.pattern:
            if bc.mixer in ("attn", "bidir"):
                c = attention.blank_cache(
                    cfg, batch, _cache_window(bc, cfg, max_seq), seg.n,
                    device)
            elif bc.mixer == "cross":
                c = None
            elif bc.mixer == "rwkv":
                c = rwkv.blank_state(cfg, batch, seg.n, device)
            elif bc.mixer == "hybrid":
                c = {"attn": attention.blank_cache(
                        cfg, batch, _cache_window(bc, cfg, max_seq), seg.n,
                        device),
                     "ssm": ssm.blank_state(cfg, batch, seg.n, device)}
            else:
                raise ValueError(bc.mixer)
            caches.append(c)
        out.append(tuple(caches))
    return out


def plan_cache_specs(cfg: ModelConfig, plan: List[Segment], mk: Maker,
                     batch: int, max_seq: int, name: str = "cache"
                     ) -> List[Tuple[Any, ...]]:
    """:func:`blank_plan_cache`'s leaves through a maker (the reference's
    ``plan_cache_specs``)."""
    out = []
    for i, seg in enumerate(plan):
        caches = []
        for j, bc in enumerate(seg.pattern):
            nm = f"{name}.seg{i}.pos{j}"
            if bc.mixer in ("attn", "bidir"):
                c = attention.cache_specs(
                    cfg, mk, batch, _cache_window(bc, cfg, max_seq), seg.n,
                    nm)
            elif bc.mixer == "cross":
                c = None
            elif bc.mixer == "rwkv":
                c = rwkv.state_specs(cfg, mk, batch, seg.n, nm)
            elif bc.mixer == "hybrid":
                c = {"attn": attention.cache_specs(
                        cfg, mk, batch, _cache_window(bc, cfg, max_seq),
                        seg.n, nm + ".attn"),
                     "ssm": ssm.state_specs(cfg, mk, batch, seg.n,
                                            nm + ".ssm")}
            else:
                raise ValueError(bc.mixer)
            caches.append(c)
        out.append(tuple(caches))
    return out


def _layer_of(tree: Any, layer: int) -> Any:
    """One layer's slice (views) of a stacked cache tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer_of(v, layer) for k, v in tree.items()}
    return tree[layer]


def _restack(layers: List[Any], before: Any) -> Any:
    """The layers' caches stacked again. A ring cache (a dict with
    ``pos``) that decode wrote in place is ``before`` itself."""
    first = layers[0]
    if first is None:
        return None
    if isinstance(first, dict):
        if before is not None and "pos" in first:
            return before
        return {k: _restack([c[k] for c in layers],
                            None if before is None else before[k])
                for k in first}
    return torch.stack(layers)


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------
def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _self_attention(p, cfg, bc, h, mode, cache, index, positions,
                    use_flash, cache_len, causal=True):
    n_meta = cfg.n_meta_tokens if bc.window > 0 else 0
    if mode == "decode":
        return attention.decode_step(p, cfg, h, cache, index,
                                     window=bc.window, n_meta=n_meta,
                                     use_rope=bc.use_rope)
    return attention.attend(
        p, cfg, h, causal=causal, window=bc.window, n_meta=n_meta,
        positions=positions, use_rope=bc.use_rope, use_flash=use_flash,
        make_cache=_cache_window(bc, cfg, cache_len or h.shape[1])
        if mode == "prefill" and causal else 0)


def _cross_attention(p, cfg, h, mode, index, cross_src, cross_kv):
    if mode == "decode":
        return attention.decode_step(p, cfg, h, None, index,
                                     cross_cache=cross_kv)[0]
    return attention.attend(p, cfg, h, cross_src=cross_src)[0]


def block_apply(bc: BlockCfg, cfg: ModelConfig, p: Dict[str, Any],
                x: torch.Tensor, *, mode: str, cache: Any = None,
                index=None, cross_src: Optional[torch.Tensor] = None,
                cross_kv: Optional[Dict] = None,
                positions: Optional[torch.Tensor] = None,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                cache_len: Optional[int] = None, sh=None, cache_spec=None
                ) -> Tuple[torch.Tensor, Any,
                           Optional[Dict[str, torch.Tensor]]]:
    """Apply one block given its parameter tree. Returns (x, new_cache,
    aux): the router's aux terms of an MoE block, None for the others.

    Attention: decode steps over the ring cache ``cache`` at position
    ``index`` (updating it in place); train and prefill attend over the
    sequence at ``positions``, through the flash kernel when
    ``use_flash`` (causal self-attention without a window only, as the
    reference routes it), and prefill builds a ring cache of
    ``cache_len`` slots (by default the prompt length). Cross-attention
    reads ``cross_src`` (train, prefill) or the layer's ``cross_kv``
    (decode). RWKV: decode runs the time mix one step in plain PyTorch,
    as the reference does; train and prefill start from ``cache`` or a
    blank state and take the kernel when ``use_rwkv_kernel``. The SSM
    heads scan the sequence from ``cache`` or zero, or step once.

    On a mesh (``sh``, the step's
    :class:`~repro_torch.launch.partition.Shards`; ``cache_spec``, the
    layer's cache specs) :func:`block_apply_sharded` computes it."""
    if sh is not None:
        return block_apply_sharded(
            bc, cfg, p, x, sh, mode=mode, cache=cache, index=index,
            cross_src=cross_src, cross_kv=cross_kv, positions=positions,
            use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
            cache_len=cache_len, cache_spec=cache_spec)
    aux = None
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    new_cache = cache
    if bc.mixer in ("attn", "bidir"):
        o, new_cache = _self_attention(p["mixer"], cfg, bc, h, mode, cache,
                                       index, positions, use_flash,
                                       cache_len, causal=bc.mixer == "attn")
    elif bc.mixer == "cross":
        o = _cross_attention(p["mixer"], cfg, h, mode, index, cross_src,
                             cross_kv)
    elif bc.mixer == "rwkv":
        if mode == "decode":
            o, new_cache = rwkv.tm_apply(p["mixer"], cfg, h, cache,
                                         use_kernel=False)
        else:
            state = cache if cache is not None else rwkv.blank_state(
                cfg, h.shape[0], None, h.device)
            o, new_cache = rwkv.tm_apply(p["mixer"], cfg, h, state,
                                         use_kernel=use_rwkv_kernel)
    elif bc.mixer == "hybrid":
        pm = p["mixer"]
        oa, ca = _self_attention(pm["attn"], cfg, bc, h, mode,
                                 None if cache is None else cache["attn"],
                                 index, positions, use_flash, cache_len)
        if mode == "decode":
            os_, cs = ssm.apply_step(pm["ssm"], cfg, h, cache["ssm"])
        else:
            st = cache["ssm"] if cache is not None else ssm.blank_state(
                cfg, h.shape[0], None, h.device)
            os_, cs = ssm.apply_seq(pm["ssm"], cfg, h, st)
        oa = rmsnorm_1d(pm["attn_norm.scale"], oa, cfg.norm_eps)
        beta = pm["beta"].float()
        # in f32, the first product's add fused as the compiled reference
        # fuses it
        oaf, osf = oa.float(), os_.float()
        o = (fma(beta[0].expand_as(oaf), oaf, beta[1] * osf) * 0.5).to(
            x.dtype)
        new_cache = {"attn": ca, "ssm": cs}
    else:
        raise ValueError(bc.mixer)
    x = x + o
    if bc.has_cross:
        h = rmsnorm(p["ln_cross"]["scale"], x, cfg.norm_eps)
        x = x + _cross_attention(p["cross"], cfg, h, mode, index, cross_src,
                                 cross_kv)
    h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
    if bc.ffn == "mlp":
        o = mlp.apply(p["ffn"], cfg, h)
    elif bc.ffn == "moe":
        o, aux = moe.apply(p["ffn"], cfg, h)
    else:
        o, new_cache = rwkv.cm_apply(p["ffn"], cfg, h, new_cache)
    return x + o, new_cache, aux


def _add_aux(total: Dict[str, torch.Tensor],
             aux: Optional[Dict[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
    """The running sum of the blocks' aux terms (a block without a router
    adds the reference's zeros: nothing)."""
    if aux is None:
        return total
    return {k: total[k] + aux[k] for k in AUX_KEYS}


def _nested_group(n: int) -> int:
    """Group size for two-level remat: the divisor of n nearest sqrt(n)
    (1 below 16 layers). Live activation boundaries go from n to about
    2 sqrt(n) at the cost of one more forward recompute per group."""
    if n < 16:
        return 1
    target = max(int(n ** 0.5), 2)
    for delta in range(target):
        for g in (target - delta, target + delta):
            if 1 < g < n and n % g == 0:
                return g
    return 1


def _train_layers(cfg: ModelConfig, seg: Segment, layers, x: torch.Tensor,
                  aux: Dict[str, torch.Tensor], positions, cross_src,
                  use_flash: bool, use_rwkv_kernel: bool, remat: bool,
                  sh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``x`` through ``layers`` (each a list of the pattern's parameter
    trees) in train mode, the aux terms added to ``aux``, each layer
    recomputed in the backward pass when ``remat``. The trees are read
    before the call, so a recompute uses the tensors of this forward pass
    (those of ``torch.func.functional_call``, say) and never reads the
    module again."""
    def layer_fn(h, aux, trees):
        for bc, p in zip(seg.pattern, trees):
            h, _, a = block_apply(bc, cfg, p, h, mode="train",
                                  positions=positions, cross_src=cross_src,
                                  use_flash=use_flash,
                                  use_rwkv_kernel=use_rwkv_kernel, sh=sh)
            aux = _add_aux(aux, a)
        return h, aux

    for trees in layers:
        if remat:
            x, aux = checkpoint(layer_fn, x, aux, trees, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = layer_fn(x, aux, trees)
    return x, aux


def plan_apply(cfg: ModelConfig, plan: List[Segment], segments: nn.ModuleList,
               x: torch.Tensor, *, mode: str,
               caches: Optional[List] = None, index=None,
               cross_src: Optional[torch.Tensor] = None,
               cross_kvs: Optional[List] = None,
               positions: Optional[torch.Tensor] = None,
               use_flash: bool = False, use_rwkv_kernel: bool = False,
               cache_len: Optional[int] = None, remat_mode: str = "layer",
               sh=None) -> Tuple[torch.Tensor, Optional[List],
                          Dict[str, torch.Tensor]]:
    """Run x through every layer. Returns (x, new caches, summed aux): the
    caches in decode and prefill, None in train. In decode the attention
    caches are updated in place and returned as they came. ``cross_kvs``
    (decode) mirrors the plan: per segment and position the stacked
    source keys and values of a cross layer, None elsewhere.
    ``remat_mode`` (train, under autograd only): ``"layer"`` recomputes
    each layer in the backward pass, ``"nested"`` also each group of
    :func:`_nested_group` layers (the group's boundaries alone are kept
    between the passes), ``"none"`` keeps every activation. ``sh``: the
    step's layout on a mesh (its ``cache_specs``, the caches' specs in
    their stacked layout), or None on one device."""
    if remat_mode not in REMAT_MODES:
        raise ValueError(f"remat_mode {remat_mode!r} is not one of "
                         f"{REMAT_MODES}")
    aux = _zero_aux(x.device)
    new_caches: List = []
    for si, seg in enumerate(plan):
        if mode == "train":
            layers = [[b.tree() for b in layer] for layer in segments[si]]
            remat = remat_mode != "none" and torch.is_grad_enabled()
            G = _nested_group(seg.n) if remat and remat_mode == "nested" \
                else 1
            for g0 in range(0, seg.n, G):
                args = (cfg, seg, layers[g0:g0 + G], x, aux, positions,
                        cross_src, use_flash, use_rwkv_kernel, remat, sh)
                x, aux = (_train_layers(*args) if G == 1 else checkpoint(
                    _train_layers, *args, use_reentrant=False,
                    preserve_rng_state=False))
            continue
        per_pos: List[List[Any]] = [[] for _ in seg.pattern]
        for layer in range(seg.n):
            for j, bc in enumerate(seg.pattern):
                cache = None if caches is None else _layer_of(caches[si][j],
                                                              layer)
                xkv = None if cross_kvs is None else _layer_of(
                    cross_kvs[si][j], layer)
                cspec = None
                if sh is not None and sh.cache_specs is not None:
                    cspec = _unstacked(sh.cache_specs[si][j])
                x, cache, a = block_apply(
                    bc, cfg, segments[si][layer][j].tree(), x, mode=mode,
                    cache=cache, index=index, cross_src=cross_src,
                    cross_kv=xkv, positions=positions, use_flash=use_flash,
                    use_rwkv_kernel=use_rwkv_kernel, cache_len=cache_len,
                    sh=sh, cache_spec=cspec)
                aux = _add_aux(aux, a)
                per_pos[j].append(cache)
        new_caches.append(tuple(
            _restack(layers, caches[si][j] if mode == "decode" else None)
            for j, layers in enumerate(per_pos)))
    return x, (new_caches if mode != "train" else None), aux


# ---------------------------------------------------------------------------
# On a mesh (launch/partition.py)
# ---------------------------------------------------------------------------
def _unstacked(spec_tree: Any) -> Any:
    """A stacked cache's specs less their leading ``layers`` entry."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: _unstacked(v) for k, v in spec_tree.items()}
    return tuple(spec_tree[1:])


def _state_view(sh, state: Dict[str, torch.Tensor], spec, keep=()):
    """A recurrent state from its stored blocks to the compute's layout:
    every stored cut gathered but the batch's (dim 0) and those of
    ``keep`` (``{key: dim}``, a rank's own heads)."""
    from ..launch import partition
    out = {}
    for k, x in state.items():
        for i, e in enumerate(spec[k]):
            if i > 0 and e is not None and dict(keep).get(k) != i:
                x = partition.gather_dim(sh.mesh, e, x, i)
        out[k] = x
    return out


def _state_store(sh, state: Dict[str, torch.Tensor], spec, keep=()):
    """:func:`_state_view`'s inverse: each rank's stored blocks."""
    from ..launch import partition
    out = {}
    for k, x in state.items():
        sl = list(partition.region(x.shape, spec[k], sh.mesh, sh.mesh.coord))
        sl[0] = slice(None)
        if k in dict(keep):
            sl[dict(keep)[k]] = slice(None)
        for i, e in enumerate(spec[k]):
            if e is None:
                sl[i] = slice(None)
        out[k] = x[tuple(sl)].clone()
    return out


def _rwkv_state(cfg: ModelConfig, sh, h: torch.Tensor, cache, spec):
    """The RWKV state in the compute's layout: a rank's heads of ``wkv``
    where the heads split."""
    keep = {"wkv": 1} if sh.splits(cfg.n_heads) else {}
    if cache is None:
        st = rwkv.blank_state(cfg, h.shape[0], None, h.device)
        if keep:
            h0, h1 = sh.chunk(cfg.n_heads)
            st["wkv"] = st["wkv"][:, h0:h1].clone()
        return st, keep
    return _state_view(sh, cache, spec, keep), keep


def block_apply_sharded(bc: BlockCfg, cfg: ModelConfig, p: Dict[str, Any],
                        x: torch.Tensor, sh, *, mode: str, cache: Any = None,
                        index=None, cross_src=None, cross_kv=None,
                        positions=None, use_flash: bool = False,
                        use_rwkv_kernel: bool = False,
                        cache_len: Optional[int] = None, cache_spec=None):
    """:func:`block_apply` on a mesh: the residual stream whole on every
    rank of a batch shard; attention, the FFN, the experts and the RWKV
    time mix split over ``model`` (``attention.attend_sharded``,
    ``mlp.apply_sharded``, ``moe.apply_sharded``,
    ``rwkv.tm_apply_sharded``), the norms and the SSM heads whole. The
    caches in and out are stored as ``cache_spec`` cuts them (attention
    caches by ``attention.cache_cut``)."""
    aux = None
    w = sh.w
    h = rmsnorm(w(p["ln1"]["scale"]), x, cfg.norm_eps)
    new_cache = cache
    n_meta = cfg.n_meta_tokens if bc.window > 0 else 0

    def self_attention(pa, c, causal=True):
        if mode == "decode":
            return attention.decode_step_sharded(
                pa, cfg, h, c, index, sh, window=bc.window, n_meta=n_meta,
                use_rope=bc.use_rope)
        return attention.attend_sharded(
            pa, cfg, h, sh, causal=causal, window=bc.window, n_meta=n_meta,
            positions=positions, use_rope=bc.use_rope, use_flash=use_flash,
            make_cache=_cache_window(bc, cfg, cache_len or h.shape[1])
            if mode == "prefill" and causal else 0)

    def cross_attention(pa, hh):
        if mode == "decode":
            return attention.decode_step_sharded(pa, cfg, hh, None, index, sh,
                                                 cross_cache=cross_kv)[0]
        return attention.attend_sharded(pa, cfg, hh, sh,
                                        cross_src=cross_src)[0]

    rwkv_keep = None
    if bc.mixer in ("attn", "bidir"):
        o, new_cache = self_attention(p["mixer"], cache,
                                      causal=bc.mixer == "attn")
    elif bc.mixer == "cross":
        o = cross_attention(p["mixer"], h)
    elif bc.mixer == "rwkv":
        st, rwkv_keep = _rwkv_state(cfg, sh, h, cache, cache_spec)
        o, new_cache = rwkv.tm_apply_sharded(
            p["mixer"], cfg, h, st, sh,
            use_kernel=use_rwkv_kernel and mode != "decode")
    elif bc.mixer == "hybrid":
        pm = p["mixer"]
        oa, ca = self_attention(pm["attn"], None if cache is None
                                else cache["attn"])
        full = {k: w(v) for k, v in pm["ssm"].items()}
        sspec = None if cache_spec is None else cache_spec["ssm"]
        if cache is None:
            st = ssm.blank_state(cfg, h.shape[0], None, h.device)
        else:
            st = _state_view(sh, cache["ssm"], sspec)
        if mode == "decode":
            os_, cs = ssm.apply_step(full, cfg, h, st)
        else:
            os_, cs = ssm.apply_seq(full, cfg, h, st)
        if mode != "train":
            cs = _state_store(sh, cs, sspec)
        oa = rmsnorm_1d(w(pm["attn_norm.scale"]), oa, cfg.norm_eps)
        beta = w(pm["beta"]).float()
        oaf, osf = oa.float(), os_.float()
        o = (fma(beta[0].expand_as(oaf), oaf, beta[1] * osf) * 0.5).to(
            x.dtype)
        new_cache = {"attn": ca, "ssm": cs}
    else:
        raise ValueError(bc.mixer)
    x = x + o
    if bc.has_cross:
        hc = rmsnorm(w(p["ln_cross"]["scale"]), x, cfg.norm_eps)
        x = x + cross_attention(p["cross"], hc)
    h = rmsnorm(w(p["ln2"]["scale"]), x, cfg.norm_eps)
    if bc.ffn == "mlp":
        o = mlp.apply_sharded(p["ffn"], cfg, h, sh)
    elif bc.ffn == "moe":
        o, aux = moe.apply_sharded(p["ffn"], cfg, h, sh)
    else:
        o, new_cache = rwkv.cm_apply_sharded(p["ffn"], cfg, h, new_cache, sh)
    if rwkv_keep is not None and mode != "train":
        new_cache = _state_store(sh, new_cache, cache_spec, rwkv_keep)
    return x + o, new_cache, aux
