"""Layer-stack assembly: the block plan, its parameters, caches and
application.

Port of ``repro/models/transformer.py`` for the ``ssm`` and ``dense``
families. An ``ssm`` plan is one :class:`Segment` of ``n_layers`` blocks,
each an RWKV6 TimeMix (mixer ``rwkv``) and ChannelMix (FFN ``rwkv_cm``); a
``dense`` plan one segment of causal self-attention (mixer ``attn``,
window ``sliding_window``) and an MLP (FFN ``mlp``). Every block is
pre-norm residual. The other families raise ``NotImplementedError``
naming the ROADMAP item that brings their layers. Parameters are one
:class:`Block` per layer (the reference stacks them on a leading
``layers`` axis and scans); caches keep the reference's stacked layout,
per segment a tuple (one entry per pattern position) of dicts of (L, ...)
tensors. :func:`plan_apply` is a loop over the layers (no scan); in train
mode it recomputes each layer's activations in the backward pass
(``remat_mode="layer"``, the reference's ``remat=True``) or also groups of
layers (``"nested"``), through ``torch.utils.checkpoint``. ``mode`` is
train | prefill | decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention, mlp, rwkv
from .common import Maker, ModelConfig, rmsnorm


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


_UNPORTED = {
    "moe": "ROADMAP Queue A item 14: models/moe.py",
    "hybrid": "ROADMAP Queue A item 14: models/ssm.py and the hybrid plan",
    "vlm": "ROADMAP Queue A item 14: the cross-attention plan",
    "encdec": "ROADMAP Queue A item 14: the encoder-decoder plan",
}
_BLOCKS = {("rwkv", "rwkv_cm"), ("attn", "mlp")}
# the auxiliary losses a block returns (the MoE router's; zero for the
# ported families)
AUX_KEYS = ("load_balance", "router_z", "dropped_frac")
REMAT_MODES = ("none", "layer", "nested")


def make_plan(cfg: ModelConfig) -> List[Segment]:
    """Decoder plan for the configured family (``ssm`` and ``dense``)."""
    if cfg.family == "ssm":
        return [Segment((BlockCfg(mixer="rwkv", ffn="rwkv_cm"),),
                        cfg.n_layers)]
    if cfg.family == "dense" and not cfg.is_moe:
        return [Segment((BlockCfg(mixer="attn", ffn="mlp",
                                  window=cfg.sliding_window),),
                        cfg.n_layers)]
    family = "moe" if cfg.is_moe else cfg.family
    where = _UNPORTED.get(family, "ROADMAP Queue A item 14")
    raise NotImplementedError(f"the {family} family is not ported yet: "
                              f"{where}")


def plan_layers(plan: List[Segment]) -> int:
    return sum(len(s.pattern) * s.n for s in plan)


def _check_block(bc: BlockCfg) -> None:
    if (bc.mixer, bc.ffn) not in _BLOCKS or bc.has_cross:
        raise NotImplementedError(f"block {bc} is not ported yet: ROADMAP "
                                  f"Queue A item 14")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """The parameters of one pre-norm residual block (ln1, mixer, ln2,
    ffn); :func:`block_apply` computes it from :meth:`tree`."""

    def __init__(self, cfg: ModelConfig, bc: BlockCfg, mk: Maker,
                 prefix: str):
        super().__init__()
        _check_block(bc)
        d = cfg.d_model
        self.ln1 = nn.Parameter(mk(f"{prefix}.ln1.norm.scale", (d,), 1.0))
        if bc.mixer == "rwkv":
            self.mixer = rwkv.TimeMix(cfg, mk, f"{prefix}.tm")
        else:
            self.mixer = attention.Attention(cfg, mk, f"{prefix}.attn")
        self.ln2 = nn.Parameter(mk(f"{prefix}.ln2.norm.scale", (d,), 1.0))
        if bc.ffn == "rwkv_cm":
            self.ffn = rwkv.ChannelMix(cfg, mk, f"{prefix}.cm")
        else:
            self.ffn = mlp.MLP(cfg, mk, f"{prefix}.mlp")

    def tree(self) -> Dict[str, Any]:
        """The parameters under the reference's keys."""
        return {"ln1": {"scale": self.ln1}, "mixer": self.mixer.tree(),
                "ln2": {"scale": self.ln2}, "ffn": self.ffn.tree()}


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
    of ``max_seq`` slots (or the window) for attention, the recurrent
    state for RWKV."""
    out = []
    for seg in plan:
        caches = []
        for bc in seg.pattern:
            _check_block(bc)
            if bc.mixer == "attn":
                caches.append(attention.blank_cache(
                    cfg, batch, _cache_window(bc, cfg, max_seq), seg.n,
                    device))
            else:
                caches.append(rwkv.blank_state(cfg, batch, seg.n, device))
        out.append(tuple(caches))
    return out


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------
def block_apply(bc: BlockCfg, cfg: ModelConfig, p: Dict[str, Any],
                x: torch.Tensor, *, mode: str, cache: Any = None,
                index=None, positions: Optional[torch.Tensor] = None,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
    """Apply one block given its parameter tree. Returns (x, new_cache).

    Attention: decode steps over the ring cache ``cache`` at position
    ``index`` (updating it in place); train and prefill attend over the
    sequence at ``positions``, through the flash kernel when
    ``use_flash``, and prefill builds a ring cache of ``cache_len`` slots
    (by default the prompt length). RWKV: decode runs the time mix one
    step in plain PyTorch, as the reference does; train and prefill start
    from ``cache`` or a blank state and take the kernel when
    ``use_rwkv_kernel``."""
    _check_block(bc)
    h = rmsnorm(p["ln1"]["scale"], x, cfg.norm_eps)
    if bc.mixer == "attn":
        n_meta = cfg.n_meta_tokens if bc.window > 0 else 0
        if mode == "decode":
            o, new_cache = attention.decode_step(
                p["mixer"], cfg, h, cache, index, window=bc.window,
                n_meta=n_meta, use_rope=bc.use_rope)
        else:
            o, new_cache = attention.attend(
                p["mixer"], cfg, h, causal=True, window=bc.window,
                n_meta=n_meta, positions=positions, use_rope=bc.use_rope,
                use_flash=use_flash,
                make_cache=_cache_window(bc, cfg, cache_len or h.shape[1])
                if mode == "prefill" else 0)
        x = x + o
        h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
        return x + mlp.apply(p["ffn"], cfg, h), new_cache
    if mode == "decode":
        o, new_cache = rwkv.tm_apply(p["mixer"], cfg, h, cache,
                                     use_kernel=False)
    else:
        state = cache if cache is not None else rwkv.blank_state(
            cfg, h.shape[0], None, h.device)
        o, new_cache = rwkv.tm_apply(p["mixer"], cfg, h, state,
                                     use_kernel=use_rwkv_kernel)
    x = x + o
    h = rmsnorm(p["ln2"]["scale"], x, cfg.norm_eps)
    o, new_cache = rwkv.cm_apply(p["ffn"], cfg, h, new_cache)
    return x + o, new_cache


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


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
                  positions, use_flash: bool, use_rwkv_kernel: bool,
                  remat: bool) -> torch.Tensor:
    """``x`` through ``layers`` (each a list of the pattern's parameter
    trees) in train mode, each layer recomputed in the backward pass when
    ``remat``. The trees are read before the call, so a recompute uses the
    tensors of this forward pass (those of ``torch.func.functional_call``,
    say) and never reads the module again."""
    def layer_fn(h, trees):
        for bc, p in zip(seg.pattern, trees):
            h, _ = block_apply(bc, cfg, p, h, mode="train",
                               positions=positions, use_flash=use_flash,
                               use_rwkv_kernel=use_rwkv_kernel)
        return h

    for trees in layers:
        if remat:
            x = checkpoint(layer_fn, x, trees, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_fn(x, trees)
    return x


def plan_apply(cfg: ModelConfig, plan: List[Segment], segments: nn.ModuleList,
               x: torch.Tensor, *, mode: str,
               caches: Optional[List] = None, index=None,
               positions: Optional[torch.Tensor] = None,
               use_flash: bool = False, use_rwkv_kernel: bool = False,
               cache_len: Optional[int] = None, remat_mode: str = "layer"
               ) -> Tuple[torch.Tensor, Optional[List],
                          Dict[str, torch.Tensor]]:
    """Run x through every layer. Returns (x, new caches, summed aux): the
    caches in decode and prefill, None in train. In decode the attention
    caches are updated in place and returned as they came. ``remat_mode``
    (train only): ``"layer"`` recomputes each layer in the backward pass,
    ``"nested"`` also each group of :func:`_nested_group` layers (the
    group's boundaries alone are kept between the passes), ``"none"``
    keeps every activation."""
    if remat_mode not in REMAT_MODES:
        raise ValueError(f"remat_mode {remat_mode!r} is not one of "
                         f"{REMAT_MODES}")
    aux = _zero_aux(x.device)
    new_caches: List = []
    for si, seg in enumerate(plan):
        if mode == "train":
            layers = [[b.tree() for b in layer] for layer in segments[si]]
            remat = remat_mode != "none"
            G = _nested_group(seg.n) if remat_mode == "nested" else 1
            if G == 1:
                x = _train_layers(cfg, seg, layers, x, positions, use_flash,
                                  use_rwkv_kernel, remat)
                continue
            for g0 in range(0, seg.n, G):
                x = checkpoint(_train_layers, cfg, seg, layers[g0:g0 + G], x,
                               positions, use_flash, use_rwkv_kernel, True,
                               use_reentrant=False, preserve_rng_state=False)
            continue
        per_pos: List[List[Dict[str, torch.Tensor]]] = [[] for _ in
                                                         seg.pattern]
        for layer in range(seg.n):
            for j, bc in enumerate(seg.pattern):
                cache = None if caches is None else {
                    key: val[layer] for key, val in caches[si][j].items()}
                x, cache = block_apply(
                    bc, cfg, segments[si][layer][j].tree(), x, mode=mode,
                    cache=cache, index=index, positions=positions,
                    use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
                    cache_len=cache_len)
                per_pos[j].append(cache)
        new_caches.append(tuple(
            caches[si][j] if mode == "decode" and bc.mixer == "attn"
            else {key: torch.stack([c[key] for c in layers])
                  for key in layers[0]}
            for j, (bc, layers) in enumerate(zip(seg.pattern, per_pos))))
    return x, (new_caches if mode != "train" else None), aux
