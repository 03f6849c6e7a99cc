"""Model facade: embedding, block plan and head, with forward, prefill and
decode.

Port of ``repro/models/model.py``, every family. The parameters live in
the module (built on ``device`` from ``generator`` when the model is
made), so the methods take the batch alone:

    forward:  {'tokens': (B, S) int[, 'src_embed': (B, S_src, d)]
               [, 'vision_embed': (B, P, d)]} -> (logits (B, S, V) f32,
                                                   aux)
    loss:     the same and {'labels': (B, S) int[, 'loss_mask': (B, S)]}
              -> (total, metrics)
    prefill:  the forward's batch -> (last-position logits (B, V) f32,
                                      caches, cross_kvs or None)
    decode:   token (B, 1) int, index, caches[, cross_kvs]
              -> (logits (B, V), caches)

An encoder-decoder arch encodes ``src_embed`` (the stub frontend's frame
embeddings) through its encoder plan (bidirectional, in train mode, as
the reference runs it); a vision arch reads ``vision_embed`` as its
cross-attention source. Meta tokens (hymba) are prepended to the
sequence: decode positions count them (``index`` includes the offset).
``prefill`` and ``decode`` run under ``torch.inference_mode``. The train
step (:mod:`repro_torch.launch.steps`) differentiates ``loss`` through
``torch.func.functional_call``, so its parameters may come from outside
the module; :meth:`leaf_groups` names them in the reference's leaf order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from . import attention, transformer
from .common import (Maker, ModelConfig, init_maker, meta_maker, norm_param,
                     param, rmsnorm)
from .transformer import Segment, make_encoder_plan, make_plan


def _segments_tree(segments: nn.ModuleList) -> List:
    return [[[b.tree() for b in layer] for layer in seg] for seg in segments]


class Model(nn.Module):
    """``Model(cfg)`` builds its parameters on the card (it raises where
    there is none); ``device="cpu"`` builds them on the CPU and
    ``device="meta"`` only their shapes. ``generator`` (on that device)
    draws them; by default a generator seeded 0. ``cut(x, axes)``, where
    given, keeps a block of each parameter as it is drawn (a rank's
    blocks: :func:`repro_torch.launch.partition.build_local`)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, cut=None):
        super().__init__()
        self.cfg = cfg
        self.plan: List[Segment] = make_plan(cfg)
        self.enc_plan: List[Segment] = (
            make_encoder_plan(cfg) if cfg.n_encoder_layers else [])
        dev = resolve_device(device)
        if dev.type == "meta":
            mk = meta_maker(cfg.param_dtype)
        else:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            mk = init_maker(generator, cfg.param_dtype, dev, cut)
        d = cfg.d_model
        self.embed = param(mk("embed", (cfg.padded_vocab, d),
                              ("vocab", "embed"), 0.02))
        self.segments = transformer.plan_params(cfg, self.plan, mk, "dec")
        self.final_norm = norm_param(mk, "final", d)
        self.unembed = (None if cfg.tie_embeddings else param(
            mk("unembed", (d, cfg.padded_vocab), ("embed", "vocab"), 0.02)))
        self.meta_tokens = (param(mk(
            "meta_tokens", (cfg.n_meta_tokens, d), (None, "embed"), 0.02))
            if cfg.n_meta_tokens else None)
        self.encoder = None
        if self.enc_plan:
            self.encoder = nn.Module()
            self.encoder.segments = transformer.plan_params(
                cfg, self.enc_plan, mk, "enc")
            self.encoder.final_norm = norm_param(mk, "enc_final", d)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> Dict:
        """The parameters under the reference's keys and nesting, each
        segment's blocks as a list over its layers."""
        t: Dict[str, Any] = {"embed": self.embed,
                             "segments": _segments_tree(self.segments),
                             "final_norm": {"scale": self.final_norm}}
        if self.unembed is not None:
            t["unembed"] = self.unembed
        if self.meta_tokens is not None:
            t["meta_tokens"] = self.meta_tokens
        if self.encoder is not None:
            t["encoder"] = {
                "segments": _segments_tree(self.encoder.segments),
                "final_norm": {"scale": self.encoder.final_norm}}
        return t

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        """Each parameter's stand-in by name: a ``meta`` tensor of its
        shape and dtype."""
        meta = Model(self.cfg, device="meta")
        return {n: p.detach() for n, p in meta.named_parameters()}

    def param_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Each parameter's logical axes by name: the reference's axes of
        its leaf, less the leading ``"layers"`` of a segment's stacked
        leaf (the port holds a tensor a layer)."""
        meta = Model(self.cfg, device="meta")
        return {n: p.axes for n, p in meta.named_parameters()}

    def param_paths(self) -> Dict[str, Tuple[tuple, Optional[int]]]:
        """Each parameter's name -> (its path in the reference's tree,
        its layer or None): the reference stacks a segment's layers on a
        leading axis, so ``segments.0.3.0.mixer.wq`` is layer 3 of
        ``("segments", 0, 0, "mixer", "wq")`` (and the encoder's under
        ``("encoder", "segments", ...)``)."""
        names = {id(p): n for n, p in self.named_parameters()}
        out: Dict[str, Tuple[tuple, Optional[int]]] = {}

        def walk(node, path, layer):
            if isinstance(node, dict):
                for k, v in node.items():
                    if k == "segments" and layer is None:
                        for si, seg in enumerate(v):
                            for li, blocks in enumerate(seg):
                                for j, block in enumerate(blocks):
                                    walk(block, path + (k, si, j), li)
                    else:
                        walk(v, path + (k,), layer)
            else:
                out[names[id(node)]] = (path, layer)

        walk(self.tree(), (), None)
        return out

    def leaf_groups(self) -> List[List[str]]:
        """The parameters' names grouped into the reference's leaves, in
        the order of ``jax.tree.leaves`` of the reference's tree (dict
        keys sorted at every level, so the paths sorted; a segment's leaf
        holds that parameter of every layer, in layer order)."""
        groups: Dict[tuple, List[Tuple[int, str]]] = {}
        for name, (path, layer) in self.param_paths().items():
            groups.setdefault(path, []).append((layer or 0, name))
        return [[n for _, n in sorted(groups[p])] for p in sorted(groups)]

    # ------------------------------------------------------------------ embed
    def _lookup(self, tokens: torch.Tensor, sh=None) -> torch.Tensor:
        """The embedding rows of ``tokens``. On a mesh the vocab splits
        over ``model`` where it divides: each rank looks up the tokens in
        its rows (zero elsewhere) and the ranks' rows are summed."""
        if sh is None:
            return self.embed[tokens]
        v = self.cfg.padded_vocab
        if not sh.splits(v):
            return sh.w(self.embed)[tokens]
        lo, hi = sh.chunk(v)
        rows = sh.cols(self.embed, lo, hi, dim=0)
        mine = (tokens >= lo) & (tokens < hi)
        got = rows[torch.where(mine, tokens - lo, torch.zeros_like(tokens))]
        return sh.leave(torch.where(mine[..., None], got,
                                    torch.zeros((), dtype=got.dtype,
                                                device=got.device)))

    def _embed(self, tokens: torch.Tensor, sh=None) -> torch.Tensor:
        cfg = self.cfg
        x = self._lookup(tokens, sh).to(cfg.activation_dtype)
        if self.meta_tokens is not None:
            meta = (self.meta_tokens if sh is None
                    else sh.w(self.meta_tokens))
            meta = meta.to(cfg.activation_dtype)[None].expand(
                tokens.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor, sh=None) -> torch.Tensor:
        if sh is not None:
            return self._logits_sharded(x, sh)
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        w = self.embed.T if self.unembed is None else self.unembed
        return (x @ w.to(x.dtype)).float()

    def _logits_sharded(self, x: torch.Tensor, sh) -> torch.Tensor:
        """Vocab-parallel logits: each rank's vocab block, gathered."""
        x = rmsnorm(sh.w(self.final_norm), x, self.cfg.norm_eps)
        v = self.cfg.padded_vocab
        if not sh.splits(v):
            w = (sh.w(self.embed).T if self.unembed is None
                 else sh.w(self.unembed))
            return (x @ w.to(x.dtype)).float()
        lo, hi = sh.chunk(v)
        w = (sh.cols(self.embed, lo, hi, dim=0).T if self.unembed is None
             else sh.cols(self.unembed, lo, hi))
        part = (sh.enter(x) @ w.to(x.dtype)).float()
        return sh.gather_model(part, -1)

    def _encode(self, src_embed: torch.Tensor, use_flash: bool,
                remat_mode: str = "layer", sh=None) -> torch.Tensor:
        x = src_embed.to(self.cfg.activation_dtype)
        x, _, _ = transformer.plan_apply(
            self.cfg, self.enc_plan, self.encoder.segments, x, mode="train",
            use_flash=use_flash, remat_mode=remat_mode, sh=sh)
        scale = (self.encoder.final_norm if sh is None
                 else sh.w(self.encoder.final_norm))
        return rmsnorm(scale, x, self.cfg.norm_eps)

    def _cross_source(self, batch: Dict[str, torch.Tensor], use_flash: bool,
                      remat_mode: str = "layer", sh=None
                      ) -> Optional[torch.Tensor]:
        if self.enc_plan:
            return self._encode(batch["src_embed"], use_flash, remat_mode,
                                sh)
        if self.cfg.family == "vlm":
            return batch["vision_embed"].to(self.cfg.activation_dtype)
        return None

    # ------------------------------------------------------------------ train
    def forward(self, batch: Dict[str, torch.Tensor], *,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                remat_mode: str = "layer", sh=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits (B, S, V) f32 at every prompt position (the meta
        tokens' dropped), the summed auxiliary losses of
        :data:`transformer.AUX_KEYS`). ``remat_mode`` matters only under
        autograd (:func:`transformer.plan_apply`). ``sh``: the step's
        layout on a mesh (:class:`repro_torch.launch.partition.Shards`),
        the batch this rank's rows."""
        x, aux = self._hidden(batch, use_flash, use_rwkv_kernel, remat_mode,
                              sh)
        return self._logits(x, sh), aux

    def _hidden(self, batch, use_flash, use_rwkv_kernel, remat_mode, sh):
        """The last layer's output at every prompt position, and the aux
        terms."""
        cross_src = self._cross_source(batch, use_flash, remat_mode, sh)
        x = self._embed(batch["tokens"], sh)
        x, _, aux = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="train",
            cross_src=cross_src, positions=self._positions(x),
            use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
            remat_mode=remat_mode, sh=sh)
        if self.cfg.n_meta_tokens:
            x = x[:, self.cfg.n_meta_tokens:]
        return x, aux

    def _ce_vocab_parallel(self, x: torch.Tensor, labels: torch.Tensor,
                           sh) -> torch.Tensor:
        """The cross-entropy from each rank's vocab block of the logits,
        never gathered (Megatron's vocab-parallel loss): the row max over
        ``model``, the exp-sums and the label's logit (on the rank that
        holds it) summed over ``model`` in rank order."""
        from ..launch import partition
        x = rmsnorm(sh.w(self.final_norm), x, self.cfg.norm_eps)
        lo, hi = sh.chunk(self.cfg.padded_vocab)
        w = (sh.cols(self.embed, lo, hi, dim=0).T if self.unembed is None
             else sh.cols(self.unembed, lo, hi))
        part = (sh.enter(x) @ w.to(x.dtype)).float()
        with torch.no_grad():
            top = partition.max_axes(sh.mesh, ("model",), part.amax(-1))
        sums = sh.leave(torch.exp(part - top[..., None]).sum(-1))
        mine = (labels >= lo) & (labels < hi)
        at = part.gather(-1, torch.where(mine, labels - lo,
                                         torch.zeros_like(labels))[..., None])
        label_logit = sh.leave(torch.where(mine, at[..., 0],
                                           torch.zeros_like(at[..., 0])))
        return torch.log(sums) + top - label_logit

    def loss(self, batch: Dict[str, torch.Tensor], *,
             use_flash: bool = False, use_rwkv_kernel: bool = False,
             remat_mode: str = "layer", sh=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics): the mean cross-entropy over the padded vocab
        (``loss_mask`` weighting it when given) plus the router terms;
        ``metrics`` holds the aux terms, ``ce`` and ``loss``.

        On a mesh (``sh``) the batch is this rank's rows: ``ce`` is its
        share of the global mean (the ranks' shares sum to it), and the
        total differentiates to this rank's part of the gradient."""
        cfg = self.cfg
        labels = batch["labels"].long()
        if sh is not None and sh.m > 1 and sh.splits(cfg.padded_vocab):
            x, aux = self._hidden(batch, use_flash, use_rwkv_kernel,
                                  remat_mode, sh)
            ce = self._ce_vocab_parallel(x, labels, sh)
        else:
            logits, aux = self(batch, use_flash=use_flash,
                               use_rwkv_kernel=use_rwkv_kernel,
                               remat_mode=remat_mode, sh=sh)
            lse = torch.logsumexp(logits, dim=-1)
            # the reference takes the label's logit as a one-hot where-sum
            # over the vocab; that sum adds exact zeros to the one logit, so
            # a gather gives the same value and gradient without a (B, S, V)
            # mask
            ce = lse - logits.gather(-1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            ce_mean = ce.mean()
            if sh is not None and sh.batch_count() > 1:
                ce_mean = ce_mean / sh.batch_count()
        else:
            mask = mask.to(ce.dtype)
            count = mask.sum()
            if sh is not None:
                from ..launch import partition
                count = partition.sum_axes(sh.mesh, sh.batch_axes, count)
            ce_mean = (ce * mask).sum() / torch.clamp(count, min=1.0)
        total = (ce_mean + cfg.router_aux_weight * aux["load_balance"]
                 + cfg.router_z_weight * aux["router_z"])
        metrics = dict(aux, ce=ce_mean, loss=total)
        return total, metrics

    # ------------------------------------------------------------------ serve
    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], *,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                max_seq: Optional[int] = None, sh=None
                ) -> Tuple[torch.Tensor, List, Optional[List]]:
        """Full-sequence pass building the decode state: attention ring
        caches of ``max_seq`` slots (the decode budget, meta tokens
        included, by default the sequence length; a window caps them),
        the RWKV and SSM states from zero, and the cross layers' source
        keys and values. Returns (last-position logits (B, V) f32,
        caches, cross_kvs or None). On a mesh (``sh``, with its
        ``cache_specs``) the caches come out as the mesh stores them."""
        cross_src = self._cross_source(batch, use_flash, sh=sh)
        x = self._embed(batch["tokens"], sh)
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="prefill",
            cross_src=cross_src, positions=self._positions(x),
            use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
            cache_len=max_seq, sh=sh)
        cross_kvs = (None if cross_src is None
                     else self.precompute_cross_kvs(cross_src, sh))
        return self._logits(x[:, -1:], sh)[:, 0], caches, cross_kvs

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, index, caches: List,
               cross_kvs: Optional[List] = None, sh=None
               ) -> Tuple[torch.Tensor, List]:
        """One token step. token: (B, 1); ``index`` (an int or a 0-d
        tensor) is the position of this token, meta tokens included. The
        attention caches are updated in place."""
        x = self._lookup(token, sh).to(self.cfg.activation_dtype)
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="decode",
            caches=caches, index=index, cross_kvs=cross_kvs, sh=sh)
        return self._logits(x, sh)[:, 0], caches

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    # ------------------------------------------------------------ decode state
    def blank_caches(self, batch: int, max_seq: int) -> List:
        return transformer.blank_plan_cache(self.cfg, self.plan, batch,
                                            max_seq, self.device)

    def cache_specs(self, mk: Maker, batch: int, max_seq: int) -> List:
        """The decode caches' leaves through a maker (shapes or axes), in
        :meth:`blank_caches`' layout."""
        return transformer.plan_cache_specs(self.cfg, self.plan, mk, batch,
                                            max_seq)

    def cross_kv_specs(self, mk: Maker, batch: int, src_len: int
                       ) -> Optional[List]:
        """The cross layers' source keys and values through a maker, in
        :meth:`precompute_cross_kvs`' layout; None without a cross
        layer."""
        cfg = self.cfg
        out, any_ = [], False
        for si, seg in enumerate(self.plan):
            row = []
            for j, bc in enumerate(seg.pattern):
                if bc.mixer != "cross" and not bc.has_cross:
                    row.append(None)
                    continue
                any_ = True
                shape = (seg.n, batch, src_len, cfg.n_kv_heads, cfg.hd)
                axes = ("layers", "batch", None, "kv_head", None)
                row.append({k: mk(f"xkv.seg{si}.pos{j}.{k}", shape, axes,
                                  0.0) for k in ("k", "v")})
            out.append(tuple(row))
        return out if any_ else None

    @torch.inference_mode()
    def precompute_cross_kvs(self, src: torch.Tensor, sh=None) -> List:
        """Per segment and position, the cross layers' source keys and
        values stacked over the segment's layers (None elsewhere); on a
        mesh as it stores them (:func:`attention.cross_kv_sharded`)."""
        kv_of = (attention.precompute_cross_kv if sh is None else
                 lambda p, cfg, s: attention.cross_kv_sharded(p, cfg, s, sh))
        out = []
        for si, seg in enumerate(self.plan):
            row = []
            for j, bc in enumerate(seg.pattern):
                if bc.mixer != "cross" and not bc.has_cross:
                    row.append(None)
                    continue
                kvs = [kv_of(
                    layer[j].mixer.tree() if bc.mixer == "cross"
                    else layer[j].cross.tree(), self.cfg, src)
                    for layer in self.segments[si]]
                row.append({k: torch.stack([kv[k] for kv in kvs])
                            for k in ("k", "v")})
            out.append(tuple(row))
        return out


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device, generator)
