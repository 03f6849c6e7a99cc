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
from .common import ModelConfig, init_maker, meta_maker, rmsnorm
from .transformer import Segment, make_encoder_plan, make_plan


def _segments_tree(segments: nn.ModuleList) -> List:
    return [[[b.tree() for b in layer] for layer in seg] for seg in segments]


class Model(nn.Module):
    """``Model(cfg)`` builds its parameters on the card (it raises where
    there is none); ``device="cpu"`` builds them on the CPU and
    ``device="meta"`` only their shapes. ``generator`` (on that device)
    draws them; by default a generator seeded 0."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
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
            mk = init_maker(generator, cfg.param_dtype, dev)
        d = cfg.d_model
        self.embed = nn.Parameter(mk("embed", (cfg.padded_vocab, d), 0.02))
        self.segments = transformer.plan_params(cfg, self.plan, mk, "dec")
        self.final_norm = nn.Parameter(mk("final.norm.scale", (d,), 1.0))
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            mk("unembed", (d, cfg.padded_vocab), 0.02)))
        self.meta_tokens = (nn.Parameter(mk(
            "meta_tokens", (cfg.n_meta_tokens, d), 0.02))
            if cfg.n_meta_tokens else None)
        self.encoder = None
        if self.enc_plan:
            self.encoder = nn.Module()
            self.encoder.segments = transformer.plan_params(
                cfg, self.enc_plan, mk, "enc")
            self.encoder.final_norm = nn.Parameter(
                mk("enc_final.norm.scale", (d,), 1.0))

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
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.activation_dtype)
        if self.meta_tokens is not None:
            meta = self.meta_tokens.to(cfg.activation_dtype)[None].expand(
                tokens.shape[0], -1, -1)
            x = torch.cat([meta, x], dim=1)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        w = self.embed.T if self.unembed is None else self.unembed
        return (x @ w.to(x.dtype)).float()

    def _encode(self, src_embed: torch.Tensor, use_flash: bool,
                remat_mode: str = "layer") -> torch.Tensor:
        x = src_embed.to(self.cfg.activation_dtype)
        x, _, _ = transformer.plan_apply(
            self.cfg, self.enc_plan, self.encoder.segments, x, mode="train",
            use_flash=use_flash, remat_mode=remat_mode)
        return rmsnorm(self.encoder.final_norm, x, self.cfg.norm_eps)

    def _cross_source(self, batch: Dict[str, torch.Tensor], use_flash: bool,
                      remat_mode: str = "layer"
                      ) -> Optional[torch.Tensor]:
        if self.enc_plan:
            return self._encode(batch["src_embed"], use_flash, remat_mode)
        if self.cfg.family == "vlm":
            return batch["vision_embed"].to(self.cfg.activation_dtype)
        return None

    # ------------------------------------------------------------------ train
    def forward(self, batch: Dict[str, torch.Tensor], *,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                remat_mode: str = "layer"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits (B, S, V) f32 at every prompt position (the meta
        tokens' dropped), the summed auxiliary losses of
        :data:`transformer.AUX_KEYS`). ``remat_mode`` matters only under
        autograd (:func:`transformer.plan_apply`)."""
        cross_src = self._cross_source(batch, use_flash, remat_mode)
        x = self._embed(batch["tokens"])
        x, _, aux = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="train",
            cross_src=cross_src, positions=self._positions(x),
            use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
            remat_mode=remat_mode)
        if self.cfg.n_meta_tokens:
            x = x[:, self.cfg.n_meta_tokens:]
        return self._logits(x), aux

    def loss(self, batch: Dict[str, torch.Tensor], *,
             use_flash: bool = False, use_rwkv_kernel: bool = False,
             remat_mode: str = "layer"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics): the mean cross-entropy over the padded vocab
        (``loss_mask`` weighting it when given) plus the router terms;
        ``metrics`` holds the aux terms, ``ce`` and ``loss``."""
        cfg = self.cfg
        logits, aux = self(batch, use_flash=use_flash,
                           use_rwkv_kernel=use_rwkv_kernel,
                           remat_mode=remat_mode)
        labels = batch["labels"].long()
        lse = torch.logsumexp(logits, dim=-1)
        # the reference takes the label's logit as a one-hot where-sum
        # over the vocab; that sum adds exact zeros to the one logit, so a
        # gather gives the same value and gradient without a (B, S, V)
        # mask
        ce = lse - logits.gather(-1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            ce_mean = ce.mean()
        else:
            mask = mask.to(ce.dtype)
            ce_mean = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = (ce_mean + cfg.router_aux_weight * aux["load_balance"]
                 + cfg.router_z_weight * aux["router_z"])
        metrics = dict(aux, ce=ce_mean, loss=total)
        return total, metrics

    # ------------------------------------------------------------------ serve
    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], *,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, List, Optional[List]]:
        """Full-sequence pass building the decode state: attention ring
        caches of ``max_seq`` slots (the decode budget, meta tokens
        included, by default the sequence length; a window caps them),
        the RWKV and SSM states from zero, and the cross layers' source
        keys and values. Returns (last-position logits (B, V) f32,
        caches, cross_kvs or None)."""
        cross_src = self._cross_source(batch, use_flash)
        x = self._embed(batch["tokens"])
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="prefill",
            cross_src=cross_src, positions=self._positions(x),
            use_flash=use_flash, use_rwkv_kernel=use_rwkv_kernel,
            cache_len=max_seq)
        cross_kvs = (None if cross_src is None
                     else self.precompute_cross_kvs(cross_src))
        return self._logits(x[:, -1:])[:, 0], caches, cross_kvs

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, index, caches: List,
               cross_kvs: Optional[List] = None
               ) -> Tuple[torch.Tensor, List]:
        """One token step. token: (B, 1); ``index`` (an int or a 0-d
        tensor) is the position of this token, meta tokens included. The
        attention caches are updated in place."""
        x = self.embed[token].to(self.cfg.activation_dtype)
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="decode",
            caches=caches, index=index, cross_kvs=cross_kvs)
        return self._logits(x)[:, 0], caches

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    # ------------------------------------------------------------ decode state
    def blank_caches(self, batch: int, max_seq: int) -> List:
        return transformer.blank_plan_cache(self.cfg, self.plan, batch,
                                            max_seq, self.device)

    @torch.inference_mode()
    def precompute_cross_kvs(self, src: torch.Tensor) -> List:
        """Per segment and position, the cross layers' source keys and
        values stacked over the segment's layers (None elsewhere)."""
        out = []
        for si, seg in enumerate(self.plan):
            row = []
            for j, bc in enumerate(seg.pattern):
                if bc.mixer != "cross" and not bc.has_cross:
                    row.append(None)
                    continue
                kvs = [attention.precompute_cross_kv(
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
