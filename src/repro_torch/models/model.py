"""Model facade: embedding, block plan and head, with forward, prefill and
decode.

Port of ``repro/models/model.py`` for the ``ssm`` and ``dense`` families
(no meta tokens, encoder or vision inputs yet). The parameters
live in the module (built on ``device`` from ``generator`` when the model
is made), so the methods take the batch alone:

    forward:  {'tokens': (B, S) int} -> (logits (B, S, V) f32, aux)
    loss:     {'tokens', 'labels': (B, S) int[, 'loss_mask': (B, S)]}
              -> (total, metrics)
    prefill:  {'tokens': (B, S) int} -> (last-position logits (B, V) f32,
                                          caches)
    decode:   token (B, 1) int, index, caches -> (logits (B, V), caches)

``prefill`` and ``decode`` run under ``torch.inference_mode``. The train
step (:mod:`repro_torch.launch.steps`) differentiates ``loss`` through
``torch.func.functional_call``, so its parameters may come from outside
the module; :meth:`leaf_groups` names them in the reference's leaf order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from . import transformer
from .common import ModelConfig, init_maker, meta_maker, rmsnorm
from .transformer import Segment, make_plan


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

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> Dict:
        """The parameters under the reference's keys and nesting, each
        segment's blocks as a list over its layers."""
        t = {"embed": self.embed,
             "segments": [[[b.tree() for b in layer] for layer in seg]
                          for seg in self.segments],
             "final_norm": {"scale": self.final_norm}}
        if self.unembed is not None:
            t["unembed"] = self.unembed
        return t

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_paths(self) -> Dict[str, Tuple[tuple, Optional[int]]]:
        """Each parameter's name -> (its path in the reference's tree,
        its layer or None): the reference stacks a segment's layers on a
        leading axis, so ``segments.0.3.0.mixer.wq`` is layer 3 of
        ``("segments", 0, 0, "mixer", "wq")``."""
        names = {id(p): n for n, p in self.named_parameters()}
        out: Dict[str, Tuple[tuple, Optional[int]]] = {}

        def walk(node, path, layer):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,), layer)
            else:
                out[names[id(node)]] = (path, layer)

        tree = self.tree()
        for key, sub in tree.items():
            if key != "segments":
                walk(sub, (key,), None)
        for si, seg in enumerate(tree["segments"]):
            for layer, blocks in enumerate(seg):
                for j, block in enumerate(blocks):
                    walk(block, ("segments", si, j), layer)
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
        return self.embed[tokens].to(self.cfg.activation_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        w = self.embed.T if self.unembed is None else self.unembed
        return (x @ w.to(x.dtype)).float()

    # ------------------------------------------------------------------ train
    def forward(self, batch: Dict[str, torch.Tensor], *,
                use_flash: bool = False, use_rwkv_kernel: bool = False,
                remat_mode: str = "layer"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits (B, S, V) f32 at every position, the summed auxiliary
        losses of :data:`transformer.AUX_KEYS`). ``remat_mode`` matters
        only under autograd (:func:`transformer.plan_apply`)."""
        x = self._embed(batch["tokens"])
        x, _, aux = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="train",
            positions=self._positions(x), use_flash=use_flash,
            use_rwkv_kernel=use_rwkv_kernel, remat_mode=remat_mode)
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
                max_seq: Optional[int] = None) -> Tuple[torch.Tensor, List]:
        """Full-sequence pass building the decode state: attention ring
        caches of ``max_seq`` slots (the decode budget, by default the
        prompt length; a window caps them), the RWKV state from zero.
        Returns (last-position logits (B, V) f32, caches)."""
        x = self._embed(batch["tokens"])
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="prefill",
            positions=self._positions(x), use_flash=use_flash,
            use_rwkv_kernel=use_rwkv_kernel, cache_len=max_seq)
        return self._logits(x[:, -1:])[:, 0], caches

    @torch.inference_mode()
    def decode(self, token: torch.Tensor, index, caches: List
               ) -> Tuple[torch.Tensor, List]:
        """One token step. token: (B, 1); ``index`` (an int or a 0-d
        tensor) is the position of this token. The attention caches are
        updated in place."""
        x = self._embed(token)
        x, caches, _ = transformer.plan_apply(
            self.cfg, self.plan, self.segments, x, mode="decode",
            caches=caches, index=index)
        return self._logits(x)[:, 0], caches

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    # ------------------------------------------------------------ decode state
    def blank_caches(self, batch: int, max_seq: int) -> List:
        return transformer.blank_plan_cache(self.cfg, self.plan, batch,
                                            max_seq, self.device)


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    return Model(cfg, device, generator)
