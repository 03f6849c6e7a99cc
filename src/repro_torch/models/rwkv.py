"""RWKV6 ("Finch") blocks: attention-free, data-dependent decay.

Port of ``repro/models/rwkv.py``. Per layer a TimeMix (the WKV linear
recurrence) and a ChannelMix (a gated FFN with token shift). Heads of size
``hd = d_model // n_heads``; per head an (hd x hd) f32 state S::

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with per-channel decay ``w_t = exp(-exp(decay_base + lora(x_t)))``.

:class:`TimeMix` and :class:`ChannelMix` only hold the parameters, under
the reference's keys (:meth:`Params.tree`); :func:`tm_apply` and
:func:`cm_apply` compute, from such a tree, so the tests can hand the
reference's weights to both. The dtypes change where the reference's do: ``logw`` in
the parameters' dtype, ``exp(-exp(.))`` in f32, the WKV in f32, its
output cast back to the activations' dtype before the group norm.
``tm_apply(use_kernel=True)`` sends the recurrence through the CUDA kernel
(:func:`repro_torch.kernels.rwkv6.ops.wkv`); otherwise it runs
:func:`wkv_ref`, the sequential recurrence in plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.rwkv6 import ops as rwkv_ops
from ..kernels.rwkv6 import ref as rwkv_ref
from .common import (Maker, ModelConfig, Params, Tree, groupnorm_heads,
                     sigmoid)

# Five mixing targets in TimeMix: r, k, v, g(ate), w(decay)
_MIX = ("r", "k", "v", "g", "w")

class TimeMix(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, lora, m = cfg.d_model, cfg.rwkv_decay_lora, len(_MIX)
        # token-shift base mixing per target; data-dependent LoRA (A shared)
        self._param("mix_base", mk(f"{prefix}.mix_base", (m, d),
                                   (None, "embed"), 0.5))
        self._param("mix_A", mk(f"{prefix}.mix_A", (d, lora),
                                ("embed", None)))
        self._param("mix_B", mk(f"{prefix}.mix_B", (m, lora, d),
                                (None, None, "embed"), 0.0))
        for name in ("wr", "wk", "wv", "wg"):
            self._param(name, mk(f"{prefix}.{name}", (d, d),
                                 ("embed", "heads")))
        self._param("wo", mk(f"{prefix}.wo", (d, d), ("heads", "embed")))
        # decay: w_t = exp(-exp(decay_base + lora))
        self._param("decay_base", mk(f"{prefix}.decay_base", (d,),
                                     ("embed",), 0.0))
        self._param("decay_A", mk(f"{prefix}.decay_A", (d, lora),
                                  ("embed", None)))
        self._param("decay_B", mk(f"{prefix}.decay_B", (lora, d),
                                  (None, "embed"), 0.0))
        self._param("bonus_u", mk(f"{prefix}.bonus_u", (d,), ("embed",),
                                  0.5))
        self._param("gn.scale", mk(f"{prefix}.gn.scale", (d,), ("embed",),
                                   1.0))


class ChannelMix(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self._param("mix_k", mk(f"{prefix}.mix_k", (d,), ("embed",), 0.5))
        self._param("mix_r", mk(f"{prefix}.mix_r", (d,), ("embed",), 0.5))
        self._param("wk", mk(f"{prefix}.wk", (d, f), ("embed", "ff")))
        self._param("wv", mk(f"{prefix}.wv", (f, d), ("ff", "embed")))
        self._param("wr", mk(f"{prefix}.wr", (d, d), ("embed", "heads")))


# ---------------------------------------------------------------------------
# Recurrent state (the serving "cache")
# ---------------------------------------------------------------------------
def blank_state(cfg: ModelConfig, batch: int, layers: Optional[int],
                device) -> Tree:
    """Zero state: ``wkv`` (B, H, hd, hd) f32, ``tm_prev`` and ``cm_prev``
    (B, d) in the activations' dtype, with a leading layer axis when
    ``layers`` is given."""
    h = cfg.n_heads
    hd = cfg.d_model // h
    lead = () if layers is None else (layers,)
    act = cfg.activation_dtype
    return {
        "wkv": torch.zeros(lead + (batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "tm_prev": torch.zeros(lead + (batch, cfg.d_model), dtype=act,
                               device=device),
        "cm_prev": torch.zeros(lead + (batch, cfg.d_model), dtype=act,
                               device=device),
    }


def state_specs(cfg: ModelConfig, mk: Maker, batch: int,
                layers: Optional[int], name: str = "rwkv_state") -> Tree:
    """The state's leaves through a maker, as the reference's
    ``state_specs``."""
    h = cfg.n_heads
    hd = cfg.d_model // h
    lead = () if layers is None else (layers,)
    la = () if layers is None else ("layers",)
    return {
        "wkv": mk(f"{name}.wkv", lead + (batch, h, hd, hd),
                  la + ("batch", "heads_only", None, None), 0.0,
                  dtype_override=torch.float32),
        "tm_prev": mk(f"{name}.tm_prev", lead + (batch, cfg.d_model),
                      la + ("batch", "embed"), 0.0),
        "cm_prev": mk(f"{name}.cm_prev", lead + (batch, cfg.d_model),
                      la + ("batch", "embed"), 0.0),
    }


# ---------------------------------------------------------------------------
# TimeMix
# ---------------------------------------------------------------------------
def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with ``prev`` filling t = 0. x: (B, S, d), prev: (B, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _tm_project(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                prev: torch.Tensor, heads: Optional[int] = None):
    """r, k, v, g, w and u from the inputs (B, S, d), of ``heads`` heads
    (by default all; fewer where ``p`` holds a rank's columns)."""
    b, seq, d = x.shape
    h = heads or cfg.n_heads
    hd = d // cfg.n_heads
    delta = _token_shift(x, prev) - x
    # data-dependent mixing: mix_t = base + tanh(x A) B, per target
    low = torch.tanh(x @ p["mix_A"])
    dyn = torch.einsum("bsl,mld->mbsd", low, p["mix_B"])
    mixed = x[None] + delta[None] * (p["mix_base"][:, None, None] + dyn)
    xr, xk, xv, xg, xw = mixed.unbind(0)
    r = (xr @ p["wr"]).reshape(b, seq, h, hd)
    k = (xk @ p["wk"]).reshape(b, seq, h, hd)
    v = (xv @ p["wv"]).reshape(b, seq, h, hd)
    gate = xg @ p["wg"]
    g = gate * sigmoid(gate)               # jax.nn.silu
    logw = p["decay_base"] + torch.tanh(xw @ p["decay_A"]) @ p["decay_B"]
    w = torch.exp(-torch.exp(logw.float())).reshape(b, seq, h, hd)
    u = p["bonus_u"].reshape(h, hd)
    return r, k, v, g, w, u


# The WKV recurrence one step at a time in plain PyTorch (the reference's
# wkv_ref). r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd)
# f32. Returns y (B, S, H, hd) f32 and the final state.
wkv_ref = rwkv_ref.wkv


def tm_apply(p: Tree, cfg: ModelConfig, x: torch.Tensor, state: Tree,
             use_kernel: bool = False, heads: Optional[int] = None,
             product=None) -> Tuple[torch.Tensor, Tree]:
    """TimeMix over a sequence. ``state``: a :func:`blank_state` slice
    with no layer axis. The new ``tm_prev`` is the last row of ``x``.
    ``heads``: the heads ``p`` holds (a rank's, on a mesh), and
    ``product(y, wo)`` the output projection's place (the mesh's)."""
    b, seq, _ = x.shape
    h = heads or cfg.n_heads
    d = h * (cfg.d_model // cfg.n_heads)
    r, k, v, g, w, u = _tm_project(p, cfg, x, state["tm_prev"], h)
    if use_kernel:
        y, new_wkv = rwkv_ops.wkv(r, k, v, w, u, state["wkv"])
    else:
        y, new_wkv = wkv_ref(r.float(), k.float(), v.float(), w, u,
                             state["wkv"])
    y = y.reshape(b, seq, d).to(x.dtype)
    y = groupnorm_heads(p["gn.scale"], y, h, cfg.norm_eps) * g
    out = y @ p["wo"] if product is None else product(y, p["wo"])
    return out, dict(state, wkv=new_wkv, tm_prev=x[:, -1])


# ---------------------------------------------------------------------------
# ChannelMix
# ---------------------------------------------------------------------------
def cm_apply(p: Tree, cfg: ModelConfig, x: torch.Tensor,
             state: Tree) -> Tuple[torch.Tensor, Tree]:
    xs = _token_shift(x, state["cm_prev"])
    xk = x + (xs - x) * p["mix_k"]
    xr = x + (xs - x) * p["mix_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return out, dict(state, cm_prev=x[:, -1])


# ---------------------------------------------------------------------------
# On a mesh: the heads over ``model``
# ---------------------------------------------------------------------------
def tm_apply_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                     state: Tree, sh, use_kernel: bool = False
                     ) -> Tuple[torch.Tensor, Tree]:
    """:func:`tm_apply` on a mesh: each rank's heads (their columns of
    ``wr``/``wk``/``wv``/``wg``/``decay_B``, their channels of
    ``decay_base``/``bonus_u``/``gn.scale``, their rows of ``wo``; the
    WKV, through the kernel on the rank's heads, over its slice of the
    state), the output's parts summed in rank order; where the heads do
    not divide ``model``, the layer whole."""
    h = cfg.n_heads
    if not sh.splits(h):
        return tm_apply({k: sh.w(v) for k, v in p.items()}, cfg, x, state,
                        use_kernel)
    hd = cfg.d_model // h
    h0, h1 = sh.chunk(h)
    c0, c1 = h0 * hd, h1 * hd
    local = {}
    for k, v in p.items():
        if k in ("wr", "wk", "wv", "wg", "decay_B"):
            local[k] = sh.cols(v, c0, c1)
        elif k in ("decay_base", "bonus_u", "gn.scale"):
            local[k] = sh.cols(v, c0, c1, dim=0)
        elif k == "wo":
            local[k] = sh.cols(v, c0, c1, dim=0)
        else:
            local[k] = sh.w(v, tp=True)
    out, new = tm_apply(local, cfg, sh.enter(x), state, use_kernel,
                        heads=h1 - h0, product=sh.product)
    return sh.leave(out, x.dtype), new


def cm_apply_sharded(p: Tree, cfg: ModelConfig, x: torch.Tensor,
                     state: Tree, sh) -> Tuple[torch.Tensor, Tree]:
    """:func:`cm_apply` on a mesh: the key path's ``ff`` dim over
    ``model`` where it divides (the parts of ``k @ wv`` summed in rank
    order), the receptance gate whole."""
    xs = _token_shift(x, state["cm_prev"])
    xk = x + (xs - x) * sh.w(p["mix_k"])
    xr = x + (xs - x) * sh.w(p["mix_r"])
    f = cfg.d_ff
    if sh.splits(f):
        lo, hi = sh.chunk(f)
        k = torch.square(torch.relu(sh.enter(xk) @ sh.cols(p["wk"], lo, hi)))
        kv = sh.leave(sh.product(k, sh.cols(p["wv"], lo, hi, dim=0)),
                      x.dtype)
    else:
        kv = torch.square(torch.relu(xk @ sh.w(p["wk"]))) @ sh.w(p["wv"])
    out = sigmoid(xr @ sh.w(p["wr"])) * kv
    return out, dict(state, cm_prev=x[:, -1])
