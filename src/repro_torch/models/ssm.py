"""Mamba-style selective SSM branch of the hymba hybrid mixer.

Port of ``repro/models/ssm.py``. The diagonal selective scan::

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t x_t)
    y_t = C_t^T h_t + D * x_t

with ``dt`` data-dependent (softplus) and ``A = -exp(log_a)``.
:class:`SSM` holds the parameters under the reference's keys;
:func:`apply_seq` (a sequence, by ``SSM_CHUNK`` chunks) and
:func:`apply_step` (one decode token) compute from its ``tree()``.

The reference's numbers are those of its compiled (jitted) form, and this
module follows them:

- the scan is :func:`associative_scan`, which recurses as
  ``lax.associative_scan`` does (adjacent pairs combined, the odd half
  scanned, the evens filled in): O(log S) steps, not S. The compiled
  combine ``A2 * b1 + b2`` is one fused multiply-add, and so is the
  carry-in ``dBx[0] + dA[0] * h0``, so both go through
  :func:`~repro_torch.models.common.fma`; so are the conv's adds and the
  ``D * x`` skip, as XLA contracts them;
- ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes
  it (``torch.nn.functional.softplus`` switches to ``x`` above a
  threshold);
- ``silu`` is ``x * sigmoid(x)`` with the reference's sigmoid
  (:func:`~repro_torch.models.common.sigmoid`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import (Maker, ModelConfig, Params, Tree, fma, rmsnorm_1d,
                     sigmoid)

# Positions per sequential chunk of the state scan: the (B, T, di, n) f32
# tensors exist one chunk at a time.
SSM_CHUNK = 256


class SSM(Params):
    def __init__(self, cfg: ModelConfig, mk: Maker, prefix: str):
        super().__init__()
        d, n = cfg.d_model, cfg.ssm_state
        di = cfg.ssm_expand * d
        self._param("win", mk(f"{prefix}.win", (d, 2 * di), ("embed", "ff")))
        self._param("conv", mk(f"{prefix}.conv", (cfg.conv_width, di),
                               (None, "ff"), 0.5))
        self._param("wbc", mk(f"{prefix}.wbc", (di, 2 * n), ("ff", None)))
        self._param("wdt", mk(f"{prefix}.wdt", (di, 1), ("ff", None)))
        self._param("dt_bias", mk(f"{prefix}.dt_bias", (di,), ("ff",), 0.0))
        self._param("log_a", mk(f"{prefix}.log_a", (di, n), ("ff", None),
                                0.1))
        self._param("skip_d", mk(f"{prefix}.skip_d", (di,), ("ff",), 0.5))
        self._param("wout", mk(f"{prefix}.wout", (di, d), ("ff", "embed")))
        self._param("norm.scale", mk(f"{prefix}.norm.scale", (di,), ("ff",),
                                     1.0))


def blank_state(cfg: ModelConfig, batch: int, layers: Optional[int],
                device) -> Tree:
    """Zero state: ``h`` (B, di, n) f32 and ``conv`` (B, W - 1, di) in the
    activations' dtype, with a leading layer axis when ``layers`` is
    given."""
    di = cfg.ssm_expand * cfg.d_model
    lead = () if layers is None else (layers,)
    return {
        "h": torch.zeros(lead + (batch, di, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, di),
                            dtype=cfg.activation_dtype, device=device),
    }


def state_specs(cfg: ModelConfig, mk: Maker, batch: int,
                layers: Optional[int], name: str = "ssm_state") -> Tree:
    """The state's leaves through a maker, as the reference's
    ``state_specs``."""
    di = cfg.ssm_expand * cfg.d_model
    lead = () if layers is None else (layers,)
    la = () if layers is None else ("layers",)
    return {
        "h": mk(f"{name}.h", lead + (batch, di, cfg.ssm_state),
                la + ("batch", "ff", None), 0.0,
                dtype_override=torch.float32),
        "conv": mk(f"{name}.conv", lead + (batch, cfg.conv_width - 1, di),
                   la + ("batch", None, "ff"), 0.0),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(conv: torch.Tensor, x: torch.Tensor, prev: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d of x (B, S, di) with ``prev`` (B, W-1, di)
    as left context; returns (out, the new left context)."""
    w = conv.shape[0]
    s = x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)
    taps = [xp[:, i:i + s] for i in range(w)]
    if x.dtype != torch.float32 or w == 1:
        out = taps[0] * conv[0]
        for i in range(1, w):
            out = out + taps[i] * conv[i]
    else:
        # the compiled reference fuses each add with a product: the first
        # with its left one (p0 + p1 = fma(x0, c0, p1)), the later ones
        # with the new tap's
        out = fma(taps[0], conv[0].expand_as(taps[0]), taps[1] * conv[1])
        for i in range(2, w):
            out = fma(taps[i], conv[i].expand_as(taps[i]), out)
    return out, (xp[:, -(w - 1):] if w > 1 else prev)


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h of the inclusive scan h_t = a_t h_{t-1} + b_t over dim 1 (h_0 =
    b_0), combined as ``lax.associative_scan`` combines (a1, b1) then
    (a2, b2) into (a1 a2, a2 b1 + b2), the add fused: adjacent pairs, the
    odd positions by recursion on them, then the even ones. The a part of
    the even positions feeds no h, so it is not formed; every h is the
    reference's arithmetic."""
    n = a.shape[1]
    if n < 2:
        return b
    a_hi = a[:, 1::2]
    odd = associative_scan(a[:, 0:n - 1:2] * a_hi,
                           fma(a_hi, b[:, 0:n - 1:2], b[:, 1::2]))
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    h[:, 1::2] = odd
    if n > 2:
        a_ev = a[:, 2::2]
        h[:, 2::2] = fma(a_ev, odd[:, :a_ev.shape[1]], b[:, 2::2])
    return h


def scan_block(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor
               ) -> torch.Tensor:
    """h (B, T, di, n) of h_t = dA_t h_{t-1} + dBx_t from h0 (B, di, n)."""
    first = fma(dA[:, 0], h0, dBx[:, 0])
    dBx = torch.cat([first[:, None], dBx[:, 1:]], dim=1)
    return associative_scan(dA, dBx)


def _chunk_y(dt, xf, bm, cm, a, h0):
    """One chunk: (y (B, T, di) f32, its last state)."""
    dA = torch.exp(dt[..., None] * a)
    dBx = (dt * xf)[..., None] * bm[:, :, None, :]
    h = scan_block(dA, dBx, h0)
    return torch.einsum("btdn,btn->btd", h, cm), h[:, -1]


def apply_seq(p: Tree, cfg: ModelConfig, x: torch.Tensor, state: Tree
              ) -> Tuple[torch.Tensor, Tree]:
    """The SSM branch over a sequence: x (B, S, d) -> (B, S, d) and the
    new state. Sequences longer than ``SSM_CHUNK`` (and a multiple of it)
    are scanned chunk by chunk, the state carried between chunks."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    xin, z = (x @ p["win"]).chunk(2, dim=-1)
    xin, conv_state = _causal_conv(p["conv"], xin, state["conv"])
    xin = silu(xin)
    bm, cm = (xin @ p["wbc"]).float().split(n, dim=-1)
    dt = softplus((xin @ p["wdt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["log_a"].float())
    xf = xin.float()
    if s > SSM_CHUNK and s % SSM_CHUNK == 0:
        h, ys = state["h"], []
        for i in range(0, s, SSM_CHUNK):
            sl = slice(i, i + SSM_CHUNK)
            yc, h = _chunk_y(dt[:, sl], xf[:, sl], bm[:, sl], cm[:, sl], a,
                             h)
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    else:
        y, h = _chunk_y(dt, xf, bm, cm, a, state["h"])
    y = fma(p["skip_d"].float().expand_as(xf), xf, y)
    y = y.to(x.dtype) * silu(z)
    y = rmsnorm_1d(p["norm.scale"], y, cfg.norm_eps)
    return y @ p["wout"], {"h": h, "conv": conv_state}


def apply_step(p: Tree, cfg: ModelConfig, x: torch.Tensor, state: Tree
               ) -> Tuple[torch.Tensor, Tree]:
    """One decode token: x (B, 1, d) -> (B, 1, d) and the new state."""
    n = cfg.ssm_state
    xin, z = (x[:, 0] @ p["win"]).chunk(2, dim=-1)
    window = torch.cat([state["conv"].to(xin.dtype), xin[:, None]], dim=1)
    xin = silu(torch.einsum("bwd,wd->bd", window, p["conv"]))
    bm, cm = (xin @ p["wbc"]).float().split(n, dim=-1)
    dt = softplus((xin @ p["wdt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["log_a"].float())
    dA = torch.exp(dt[..., None] * a)
    xf = xin.float()
    h = fma(dA, state["h"], (dt * xf)[..., None] * bm[:, None, :])
    y = fma(p["skip_d"].float().expand_as(xf), xf,
            torch.einsum("bdn,bn->bd", h, cm))
    y = y.to(x.dtype) * silu(z)
    y = rmsnorm_1d(p["norm.scale"], y, cfg.norm_eps)
    return (y @ p["wout"])[:, None], {"h": h, "conv": window[:, 1:]}
