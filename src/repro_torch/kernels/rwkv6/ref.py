"""Plain PyTorch WKV6: the versions beside the CUDA kernel.

The recurrence, per head, with an (hd x hd) f32 state S::

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

:func:`wkv` is the sequential oracle in the model's layout (B, S, H, hd),
as ``repro/kernels/rwkv6/ref.py::wkv``. :func:`wkv_chunked` is the chunked
form that ``repro/kernels/rwkv6/rwkv6.py::_wkv_kernel`` computes, step for
step, in the layout (BH, S, D). :func:`wkv_subchunked` is the same function
in the form the CUDA kernel computes: the chunk's intra term split at
sub-chunks of 8 tokens, exact pairwise only inside them.
"""
from __future__ import annotations

from typing import Tuple

import torch

# the floor of w before its log, as in the Pallas kernel
W_FLOOR = 1e-38


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd).
    Returns y (B, S, H, hd) f32 and the final state f32, one step at a
    time."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w: (BH, S, D) f32 with S % chunk == 0; u: (BH, D); s0:
    (BH, D, D). Returns y (BH, S, D) and s_out (BH, D, D), f32.

    Per chunk of T tokens, with L the inclusive cumsum of log w over the
    chunk and L_prev = L - log w: r~ = r e^{L_prev}, k^ = k e^{L_T - L};
    y = r~ S + (pairwise intra term) v + (r u k) v; S <- e^{L_T} S + k^T v.
    The intra term is the exact pairwise sum over i < t of
    sum_k r_tk k_ik e^{L_prev,tk - L_ik}, every exponent <= 0, so strong
    decays cannot overflow."""
    bh, seq, d = r.shape
    strict = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=r.device).tril(-1)
    s = s0.clone()
    ys = []
    for c0 in range(0, seq, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=W_FLOOR))
        big_l = torch.cumsum(logw, dim=1)
        l_prev = big_l - logw
        l_t = big_l[:, -1]
        r_t = rc * torch.exp(l_prev)
        k_hat = kc * torch.exp(l_t[:, None, :] - big_l)
        inter = torch.matmul(r_t, s)
        dl = l_prev[:, :, None, :] - big_l[:, None, :, :]
        dl = torch.where(strict[None, :, :, None], dl,
                         torch.tensor(float("-inf"), device=r.device))
        scores = (rc[:, :, None, :] * kc[:, None, :, :]
                  * torch.exp(dl)).sum(-1)
        intra = torch.matmul(scores, vc)
        diag = (rc * u[:, None, :] * kc).sum(-1, keepdim=True)
        ys.append(inter + intra + diag * vc)
        s = torch.exp(l_t)[:, :, None] * s + torch.matmul(
            k_hat.transpose(1, 2), vc)
    return torch.cat(ys, dim=1), s


# tokens per sub-chunk of wkv_subchunked (and of csrc/wkv.cuh)
SUB = 8


def wkv_subchunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                   chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`wkv_chunked`'s arguments and result; chunk a multiple of
    :data:`SUB`. Per chunk the intra term is one (T x T) matrix ``a``
    applied to v, with the bonus r.u.k on its diagonal. Inside a sub-chunk
    its pairs are the exact pairwise sum. A pair (t, i) that straddles the
    end e = 8q + 7 of i's sub-chunk q factors there::

        e^{L_prev,t - L_i} = e^{L_prev,t - L_e} e^{L_e - L_i}

    both exponents <= 0, so block (t >= 8(q + 1), i in q) of ``a`` is a
    product of r scaled to e and k scaled from e, overflow-free at any
    decay; exponentials per chunk fall from T(T - 1)/2 to about 184 per
    channel at T = 32."""
    bh, seq, d = r.shape
    if chunk % SUB:
        raise ValueError(f"wkv_subchunked: chunk {chunk} is not a multiple "
                         f"of {SUB}")
    strict = torch.ones(SUB, SUB, dtype=torch.bool,
                        device=r.device).tril(-1)
    eye = torch.eye(chunk, dtype=torch.bool, device=r.device)
    s = s0.clone()
    ys = []
    for c0 in range(0, seq, chunk):
        rc, kc, vc, wc = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=W_FLOOR))
        big_l = torch.cumsum(logw, dim=1)
        l_prev = big_l - logw
        l_t = big_l[:, -1]
        a = torch.zeros(bh, chunk, chunk, dtype=r.dtype, device=r.device)
        for p in range(0, chunk, SUB):
            blk = slice(p, p + SUB)
            dl = l_prev[:, blk, None, :] - big_l[:, None, blk, :]
            dl = torch.where(strict[None, :, :, None], dl,
                             torch.tensor(float("-inf"), device=r.device))
            a[:, blk, blk] = (rc[:, blk, None, :] * kc[:, None, blk, :]
                              * torch.exp(dl)).sum(-1)
        for q in range(0, chunk - SUB, SUB):
            e = q + SUB - 1
            r_e = rc[:, e + 1:] * torch.exp(l_prev[:, e + 1:]
                                            - big_l[:, e:e + 1])
            k_e = kc[:, q:e + 1] * torch.exp(big_l[:, e:e + 1]
                                             - big_l[:, q:e + 1])
            a[:, e + 1:, q:e + 1] = torch.matmul(r_e, k_e.transpose(1, 2))
        a = torch.where(eye, (rc * u[:, None, :] * kc).sum(-1)[:, :, None],
                        a)
        r_t = rc * torch.exp(l_prev)
        k_hat = kc * torch.exp(l_t[:, None, :] - big_l)
        ys.append(torch.matmul(r_t, s) + torch.matmul(a, vc))
        s = torch.exp(l_t)[:, :, None] * s + torch.matmul(
            k_hat.transpose(1, 2), vc)
    return torch.cat(ys, dim=1), s
