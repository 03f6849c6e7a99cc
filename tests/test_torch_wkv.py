"""The port's WKV6 (its plain versions, and its wrapper on CPU tensors)
against the JAX reference.

Inputs are drawn with numpy and handed to both packages. The reference's
``ops.wkv`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it. Tolerances:

- the sequential oracles (``ref.wkv`` in both packages): the same f32
  recurrence, einsums summed in another order; measured at most 1.5e-5 on
  |y| <= 103, held to atol 1e-4, rtol 1e-5;
- the chunked form (the port's ``wkv_chunked`` behind ``ops.wkv``) against
  the reference's Pallas body: the same chunked f32 algorithm, cumsum and
  products summed in another order; measured at most 7.4e-5 on |y| <= 103,
  held to atol 2e-4, rtol 1e-5;
- chunked against sequential (one formulation against the other): the
  reference's own kernel tolerance, atol 1e-3, rtol 2e-3; with strong
  decays atol 1e-2, because the chunk's cumsum of log w reaches about
  -1760 there, where an f32 ulp is 1.2e-4, and the pairwise exponents
  L_prev - L carry that much error (2.7e-3 against an f64 oracle at
  S = 1024, where the sequential recurrence is 3.7e-5 off).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6 import ops as j_ops
from repro.kernels.rwkv6 import ref as j_ref
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.rwkv6 import ops, ref, rwkv6

SEQ_TOL = dict(atol=1e-4, rtol=1e-5)
CHUNK_TOL = dict(atol=2e-4, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-3, rtol=2e-3)
STRONG_TOL = dict(atol=1e-2, rtol=2e-3)

# tests/test_kernels.py's shapes: (B, S, H, hd, chunk)
REF_SHAPES = [(2, 64, 3, 16, 32), (1, 128, 2, 64, 32), (2, 37, 1, 8, 32),
              (1, 32, 4, 32, 8)]


def _inputs(b, s, h, hd, seed, lo=-4.0, hi=1.0):
    """r, k, v ~ N(0, 1), w = exp(-exp(U(lo, hi))), u ~ 0.5 N(0, 1),
    state ~ 0.1 N(0, 1), as the reference's kernel test draws them."""
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(g.uniform(lo, hi, (b, s, h, hd)))).astype(np.float32)
    u = (g.standard_normal((h, hd)) * 0.5).astype(np.float32)
    s0 = (g.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("b,s,h,hd,chunk", REF_SHAPES)
def test_sequential_matches_reference(b, s, h, hd, chunk):
    arrays = _inputs(b, s, h, hd, b * s + hd)
    _close(ref.wkv(*_t(arrays)), j_ref.wkv(*_j(arrays)), SEQ_TOL)


@pytest.mark.parametrize("b,s,h,hd,chunk", REF_SHAPES)
def test_ops_matches_reference_kernel(b, s, h, hd, chunk):
    """ops.wkv on CPU tensors (pad, layout, wkv_chunked) against the
    reference's ops.wkv (its Pallas kernel, interpret mode), and both
    against the sequential oracle."""
    arrays = _inputs(b, s, h, hd, b * s + hd)
    got = ops.wkv(*_t(arrays), chunk=chunk)
    assert got[0].shape == (b, s, h, hd) and got[1].shape == (b, h, hd, hd)
    assert got[0].dtype == got[1].dtype == torch.float32
    _close(got, j_ops.wkv(*_j(arrays), chunk=chunk), CHUNK_TOL)
    _close(got, ref.wkv(*_t(arrays)), KERNEL_TOL)
    _close(ops.wkv(*_t(arrays), force_ref=True), ref.wkv(*_t(arrays)),
           dict(atol=0, rtol=0))


def test_state_carry_composes():
    """wkv(AB) == wkv(B) after wkv(A), through the padding of both halves
    (tests/test_kernels.py's composition case, and the reference's
    result)."""
    b, s, h, hd = 1, 64, 2, 16
    r, k, v, w, u, _ = _inputs(b, s, h, hd, 7, -3.0, 0.5)
    s0 = np.zeros((b, h, hd, hd), np.float32)
    whole = ops.wkv(*_t((r, k, v, w, u, s0)))
    half = s // 2
    first = _t((r[:, :half], k[:, :half], v[:, :half], w[:, :half]))
    second = _t((r[:, half:], k[:, half:], v[:, half:], w[:, half:]))
    y1, s1 = ops.wkv(*first, torch.from_numpy(u), torch.from_numpy(s0))
    y2, s2 = ops.wkv(*second, torch.from_numpy(u), s1)
    _close((torch.cat([y1, y2], 1), s2), whole, KERNEL_TOL)
    _close(whole, j_ops.wkv(*_j((r, k, v, w, u, s0))), CHUNK_TOL)
    # halves that are not chunk multiples go through the padding
    cut = 21
    y1, s1 = ops.wkv(*_t((r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut])),
                     torch.from_numpy(u), torch.from_numpy(s0))
    y2, s2 = ops.wkv(*_t((r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:])),
                     torch.from_numpy(u), s1)
    _close((torch.cat([y1, y2], 1), s2), whole, KERNEL_TOL)


@pytest.mark.parametrize("lo,hi,tol", [(-4.0, 1.0, KERNEL_TOL),
                                       (2.0, 4.0, STRONG_TOL)])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_matches_sequential(lo, hi, tol, chunk):
    """wkv_chunked against the sequential oracle at the serve length, one
    batch row of three heads; finite at strong decays."""
    r, k, v, w, u, s0 = _inputs(1, 1024, 3, 64, 11, lo, hi)
    y, s = ops.wkv(*_t((r, k, v, w, u, s0)), chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close((y, s), ref.wkv(*_t((r, k, v, w, u, s0))), tol)


def test_chunked_at_the_clamp():
    """w below the 1e-38 floor (0 and subnormals) is taken at the floor:
    the state forgets at once, as the sequential recurrence does with the
    true w, and nothing overflows."""
    r, k, v, w, u, s0 = _inputs(2, 64, 2, 16, 3)
    w[:, ::3] = 0.0
    w[:, 1::7] = 1e-40
    w[:, 2::5] = 1.0
    y, s = ops.wkv(*_t((r, k, v, w, u, s0)))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close((y, s), ref.wkv(*_t((r, k, v, w, u, s0))), KERNEL_TOL)


def test_padding_leaves_the_state_unchanged():
    """Rows padded with w = 1, r = k = v = 0 change neither y nor the
    state: the kernel layout with S = 37 equals the same rows run as 37
    sequential steps."""
    r, k, v, w, u, s0 = _inputs(2, 37, 3, 8, 5)
    y, s = ops.wkv(*_t((r, k, v, w, u, s0)), chunk=8)
    assert y.shape == (2, 37, 3, 8)
    _close((y, s), ref.wkv(*_t((r, k, v, w, u, s0))), KERNEL_TOL)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    bh, s, d = 4, 64, 16
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(bh, s, d, generator=g) for _ in range(3)]
    args.append(torch.rand(bh, s, d, generator=g))
    args += [torch.randn(bh, d, generator=g), torch.randn(bh, d, d,
                                                          generator=g)]
    before = LAUNCHES["wkv"]
    got = rwkv6.wkv_kernel(*args, chunk=16)
    want = ref.wkv_chunked(*args, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES["wkv"] == before


def _kernel_args(bh=2, s=64, d=16):
    g = torch.Generator().manual_seed(1)
    return ([torch.randn(bh, s, d, generator=g) for _ in range(4)]
            + [torch.randn(bh, d, generator=g),
               torch.randn(bh, d, d, generator=g)])


@pytest.mark.parametrize("case,match", [
    ("bf16", "must be f32"),
    ("seq", "not a multiple of the chunk"),
    ("hd", "head size 24"),
    ("chunk", "chunk 64"),
    ("shape", r"u must be \(2, 16\)"),
    ("strided", "must be contiguous"),
    ("layout", r"want r of \(BH, S, D\)")])
def test_wrapper_refuses(case, match):
    args, chunk = _kernel_args(), 32
    if case == "bf16":
        args[1] = args[1].bfloat16()
    elif case == "seq":
        args = _kernel_args(s=48)
    elif case == "hd":
        args = _kernel_args(d=24)
    elif case == "chunk":
        chunk = 64
    elif case == "shape":
        args[4] = args[4][:, :8].contiguous()
    elif case == "strided":
        args[2] = torch.randn(2, 16, 64).transpose(1, 2)
    elif case == "layout":
        args[0] = args[0][None]
    with pytest.raises(ValueError, match=match):
        rwkv6.wkv_kernel(*args, chunk=chunk)
