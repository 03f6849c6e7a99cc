"""The port's WKV6 (its plain versions, and its wrapper on CPU tensors)
against the JAX reference.

Inputs are drawn with numpy and handed to both packages. The reference's
``ops.wkv`` runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it. Tolerances:

- the sequential oracles (``ref.wkv`` in both packages): the same f32
  recurrence, einsums summed in another order; measured at most 1.5e-5 on
  |y| <= 103, held to atol 1e-4, rtol 1e-5;
- the chunked forms against the reference's Pallas body: ``wkv_chunked``,
  the same chunked f32 algorithm, cumsum and products summed in another
  order, measured at most 7.4e-5 on |y| <= 103 (``wkv_chunked`` is also
  what ``ops.wkv`` runs on CPU tensors); ``wkv_subchunked`` (the CUDA
  kernel's form), whose pairs across sub-chunks take e^{a} e^{b} for
  e^{a + b}, at most 6.8e-5; both held to atol 2e-4, rtol 1e-5;
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
    """On CPU tensors in the model's layout the wrapper runs the kernel's
    plain version, wkv_chunked, and counts no launch."""
    b, s, h, hd = 2, 64, 2, 16
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(b, s, h, hd, generator=g) for _ in range(3)]
    args.append(torch.rand(b, s, h, hd, generator=g))
    args += [torch.randn(h, hd, generator=g),
             torch.randn(b, h, hd, hd, generator=g)]
    before = LAUNCHES["wkv"]
    y, s_out = rwkv6.wkv_kernel(*args, chunk=16)
    bh = [a.transpose(1, 2).reshape(b * h, s, hd) for a in args[:4]]
    want_y, want_s = ref.wkv_chunked(
        *bh, args[4][None].expand(b, h, hd).reshape(b * h, hd),
        args[5].reshape(b * h, hd, hd), chunk=16)
    assert y.shape == (b, s, h, hd) and y.is_contiguous()
    assert torch.equal(y, want_y.reshape(b, h, s, hd).transpose(1, 2))
    assert torch.equal(s_out, want_s.reshape(b, h, hd, hd))
    assert LAUNCHES["wkv"] == before


def test_wrapper_takes_the_model_layout():
    """bf16 r, k, v and u as the served model makes them give what their
    f32 values give; so do views (a head slice, an S slice off the base)
    and ops.wkv on them."""
    arrays = _inputs(2, 64, 3, 16, 21)
    r, k, v, w, u, s0 = _t(arrays)
    bf = [a.bfloat16() for a in (r, k, v, u)]
    got = rwkv6.wkv_kernel(bf[0], bf[1], bf[2], w, bf[3], s0)
    want = rwkv6.wkv_kernel(*(a.float() for a in bf[:3]), w,
                            bf[3].float(), s0)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert all(torch.equal(a, c) for a, c in zip(
        ops.wkv(bf[0], bf[1], bf[2], w, bf[3], s0), want))
    big = torch.cat([r, k, v], 2)          # (2, 64, 9, 16): heads in thirds
    views = [big[:, :, 3 * i:3 * i + 3] for i in range(3)]
    assert not views[1].is_contiguous()
    got = rwkv6.wkv_kernel(*views, w, u, s0)
    want = rwkv6.wkv_kernel(r, k, v, w, u, s0)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    got = rwkv6.wkv_kernel(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s0)
    want = rwkv6.wkv_kernel(*(a[:, 32:].contiguous() for a in (r, k, v, w)),
                            u, s0)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.parametrize("b,s,h,hd,chunk", REF_SHAPES)
def test_subchunked_matches_reference_kernel(b, s, h, hd, chunk):
    """wkv_subchunked in the kernel's layout against the reference's
    Pallas body (interpret mode), S = 37 padded as ops.wkv pads it."""
    arrays = _inputs(b, s, h, hd, b * s + hd)
    pad = (-s) % chunk
    r, k, v, w = (np.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)),
                         constant_values=cv)
                  for a, cv in zip(arrays[:4], (0, 0, 0, 1)))
    bh = [torch.from_numpy(a).transpose(1, 2).reshape(b * h, s + pad, hd)
          for a in (r, k, v, w)]
    y, st = ref.wkv_subchunked(
        *bh, torch.from_numpy(arrays[4])[None].expand(b, h, hd).reshape(
            b * h, hd),
        torch.from_numpy(arrays[5]).reshape(b * h, hd, hd), chunk=chunk)
    y = y.reshape(b, h, s + pad, hd).transpose(1, 2)[:, :s]
    _close((y, st.reshape(b, h, hd, hd)),
           j_ops.wkv(*_j(arrays), chunk=chunk), CHUNK_TOL)


@pytest.mark.parametrize("lo,hi,tol", [(-4.0, 1.0, KERNEL_TOL),
                                       (2.0, 4.0, STRONG_TOL)])
def test_subchunked_matches_sequential(lo, hi, tol):
    """wkv_subchunked against the sequential oracle, one head at S = 1024,
    where strong decays take the chunk's cumsum to about -1760; finite."""
    r, k, v, w, u, s0 = _t(_inputs(1, 1024, 1, 64, 13, lo, hi))
    y, st = ref.wkv_subchunked(*(a[:, :, 0] for a in (r, k, v, w)), u,
                               s0[:, 0], chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    _close((y[:, :, None], st[:, None]), ref.wkv(r, k, v, w, u, s0), tol)


def _kernel_args(b=2, s=64, h=2, hd=16):
    g = torch.Generator().manual_seed(1)
    return ([torch.randn(b, s, h, hd, generator=g) for _ in range(4)]
            + [torch.randn(h, hd, generator=g),
               torch.randn(b, h, hd, hd, generator=g)])


@pytest.mark.parametrize("case,match", [
    ("bf16", "must be f32"),
    ("seq", "not a multiple of the chunk"),
    ("hd", "head size 24"),
    ("chunk", "chunk 64"),
    ("shape", r"u must be \(2, 16\)"),
    ("strided", "must be contiguous"),
    ("layout", r"want r of \(B, S, H, hd\)"),
    ("mixed", "share one dtype"),
    ("u_dtype", "u must be one of"),
    ("last_dim", "last dim must be contiguous"),
    ("align", "multiples of 16 bytes")])
def test_wrapper_refuses(case, match):
    """Inputs the kernel cannot take raise, naming the reason; nothing is
    copied to make them fit."""
    args, chunk = _kernel_args(), 32
    if case == "bf16":
        args[3] = args[3].bfloat16()             # w is read in f32
    elif case == "seq":
        args = _kernel_args(s=48)
    elif case == "hd":
        args = _kernel_args(hd=24)
    elif case == "chunk":
        chunk = 64
    elif case == "shape":
        args[4] = args[4][:, :8].contiguous()
    elif case == "strided":
        args[5] = args[5].transpose(2, 3)        # the state is read as is
    elif case == "layout":
        args[0] = args[0][0]
    elif case == "mixed":
        args[1] = args[1].bfloat16()
    elif case == "u_dtype":
        args[4] = args[4].half()
    elif case == "last_dim":
        args[2] = torch.randn(2, 64, 2, 32)[..., ::2]
    elif case == "align":
        args[0] = torch.randn(2 * 64 * 2 * 16 + 1)[1:].view(2, 64, 2, 16)
    with pytest.raises(ValueError, match=match):
        rwkv6.wkv_kernel(*args, chunk=chunk)
