"""The port's attention layer (rope, MLP, masks, the SDPA paths, attend,
decode over the ring cache) and its flash-attention wrapper on CPU
tensors, against the JAX reference.

Inputs are drawn with numpy and handed to both packages. The reference's
``flash_attention`` runs its Pallas kernel in interpret mode with 32-row
blocks, as ``tests/test_kernels.py`` runs it; on CPU tensors the port's
wrapper runs its plain version, ``ref.attention``. Tolerances:

- flash attention: the reference's own, atol 2e-5 / rtol 1e-4 in f32 and
  2e-2 in bf16 (``tests/test_kernels.py``);
- f32 modules: the same arithmetic, with sums in another order and
  PyTorch's CPU ``cos``, ``sin``, ``tanh`` and ``exp`` an ulp from XLA's
  (ROADMAP Queue C): held to atol 1e-5, rtol 1e-5 (rope angles: atol
  1e-6);
- bf16 modules: the MLP's activations and the rope rotation round as the
  reference's (bit-equal on the same inputs); an ulp of f32 in a cos or sin
  flips a bf16 rounding of the rotated q or k now and then (an ulp of bf16
  is 0.4 %), and the attention sums in another order: measured at most
  3.4e-3 (relative L2), held to 1e-2.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro.models import mlp as j_mlp
from repro.models import rope as j_rope
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention as fa_k
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import Model, attention, mlp, rope

FLASH_F32 = dict(atol=2e-5, rtol=1e-4)
FLASH_BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's flash shapes: (B, S, H, Kv, hd)
FLASH_SHAPES = [(1, 64, 4, 4, 16), (2, 96, 8, 2, 32), (1, 64, 4, 1, 16),
                (1, 50, 4, 2, 16), (2, 64, 6, 3, 64)]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(dtype, got, want):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert _rel(got, want) <= BF16_REL


def _qkv(b, sq, sk, h, kv, hd, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, sq, h, hd)).astype(np.float32),
            g.standard_normal((b, sk, kv, hd)).astype(np.float32),
            g.standard_normal((b, sk, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,kv,hd", FLASH_SHAPES)
def test_flash_matches_reference(b, s, h, kv, hd):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, h, kv, hd, s + h + kv),
                                       "f32")
    scale = 1.0 / hd ** 0.5
    want_k = j_fa_ops.flash_attention(jq, jk, jv, causal=True, scale=scale,
                                      bq=32, bk=32)
    want_r = j_fa_ref.attention(jq, jk, jv, causal=True, scale=scale)
    before = LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, scale=scale)
    got_r = fa_ref.attention(tq, tk, tv, causal=True, scale=scale)
    assert LAUNCHES["flash_attention"] == before
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    for g_, w_ in ((got, want_k), (got, want_r), (got_r, want_r)):
        np.testing.assert_allclose(_np(g_), _np(w_), **FLASH_F32)


def test_tf32_split_matches_the_kernels():
    """ref.tf32_split is tf32x3.cuh's split: hi has no bits below tf32's
    10, lo no bits below the tensor core's read, and hi + lo is within
    2^-21 of x (lo's cut bits) where hi alone is 2^-11 off."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32) * 3)
    hi, lo = fa_ref.tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((x - hi - lo).abs() / x.abs()).max()) <= 2.0 ** -21
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("causal", [True, False])
def test_flash_3xtf32_emulation_within_f32_tolerance(causal):
    """The f32 kernel's products in 3xTF32 (emulated on the CPU with the
    kernel's split) stay within the reference's f32 tolerance of
    ref.attention and of the reference's plain version at the width of
    yi-9b's heads (hd 128, S 512, GQA 4:1): the headroom the card must
    keep. Plain TF32 (the hi parts alone) misses it."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 512, 512, 8, 2, 128, 11),
                                       "f32")
    scale = 1.0 / 128 ** 0.5
    emu = fa_ref.attention_tf32x3(tq, tk, tv, causal=causal, scale=scale)
    want = fa_ref.attention(tq, tk, tv, causal=causal, scale=scale)
    np.testing.assert_allclose(_np(emu), _np(want), **FLASH_F32)
    np.testing.assert_allclose(
        _np(emu), _np(j_fa_ref.attention(jq, jk, jv, causal=causal,
                                         scale=scale)), **FLASH_F32)
    assert float((emu - want).abs().max()) <= FLASH_F32["atol"] / 4
    hi = [fa_ref.tf32_split(t)[0] for t in (tq, tk, tv)]
    plain_tf32 = fa_ref.attention(*hi, causal=causal, scale=scale)
    assert not torch.allclose(plain_tf32, want, **FLASH_F32)


def test_flash_bf16_inputs():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 64, 64, 4, 4, 32, 0), "bf16")
    want = j_fa_ops.flash_attention(jq, jk, jv, causal=True, scale=0.17,
                                    bq=32, bk=32)
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, scale=0.17)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_BF16)
    np.testing.assert_allclose(
        _np(got), _np(j_fa_ref.attention(jq, jk, jv, causal=True,
                                         scale=0.17)), **FLASH_BF16)


def test_flash_first_row_attends_only_self():
    _, (tq, tk, tv) = _both(_qkv(1, 32, 32, 2, 2, 16, 3), "f32")
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, scale=1.0)
    np.testing.assert_allclose(_np(got[:, 0]), _np(tv[:, 0]), atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(50, 50), (17, 70), (70, 17)])
def test_flash_ragged_and_noncausal_match_reference(causal, sq, sk):
    """Sq != Sk (both counted from 0, as the reference masks them) and
    full attention, against the reference's plain version."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, sq, sk, 4, 2, 16, sq + sk),
                                       "f32")
    want = j_fa_ref.attention(jq, jk, jv, causal=causal, scale=0.25)
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal, scale=0.25)
    np.testing.assert_allclose(_np(got), _np(want), **FLASH_F32)


@pytest.mark.parametrize("force_ref", [False, True])
def test_flash_routes_agree_and_count_no_launch_on_cpu(force_ref):
    _, (tq, tk, tv) = _both(_qkv(2, 96, 96, 8, 2, 32, 5), "f32")
    before = LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, scale=0.3,
                                 force_ref=force_ref)
    assert LAUNCHES["flash_attention"] == before
    assert torch.equal(got, fa_ref.attention(tq, tk, tv, causal=True,
                                             scale=0.3))


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    _, (q, k, v) = _both(_qkv(1, 8, 8, 4, 2, 16, 6), "f32")
    with pytest.raises(ValueError, match="head size"):
        fa_k.flash_attention_kernel(q[..., :8], k[..., :8], v[..., :8],
                                    scale=1.0, causal=True)
    with pytest.raises(ValueError, match="dtype"):
        fa_k.flash_attention_kernel(q, k.double(), v, scale=1.0,
                                    causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        fa_k.flash_attention_kernel(q.transpose(2, 3), k, v, scale=1.0,
                                    causal=True)
    with pytest.raises(ValueError, match="group"):
        fa_k.flash_attention_kernel(q[:, :, :3], k, v, scale=1.0,
                                    causal=True)
    # strided views of the model's layout are taken as they are
    got = fa_k.flash_attention_kernel(q[:, ::2], k[:, ::2], v[:, ::2],
                                      scale=1.0, causal=True)
    assert torch.equal(got, fa_ref.attention(q[:, ::2], k[:, ::2],
                                             v[:, ::2], causal=True,
                                             scale=1.0))


# (storage offset, strides) of a (2, 8, 4, 16) view whose base address or
# one of whose batch, sequence and head strides is not a multiple of 16
# bytes in bf16
MISALIGNED_BF16 = {"base": (1, (512, 64, 16, 1)),
                   "batch": (0, (516, 64, 16, 1)),
                   "seq": (0, (1024, 68, 16, 1)),
                   "head": (0, (1024, 128, 20, 1))}


@pytest.mark.parametrize("name", ["q", "k", "v"])
@pytest.mark.parametrize("what", sorted(MISALIGNED_BF16))
def test_flash_wrapper_refuses_misaligned_bf16_views(what, name):
    """The bf16 kernel loads q, k and v by TMA, whose tensor maps take a
    base address and strides that are multiples of 16 bytes: the wrapper
    refuses other bf16 views on every device, before the CPU's plain
    version runs. The same view in f32 (the 3xTF32 kernel) is taken."""
    offset, strides = MISALIGNED_BF16[what]
    g = torch.Generator().manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.randn(2 * 1032 + 1, generator=g).to(dtype)
        args = {n: torch.randn(2, 8, 4, 16, generator=g).to(dtype)
                for n in ("q", "k", "v")}
        args[name] = torch.as_strided(buf, (2, 8, 4, 16), strides, offset)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="multiples of 16 bytes"):
                fa_k.flash_attention_kernel(**args, scale=0.3, causal=True)
        else:
            got = fa_k.flash_attention_kernel(**args, scale=0.3, causal=True)
            assert torch.equal(got, fa_ref.attention(**args, causal=True,
                                                     scale=0.3))


def test_flash_wrapper_takes_aligned_strided_bf16_views():
    """Views whose offsets and strides are multiples of 16 bytes go through
    as they are: every other position, a slice of the head dim, and k and
    v from a heads-first tensor."""
    g = torch.Generator().manual_seed(12)
    q = torch.randn(2, 16, 4, 48, generator=g).to(torch.bfloat16)[:, ::2,
                                                                  :, 16:32]
    kv_heads_first = torch.randn(2, 2, 8, 16, generator=g).to(torch.bfloat16)
    k = kv_heads_first.transpose(1, 2)
    v = torch.randn(2, 8, 2, 32, generator=g).to(torch.bfloat16)[..., 16:]
    got = fa_k.flash_attention_kernel(q, k, v, scale=0.25, causal=True)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, fa_ref.attention(q, k, v, causal=True,
                                             scale=0.25))


# ---------------------------------------------------------------------------
# rope and MLP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 1_000_000.0)])
def test_rope_angles_match_reference(hd, theta):
    pos = np.arange(0, 4097, 3, dtype=np.int32)
    jc, js = j_rope.rope_angles(jnp.asarray(pos), hd, theta)
    tc, ts = rope.rope_angles(torch.from_numpy(pos), hd, theta)
    assert tc.dtype == torch.float32 and tc.shape == (len(pos), hd // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches_reference(dtype):
    """On the same angles the rotation is bit-equal (one rounding at the
    end, in f32 inside); through each side's own angles, the stated
    tolerance."""
    jd, td = DTYPES[dtype]
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(4096 - 40, 4096, dtype=np.int32)
    jc, js = j_rope.rope_angles(jnp.asarray(pos), 16)
    want = j_rope.apply_rope(jnp.asarray(x, jd), jc, js)
    same = rope.apply_rope(torch.from_numpy(x).to(td),
                           torch.from_numpy(np.array(jc)),
                           torch.from_numpy(np.array(js)))
    assert same.dtype == td
    np.testing.assert_array_equal(_np(same), _np(want))
    own = rope.apply_rope(torch.from_numpy(x).to(td),
                          *rope.rope_angles(torch.from_numpy(pos), 16))
    _check(dtype, own, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(dtype, kind):
    jd, td = DTYPES[dtype]
    arch = "yi-9b" if kind == "swiglu" else "granite-34b"
    j_cfg = j_get_config(arch).reduced(param_dtype=jd, activation_dtype=jd)
    t_cfg = get_config(arch).reduced(param_dtype=td, activation_dtype=td)
    g = np.random.default_rng(8)
    p = {k: (g.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wg", (64, 128)), ("wu", (64, 128)),
                      ("wd", (128, 64)))
         if kind == "swiglu" or k != "wg"}
    x = (g.standard_normal((2, 37, 64)) * 2).astype(np.float32)
    want = j_mlp.apply({k: jnp.asarray(v, jd) for k, v in p.items()}, j_cfg,
                       jnp.asarray(x, jd))
    got = mlp.apply({k: torch.from_numpy(v).to(td) for k, v in p.items()},
                    t_cfg, torch.from_numpy(x).to(td))
    assert got.dtype == td
    _check(dtype, got, want)
    # the activation alone, on the same inputs: bit-equal in bf16
    h = torch.from_numpy(x).to(td)
    jh = jnp.asarray(x, jd)
    act = (h * mlp.sigmoid(h) if kind == "swiglu" else mlp.gelu_tanh(h))
    j_act = (jax.nn.silu(jh) if kind == "swiglu"
             else jax.nn.gelu(jh, approximate=True))
    if dtype == "bf16":
        np.testing.assert_array_equal(_np(act), _np(j_act))
    else:
        np.testing.assert_allclose(_np(act), _np(j_act), **F32)


# ---------------------------------------------------------------------------
# masks and the SDPA paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,n_meta", [
    (True, 0, 0), (False, 0, 0), (True, 8, 0), (True, 8, 3), (False, 5, 2)])
def test_mask_and_slot_match_reference(causal, window, n_meta):
    qp = np.arange(5, 30, dtype=np.int32)
    kp = np.concatenate([np.arange(-1, 25), [-1, -1]]).astype(np.int32)
    want = j_attn._mask(jnp.asarray(qp), jnp.asarray(kp), causal, window,
                        n_meta)
    got = attention._mask(torch.from_numpy(qp), torch.from_numpy(kp),
                          causal, window, n_meta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = np.arange(0, 40, dtype=np.int32)
    W = 11
    want_s = np.asarray(j_attn._slot(jnp.asarray(pos), W, n_meta))
    np.testing.assert_array_equal(
        attention._slot(torch.from_numpy(pos), W, n_meta).numpy(), want_s)
    assert [attention._slot(int(p), W, n_meta) for p in pos] == list(want_s)


def _mask_case(sq, window, n_meta, causal=True):
    pos = np.arange(sq, dtype=np.int32)
    return (j_attn._mask(jnp.asarray(pos), jnp.asarray(pos), causal, window,
                         n_meta),
            attention._mask(torch.from_numpy(pos), torch.from_numpy(pos),
                            causal, window, n_meta))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window,n_meta", [(0, 0), (9, 2)])
def test_sdpa_matches_reference(dtype, window, n_meta):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 37, 37, 8, 2, 16, 9), dtype)
    jm, tm = _mask_case(37, window, n_meta)
    want = j_attn._sdpa(jq, jk, jv, jm, 0.25)
    got = attention._sdpa(tq, tk, tv, tm, 0.25)
    assert got.dtype == tq.dtype
    _check(dtype, got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window,n_meta", [
    (True, 0, 0), (True, 12, 3), (False, 0, 0)])
def test_sdpa_chunked_matches_reference(dtype, causal, window, n_meta):
    """Chunks of 16 rows over S = 50: a short last chunk, against the
    reference's padded one and against the whole score matrix."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 50, 50, 4, 2, 16, 10), dtype)
    pos = np.arange(50, dtype=np.int32)
    kw = dict(causal=causal, window=window, n_meta=n_meta, scale=0.25,
              chunk=16)
    want = j_attn._sdpa_chunked(jq, jk, jv, q_pos=jnp.asarray(pos),
                                k_pos=jnp.asarray(pos), **kw)
    got = attention._sdpa_chunked(tq, tk, tv, q_pos=torch.from_numpy(pos),
                                  kv_pos=torch.from_numpy(pos), **kw)
    _check(dtype, got, want)
    whole = attention._sdpa(tq, tk, tv, _mask_case(50, window, n_meta,
                                                   causal)[1], 0.25)
    assert torch.equal(got, whole)


# ---------------------------------------------------------------------------
# attend and decode over the ring cache
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _layer(arch, dtype):
    """(reference config, its layer-0 attention params, port config, the
    port's params) with the same weights."""
    jd, td = DTYPES[dtype]
    j_cfg = j_get_config(arch).reduced(param_dtype=jd, activation_dtype=jd)
    t_cfg = get_config(arch).reduced(param_dtype=td, activation_dtype=td)
    params = JModel(j_cfg).init(jax.random.key(1))
    model = Model(t_cfg, device="meta").to_empty(device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    j_p = jax.tree.map(lambda a: a[0], params["segments"][0][0]["mixer"])
    return j_cfg, j_p, t_cfg, model.segments[0][0][0].mixer.tree()


def _x(dtype, shape, seed):
    return _both([np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,use_flash,window", [
    ("yi-9b", False, 0), ("yi-9b", True, 0), ("qwen3-32b", True, 0),
    ("granite-34b", True, 0), ("minicpm-2b", False, 0), ("yi-9b", True, 7)])
def test_attend_matches_reference(dtype, arch, use_flash, window):
    """attend on both routes (a window sends use_flash to the plain path,
    as in the reference), with the ring cache of a 45-slot budget."""
    j_cfg, j_p, t_cfg, t_p = _layer(arch, dtype)
    (jx,), (tx,) = _x(dtype, (2, 37, 64), 11)
    want, want_c = j_attn.attend(j_p, j_cfg, jx, window=window,
                                 use_flash=use_flash, make_cache=45)
    before = LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, got_c = attention.attend(t_p, t_cfg, tx, window=window,
                                      use_flash=use_flash, make_cache=45)
    assert LAUNCHES["flash_attention"] == before
    _check(dtype, got, want)
    for key in ("k", "v"):
        assert got_c[key].dtype == t_cfg.activation_dtype
        _check(dtype, got_c[key], want_c[key])
    np.testing.assert_array_equal(got_c["pos"].numpy(),
                                  np.asarray(want_c["pos"]))


def test_attend_takes_the_chunked_path_at_its_threshold():
    """S = CHUNKED_THRESHOLD: both sides attend in chunks of Q_CHUNK rows
    (the path the served prefill takes without the kernel)."""
    assert attention.CHUNKED_THRESHOLD == j_attn.CHUNKED_THRESHOLD
    assert attention.Q_CHUNK == j_attn.Q_CHUNK
    j_cfg, j_p, t_cfg, t_p = _layer("yi-9b", "f32")
    (jx,), (tx,) = _x("f32", (1, attention.CHUNKED_THRESHOLD, 64), 15)
    want, _ = j_attn.attend(j_p, j_cfg, jx)
    with torch.no_grad():
        got, _ = attention.attend(t_p, t_cfg, tx)
    _check("f32", got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attend_keeps_the_last_positions_in_a_short_cache(dtype):
    """A prefill longer than the ring keeps the meta tokens and the last
    W - n_meta positions in their slots."""
    j_cfg, j_p, t_cfg, t_p = _layer("yi-9b", dtype)
    (jx,), (tx,) = _x(dtype, (2, 30, 64), 12)
    want, want_c = j_attn.attend(j_p, j_cfg, jx, window=8, n_meta=2,
                                 make_cache=10)
    with torch.no_grad():
        got, got_c = attention.attend(t_p, t_cfg, tx, window=8, n_meta=2,
                                      make_cache=10)
    _check(dtype, got, want)
    np.testing.assert_array_equal(got_c["pos"].numpy(),
                                  np.asarray(want_c["pos"]))
    _check(dtype, got_c["k"], want_c["k"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window,n_meta,W", [(0, 0, 24), (6, 2, 8)])
def test_decode_step_over_a_ring_that_wraps(dtype, window, n_meta, W):
    """Twelve steps from a 9-token prefill: with a window of 6 (and 2 meta
    tokens) the 8-slot ring wraps; without one, 24 slots hold it all."""
    j_cfg, j_p, t_cfg, t_p = _layer("qwen3-32b", dtype)
    (jx,), (tx,) = _x(dtype, (2, 9, 64), 13)
    _, j_cache = j_attn.attend(j_p, j_cfg, jx, window=window, n_meta=n_meta,
                               make_cache=W)
    with torch.no_grad():
        _, t_cache = attention.attend(t_p, t_cfg, tx, window=window,
                                      n_meta=n_meta, make_cache=W)
    (jsteps,), (tsteps,) = _x(dtype, (2, 12, 64), 14)
    for step in range(12):
        index = 9 + step
        want, j_cache = j_attn.decode_step(
            j_p, j_cfg, jsteps[:, step:step + 1], j_cache, jnp.int32(index),
            window=window, n_meta=n_meta)
        with torch.no_grad():
            got, cache = attention.decode_step(
                t_p, t_cfg, tsteps[:, step:step + 1], t_cache, index,
                window=window, n_meta=n_meta)
        assert cache is t_cache          # updated in place
        _check(dtype, got, want)
    np.testing.assert_array_equal(t_cache["pos"].numpy(),
                                  np.asarray(j_cache["pos"]))
    _check(dtype, t_cache["k"], j_cache["k"])
    _check(dtype, t_cache["v"], j_cache["v"])


def test_cross_attention_raises_naming_the_roadmap():
    """Cross-attention (refused until the encoder-decoder and vision plans
    were ported) against the reference: ``attend(cross_src=...)``, then
    a decode step over ``precompute_cross_kv``'s keys and values, with
    the tanh gate set nonzero (zero at init, it would compare nothing)
    and qk-norm on (qwen3's layer)."""
    for dtype in ("f32", "bf16"):
        j_cfg, j_p, t_cfg, t_p = _layer("qwen3-32b", dtype)
        j_p = dict(j_p, gate=jnp.full((1,), 0.6, j_p["wq"].dtype))
        t_p = dict(t_p, gate=torch.full((1,), 0.6, dtype=t_p["wq"].dtype))
        (jx,), (tx,) = _x(dtype, (2, 9, 64), 3)
        (jsrc,), (tsrc,) = _x(dtype, (2, 13, 64), 4)
        want, _ = j_attn.attend(j_p, j_cfg, jx, cross_src=jsrc)
        with torch.no_grad():
            got, cache = attention.attend(t_p, t_cfg, tx, cross_src=tsrc)
        assert cache is None
        _check(dtype, got, want)
        j_kv = j_attn.precompute_cross_kv(j_p, j_cfg, jsrc)
        with torch.no_grad():
            t_kv = attention.precompute_cross_kv(t_p, t_cfg, tsrc)
            got, kept = attention.decode_step(t_p, t_cfg, tx[:, :1], None,
                                              9, cross_cache=t_kv)
        for key in ("k", "v"):
            _check(dtype, t_kv[key], j_kv[key])
        want, _ = j_attn.decode_step(j_p, j_cfg, jx[:, :1], None,
                                     jnp.int32(9), cross_cache=j_kv)
        assert kept is None
        _check(dtype, got, want)
