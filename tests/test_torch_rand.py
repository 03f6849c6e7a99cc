"""repro_torch.rand against the reference's streams.

The GA counter RNG must equal ``repro.kernels.ga.prng`` bit for bit
(threefry, offsets including negative ones, row strides, uniform, randint,
bernoulli). ``normal`` goes through ``log``/``sqrt``/``cos``, whose f32
results differ between XLA's CPU math and PyTorch's by an ulp on some
inputs: it is held to 4e-7 absolute plus 4e-7 relative (about 3 ulp at the
magnitudes drawn). The keyed recipes must equal ``jax.random`` bit for bit
under ``jax_threefry_partitionable=True``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ga import prng
from repro_torch import rand

K0, K1 = 0xDEADBEEF, 12345
NORMAL_TOL = 4e-7


def _np(t):
    return t.numpy()


def test_threefry_matches_reference():
    g = np.random.default_rng(0)
    k = g.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    x = g.integers(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    want = prng.threefry2x32(jnp.asarray(k[0]), jnp.asarray(k[1]),
                             jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = rand.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                              for a in (k[0], k[1], x[0], x[1])))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(_np(t).astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("offset,row_stride", [
    ((0, 0), None), ((-3, 5), 53), ((7, -2), None), ((-2, 0), 160),
    ((2**20, 3), 4099)])
def test_random_bits_counters(offset, row_stride):
    want = prng.random_bits(jnp.uint32(K0), jnp.uint32(K1), (37, 53), 0xA1,
                            offset, row_stride)
    got = rand.random_bits(K0, K1, (37, 53), 0xA1, offset, row_stride)
    np.testing.assert_array_equal(_np(got).astype(np.uint32),
                                  np.asarray(want))


def test_uniform_randint_bernoulli_bit_equal():
    k0, k1 = jnp.uint32(K0), jnp.uint32(K1)
    np.testing.assert_array_equal(
        _np(rand.uniform(K0, K1, (64, 53), 0xB2, (-1, 0), 53)),
        np.asarray(prng.uniform(k0, k1, (64, 53), 0xB2, (-1, 0), 53)))
    for maxval in (1, 7, 161, 257):
        np.testing.assert_array_equal(
            _np(rand.randint(K0, K1, (37, 3), maxval, 0xC3)),
            np.asarray(prng.randint(k0, k1, (37, 3), maxval, 0xC3)))
    for p in (0.5, 1.0 / 160, 0.9):
        np.testing.assert_array_equal(
            _np(rand.bernoulli(K0, K1, (64, 53), p, 0xE5, (-2, 0), 53)),
            np.asarray(prng.bernoulli(k0, k1, (64, 53), p, 0xE5, (-2, 0),
                                      53)))


def test_batched_key_broadcasts_like_vmap():
    seeds = np.array([[1, 2], [0xFFFFFFFF, 7], [K0, K1]], np.uint32)
    want = jax.vmap(lambda s: prng.randint(s[0], s[1], (5, 3), 29, 0xA1))(
        jnp.asarray(seeds))
    t = torch.from_numpy(seeds.astype(np.int64))
    got = rand.randint(t[:, 0].reshape(-1, 1, 1), t[:, 1].reshape(-1, 1, 1),
                       (5, 3), 29, 0xA1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_normal_within_stated_tolerance():
    want = np.asarray(prng.normal(jnp.uint32(K0), jnp.uint32(K1), (64, 53),
                                  0xF6))
    got = _np(rand.normal(K0, K1, (64, 53), 0xF6))
    np.testing.assert_allclose(got, want, rtol=NORMAL_TOL, atol=NORMAL_TOL)


# ---------------------------------------------------------------------------
# keyed recipes (jax.random, partitionable layout)
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _words(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1, -1])
def test_key_split_fold_in(seed):
    jk, tk = jax.random.key(seed), rand.key(seed)
    np.testing.assert_array_equal(_np(rand.key_data(tk)), _words(jk))
    np.testing.assert_array_equal(_np(rand.split(tk, 5)),
                                  _words(jax.random.split(jk, 5)))
    np.testing.assert_array_equal(_np(rand.fold_in(tk, 0xACC)),
                                  _words(jax.random.fold_in(jk, 0xACC)))
    # batched keys split like a vmap over keys
    jks = jax.random.split(jk, 3)
    np.testing.assert_array_equal(
        _np(rand.split(rand.split(tk, 3), 2)),
        _words(jax.vmap(lambda k: jax.random.split(k, 2))(jks)))


@pytest.mark.parametrize("lo,hi,shape", [
    (0, 7, ()), (128, 257, ()), (0, 1, (5,)), (3, 3, (4, 2)),
    (-5, 100000, (6,)), (0, 2**31 - 1, (7,)), (16, 33, (2, 3))])
def test_keyed_randint(lo, hi, shape):
    jk = jax.random.key(42)
    np.testing.assert_array_equal(
        _np(rand.keyed_randint(rand.key(42), shape, lo, hi)),
        np.asarray(jax.random.randint(jk, shape, lo, hi)))


def test_keyed_randint_traced_maxval():
    counts = np.array([0, 1, 2, 5, 64, 3], np.int32)
    jks = jax.random.split(jax.random.key(9), counts.size)
    want = jax.vmap(lambda k, m: jax.random.randint(
        k, (), 0, jnp.maximum(m, 1)))(jks, jnp.asarray(counts))
    got = rand.keyed_randint(rand.split(rand.key(9), counts.size), (), 0,
                             torch.clamp(torch.from_numpy(counts), min=1))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_keyed_uniform_bernoulli_bits():
    jk, tk = jax.random.key(3), rand.key(3)
    np.testing.assert_array_equal(_np(rand.keyed_uniform(tk, (9, 31))),
                                  np.asarray(jax.random.uniform(jk, (9, 31))))
    for p in (0.5, 0.1):
        np.testing.assert_array_equal(
            _np(rand.keyed_bernoulli(tk, p, (9, 31))),
            np.asarray(jax.random.bernoulli(jk, p, (9, 31))))
    np.testing.assert_array_equal(
        _np(rand.keyed_bits(tk, (4, 5))).astype(np.uint32),
        np.asarray(jax.random.bits(jk, (4, 5))))


def test_keyed_uniform_with_bounds_on_batched_keys():
    """The float init: one key per island, genes uniform in the bounds.
    The reference's scaling is one fused multiply-add in XLA's CPU code,
    so this holds :func:`rand.fma` as well."""
    n_keys = 5
    jks = jax.random.split(jax.random.key(21), n_keys)
    want = jax.vmap(lambda k: jax.random.uniform(
        k, (8, 64), jnp.float32, -5.0, 5.0))(jks)
    got = rand.keyed_uniform(rand.split(rand.key(21), n_keys), (8, 64), -5.0,
                             5.0)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_fma_rounds_once():
    """``rand.fma`` is the exactly rounded ``a * b + c`` of an FMA: no f32
    value lies nearer the exact result (ties to an even last bit)."""
    from fractions import Fraction
    g = np.random.default_rng(1)
    n = 3000
    a, b, c = ((g.uniform(-1, 1, n) * 2.0 ** g.integers(-30, 5, n)).astype(
        np.float32) for _ in range(3))
    # results far below a * b, where the rounding of a * b would show
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    got = _np(rand.fma(*(torch.from_numpy(v) for v in (a, b, c))))
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        x = got[i]
        dx = abs(Fraction(float(x)) - exact)
        for y in (np.nextafter(x, np.float32(-np.inf)),
                  np.nextafter(x, np.float32(np.inf))):
            dy = abs(Fraction(float(y)) - exact)
            assert dy > dx or (dy == dx and int(x.view(np.int32)) % 2 == 0), \
                (a[i], b[i], c[i], x)


# ---------------------------------------------------------------------------
# keyed recipes through log, log1p and erf_inv (gumbel, categorical, normal)
# and the permutation; tolerances: the port computes each log, log1p and
# sqrt correctly rounded (the f64 function rounded once), where XLA's CPU
# code rounds about 6 % of f32 logs an ulp away; erf_inv is held to 2 ulp
# of XLA's value, the normals and the Gumbel draws to 2.4e-7 absolute plus
# 2.4e-7 relative (2 ulp at 1: the Gumbel's outer log cancels near 0, so
# its error there is absolute), categorical draws to at most 0.5 %
# differing, the permutation bit for bit
# ---------------------------------------------------------------------------
CATEGORICAL_MAX_FRACTION = 0.005
DRAW_TOL = 2.4e-7


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.abs(want).astype(np.float32)).astype(np.float64)


def test_erf_inv_matches_xla_within_two_ulp():
    assert jax.config.jax_threefry_partitionable
    edge = np.float32(1 - 2**-24)
    x = np.concatenate([np.float32([edge, -edge, 0.0, -0.0, 0.5, -0.5]),
                        np.linspace(-edge, edge, 200001, dtype=np.float32)])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = _np(rand.erf_inv(torch.from_numpy(x)))
    np.testing.assert_array_equal(got[:4], want[:4])    # the edges and 0
    assert _ulps(got, want).max() <= 2
    assert np.isinf(_np(rand.erf_inv(torch.tensor([1.0, -1.0])))).all()


def test_keyed_normal_on_batched_keys_within_tolerance():
    assert jax.config.jax_threefry_partitionable
    jks = jax.random.split(jax.random.key(31), 4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (50, 64)))(jks))
    got = _np(rand.keyed_normal(rand.split(rand.key(31), 4), (50, 64)))
    np.testing.assert_allclose(got, want, rtol=DRAW_TOL, atol=DRAW_TOL)


def test_keyed_gumbel_within_tolerance():
    assert jax.config.jax_threefry_partitionable
    jks = jax.random.split(jax.random.key(32), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (40, 77)))(jks))
    got = _np(rand.keyed_gumbel(rand.split(rand.key(32), 3), (40, 77)))
    np.testing.assert_allclose(got, want, rtol=DRAW_TOL, atol=DRAW_TOL)


@pytest.mark.parametrize("lanes", [1, 7, 256])
def test_keyed_categorical_within_stated_count(lanes):
    assert jax.config.jax_threefry_partitionable
    g = np.random.default_rng(lanes)
    logits = g.normal(size=(3, lanes)).astype(np.float32)
    logits[1, : lanes // 2] = -np.inf                  # masked lanes
    jks = jax.random.split(jax.random.key(33), 3)
    want = np.asarray(jax.vmap(lambda k, l: jax.random.categorical(
        k, l, shape=(2000,)))(jks, jnp.asarray(logits)))
    got = _np(rand.keyed_categorical(rand.split(rand.key(33), 3),
                                     torch.from_numpy(logits), (2000,)))
    assert (got != want).sum() <= CATEGORICAL_MAX_FRACTION * want.size
    assert (got[1] >= lanes // 2).all()


@pytest.mark.parametrize("n", [1, 2, 5, 8, 64, 1625, 3000])
def test_keyed_permutation_bit_equal(n):
    assert jax.config.jax_threefry_partitionable
    for seed in (0, 11):
        np.testing.assert_array_equal(
            _np(rand.keyed_permutation(rand.key(seed), n)),
            np.asarray(jax.random.permutation(jax.random.key(seed), n)))
    jks = jax.random.split(jax.random.key(5), 3)
    np.testing.assert_array_equal(
        _np(rand.keyed_permutation(rand.split(rand.key(5), 3), n)),
        np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jks)))
