"""The roulette CDF's segmented scan order, on the CPU.

``common.prefix_sum`` sums lanes left to right inside segments of
``SCAN_SEGMENT`` (64) lanes and adds each segment's carry once per lane,
``cum[j] = carry_s + local[j]`` with ``carry_{s+1} = cum[64 s + 63]``. The
CUDA kernels (``roulette_cdf.cu``, and ``plan_rows.cuh::roulette_cdf_warp``
in the untiled generation kernels) follow the same order, bit for bit on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3-3c).
Here the order is held against the left-to-right scan it replaced (equal
up to 64 lanes), against a scalar numpy formulation of itself, for
monotonicity, against an f64 sum, and, through the selection plan, against
the reference's blocked ``tril @ w`` at 10,000 lanes (a count of differing
parents, ROADMAP Queue C). Run as a script, it prints the measurements of
Queue C's roulette entries (:func:`main`).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ga.common import GenerationSpec as JSpec
from repro.kernels.ga.common import selection_plan as j_plan
from repro_torch.kernels.ga import common
from repro_torch.kernels.ga.common import GenerationSpec as TSpec
from repro_torch.kernels.ga.common import selection_plan as t_plan

F32_EPS = 2.0 ** -24  # the unit roundoff of f32


def _serial(w: torch.Tensor) -> torch.Tensor:
    """The left-to-right f32 scan that was the order before segments."""
    cum = torch.empty_like(w)
    acc = torch.zeros_like(w[..., 0])
    for j in range(w.shape[-1]):
        acc = acc + w[..., j]
        cum[..., j] = acc
    return cum


def _segmented_np(w: np.ndarray) -> np.ndarray:
    """The segmented order by scalar np.float32 adds, one lane at a time."""
    out = np.empty_like(w)
    carry = np.float32(0.0)
    for s0 in range(0, len(w), 64):
        local = np.float32(0.0)
        for j in range(s0, min(s0 + 64, len(w))):
            local = np.float32(local + w[j])
            out[j] = np.float32(carry + local)
        carry = out[min(s0 + 64, len(w)) - 1]
    return out


def _fitness(kind: str, n_isl: int, n: int, seed: int):
    """(I, n) f32 fitness and (I,) int32 sizes: "random" (normal * 10 with
    -inf lanes), "tied" (one value everywhere), "masked" (sizes below n,
    0 and 1 on the first islands, -inf at every segment's end)."""
    rng = np.random.default_rng(seed)
    fit = (rng.normal(size=(n_isl, n)) * 10).astype(np.float32)
    size = np.full(n_isl, n, np.int32)
    if kind == "random":
        fit[:, 1:4] = -np.inf
    elif kind == "tied":
        fit[:] = 2.5
    else:
        size = rng.integers(n // 2, n + 1, n_isl).astype(np.int32)
        size[0], size[1] = 0, 1
        fit[:, 63::64] = -np.inf
    return torch.from_numpy(fit), torch.from_numpy(size)


def _weights(fit, size):
    """The roulette weights that ``common.roulette_cdf`` sums."""
    masked = common.masked_fitness(fit, size)
    valid = torch.isfinite(masked)
    lo = torch.where(valid, masked, float("inf")).amin(-1, keepdim=True)
    return torch.where(valid, torch.where(valid, masked, 0.0) - lo + 1e-6,
                       0.0)


@pytest.mark.parametrize("kind", ["random", "tied", "masked"])
def test_segmented_scan_is_the_serial_scan_up_to_a_segment(kind):
    """For every n in 1-64 the segmented order is the left-to-right scan
    bit for bit, so every exact roulette test against the reference (32
    lanes) holds unchanged."""
    assert common.SCAN_SEGMENT == 64
    for n in range(1, 65):
        fit, size = _fitness(kind, 4, n, n)
        got = common.roulette_cdf(common.masked_fitness(fit, size))
        assert torch.equal(got, _serial(_weights(fit, size))), n


@pytest.mark.parametrize("n", [65, 127, 128, 129, 4097, 10000])
def test_segmented_scan_equals_scalar_numpy(n):
    """Above one segment: an independent formulation of the order."""
    fit, size = _fitness("masked" if n % 2 else "random", 2, n, n)
    w = _weights(fit, size)
    got = common.prefix_sum(w)
    for i in range(w.shape[0]):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _segmented_np(w[i].numpy()))


@pytest.mark.parametrize("kind", ["random", "tied", "masked"])
def test_segmented_cdf_never_decreases(kind):
    """The inverse-CDF count ``(cum <= u).sum()`` and the kernels' binary
    search (``plan_rows.cuh::count_at_most``) agree only on a CDF that
    never decreases; weights spanning 12 decades included."""
    for n in (63, 64, 65, 129, 4200, 10000):
        fit, size = _fitness(kind, 3, n, n)
        cum = common.roulette_cdf(common.masked_fitness(fit, size))
        assert bool((cum[:, 1:] >= cum[:, :-1]).all()), (kind, n)
    rng = np.random.default_rng(7)
    w = torch.from_numpy((10.0 ** rng.uniform(-6, 6, (2, 10000))).astype(
        np.float32))
    cum = common.prefix_sum(w)
    assert bool((cum[:, 1:] >= cum[:, :-1]).all())


def test_segmented_cdf_near_the_f64_sum():
    """At 10,000 lanes every lane lies within gamma_k of the f64 sum of the
    same f32 weights, k = 64 + ceil(n / 64) the adds on its longest chain
    (``|err| <= k u / (1 - k u) * total``, u = 2^-24), and closer than the
    serial scan it replaced on Fig. 4's fitness."""
    n = 10000
    fit = torch.from_numpy((np.random.default_rng(0).normal(size=n) * 10)
                           .astype(np.float32))[None]
    size = torch.tensor([n], dtype=torch.int32)
    w = _weights(fit, size)
    exact = torch.cumsum(w.double(), -1)
    cum = common.roulette_cdf(common.masked_fitness(fit, size))
    err = (cum.double() - exact).abs().max().item()
    k = 64 + -(-n // 64)
    bound = k * F32_EPS / (1 - k * F32_EPS) * exact[0, -1].item()
    assert err <= bound, (err, bound)
    serial_err = (_serial(w).double() - exact).abs().max().item()
    assert err < serial_err, (err, serial_err)


def _plans(n: int, seed: int):
    """The port's and the jitted reference's selection plans under roulette
    on ``test_roulette_plan_above_the_selection_block``'s inputs (key words
    0x1234/0x5678, fitness ``normal * 10``) at n lanes and numpy seed
    ``seed``, as numpy arrays by field."""
    fit = (np.random.default_rng(seed).normal(size=n) * 10).astype(np.float32)
    kw = dict(kind="binary", length=160, elite=2, selection="roulette",
              tournament_k=2, crossover="two_point", crossover_rate=0.9,
              mutation_rate=1.0 / 160, mutation_sigma=0.3)
    want = jax.jit(lambda f: j_plan(jnp.uint32(0x1234), jnp.uint32(0x5678),
                                    f, jnp.int32(n), JSpec(**kw), n))(
        jnp.asarray(fit))
    got = t_plan(torch.tensor([[0x1234, 0x5678]]),
                 torch.from_numpy(fit)[None], torch.tensor([n]), TSpec(**kw),
                 n)
    return ({name: g[0].numpy() for name, g in zip(got._fields, got)},
            {name: np.asarray(w) for name, w in zip(got._fields, want)})


def test_roulette_plan_at_ten_thousand_lanes():
    """n = 10,000 (Fig. 4's population): the reference's blocked ``tril @
    w`` CDF and the segmented scan differ by ulps, so a few parents may
    differ, held to ROADMAP Queue C's 0.5 % of rows; the elite, cuts and
    gate are exact."""
    n = 10000
    got, want = _plans(n, 0)
    for name in got:
        if name in ("idx_a", "idx_b"):
            differ = int((got[name] != want[name]).sum())
            assert differ <= n * 0.005, (name, differ)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)


def _plan_differences(n: int, seed: int):
    """(differing idx_a, differing idx_b, the first differing (field, row,
    port, reference)) of :func:`_plans`."""
    got, want = _plans(n, seed)
    counts, first = [], None
    for name in ("idx_a", "idx_b"):
        rows = np.nonzero(got[name] != want[name])[0]
        counts.append(len(rows))
        if len(rows) and (first is None or rows[0] < first[1]):
            r = int(rows[0])
            first = (name, r, int(got[name][r]), int(want[name][r]))
    return counts[0], counts[1], first


def main():
    """Prints the measurements of ROADMAP Queue C's roulette entries:
    the port's plan against the reference's under the segmented order and
    under the left-to-right scan it replaced, each order's distance from an
    f64 sum at 10,000 lanes, and the fewest lanes at which XLA's jitted
    ``tril @ w`` and the port's scan first differ (five seeds).

        PYTHONPATH=src python tests/test_torch_roulette_scan.py
    """
    segmented = common.prefix_sum
    for n, seed in ((4200, 0), (4200, 1), (10000, 0)):
        for order, fn in (("segmented", segmented),
                          ("left-to-right", _serial)):
            common.prefix_sum = fn
            try:
                a, b, first = _plan_differences(n, seed)
            finally:
                common.prefix_sum = segmented
            print(f"{n} lanes, seed {seed}, {order}: idx_a differs in {a}, "
                  f"idx_b in {b}; first (field, row, port, reference) "
                  f"{first}")
    fit = torch.from_numpy((np.random.default_rng(0).normal(size=10000)
                            * 10).astype(np.float32))[None]
    w = _weights(fit, torch.tensor([10000], dtype=torch.int32))
    exact = torch.cumsum(w.double(), -1)
    for order, fn in (("segmented", segmented), ("left-to-right", _serial)):
        err = (fn(w).double() - exact).abs().max().item()
        print(f"10000 lanes, {order}: largest distance from the f64 sum "
              f"{err:.6e} (total {exact[0, -1].item():.6e})")

    @jax.jit
    def tril_sum(w):
        m = w.shape[0]
        ri = jax.lax.broadcasted_iota(jnp.int32, (m, m), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (m, m), 1)
        return jnp.dot((ci <= ri).astype(jnp.float32), w[:, None],
                       preferred_element_type=jnp.float32)[:, 0]

    for n in range(1, 129):
        for seed in range(5):
            f = (np.random.default_rng(seed).normal(size=n) * 10).astype(
                np.float32)
            w = f - f.min() + np.float32(1e-6)
            port = segmented(torch.from_numpy(w)).numpy()
            ref = np.asarray(tril_sum(jnp.asarray(w)))
            lanes = np.nonzero(port != ref)[0]
            if len(lanes):
                j = int(lanes[0])
                print(f"tril @ w first differs at n {n}, seed {seed}, lane "
                      f"{j}: port {port[j]!r}, reference {ref[j]!r}")
                return


if __name__ == "__main__":
    main()
