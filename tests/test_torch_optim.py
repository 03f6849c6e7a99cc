"""The port's optimizer (``repro_torch.optim``) against the JAX reference
(``repro.optim``) on the same numpy inputs.

Tolerances (ROADMAP Queue C):

- the schedules equal the reference's eager schedules bit for bit (their
  ``cos``, ``log`` and ``exp`` are the f64 functions rounded once, which
  XLA's f32 ones match on these steps); the reference's *jitted*
  schedule, which the train step runs, folds ``base * step / w`` into
  ``step * (base / w)`` and divides by constants as products with their
  f32 reciprocals, so it is held to rtol 5e-7 (measured: at most
  4.3e-7, 7 ulps, where ``1 + cos`` cancels near the cosine's end; 1-3
  ulps on up to 6 % of the steps elsewhere);
- the global norm sums each leaf in another order than XLA: rtol 2e-6;
- AdamW differs from the reference's jitted update by an ulp or two of
  the master per step (the norm's order, XLA's fused multiply-adds):
  atol 1e-6 on the master and the moments over 5 steps, f32 and bf16;
- the compressors equal the reference under ``shard_map`` bit for bit
  (2 gloo ranks against 2 fake CPU devices).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_harness as harness
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro.optim import schedules as j_sched
from repro.optim.compression import _dequant_int8 as j_dequant
from repro.optim.compression import _quant_int8 as j_quant
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.optim import adamw, clip, compression, schedules

SHAPES = {"a": (64, 32), "b": (7,), "c": (3, 5, 9), "d": (1000,)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(tree, dtype):
    jd, td = DTYPES[dtype]
    return ({k: jnp.asarray(v, jd) for k, v in tree.items()},
            {k: torch.tensor(v).to(td) for k, v in tree.items()})


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    """The norm within rtol 2e-6; each leaf scaled in f32 and cast back to
    its dtype (a bf16 leaf stays bf16)."""
    jt, tt = _both(_tree(0, 3.0), dtype)
    want, want_n = jax.jit(lambda t: j_clip.clip_by_global_norm(
        t, max_norm))(jt)
    got, got_n = clip.clip_by_global_norm(tt, max_norm)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=2e-6)
    for k in SHAPES:
        assert got[k].dtype == tt[k].dtype
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=4e-6,
                                   atol=1e-7 if dtype == "f32" else 0)
        if dtype == "bf16":
            # a scale a few ulps of f32 apart may round a bf16 one ulp
            assert np.mean(_np(got[k]) != _np(want[k])) < 0.02


def test_global_norm_sums_layers_as_one_leaf():
    """A leaf given as its layers equals the leaf stacked; leaves add in
    the given order, and the root is the correctly rounded f32 sqrt."""
    tree = _tree(1)
    layers = [torch.from_numpy(tree["c"][i].copy()) for i in range(3)]
    whole = clip.global_norm([torch.from_numpy(tree["c"])])
    split = clip.global_norm([layers])
    np.testing.assert_allclose(float(split), float(whole), rtol=1e-6)
    ss = sum(np.sum(np.square(v, dtype=np.float64)) for v in tree.values())
    got = clip.global_norm([torch.from_numpy(v) for v in tree.values()])
    np.testing.assert_allclose(float(got), math.sqrt(ss), rtol=1e-6)
    assert clip.leaves_of({"b": 1, "a": 2}) == [[2], [1]]


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-3b"])
def test_leaf_groups_follow_the_reference_leaves(arch):
    """``Model.leaf_groups`` lists the reference's leaves in
    ``jax.tree.leaves`` order, each with one name per layer."""
    j_model = JModel(j_get_config(arch, smoke=True))
    want = [tuple(leaf.shape) for leaf in
            jax.tree.leaves(j_model.abstract_params())]
    model = Model(get_config(arch, smoke=True), device="meta")
    params = dict(model.named_parameters())
    groups = model.leaf_groups()
    got = [(len(g),) + tuple(params[g[0]].shape) if len(g) > 1
           or g[0].startswith("segments") else tuple(params[g[0]].shape)
           for g in groups]
    assert got == want
    assert sorted(n for g in groups for n in g) == sorted(params)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
SCHEDULES = [("cosine", 3e-3, 200, 20), ("wsd", 3e-3, 200, 20),
             ("wsd", 1e-3, 30, 7), ("cosine", 1e-3, 30, 7),
             ("constant", 3e-3, 200, 20)]


@pytest.mark.parametrize("kind,base,total,warm", SCHEDULES)
def test_schedule_matches_reference(kind, base, total, warm):
    """Every step of the run and past its end: bit for bit against the
    eager schedule, within 5e-7 of the jitted one; f32 0-d."""
    want = j_sched.make_schedule(kind, base, total, warm)
    jitted = jax.jit(want)
    got = schedules.make_schedule(kind, base, total, warm)
    steps = range(total + 10)
    g = np.array([got(torch.tensor(s, dtype=torch.int32)).item()
                  for s in steps], np.float32)
    w = np.array([np.float32(want(jnp.int32(s))) for s in steps])
    wj = np.array([np.float32(jitted(jnp.int32(s))) for s in steps])
    assert got(3).dtype == torch.float32 and got(3).dim() == 0
    np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(g, wj, rtol=5e-7, atol=0)


def test_schedule_shapes():
    """Warmup is linear from 0, cosine ends at a tenth, WSD is flat and
    ends at a hundredth; an unknown kind raises."""
    cos = schedules.make_schedule("cosine", 1.0, 100, 10)
    assert float(cos(0)) == 0.0 and float(cos(10)) == 1.0
    np.testing.assert_allclose(float(cos(100)), 0.1, rtol=1e-6)
    w = schedules.make_schedule("wsd", 1.0, 100, 10)
    assert float(w(50)) == 1.0
    np.testing.assert_allclose(float(w(100)), 0.01, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.make_schedule("linear", 1.0, 10)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_matches_reference(dtype):
    """Five steps from the same parameters and gradients (clipped at 1):
    the master (bf16: present; f32: the parameters), the moments and the
    gradient norm within the stated tolerances, the new parameters their
    master cast to their dtype."""
    jp, tp = _both(_tree(2), dtype)
    js, ts = j_adamw.adamw_init(jp), adamw.adamw_init(tp)
    assert (ts.master is None) == (dtype == "f32") == (js.master is None)
    update = jax.jit(lambda g, s, p, lr: j_adamw.adamw_update(
        g, s, p, lr=lr, weight_decay=0.1))
    for it in range(5):
        jg, tg = _both(_tree(10 + it, 3.0), dtype)
        jp, js, jm = update(jg, js, jp, jnp.float32(1e-2))
        tp, ts, tm = adamw.adamw_update(tg, ts, tp, lr=1e-2,
                                        weight_decay=0.1)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2e-6)
        assert float(tm["lr"]) == np.float32(1e-2)
        assert int(ts.step) == int(js.step) == it + 1
        for k in SHAPES:
            master = ts.master[k] if ts.master is not None else tp[k]
            want = js.master[k] if js.master is not None else jp[k]
            np.testing.assert_allclose(_np(master), _np(want), atol=1e-6)
            np.testing.assert_allclose(_np(ts.m[k]), _np(js.m[k]),
                                       atol=1e-7)
            np.testing.assert_allclose(_np(ts.v[k]), _np(js.v[k]),
                                       atol=1e-7)
            assert tp[k].dtype == DTYPES[dtype][1]
            assert torch.equal(tp[k], master.to(tp[k].dtype))


def test_adamw_without_clipping_and_zero_decay():
    """``max_grad_norm=None`` reports a zero norm and leaves the gradient
    as it is; with no decay a first step moves each parameter by about
    ``lr`` against its gradient's sign."""
    p = {"w": torch.zeros(5)}
    g = {"w": torch.tensor([3.0, -2.0, 1e-3, -1e-3, 0.0])}
    new, st, m = adamw.adamw_update(g, adamw.adamw_init(p), p, lr=0.1,
                                    weight_decay=0.0, max_grad_norm=None)
    assert float(m["grad_norm"]) == 0.0
    np.testing.assert_allclose(new["w"].numpy(), [-0.1, 0.1, -0.1, 0.1, 0],
                               rtol=1e-4)
    assert st.master is None and int(st.step) == 1


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_quant_int8_matches_reference_at_ties():
    """Round half to even at .5 on both sides (the scale 1 makes x / scale
    the ties themselves), the scale as the compiled reference takes it,
    and the round trip within half a step."""
    x = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 3.2],
                 np.float32)
    wq, ws = jax.jit(j_quant)(jnp.asarray(x))
    q, s = compression._quant_int8(torch.from_numpy(x))
    assert float(s) == float(ws)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    rng = np.random.default_rng(0)
    y = rng.normal(size=128).astype(np.float32)
    q, s = compression._quant_int8(torch.from_numpy(y))
    err = np.abs(compression._dequant_int8(q, s).numpy() - y).max()
    assert err <= float(s) * 0.5 + 1e-6
    np.testing.assert_array_equal(
        compression._dequant_int8(q, s).numpy(),
        np.asarray(j_dequant(jnp.asarray(q.numpy()), jnp.float32(s))))


def test_compress_psum_one_rank_and_unknown_method():
    """A world of one: "none" returns the gradient and its error as they
    were, an unknown method raises; ``init_error`` is f32 zeros."""
    class One:
        world, rank = 1, 0

        def gather_stack(self, x):
            return x[None]

        def sum_in_order(self, x):
            return x.clone()

    g = {"w": torch.randn(6, generator=torch.Generator().manual_seed(0))}
    e = compression.init_error(g)
    assert e["w"].dtype == torch.float32 and not e["w"].any()
    out, err = compression.compress_psum(g, e, One(), method="none")
    assert torch.equal(out["w"], g["w"]) and err["w"] is e["w"]
    for method in ("bf16", "int8"):
        out, err = compression.compress_psum(g, e, One(), method=method)
        np.testing.assert_allclose((out["w"] + err["w"]).numpy(),
                                   g["w"].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown compression"):
        compression.compress_psum(g, e, One(), method="fp8")


COMPRESS_CASES = [{"name": f"compress_{m}_{'fresh' if z else 'carried'}",
                   "kind": "compress", "W": 2, "method": m, "seed": 5,
                   "zero_error": z}
                  for m in ("none", "bf16", "int8") for z in (False, True)]


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    return harness.run_both(COMPRESS_CASES,
                            str(tmp_path_factory.mktemp("compress")))


@pytest.mark.parametrize("case", [c["name"] for c in COMPRESS_CASES])
def test_compress_psum_matches_reference(compressed, case):
    """Every rank's synced gradients (``a`` f32, ``b`` bf16, ``t`` the
    rounding ties) and new errors equal the reference's row for that
    rank, bit for bit; the synced means agree across ranks."""
    port, ref = compressed
    ranks = port[2]
    for r, res in enumerate(ranks):
        got = res[case]
        assert sorted(got) == sorted(ref[case])
        harness.assert_same(got, {k: v[r] for k, v in ref[case].items()},
                            f"{case} rank {r}")
    for k in ("out.a", "out.b", "out.t"):
        np.testing.assert_array_equal(ranks[0][case][k], ranks[1][case][k])
