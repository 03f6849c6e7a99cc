"""The port's model land (config, norms, RWKV6 blocks, the Model facade,
the serve loop) against the JAX reference, on the reduced rwkv6 config.

Weights come from the reference's ``Model.init(jax.random.key(0))`` with
``mix_B``, ``decay_B`` and ``decay_base`` replaced by seeded numpy values
(the reference inits them to zeros, which would leave the LoRA paths and a
varying decay untested), carried into the port by
``convert.model_params_from_numpy``. Prompts are numpy, S = 37, so the WKV
kernel route pads. The reference runs eagerly; with ``use_rwkv_kernel``
its Pallas kernel runs in interpret mode.

Tolerances:

- f32: the same arithmetic; the WKV's sums and XLA's ``exp`` differ by
  ulps (measured: logits 1.1e-6 of |logits| <= 0.7, the wkv state 3.0e-5
  of |state| <= 42). Held to atol 1e-5, rtol 1e-4 on logits and
  activations, atol 2e-4, rtol 1e-5 on the wkv state.
- bf16 (``reduced(param_dtype=bfloat16, activation_dtype=bfloat16)``):
  the projections round bit for bit as the reference's, but an ulp of
  f32 in ``w`` or the WKV sum flips a bf16 rounding of ``y`` now and then
  (an ulp of bf16 is 0.4 %), and the flips travel through both layers.
  Measured over three seeds: relative L2 at most 0.0141 (forward), 0.0122
  (prefill logits), 0.0225 (decode logits), 0.0084 (caches). Held to a
  relative L2 of 5e-2 on logits and 3e-2 on caches.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import common as j_common
from repro.models import rwkv as j_rwkv
from repro.models import transformer as j_transformer
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model, common, rwkv, transformer

ARCH = "rwkv6-3b"
F32 = dict(act=dict(atol=1e-5, rtol=1e-4), state=dict(atol=2e-4, rtol=1e-5))
BF16_LOGITS, BF16_CACHE = 5e-2, 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEQ, BATCH, DECODE_STEPS = 37, 2, 8


def _configs(dtype):
    jd, td = DTYPES[dtype]
    j_cfg = j_get_config(ARCH).reduced(param_dtype=jd, activation_dtype=jd)
    t_cfg = get_config(ARCH).reduced(param_dtype=td, activation_dtype=td)
    return j_cfg, t_cfg


@functools.lru_cache(maxsize=None)
def _models(dtype):
    """(reference model, its params, port model) with the same weights."""
    j_cfg, t_cfg = _configs(dtype)
    j_model = JModel(j_cfg)
    params = j_model.init(jax.random.key(0))
    g = np.random.default_rng(0)
    tm = params["segments"][0][0]["mixer"]
    for name, draw in (("mix_B", lambda s: g.standard_normal(s) * 0.1),
                       ("decay_B", lambda s: g.standard_normal(s) * 0.1),
                       ("decay_base", lambda s: g.uniform(-5.0, 1.0, s))):
        tm[name] = jnp.asarray(draw(tm[name].shape), tm[name].dtype)
    model = Model(t_cfg, device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return j_model, params, model


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(dtype, got, want, kind):
    """kind: 'act' (logits, activations) or 'state' (the wkv state)."""
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32[kind])
    else:
        assert _rel(got, want) <= (BF16_LOGITS if kind == "act"
                                   else BF16_CACHE)


def _check_caches(dtype, got, want):
    got = convert.caches_to_numpy(got)
    assert len(got) == len(want)
    for g_seg, w_seg in zip(got, want):
        for g_c, w_c in zip(g_seg, w_seg):
            assert set(g_c) == set(w_c) == {"wkv", "tm_prev", "cm_prev"}
            for key in g_c:
                assert g_c[key].shape == np.asarray(w_c[key]).shape
                _check(dtype, g_c[key], w_c[key],
                       "state" if key == "wkv" else "act")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    want = j_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for field in dataclasses.fields(want):
        w = getattr(want, field.name)
        assert getattr(got, field.name) == dtypes.get(w, w), field.name
    assert (got.hd, got.padded_vocab) == (want.hd, want.padded_vocab)
    assert got.param_count() == want.param_count()
    n = Model(got, device="meta").param_count()
    assert n == JModel(want).param_count()
    if not smoke:
        assert n == 3_104_770_560


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_shapes(val, f"{prefix}.{key}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_model_tree_has_the_references_shapes():
    """Every parameter under the reference's key, with the reference's
    shape (per layer, the stacked axis dropped)."""
    j_cfg, t_cfg = _configs("f32")
    want = JModel(j_cfg).abstract_params()
    got = Model(t_cfg, device="meta").tree()
    for key in ("embed", "unembed", "final_norm"):
        assert _shapes(got[key]) == _shapes(want[key])
    want_block = {k: v[1:] for k, v in _shapes(
        want["segments"][0][0]).items()}
    assert len(got["segments"][0]) == t_cfg.n_layers
    for layer in got["segments"][0]:
        assert _shapes(layer[0]) == want_block


# the archs ported after the dense family (tests/test_torch_moe.py,
# test_torch_hybrid.py and test_torch_encdec.py hold them end to end)
UNPORTED_ARCHS = ["seamless-m4t-large-v2", "dbrx-132b", "olmoe-1b-7b",
                  "llama-3.2-vision-90b", "hymba-1.5b"]


def _leaf_shapes(tree, prefix=""):
    """Every leaf's shape by path, a segment's blocks per layer (the
    port's) or stacked (the reference's)."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_leaf_shapes(val, f"{prefix}.{key}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, val in enumerate(tree):
            out.update(_leaf_shapes(val, f"{prefix}[{i}]"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_other_archs_raise_naming_the_roadmap(arch):
    """Each of these archs (refused until their families were ported)
    builds on ``device="meta"`` with the reference's parameter shapes and
    count at the published size."""
    assert arch in ARCHS and arch in J_ARCHS
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    model = Model(cfg, device="meta")
    want = JModel(j_cfg).abstract_params()
    got = model.tree()
    assert set(got) == set(want)
    # the port's segments hold one block tree per layer: stack them
    for node, ref in ((got, want), (got.get("encoder"), want.get("encoder"))):
        if node is None:
            continue
        for si, seg in enumerate(node["segments"]):
            for j in range(len(seg[0])):
                layers = {k: (len(seg),) + v for k, v in
                          _leaf_shapes(seg[0][j]).items()}
                assert layers == _leaf_shapes(ref["segments"][si][j]), \
                    (arch, si, j)
        node = dict(node, segments=None)
        ref = dict(ref, segments=None)
        assert _leaf_shapes({k: v for k, v in node.items() if v is not None
                             and k != "encoder"}) == _leaf_shapes(
            {k: v for k, v in ref.items() if v is not None
             and k != "encoder"})
    # the reference's Model.param_count sums in int32: count its leaves
    leaves = jax.tree.leaves(want)
    assert model.param_count() == sum(int(np.prod(leaf.shape))
                                      for leaf in leaves)
    assert cfg.param_count() == j_cfg.param_count()


def test_model_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config(ARCH, smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.serve(ARCH, new_tokens=2, verbose=False)


# ---------------------------------------------------------------------------
# norms and blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_reference(dtype):
    jd, td = DTYPES[dtype]
    g = np.random.default_rng(3)
    x = (g.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    scale = g.standard_normal(64).astype(np.float32)
    jx, js = jnp.asarray(x, jd), jnp.asarray(scale, jd)
    tx, ts = torch.from_numpy(x).to(td), torch.from_numpy(scale).to(td)
    pairs = [(common.rmsnorm(ts, tx), j_common.rmsnorm({"scale": js}, jx)),
             (common.rmsnorm_1d(ts, tx), j_common.rmsnorm_1d(js, jx)),
             (common.groupnorm_heads(ts, tx, 4),
              j_common.groupnorm_heads(js, jx, 4))]
    for got, want in pairs:
        assert got.dtype == td
        # one rounding at the end on both sides
        np.testing.assert_allclose(_np(got), _np(want),
                                   atol=1e-5 if dtype == "f32" else 0,
                                   rtol=1e-5 if dtype == "f32" else 0)


def _block_inputs(dtype, seed=4):
    jd, td = DTYPES[dtype]
    j_model, params, model = _models(dtype)
    j_cfg, t_cfg = _configs(dtype)
    g = np.random.default_rng(seed)
    x = g.standard_normal((BATCH, SEQ, 64)).astype(np.float32)
    state = {"wkv": (g.standard_normal((BATCH, 4, 16, 16)) * 0.1).astype(
                 np.float32),
             "tm_prev": g.standard_normal((BATCH, 64)).astype(np.float32),
             "cm_prev": g.standard_normal((BATCH, 64)).astype(np.float32)}
    j_state = {k: jnp.asarray(v, jnp.float32 if k == "wkv" else jd)
               for k, v in state.items()}
    t_state = {k: torch.from_numpy(v).to(torch.float32 if k == "wkv"
                                         else td)
               for k, v in state.items()}
    j_block = jax.tree.map(lambda a: a[0], params["segments"][0][0])
    t_block = model.segments[0][0][0]
    return (j_cfg, t_cfg, jnp.asarray(x, jd), torch.from_numpy(x).to(td),
            j_state, t_state, j_block, t_block)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_tm_apply_matches_reference(dtype, use_kernel):
    j_cfg, t_cfg, jx, tx, j_state, t_state, j_block, t_block = \
        _block_inputs(dtype)
    want, want_state = j_rwkv.tm_apply(j_block["mixer"], j_cfg, jx, j_state,
                                       use_kernel=use_kernel)
    with torch.no_grad():
        got, got_state = rwkv.tm_apply(t_block.mixer.tree(), t_cfg, tx,
                                       t_state, use_kernel=use_kernel)
    assert got.dtype == tx.dtype and got_state["wkv"].dtype == torch.float32
    _check(dtype, got, want, "act")
    _check(dtype, got_state["wkv"], want_state["wkv"], "state")
    assert torch.equal(got_state["tm_prev"], tx[:, -1])
    assert torch.equal(got_state["cm_prev"], t_state["cm_prev"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cm_apply_matches_reference(dtype):
    j_cfg, t_cfg, jx, tx, j_state, t_state, j_block, t_block = \
        _block_inputs(dtype)
    want, _ = j_rwkv.cm_apply(j_block["ffn"], j_cfg, jx, j_state)
    with torch.no_grad():
        got, got_state = rwkv.cm_apply(t_block.ffn.tree(), t_cfg, tx,
                                       t_state)
    _check(dtype, got, want, "act")
    assert torch.equal(got_state["cm_prev"], tx[:, -1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_block_apply_matches_reference(dtype, mode):
    j_cfg, t_cfg, jx, tx, j_state, t_state, j_block, t_block = \
        _block_inputs(dtype)
    if mode == "decode":
        jx, tx = jx[:, :1], tx[:, :1]
    bc = transformer.BlockCfg(mixer="rwkv", ffn="rwkv_cm")
    j_bc = j_transformer.BlockCfg(mixer="rwkv", ffn="rwkv_cm")
    cache = mode == "decode"
    want, want_c, _ = j_transformer.block_apply(
        j_bc, j_cfg, j_block, jx, mode=mode,
        cache=j_state if cache else None, use_rwkv_kernel=True)
    with torch.no_grad():
        got, got_c, _ = transformer.block_apply(
            bc, t_cfg, t_block.tree(), tx, mode=mode,
            cache=t_state if cache else None, use_rwkv_kernel=True)
    _check(dtype, got, want, "act")
    _check(dtype, got_c["wkv"], want_c["wkv"], "state")
    _check(dtype, got_c["cm_prev"], want_c["cm_prev"], "act")


def test_blank_state_and_caches_have_the_references_layout():
    j_cfg, t_cfg = _configs("bf16")
    want = JModel(j_cfg).blank_caches(3, 40)
    t_model_caches = _models("bf16")[2].blank_caches(3, 40)
    for g_c, w_c in zip(t_model_caches[0], want[0]):
        for key in w_c:
            assert tuple(g_c[key].shape) == w_c[key].shape, key
            assert not bool(g_c[key].any())
            assert g_c[key].dtype == (torch.float32 if key == "wkv"
                                      else torch.bfloat16)
    one = rwkv.blank_state(t_cfg, 3, None, "cpu")
    assert tuple(one["wkv"].shape) == (3, 4, 16, 16)


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_reference(dtype):
    j_model, params, model = _models(dtype)
    tok = _tokens(1, (BATCH, SEQ))
    want, _ = j_model.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux = model({"tokens": torch.from_numpy(tok).long()})
    assert all(float(v) == 0.0 for v in aux.values())
    assert got.shape == (BATCH, SEQ, 256) and got.dtype == torch.float32
    _check(dtype, got, want, "act")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_match_reference(dtype, use_kernel):
    """Prefill (logits and caches) on both routes, then eight
    teacher-forced decode steps from the prefill's caches."""
    j_model, params, model = _models(dtype)
    tok = _tokens(1, (BATCH, SEQ))
    want, want_c, _ = j_model.prefill(params, {"tokens": jnp.asarray(tok)},
                                      use_rwkv_kernel=use_kernel)
    got, got_c, _ = make_prefill_step(model, use_rwkv_kernel=use_kernel)(
        {"tokens": torch.from_numpy(tok).long()})
    assert got.shape == (BATCH, 256)
    _check(dtype, got, want, "act")
    _check_caches(dtype, got_c, want_c)
    decode = make_decode_step(model)
    nxt = _tokens(2, (BATCH, DECODE_STEPS))
    for step in range(DECODE_STEPS):
        index = SEQ + step
        want, want_c = j_model.decode(params, jnp.asarray(
            nxt[:, step:step + 1]), jnp.int32(index), want_c)
        got, got_c = decode({"token": torch.from_numpy(
            nxt[:, step:step + 1]).long(), "index": index, "caches": got_c})
        _check(dtype, got, want, "act")
    _check_caches(dtype, got_c, want_c)


def test_prefill_routes_agree_and_count_launches():
    """Both routes give one answer; on CPU tensors the kernel route runs
    the plain chunked version and counts no launch."""
    _, _, model = _models("f32")
    tok = torch.from_numpy(_tokens(5, (3, 64))).long()
    before = LAUNCHES["wkv"]
    a, ca, _ = model.prefill({"tokens": tok}, use_rwkv_kernel=True)
    b, cb, _ = model.prefill({"tokens": tok}, use_rwkv_kernel=False)
    assert LAUNCHES["wkv"] == before
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32["act"])
    np.testing.assert_allclose(ca[0][0]["wkv"].numpy(),
                               cb[0][0]["wkv"].numpy(), **F32["state"])


def test_caches_round_trip_through_numpy():
    _, _, model = _models("bf16")
    _, caches, _ = model.prefill({"tokens": torch.from_numpy(
        _tokens(6, (2, 9))).long()})
    back = convert.caches_from_numpy(
        convert.caches_to_numpy(caches), torch.bfloat16, "cpu")
    for key, val in caches[0][0].items():
        assert back[0][0][key].dtype == val.dtype
        assert torch.equal(back[0][0][key], val)


def test_params_from_numpy_refuses_a_wrong_tree():
    j_model, params, model = _models("f32")
    tree = jax.tree.map(np.asarray, params)
    tree["segments"][0][0]["mixer"].pop("bonus_u")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_numpy(model, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(model, tree)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_serve_on_cpu_returns_greedy_tokens(capsys):
    toks = serve_mod.serve(ARCH, batch=3, prompt_len=SEQ, new_tokens=5,
                           seed=1, device="cpu")
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    assert bool(((toks >= 0) & (toks < 256)).all())
    assert "prefill(3x37)" in capsys.readouterr().out
    plain = serve_mod.serve(ARCH, batch=3, prompt_len=SEQ, new_tokens=5,
                            seed=1, device="cpu", verbose=False,
                            use_rwkv_kernel=False)
    assert torch.equal(toks, plain)
    with pytest.raises(NotImplementedError, match="greedy"):
        serve_mod.serve(ARCH, greedy=False, device="cpu")


def test_generate_is_prefill_then_greedy_decode():
    _, _, model = _models("f32")
    prompts = torch.from_numpy(_tokens(7, (2, 11))).long()
    toks, t = serve_mod.generate(model, prompts, 4)
    assert t["decode_steps"] == 3 and t["prefill_s"] > 0
    logits, caches, _ = model.prefill({"tokens": prompts})
    want = [logits.argmax(-1)]
    for step in range(3):
        logits, caches = model.decode(want[-1][:, None], 11 + step, caches)
        want.append(logits.argmax(-1))
    assert torch.equal(toks, torch.stack(want, 1))
