"""The port's dense family (yi-9b, qwen3-32b, granite-34b, minicpm-2b) end
to end against the JAX reference, at ``reduced()``.

Weights come from the reference's ``Model.init(jax.random.key(0))``,
carried into the port by ``convert.model_params_from_numpy``. Prompts are
numpy, S = 37 (the flash route runs a ragged last tile). The reference
runs eagerly; with ``use_flash`` its Pallas kernel runs in interpret mode,
while on CPU tensors the port's flash wrapper runs its plain version.
Tolerances:

- f32: the same arithmetic, sums in another order and PyTorch's CPU
  ``cos``, ``sin``, ``tanh`` and ``exp`` an ulp from XLA's (measured:
  logits within 1e-6 relative L2). Held to atol 1e-5, rtol 1e-4.
- bf16: the matmuls and activations round as the reference's, but an ulp
  of f32 in a rope angle flips a bf16 rounding of q or k now and then (an
  ulp of bf16 is 0.4 %), and the flips travel through both layers
  (ROADMAP Queue C). Measured at most 1.2e-2 relative L2 on logits and
  6.2e-3 on the caches; held to 5e-2 on logits and 3e-2 on caches, as the
  rwkv6 tests hold theirs.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model, transformer

DENSE = ["yi-9b", "qwen3-32b", "granite-34b", "minicpm-2b"]
F32 = dict(atol=1e-5, rtol=1e-4)
BF16_LOGITS, BF16_CACHE = 5e-2, 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SEQ, BATCH, DECODE_STEPS, BUDGET = 37, 2, 8, 48
# published parameter counts (the reference's ModelConfig.param_count)
PARAMS = {"yi-9b": 8_829_009_920}


def _configs(arch, dtype):
    jd, td = DTYPES[dtype]
    return (j_get_config(arch).reduced(param_dtype=jd, activation_dtype=jd),
            get_config(arch).reduced(param_dtype=td, activation_dtype=td))


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    """(reference model, its params, port model) with the same weights."""
    j_cfg, t_cfg = _configs(arch, dtype)
    j_model = JModel(j_cfg)
    params = j_model.init(jax.random.key(0))
    model = Model(t_cfg, device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return j_model, params, model


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(dtype, got, want, limit=BF16_LOGITS):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert _rel(got, want) <= limit


def _check_caches(dtype, got, want):
    got = convert.caches_to_numpy(got)
    assert len(got) == len(want)
    for g_seg, w_seg in zip(got, want):
        for g_c, w_c in zip(g_seg, w_seg):
            assert set(g_c) == set(w_c) == {"k", "v", "pos"}
            np.testing.assert_array_equal(g_c["pos"], np.asarray(w_c["pos"]))
            for key in ("k", "v"):
                assert g_c[key].shape == np.asarray(w_c[key]).shape
                _check(dtype, g_c[key], w_c[key], BF16_CACHE)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, plan and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch, smoke):
    want = j_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for field in dataclasses.fields(want):
        w = getattr(want, field.name)
        assert getattr(got, field.name) == dtypes.get(w, w), field.name
    assert got.param_count() == want.param_count()
    if not smoke and arch in PARAMS:
        assert got.param_count()[0] == PARAMS[arch]
    # the reference's Model.param_count sums in int32, which overflows
    # above 2**31 parameters: count its leaves' shapes here
    leaves = jax.tree.leaves(JModel(want).abstract_params())
    n = Model(got, device="meta").param_count()
    assert n == sum(int(np.prod(leaf.shape)) for leaf in leaves)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_shapes(val, f"{prefix}.{key}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", DENSE)
def test_plan_and_tree_have_the_references_shapes(arch):
    j_cfg, t_cfg = _configs(arch, "f32")
    plan = transformer.make_plan(t_cfg)
    assert [(s.n, s.pattern) for s in plan] == [(t_cfg.n_layers, (
        transformer.BlockCfg(mixer="attn", ffn="mlp"),))]
    want = JModel(j_cfg).abstract_params()
    got = Model(t_cfg, device="meta").tree()
    assert set(got) == set(want)
    for key in got:
        if key != "segments":
            assert _shapes(got[key]) == _shapes(want[key])
    want_block = {k: v[1:] for k, v in _shapes(
        want["segments"][0][0]).items()}
    for layer in got["segments"][0]:
        assert _shapes(layer[0]) == want_block


def test_moe_plans_still_raise():
    """A dense config given experts plans MoE blocks (they were refused
    before the MoE family was ported), as the reference plans them, and
    its model has the reference's parameter shapes."""
    cfg = dataclasses.replace(get_config("yi-9b", smoke=True), n_experts=4,
                              experts_per_token=2)
    j_cfg = dataclasses.replace(j_get_config("yi-9b", smoke=True),
                                n_experts=4, experts_per_token=2)
    from repro.models import transformer as j_transformer
    plan = transformer.make_plan(cfg)
    assert [(s.n, s.pattern) for s in plan] == [(cfg.n_layers, (
        transformer.BlockCfg(mixer="attn", ffn="moe"),))]
    assert [(s.n, dataclasses.asdict(s.pattern[0])) for s in plan] == [
        (s.n, dataclasses.asdict(s.pattern[0]))
        for s in j_transformer.make_plan(j_cfg)]
    want = JModel(j_cfg).abstract_params()["segments"][0][0]["ffn"]
    got = Model(cfg, device="meta").tree()["segments"][0][0][0]["ffn"]
    assert _shapes(got) == {k: v[1:] for k, v in _shapes(want).items()}


def test_params_from_numpy_refuses_a_wrong_tree():
    _, params, model = _models("qwen3-32b", "f32")
    tree = jax.tree.map(np.asarray, params)
    tree["segments"][0][0]["mixer"].pop("q_norm.scale")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_numpy(model, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["segments"][0][0]["ffn"]["wd"] = tree["segments"][0][0]["ffn"][
        "wd"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(model, tree)


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, dtype):
    j_model, params, model = _models(arch, dtype)
    tok = _tokens(1, (BATCH, SEQ))
    want, _ = j_model.forward(params, {"tokens": jnp.asarray(tok)})
    with torch.no_grad():
        got, aux = model({"tokens": torch.from_numpy(tok).long()})
    assert all(float(v) == 0.0 for v in aux.values())
    assert got.shape == (BATCH, SEQ, 256) and got.dtype == torch.float32
    _check(dtype, got, want)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dtype, use_flash):
    """Prefill (logits and ring caches of a 48-slot budget) on both routes,
    then eight teacher-forced decode steps from the prefill's caches."""
    j_model, params, model = _models(arch, dtype)
    tok = _tokens(1, (BATCH, SEQ))
    want, want_c, _ = j_model.prefill(params, {"tokens": jnp.asarray(tok)},
                                      use_flash=use_flash, max_seq=BUDGET)
    before = LAUNCHES["flash_attention"]
    got, got_c, _ = make_prefill_step(model, max_seq=BUDGET,
                                   use_flash=use_flash)(
        {"tokens": torch.from_numpy(tok).long()})
    assert LAUNCHES["flash_attention"] == before
    assert got.shape == (BATCH, 256)
    _check(dtype, got, want)
    _check_caches(dtype, got_c, want_c)
    decode = make_decode_step(model)
    nxt = _tokens(2, (BATCH, DECODE_STEPS))
    for step in range(DECODE_STEPS):
        index = SEQ + step
        want, want_c = j_model.decode(params, jnp.asarray(
            nxt[:, step:step + 1]), jnp.int32(index), want_c)
        got, got_c = decode({"token": torch.from_numpy(
            nxt[:, step:step + 1]).long(), "index": index, "caches": got_c})
        _check(dtype, got, want)
    _check_caches(dtype, got_c, want_c)


def test_blank_caches_have_the_references_layout():
    j_cfg, _ = _configs("granite-34b", "bf16")
    want = JModel(j_cfg).blank_caches(3, 40)
    got = _models("granite-34b", "bf16")[2].blank_caches(3, 40)
    for g_c, w_c in zip(got[0], want[0]):
        for key in ("k", "v", "pos"):
            assert tuple(g_c[key].shape) == w_c[key].shape, key
            np.testing.assert_array_equal(_np(g_c[key]), _np(w_c[key]))
        assert g_c["k"].dtype == torch.bfloat16
        assert g_c["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["yi-9b", "minicpm-2b"])
def test_caches_round_trip_through_numpy(arch):
    _, _, model = _models(arch, "bf16")
    _, caches, _ = model.prefill({"tokens": torch.from_numpy(
        _tokens(6, (2, 9))).long()}, max_seq=12)
    back = convert.caches_from_numpy(convert.caches_to_numpy(caches),
                                     torch.bfloat16, "cpu")
    for key, val in caches[0][0].items():
        assert back[0][0][key].dtype == val.dtype
        assert torch.equal(back[0][0][key], val)


def test_prefill_routes_agree_and_count_no_launch_on_cpu():
    """On CPU tensors the flash route runs the plain version: no launch,
    and the plain path's answer (both sum in f32)."""
    _, _, model = _models("yi-9b", "f32")
    tok = torch.from_numpy(_tokens(5, (3, 64))).long()
    before = LAUNCHES["flash_attention"]
    a, ca, _ = model.prefill({"tokens": tok}, use_flash=True)
    b, cb, _ = model.prefill({"tokens": tok}, use_flash=False)
    with torch.no_grad():
        model({"tokens": tok}, use_flash=True)
    assert LAUNCHES["flash_attention"] == before
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
    assert torch.equal(ca[0][0]["k"], cb[0][0]["k"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def test_serve_yi_on_cpu_returns_greedy_tokens(capsys):
    toks = serve_mod.serve("yi-9b", batch=3, prompt_len=SEQ, new_tokens=5,
                           seed=1, device="cpu")
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    assert bool(((toks >= 0) & (toks < 256)).all())
    assert "prefill(3x37)" in capsys.readouterr().out
    plain = serve_mod.serve("yi-9b", batch=3, prompt_len=SEQ, new_tokens=5,
                            seed=1, device="cpu", verbose=False,
                            use_flash=False)
    assert torch.equal(toks, plain)


def test_generate_is_prefill_then_greedy_decode_over_the_ring():
    _, _, model = _models("minicpm-2b", "f32")
    prompts = torch.from_numpy(_tokens(7, (2, 11))).long()
    toks, t = serve_mod.generate(model, prompts, 4)
    assert t["decode_steps"] == 3
    logits, caches, _ = model.prefill({"tokens": prompts}, max_seq=15)
    assert caches[0][0]["k"].shape[2] == 15
    want = [logits.argmax(-1)]
    for step in range(3):
        logits, caches = model.decode(want[-1][:, None], 11 + step, caches)
        want.append(logits.argmax(-1))
    assert torch.equal(toks, torch.stack(want, 1))
    assert caches[0][0]["pos"][0].tolist() == list(range(14)) + [-1]
