"""The port's SSM branch (``models/ssm.py``) and hymba-1.5b's hybrid
mixer, run-length plan and meta tokens against the JAX reference, at
``reduced()`` (window 16, 8 meta tokens, global layer 0).

The reference runs jitted: XLA fuses the scan's ``A2 * b1 + b2`` and the
carry-in ``dBx[0] + dA[0] * h0`` into fused multiply-adds, and the port
follows that through ``models.common.fma``. The scan equals the jitted
reference's bit for bit (T = 1, 7, 256, 300, f32). ``apply_seq`` and
``apply_step`` do not (ROADMAP Queue C): the first element that differs
is the ``silu`` after the conv (XLA's ``logistic``, whose ``exp``
differs from PyTorch's in about 3 % of f32 inputs), then the small
products ``xin @ wbc`` and ``xin @ wdt`` (another summation order) and
the ``einsum`` over the state; the conv itself is bit-exact. Measured
at most 6.6e-6 apart at S = 512; held to atol 2e-5, rtol 1e-4 (f32), and
the model's logits as the dense family's (atol 1e-5, rtol 1e-4).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.launch import serve as j_serve
from repro.models import ssm as j_ssm
from repro.models import transformer as j_transformer
from repro.models.common import init_maker as j_init_maker
from repro_torch import convert
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, ssm, transformer

SSM_TOL = dict(atol=2e-5, rtol=1e-4)
MODEL_F32 = (1e-5, 1e-4)
ARCH = "hymba-1.5b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssm_layer(seed=0):
    """Reference config and SSM params (dt_bias drawn: zero at init),
    and the port's."""
    j_cfg, t_cfg = fam.configs(ARCH)
    p = dict(j_ssm.params(j_cfg, j_init_maker(jax.random.key(seed),
                                             jnp.float32), "s", None))
    p["dt_bias"] = jnp.asarray(np.random.default_rng(seed).standard_normal(
        p["dt_bias"].shape).astype(np.float32) * 0.5)
    return j_cfg, p, t_cfg, {k: _t(v) for k, v in p.items()}


def _state(cfg, seed):
    g = np.random.default_rng(seed)
    st = j_ssm.blank_state(cfg, 2, None)
    return {k: g.standard_normal(v.shape).astype(np.float32)
            for k, v in st.items()}


@pytest.mark.parametrize("T", [1, 7, 256, 300])
def test_scan_is_the_jitted_references_bit_for_bit(T):
    g = np.random.default_rng(T)
    dA = g.uniform(0.5, 1.0, (2, T, 40, 16)).astype(np.float32)
    dBx = g.standard_normal((2, T, 40, 16)).astype(np.float32)
    h0 = g.standard_normal((2, 40, 16)).astype(np.float32)
    want = np.asarray(jax.jit(j_ssm._ssm_scan_block)(dA, dBx, h0))
    got = ssm.scan_block(_t(dA), _t(dBx), _t(h0))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_recurses_as_associative_scan():
    """The recursion against the sequential recurrence (an f32 sum in
    another order)."""
    g = np.random.default_rng(1)
    a = torch.from_numpy(g.uniform(0.5, 1.0, (1, 64, 3)).astype(np.float32))
    b = torch.from_numpy(g.standard_normal((1, 64, 3)).astype(np.float32))
    h = ssm.associative_scan(a, b)
    want, acc = [], torch.zeros(1, 3)
    for t in range(64):
        acc = a[:, t] * acc + b[:, t]
        want.append(acc)
    np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_softplus_and_conv_follow_the_reference():
    g = np.random.default_rng(2)
    x = g.standard_normal(4096).astype(np.float32) * 30
    np.testing.assert_allclose(ssm.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2e-7,
                               atol=1e-30)
    j_cfg, p, _, tp = _ssm_layer()
    xin = g.standard_normal((2, 16, 128)).astype(np.float32)
    prev = g.standard_normal((2, 3, 128)).astype(np.float32)
    want, w_state = jax.jit(lambda p, x, pr: j_ssm._causal_conv(
        p, x, pr))(p, xin, prev)
    got, g_state = ssm._causal_conv(tp["conv"], _t(xin), _t(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(g_state.numpy(), np.asarray(w_state))


@pytest.mark.parametrize("seq", [16, 256, 512])
def test_apply_seq_matches_jitted_reference(seq):
    """Whole-block (S <= SSM_CHUNK) and chunked (S = 512: two chunks, the
    state carried) from a nonzero state."""
    j_cfg, p, t_cfg, tp = _ssm_layer()
    x = np.random.default_rng(seq).standard_normal((2, seq, 64)).astype(
        np.float32)
    st = _state(j_cfg, 3)
    want, w_st = jax.jit(lambda p, x, s: j_ssm.apply_seq(p, j_cfg, x, s))(
        p, x, st)
    got, g_st = ssm.apply_seq(tp, t_cfg, _t(x), {k: _t(v) for k, v in
                                                st.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSM_TOL)
    np.testing.assert_allclose(g_st["h"].numpy(), np.asarray(w_st["h"]),
                               **SSM_TOL)
    np.testing.assert_array_equal(g_st["conv"].numpy(),
                                  np.asarray(w_st["conv"]))


def test_apply_step_matches_jitted_reference():
    j_cfg, p, t_cfg, tp = _ssm_layer()
    st = _state(j_cfg, 4)
    tst = {k: _t(v) for k, v in st.items()}
    step = jax.jit(lambda p, x, s: j_ssm.apply_step(p, j_cfg, x, s))
    for i in range(4):
        x = np.random.default_rng(10 + i).standard_normal((2, 1, 64)).astype(
            np.float32)
        want, st = step(p, x, st)
        got, tst = ssm.apply_step(tp, t_cfg, _t(x), tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSM_TOL)
        np.testing.assert_allclose(tst["h"].numpy(), np.asarray(st["h"]),
                                   **SSM_TOL)


@pytest.mark.parametrize("smoke", [False, True])
def test_run_length_plan_is_the_references(smoke):
    cfg, j_cfg = fam.get_config(ARCH, smoke), fam.j_get_config(ARCH, smoke)
    plan = transformer.make_plan(cfg)
    assert [(s.n, [dataclasses.asdict(b) for b in s.pattern])
            for s in plan] == [
        (s.n, [dataclasses.asdict(b) for b in s.pattern])
        for s in j_transformer.make_plan(j_cfg)]
    if not smoke:   # globals {0, 15, 31}: 1, 14 windowed, 1, 15, 1
        assert [(s.n, s.pattern[0].window) for s in plan] == [
            (1, 0), (14, 1024), (1, 0), (15, 1024), (1, 0)]
    for w in (16, 2048):
        for bc in (b for s in plan for b in s.pattern):
            assert transformer._cache_window(bc, cfg, w) == \
                j_transformer._cache_window(bc, j_cfg, w)


def test_forward_and_loss_match_reference():
    fam.forward_loss(ARCH, MODEL_F32, seq=40)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_and_decode_keep_meta_tokens_in_the_ring(use_flash):
    """A 40-token prompt after 8 meta tokens through a window of 16: the
    windowed layer's ring (24 slots) keeps the meta tokens in slots 0-7
    and wraps the rest; the global layer keeps the whole budget."""
    caches = fam.prefill_decode(ARCH, MODEL_F32, seq=40,
                                use_flash=use_flash)
    cfg = fam.models(ARCH)[2].cfg
    windowed = [c for s, seg in zip(transformer.make_plan(cfg), caches)
                for bc, c in zip(s.pattern, seg) if bc.window]
    assert windowed
    pos = windowed[0]["attn"]["pos"][0]
    assert pos.shape[0] == cfg.sliding_window + cfg.n_meta_tokens
    assert pos[:cfg.n_meta_tokens].tolist() == list(range(
        cfg.n_meta_tokens))
    assert int(pos.min()) >= 0
    assert attention._slot(40 + 8 + 5, 24, 8) == 8 + (45 % 16)


def test_train_step_matches_reference():
    fam.train_step(ARCH, tol_params=1e-6, tol_gnorm=1e-5)


def test_serve_gives_the_references_greedy_tokens(monkeypatch):
    """``serve("hymba-1.5b", device="cpu")`` with the reference's weights
    and prompts (in place of its own draws) returns the reference's
    ``serve`` tokens: the meta-token offset in the budget and in every
    decode position."""
    batch, prompt_len, new = 2, 20, 6
    want = np.asarray(j_serve.serve(ARCH, batch=batch,
                                    prompt_len=prompt_len, new_tokens=new,
                                    seed=0, verbose=False))
    j_model = fam.JModel(fam.j_get_config(ARCH, smoke=True))
    params = j_model.init(jax.random.key(0))
    model = fam.Model(fam.get_config(ARCH, smoke=True), device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    ks = jax.random.split(jax.random.key(1), 3)
    prompts = np.asarray(jax.random.randint(ks[0], (batch, prompt_len), 0,
                                            model.cfg.vocab_size))
    monkeypatch.setattr(serve_mod, "build_model", lambda *a: model)
    monkeypatch.setattr(serve_mod, "make_inputs", lambda *a: (
        torch.from_numpy(prompts.copy()).long(), {}))
    got = serve_mod.serve(ARCH, batch=batch, prompt_len=prompt_len,
                          new_tokens=new, seed=0, device="cpu",
                          verbose=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_caches_round_trip_through_numpy():
    _, _, model = fam.models(ARCH)
    tok = torch.from_numpy(fam.inputs(model.cfg, 12, 6)["tokens"]).long()
    _, caches, _ = model.prefill({"tokens": tok}, max_seq=20)
    back = convert.caches_from_numpy(convert.caches_to_numpy(caches),
                                     torch.float32, "cpu")
    for seg, bseg in zip(caches, back):
        for c, b in zip(seg, bseg):
            for part in ("attn", "ssm"):
                for key, val in c[part].items():
                    assert b[part][key].dtype == val.dtype
                    assert torch.equal(b[part][key], val)
    blank = model.blank_caches(2, 20)
    want = fam.JModel(fam.configs(ARCH)[0]).blank_caches(2, 20)
    fam.check_caches(blank, want, (0, 0))
