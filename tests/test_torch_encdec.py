"""The port's encoder-decoder (seamless-m4t-large-v2) and vision
cross-attention (llama-3.2-vision-90b) against the JAX reference, at
``reduced()``.

seamless: the encoder plan (bidirectional attention with rope, run in
train mode over ``src_embed``), decoder blocks with ``ln_cross`` and
cross-attention over the encoder's output, its source keys and values
precomputed for decode (``cross_kvs``). llama-3.2-vision: the superblock
plan (self-attention blocks and a gated cross-attention block reading
``vision_embed``), the gate set to ``VLM_GATE`` in both packages (zero at
init, tanh(0) = 0 and the cross layer would add nothing). Tolerances as
the dense family's: f32 logits within atol 1e-5, rtol 1e-4 (other sum
orders, PyTorch's ``tanh`` and ``exp``; measured at most 7.1e-7 relative
L2 on logits).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.models import transformer as j_transformer
from repro_torch import convert
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model, transformer

MODEL_F32 = (1e-5, 1e-4)
ENCDEC, VLM = "seamless-m4t-large-v2", "llama-3.2-vision-90b"


def _plans(plan):
    return [(s.n, [dataclasses.asdict(b) for b in s.pattern]) for s in plan]


@pytest.mark.parametrize("smoke", [False, True])
def test_plans_are_the_references(smoke):
    for arch in (ENCDEC, VLM):
        cfg, j_cfg = fam.get_config(arch, smoke), fam.j_get_config(arch,
                                                                   smoke)
        assert _plans(transformer.make_plan(cfg)) == _plans(
            j_transformer.make_plan(j_cfg))
    cfg, j_cfg = fam.get_config(ENCDEC, smoke), fam.j_get_config(ENCDEC,
                                                                 smoke)
    assert _plans(transformer.make_encoder_plan(cfg)) == _plans(
        j_transformer.make_encoder_plan(j_cfg))
    vlm = transformer.make_plan(fam.get_config(VLM, smoke))
    want = (20, 4) if not smoke else (1, 1)
    assert (vlm[0].n, sum(b.mixer == "attn" for b in vlm[0].pattern)) == want
    assert vlm[0].pattern[-1].mixer == "cross"


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_forward_and_loss_match_reference(arch):
    fam.forward_loss(arch, MODEL_F32)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_prefill_and_decode_carry_cross_kvs(arch):
    """Prefill (caches None at the cross positions, the cross layers'
    source keys and values) then teacher-forced decode over them, on the
    flash route (its plain version on the CPU)."""
    fam.prefill_decode(arch, MODEL_F32, use_flash=True)


def test_encoder_and_cross_kvs_match_reference():
    j_model, params, model = fam.models(ENCDEC)
    jb, tb = fam.both(fam.inputs(model.cfg, 8, 5),
                      keys=("tokens", "src_embed"))
    want = jax.jit(lambda p, s: j_model._encode(p, s, False))(
        params, jb["src_embed"])
    with torch.no_grad():
        got = model._encode(tb["src_embed"], False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    kv = model.precompute_cross_kvs(got)
    want_kv = j_model.precompute_cross_kvs(params, want)
    fam.check_caches(kv, want_kv, (1e-5, 1e-4))
    assert kv[0][0]["k"].shape == (model.cfg.n_layers, fam.BATCH,
                                   fam.SRC_LEN, model.cfg.n_kv_heads,
                                   model.cfg.hd)


def test_zero_gate_adds_nothing_in_both():
    """At init the vision model's gate is zero: the cross layer's output
    is tanh(0) times the attention, exactly zero, in both packages."""
    j_cfg, t_cfg = fam.configs(VLM)
    j_model = fam.JModel(j_cfg)
    params = j_model.init(jax.random.key(0))
    model = Model(t_cfg, device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    jb, tb = fam.both(fam.inputs(t_cfg, 10, 8))
    plan = model.plan
    x = model._embed(tb["tokens"])
    p = model.segments[0][0][1].tree()
    assert float(p["mixer"]["gate"].detach().abs().max()) == 0.0
    with torch.no_grad():
        out, _, _ = transformer.block_apply(
            plan[0].pattern[1], t_cfg, p, x, mode="train",
            cross_src=tb["vision_embed"])
        h = transformer.rmsnorm(p["ln2"]["scale"], x, t_cfg.norm_eps)
        ffn_only = x + transformer.mlp.apply(p["ffn"], t_cfg, h)
    assert torch.equal(out, ffn_only)
    want, _ = j_model.forward(params, jb)
    with torch.no_grad():
        got, _ = model(tb)
    fam.check_close(got, want, MODEL_F32)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_train_step_matches_reference(arch):
    fam.train_step(arch, tol_params=1e-6, tol_gnorm=1e-5)


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_serve_runs_with_its_source_inputs_on_cpu(arch, capsys):
    """``serve`` draws ``src_embed`` or ``vision_embed`` beside the prompts
    (``make_inputs``) and returns greedy tokens; the plain route gives the
    same ones."""
    toks = serve_mod.serve(arch, batch=2, prompt_len=12, new_tokens=4,
                           seed=3, device="cpu")
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < 256)).all())
    assert "prefill(2x12)" in capsys.readouterr().out
    plain = serve_mod.serve(arch, batch=2, prompt_len=12, new_tokens=4,
                            seed=3, device="cpu", verbose=False,
                            use_flash=False)
    assert torch.equal(toks, plain)
    cfg = fam.get_config(arch, smoke=True)
    _, extra = serve_mod.make_inputs(cfg, 2, 12, 4, torch.device("cpu"))
    key = "src_embed" if arch == ENCDEC else "vision_embed"
    assert set(extra) == {key}
    assert extra[key].shape == (2, serve_mod.SRC_LEN if arch == ENCDEC
                                else cfg.vision_seq, cfg.d_model)


def test_caches_with_cross_positions_round_trip_through_numpy():
    _, _, model = fam.models(VLM)
    b = fam.inputs(model.cfg, 9, 6)
    _, caches, xkv = model.prefill({"tokens": torch.from_numpy(
        b["tokens"]).long(), "vision_embed": torch.from_numpy(
            b["vision_embed"])}, max_seq=12)
    assert caches[0][1] is None and xkv[0][0] is None
    back = convert.caches_from_numpy(convert.caches_to_numpy(caches),
                                     torch.float32, "cpu")
    assert back[0][1] is None
    for key, val in caches[0][0].items():
        assert back[0][0][key].dtype == val.dtype
        assert torch.equal(back[0][0][key], val)
    blank = model.blank_caches(2, 12)
    want = fam.JModel(fam.configs(VLM)[0]).blank_caches(2, 12)
    fam.check_caches(blank, want, (0, 0))
