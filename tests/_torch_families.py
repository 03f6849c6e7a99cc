"""Shared checks of the port's model families against the JAX reference,
at ``reduced()`` (tests/test_torch_moe.py, test_torch_hybrid.py and
test_torch_encdec.py).

Weights come from the reference's ``Model.init(jax.random.key(0))``
(the vision model's cross gates set to ``VLM_GATE``: zero at init, a
cross layer would add nothing and the comparison would hold nothing),
carried into the port by ``convert.model_params_from_numpy``. Inputs are
numpy, made from a seed. The reference runs jitted, as it serves and
trains: its compiled form fuses the SSM scan's multiply-adds, which the
port follows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_threefry_partitionable", True)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.steps import init_train_state as j_init  # noqa: E402
from repro.launch.steps import make_train_step as j_make_step  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import make_schedule as j_schedule  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import make_schedule  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
VLM_GATE = 0.7
BATCH, SRC_LEN = 2, 16


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def rel(got, want) -> float:
    got, want = np32(got), np32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def configs(arch, dtype="f32", **over):
    jd, td = DTYPES[dtype]
    return (j_get_config(arch).reduced(param_dtype=jd, activation_dtype=jd,
                                       **over),
            get_config(arch).reduced(param_dtype=td, activation_dtype=td,
                                     **over))


def _gate_cross(params):
    """Set every cross layer's gate to VLM_GATE (the reference's tree)."""
    for seg in params["segments"]:
        for block in seg:
            if "gate" in block["mixer"]:
                block["mixer"]["gate"] = jnp.full_like(block["mixer"]["gate"],
                                                       VLM_GATE)
    return params


@functools.lru_cache(maxsize=None)
def models(arch, dtype="f32", over=()):
    """(reference model, its params, port model) with the same weights;
    ``over`` a tuple of (field, value) config overrides."""
    j_cfg, t_cfg = configs(arch, dtype, **dict(over))
    j_model = JModel(j_cfg)
    params = _gate_cross(j_model.init(jax.random.key(0)))
    model = Model(t_cfg, device="cpu")
    convert.model_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return j_model, params, model


def inputs(cfg, seq, seed, batch=BATCH):
    """Numpy tokens (B, S) and labels, and the arch's source inputs."""
    g = np.random.default_rng(seed)
    out = {"tokens": g.integers(0, 256, (batch, seq)).astype(np.int32),
           "labels": g.integers(0, 256, (batch, seq)).astype(np.int32)}
    if cfg.n_encoder_layers:
        out["src_embed"] = g.standard_normal(
            (batch, SRC_LEN, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embed"] = g.standard_normal(
            (batch, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return out


def both(batch, dtype="f32", keys=None):
    """The batch for the reference (jnp) and for the port (torch): int
    tokens as int32 and int64, embeddings in the activations' dtype."""
    jd, td = DTYPES[dtype]
    jb, tb = {}, {}
    for k, v in batch.items():
        if keys is not None and k not in keys:
            continue
        if v.dtype == np.int32:
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v).long()
        else:
            jb[k], tb[k] = jnp.asarray(v, jd), torch.from_numpy(v).to(td)
    return jb, tb


def check_close(got, want, tol, what=""):
    """f32: allclose at ``tol`` (atol, rtol); else relative L2 <= tol."""
    if isinstance(tol, tuple):
        np.testing.assert_allclose(np32(got), np32(want), atol=tol[0],
                                   rtol=tol[1], err_msg=what)
    else:
        assert rel(got, want) <= tol, (what, rel(got, want))


def check_caches(got, want, tol):
    """The port's caches (or cross KVs) against the reference's: the same
    structure, None where it has None, ``pos`` equal, the rest close."""
    got = convert.caches_to_numpy(got)
    assert len(got) == len(want)

    def walk(g, w, path):
        if w is None:
            assert g is None, path
            return
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
            return
        assert g.shape == np.asarray(w).shape, path
        if path.endswith("pos"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        else:
            check_close(g, w, tol, path)

    for si, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws)
        for j, (g, w) in enumerate(zip(gs, ws)):
            walk(g, w, f"seg{si}.pos{j}")


def forward_loss(arch, tol, seq=24, dtype="f32", over=()):
    """``forward`` (logits and aux) and ``loss`` (total and metrics)."""
    j_model, params, model = models(arch, dtype, over)
    jb, tb = both(inputs(model.cfg, seq, 1), dtype)
    want, waux = jax.jit(j_model.forward)(params, jb)
    with torch.no_grad():
        got, gaux = model(tb)
    assert got.shape == (BATCH, seq, 256) and got.dtype == torch.float32
    check_close(got, want, tol, "logits")
    assert set(gaux) == set(waux)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    wt, wm = jax.jit(j_model.loss)(params, jb)
    with torch.no_grad():
        gt, gm = model.loss(tb)
    assert set(gm) == set(wm)
    np.testing.assert_allclose(float(gt), float(wt), rtol=1e-5)
    return gaux


def prefill_decode(arch, tol, seq=24, steps=6, budget_extra=8, dtype="f32",
                   over=(), use_flash=False):
    """Prefill (logits, caches, cross KVs) through the port's prefill step
    (its budget in tokens, the meta tokens added), then ``steps``
    teacher-forced decode steps at positions counting the meta tokens;
    returns the port's last caches."""
    j_model, params, model = models(arch, dtype, over)
    meta = model.cfg.n_meta_tokens
    jb, tb = both(inputs(model.cfg, seq, 1), dtype,
                  keys=("tokens", "src_embed", "vision_embed"))
    budget = seq + budget_extra
    want, want_c, want_x = jax.jit(lambda p, b: j_model.prefill(
        p, b, max_seq=budget + meta))(params, jb)
    got, got_c, got_x = steps_lib.make_prefill_step(
        model, max_seq=budget, use_flash=use_flash)(tb)
    assert got.shape == (BATCH, 256)
    check_close(got, want, tol, "prefill logits")
    check_caches(got_c, want_c, tol)
    if want_x is None:
        assert got_x is None
    else:
        check_caches(got_x, want_x, tol)
    decode = steps_lib.make_decode_step(model)
    j_decode = jax.jit(j_model.decode)
    nxt = np.random.default_rng(2).integers(0, 256, (BATCH, steps)).astype(
        np.int32)
    for step in range(steps):
        index = seq + step + meta
        want, want_c = j_decode(params, jnp.asarray(nxt[:, step:step + 1]),
                                jnp.int32(index), want_c, want_x)
        got, got_c = decode({"token": torch.from_numpy(
            nxt[:, step:step + 1]).long(), "index": index, "caches": got_c,
            "cross_kvs": got_x})
        check_close(got, want, tol, f"decode step {step}")
    check_caches(got_c, want_c, tol)
    return got_c


def train_step(arch, tol_params, tol_gnorm, seq=32, over=()):
    """One train step (WSD schedule) from the reference's initial state,
    on the same batch: ce, loss, the aux terms, gnorm and lr, then every
    parameter and first moment."""
    j_cfg, t_cfg = configs(arch, **dict(over))
    j_model = JModel(j_cfg)
    state = _gate_state(jax.tree.map(np.asarray,
                                     j_init(j_model, jax.random.key(0))))
    model = Model(t_cfg, device="cpu")
    j_step = jax.jit(j_make_step(j_model, schedule=j_schedule(
        "wsd", 3e-3, 10, 2)))
    step = steps_lib.make_train_step(model, schedule=make_schedule(
        "wsd", 3e-3, 10, 2))
    js = jax.tree.map(jnp.asarray, state)
    ts = convert.train_state_from_numpy(model, state, device="cpu")
    jb, tb = both(inputs(t_cfg, seq, 3, batch=4))
    js, wm = j_step(js, jb)
    ts, gm = step(ts, tb)
    assert set(wm) == set(gm)
    for k in wm:
        if k == "lr":
            assert float(gm[k]) == float(wm[k])
        elif k == "grad_norm":
            np.testing.assert_allclose(float(gm[k]), float(wm[k]),
                                       rtol=tol_gnorm)
        else:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]),
                                       rtol=2e-6, atol=1e-7, err_msg=k)
    assert int(ts.opt.step) == int(js.opt.step)
    for got, want in ((ts.params, js.params), (ts.opt.m, js.opt.m)):
        got = convert.params_to_numpy(model, got)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), atol=tol_params), got, want)
    return gm


def _gate_state(state):
    _gate_cross(state.params)
    return state
