"""The port's MoE FFN (``models/moe.py``) and the MoE archs (olmoe-1b-7b,
dbrx-132b) against the JAX reference, at ``reduced()`` (4 experts, top 2).

The routing is exact: the expert indices, their positions in the experts
and the keep mask equal the reference's (its lines at
``repro/models/moe.py:190-201``, run here in jnp on the same
activations), with and without drops (a capacity factor of 0.3 drops
choices; 1.25 drops none at this size) and through the ``SEQ_CHUNK``
slices (S = 1024: two slices, each its own capacity); ties go to the
lowest expert, as ``lax.top_k`` breaks them. In bf16 the combine equals
the reference's scatter-add bit for bit. Tolerances (ROADMAP Queue C):
f32 outputs within atol 2e-6, rtol 1e-5 (the router's softmax, the
expert products and the means sum in another order than XLA; measured
at most 6.6e-7 apart); the aux terms within rtol 1e-5; model logits
within atol 1e-5, rtol 1e-4 as the dense family's. bf16 layer outputs
within relative L2 2e-2: the bf16 router product sums in another order
than XLA's, and a router logit an ulp apart flips a near tie of the
top-k now and then (at S = 1024, 15 % of the output elements differed,
by at most 0.27), so bf16 routing is not compared.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.models import moe as j_moe
from repro.models import transformer as j_transformer
from repro.models.common import init_maker as j_init_maker
from repro_torch.models import moe, transformer

F32 = dict(atol=2e-6, rtol=1e-5)
MODEL_F32 = (1e-5, 1e-4)
BF16_REL = 2e-2
MOE_ARCHS = ["olmoe-1b-7b", "dbrx-132b"]


def _layer(dtype="f32", capacity_factor=1.25, seed=0):
    """(reference config, params; port config, params) of one MoE FFN."""
    jd, td = fam.DTYPES[dtype]
    j_cfg, t_cfg = fam.configs("olmoe-1b-7b", dtype,
                               capacity_factor=capacity_factor)
    j_p = j_moe.params(j_cfg, j_init_maker(jax.random.key(seed), jd), "m",
                       None)
    t_p = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
           for k, v in j_p.items()}
    return j_cfg, j_p, t_cfg, t_p


def _reference_routing(p, cfg, x):
    """The reference's routing lines on x (B, S, d) -> numpy (experts
    (N, K), gate (N, K), position (N * K,), keep (N * K,))."""
    N = x.shape[0] * x.shape[1]
    E, K = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(N, -1)
    logits = (xt @ p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, K)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    flat_pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    keep = flat_pos < j_moe.capacity(cfg, N)
    return tuple(np.asarray(a) for a in (eidx, gate, flat_pos, keep))


def _x(shape, seed, dtype="f32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jd, td = fam.DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("n", [1, 4, 37, 512, 2048, 4096])
def test_capacity_matches_reference(n):
    j_cfg, _, t_cfg, _ = _layer()
    assert moe.capacity(t_cfg, n) == j_moe.capacity(j_cfg, n)
    for arch in MOE_ARCHS:
        cfg = fam.get_config(arch)
        assert moe.capacity(cfg, n) == j_moe.capacity(
            fam.j_get_config(arch), n)


@pytest.mark.parametrize("seq,capacity_factor,drops", [
    (16, 1.25, False), (16, 0.3, True), (1024, 1.25, False),
    (1024, 0.3, True)])
def test_routing_and_output_match_reference(seq, capacity_factor, drops):
    """Expert indices, positions and keep equal (slice by slice through
    SEQ_CHUNK); the gates, output and aux terms within F32."""
    j_cfg, j_p, t_cfg, t_p = _layer(capacity_factor=capacity_factor)
    jx, tx = _x((2, seq, 64), seq)
    want, waux = j_moe.apply(j_p, j_cfg, jx)
    with moe.recording() as routes:
        got, gaux = moe.apply(t_p, t_cfg, tx)
    slices = seq // moe.SEQ_CHUNK if seq > moe.SEQ_CHUNK else 1
    assert len(routes) == slices
    width = seq // slices
    for i, r in enumerate(routes):
        experts, gate, position, keep = _reference_routing(
            j_p, j_cfg, jx[:, i * width:(i + 1) * width])
        np.testing.assert_array_equal(r.experts.numpy(), experts)
        np.testing.assert_array_equal(r.position.numpy(), position)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        np.testing.assert_allclose(r.gate.numpy(), gate, **F32)
        assert r.capacity == j_moe.capacity(j_cfg, 2 * width)
    assert (float(gaux["dropped_frac"]) > 0) == drops
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_ties_go_to_the_lowest_expert():
    """A router whose columns repeat gives exactly tied probabilities:
    ``lax.top_k`` takes the lowest index first, and so does the port."""
    j_cfg, j_p, t_cfg, t_p = _layer()
    router = np.asarray(j_p["router"]).copy()
    router[:, 2] = router[:, 0]
    router[:, 3] = router[:, 1]
    j_p = dict(j_p, router=jnp.asarray(router))
    t_p = dict(t_p, router=torch.from_numpy(router))
    jx, tx = _x((2, 16, 64), 5)
    experts, _, position, keep = _reference_routing(j_p, j_cfg, jx)
    r = moe.route(t_p, t_cfg, tx.reshape(32, 64))
    assert np.all(experts[:, 0] < 2)          # the tie's lower half
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.position.numpy(), position)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    got, _ = moe.apply(t_p, t_cfg, tx)
    want, _ = j_moe.apply(j_p, j_cfg, jx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_bf16_combine_is_the_references_bit_for_bit(k):
    """``combine`` against the reference's ``zeros.at[tok].add(picked *
    w)`` in bf16, on the same picked outputs and weights."""
    n, d = 300, 64
    g = np.random.default_rng(k)
    picked = g.standard_normal((n * k, d)).astype(np.float32) * 3
    w = g.uniform(0, 1, (n * k,)).astype(np.float32)
    w[::7] = 0.0                                  # dropped choices
    jp, jw = jnp.asarray(picked, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    tok = jnp.repeat(jnp.arange(n), k)
    want = jnp.zeros((n, d), jnp.bfloat16).at[tok].add(jp * jw[:, None])
    got = moe.combine(torch.from_numpy(picked).to(torch.bfloat16).reshape(
        n, k, d), torch.from_numpy(w).to(torch.bfloat16).reshape(n, k))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("seq", [16, 1024])
def test_bf16_layer_within_tolerance(seq):
    j_cfg, j_p, t_cfg, t_p = _layer("bf16")
    jx, tx = _x((2, seq, 64), 7, "bf16")
    want, _ = j_moe.apply(j_p, j_cfg, jx)
    got, _ = moe.apply(t_p, t_cfg, tx)
    assert got.dtype == torch.bfloat16
    assert fam.rel(got, want) <= BF16_REL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plan_is_the_references(arch):
    for smoke in (False, True):
        cfg, j_cfg = fam.get_config(arch, smoke), fam.j_get_config(arch,
                                                                   smoke)
        assert [(s.n, [dataclasses.asdict(b) for b in s.pattern])
                for s in transformer.make_plan(cfg)] == [
            (s.n, [dataclasses.asdict(b) for b in s.pattern])
            for s in j_transformer.make_plan(j_cfg)]
        assert transformer.make_plan(cfg)[0].pattern[0].ffn == "moe"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    """forward (with drops: reduced() drops about a tenth of the choices
    at S = 24) and loss with the router terms weighted."""
    aux = fam.forward_loss(arch, MODEL_F32)
    assert float(aux["dropped_frac"]) > 0 and float(aux["router_z"]) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    fam.prefill_decode(arch, MODEL_F32)


def test_prefill_routes_through_seq_chunk_slices():
    """A 1024-token prefill routes each layer in two slices; the flash
    route (its plain version on the CPU) agrees with the plain route."""
    _, _, model = fam.models("olmoe-1b-7b")
    tok = torch.from_numpy(fam.inputs(model.cfg, 1024, 4, batch=1)[
        "tokens"]).long()
    with moe.recording() as routes:
        a, _, _ = model.prefill({"tokens": tok}, use_flash=True)
    assert len(routes) == 2 * model.cfg.n_layers
    assert {r.capacity for r in routes} == {moe.capacity(model.cfg, 512)}
    with moe.recording() as plain:
        b, _, _ = model.prefill({"tokens": tok})
    for r, q in zip(routes, plain):
        assert torch.equal(r.experts, q.experts)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_matches_reference(arch):
    m = fam.train_step(arch, tol_params=1e-6, tol_gnorm=1e-5)
    assert float(m["load_balance"]) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS + [
    "hymba-1.5b", "seamless-m4t-large-v2", "llama-3.2-vision-90b"])
def test_leaf_order_is_the_references(arch):
    """``leaf_groups`` follows ``jax.tree.leaves`` of the reference's tree
    (the clip's order): the router beside the stacked experts' wd, wg,
    wu; the SSM keys, ``meta_tokens``, the encoder's segments and
    ``cross``/``ln_cross`` where the arch has them."""
    j_cfg, t_cfg = fam.configs(arch)
    params = fam.JModel(j_cfg).abstract_params()
    model = fam.Model(t_cfg, device="meta")
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    groups = model.leaf_groups()
    assert len(groups) == len(paths)
    pp = model.param_paths()
    for group, path in zip(groups, paths):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None))
                     for k in path)
        assert pp[group[0]][0] == keys
