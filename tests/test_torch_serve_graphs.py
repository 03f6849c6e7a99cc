"""The compiled serve path on the CPU: the prefill and the greedy decode
step as graphed steps (``launch/steps.py``: ``serve_prefill_step``,
``serve_decode_step``, ``compiled_prefill``, ``compiled_decode``) and
``launch/serve.py::generate``, which replays them on the card as the
reference jits them (``repro/launch/serve.py``).

Every arch at ``reduced()`` in f32, with the reference's weights
(``tests/_torch_families.py``):

* the port's decode step, given its index as a 0-d int32 tensor, against
  the jitted reference's, given a ``jnp.int32``, over enough steps that
  hymba's windowed ring wraps past its pinned meta tokens;
* ``capture_faults`` of the prefill and of the decode step is empty (the
  helper now sees a host read made under ``torch.inference_mode()``, as
  the served steps run, and the decode step's old ``int(index)`` is
  caught);
* ``generate`` under the emulated graphs (``emulate_graphs``: Python
  values frozen at the capture) gives the eager ``generate``'s tokens and
  logits bit for bit;
* the bookkeeping: the serve steps are JIT01 roots, the LRU reuses and
  evicts graphs, a later ``generate`` overwrites nothing an earlier one
  returned, and the decode step called twice on one carry gives the same
  bits (the graph's warm-up writes the ring slot its replay writes).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_families as fam
from _torch_capture import capture_faults, emulate_graphs
from repro_torch.configs import ARCHS
from repro_torch.core import graphed
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import attention
from repro_torch.models.attention import _mask, _project_qkv, _sdpa, _slot

MODEL_F32 = (1e-5, 1e-4)                              # logits, caches
WKV_STATE = dict(atol=2e-4, rtol=1e-5)                # tests/test_torch_models.py
SEQ, STEPS = 12, 14   # hymba: 8 meta + 12 + 14 positions, a ring of 8 + 16
ARCH_LIST = list(ARCHS)


@pytest.fixture(autouse=True)
def _fresh_graphs():
    steps_lib.release_serve_graphs()
    yield
    steps_lib.release_serve_graphs()


def _index(i: int) -> torch.Tensor:
    return torch.full((), i, dtype=torch.int32)


def _port_inputs(model, seq=SEQ, seed=1):
    jb, tb = fam.both(fam.inputs(model.cfg, seq, seed),
                      keys=("tokens", "src_embed", "vision_embed"))
    return jb, tb


def _extra(tb):
    return {k: v for k, v in tb.items() if k != "tokens"}


def _ring_leaves(caches):
    """The ring caches' leaves (what decode writes in place)."""
    out = []

    def walk(c):
        if isinstance(c, dict):
            if "pos" in c:
                out.extend([c["k"], c["v"], c["pos"]])
                return
            for v in c.values():
                walk(v)
        elif isinstance(c, (list, tuple)):
            for v in c:
                walk(v)

    walk(caches)
    return out


def _check_caches(got, want):
    """``fam.check_caches`` with the tolerances the archs' own tests
    state: MODEL_F32, and WKV_STATE on a wkv state."""
    got = fam.convert.caches_to_numpy(got)

    def walk(g, w, path):
        if w is None:
            assert g is None, path
        elif isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif path.endswith("pos"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        elif path.endswith("wkv"):
            np.testing.assert_allclose(g, np.asarray(w), err_msg=path,
                                       **WKV_STATE)
        else:
            fam.check_close(g, w, MODEL_F32, path)

    assert len(got) == len(want)
    for si, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws)
        for j, (g, w) in enumerate(zip(gs, ws)):
            walk(g, w, f"seg{si}.pos{j}")


# ---------------------------------------------------------------------------
# The helper sees host reads under inference mode
# ---------------------------------------------------------------------------
@torch.inference_mode()
def _reads_on_the_host(i: torch.Tensor):
    return int(i), i.item(), bool(i), float(i)


def test_capture_faults_sees_host_reads_under_inference_mode():
    """Under ``torch.inference_mode()`` the dispatcher shows ``int()``,
    ``.item()``, ``bool()`` and ``float()`` of a tensor as ``aten::item``
    and ``aten::is_nonzero``, not ``_local_scalar_dense``: each is a host
    read all the same."""
    faults = capture_faults(_reads_on_the_host, torch.full((), 3))
    assert len(faults) == 4, faults
    assert all(f.startswith("host read") for f in faults), faults


def test_emulated_capture_refuses_a_host_read_under_inference_mode(
        monkeypatch):
    emulate_graphs(monkeypatch)

    @torch.inference_mode()
    def step(carry, i):
        x, = carry
        return (x + int(i),), None

    with pytest.raises(RuntimeError, match="aten::item"):
        graphed.StepGraph(step)((torch.ones(3),), 2)


def _old_decode_step(p, cfg, x, cache, index, *, window=0, n_meta=0,
                     cross_cache=None, use_rope=True, product=None):
    """``attention.decode_step``'s ring-cache branch as it read before its
    index became a device tensor: a host int, Python scalars written into
    the cache (yi-9b has no cross layer)."""
    assert cross_cache is None
    index = int(index)
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos, use_rope)
    slot = _slot(index, cache["k"].shape[1], n_meta)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = index
    mask = _mask(pos, cache["pos"], True, window, n_meta)
    y = _sdpa(q, cache["k"], cache["v"], mask, 1.0 / cfg.hd ** 0.5)
    return attention._out(p, y, product), cache


def _decode_carry(model, tb, budget):
    _, (logits, caches, xkv) = steps_lib.serve_prefill_step(
        model, budget + model.cfg.n_meta_tokens, False, False, tb)
    return (logits.argmax(-1)[:, None], caches, xkv)


def test_the_old_host_index_would_be_caught(monkeypatch):
    """The decode step as it was (``int(index)``, a Python int written into
    the ring's positions) is reported now that the helper sees host reads
    under inference mode; the step as it is reports nothing."""
    _, _, model = fam.models("yi-9b")
    _, tb = _port_inputs(model)
    carry = _decode_carry(model, tb, SEQ + 4)
    writes = _ring_leaves(carry[1])
    assert capture_faults(steps_lib.serve_decode_step, model, carry,
                          _index(SEQ), writes=writes) == []
    monkeypatch.setattr(attention, "decode_step", _old_decode_step)
    faults = capture_faults(steps_lib.serve_decode_step, model, carry,
                            _index(SEQ), writes=writes)
    assert any(f.startswith("host read aten::item") for f in faults), \
        faults
    assert any(f.startswith("host constant") for f in faults), faults


# ---------------------------------------------------------------------------
# Against the reference, the index a device tensor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_decode_with_a_tensor_index_matches_reference(arch):
    """Prefill, then ``STEPS`` teacher-forced decode steps, the port's
    index a 0-d int32 tensor, the reference's a ``jnp.int32``, both
    jitted or eager as they serve; hymba's windowed ring wraps."""
    j_model, params, model = fam.models(arch)
    meta = model.cfg.n_meta_tokens
    jb, tb = _port_inputs(model)
    budget = SEQ + STEPS
    want, want_c, want_x = jax.jit(lambda p, b: j_model.prefill(
        p, b, max_seq=budget + meta))(params, jb)
    _, (got, got_c, got_x) = steps_lib.serve_prefill_step(
        model, budget + meta, False, False, tb)
    fam.check_close(got, want, MODEL_F32, "prefill logits")
    j_decode = jax.jit(j_model.decode)
    nxt = np.random.default_rng(2).integers(0, 256, (fam.BATCH, STEPS)
                                            ).astype(np.int32)
    for step in range(STEPS):
        index = SEQ + step + meta
        want, want_c = j_decode(params, jnp.asarray(nxt[:, step:step + 1]),
                                jnp.int32(index), want_c, want_x)
        got, got_c = model.decode(
            torch.from_numpy(nxt[:, step:step + 1]).long(), _index(index),
            got_c, got_x)
        fam.check_close(got, want, MODEL_F32, f"decode step {step}")
    _check_caches(got_c, want_c)
    if arch == "hymba-1.5b":     # the ring wrapped, the meta tokens kept
        pos = [c["attn"]["pos"][0] for seg in got_c for c in seg
               if isinstance(c, dict) and "attn" in c
               and c["attn"]["pos"].shape[-1] < budget + meta]
        last, ring = SEQ + STEPS - 1 + meta, pos[0][meta:]
        assert pos and pos[0][:meta].tolist() == list(range(meta))
        assert last - meta >= ring.shape[0]         # wrapped
        assert sorted(ring.tolist()) == list(range(last - ring.shape[0] + 1,
                                                   last + 1))


# ---------------------------------------------------------------------------
# Capture-clean
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_serve_steps_are_capture_clean(arch):
    """Nothing a capture refuses in the prefill (both routes' plain
    versions on the CPU) or in the decode step, whose only writes into
    its inputs are the ring caches it returns as themselves."""
    _, _, model = fam.models(arch)
    _, tb = _port_inputs(model)
    budget = SEQ + 4 + model.cfg.n_meta_tokens
    faults = []
    for route in (False, True):
        faults += capture_faults(steps_lib.serve_prefill_step, model, budget,
                                 route, route, tb)
    carry = _decode_carry(model, tb, SEQ + 4)
    faults += capture_faults(steps_lib.serve_decode_step, model, carry,
                             _index(SEQ + model.cfg.n_meta_tokens),
                             writes=_ring_leaves(carry[1]))
    assert faults == []


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-3b", "hymba-1.5b",
                                  "seamless-m4t-large-v2", "olmoe-1b-7b"])
def test_decode_step_twice_on_one_carry_gives_the_same_bits(arch):
    """The graph's warm-up runs the decode step on the static buffers, so
    it writes the ring slot the first replay writes: harmless because the
    step writes its slot before it reads it. Called twice on one carry
    (the second time over the ring the first wrote), the step gives the
    same bits."""
    _, _, model = fam.models(arch)
    _, tb = _port_inputs(model)
    carry = _decode_carry(model, tb, SEQ + 4)
    index = _index(SEQ + model.cfg.n_meta_tokens)
    first = steps_lib.serve_decode_step(model, carry, index)
    first = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, first)
    second = steps_lib.serve_decode_step(model, carry, index)
    for a, b in zip(pytree.tree_leaves(first), pytree.tree_leaves(second)):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# generate under emulated graphs against eager
# ---------------------------------------------------------------------------
def _generate(model, tb, new, **kw):
    return serve_lib.generate(model, tb["tokens"], new, keep_logits=True,
                              use_flash=True, use_rwkv_kernel=True,
                              **_extra(tb), **kw)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_graphed_generate_equals_eager(monkeypatch, arch):
    """``generate`` replaying the emulated graphs (the index a device
    scalar filled before each replay; every other Python value frozen at
    the capture) gives the eager steps' tokens and logits bit for bit,
    and launches what they launch."""
    _, _, model = fam.models(arch)
    _, tb = _port_inputs(model)
    want, w_info = _generate(model, tb, STEPS, graphs=False)
    emulate_graphs(monkeypatch)
    got, g_info = _generate(model, tb, STEPS)
    assert g_info["graphs"] and not w_info["graphs"]
    assert got.shape == (fam.BATCH, STEPS)
    assert torch.equal(got, want)
    assert torch.equal(g_info["logits"], w_info["logits"])
    assert g_info["capture_s"] > 0 and w_info["capture_s"] == 0
    graphs = [g for _, g in steps_lib._SERVE_GRAPHS.values()]
    assert len(graphs) == 2 and all(g.captures == 1 for g in graphs)
    again, _ = _generate(model, tb, STEPS)       # replays, no capture
    assert torch.equal(again, want)
    assert all(g.captures == 1 for g in graphs)


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------
def test_later_generate_overwrites_nothing_returned(monkeypatch):
    emulate_graphs(monkeypatch)
    _, _, model = fam.models("hymba-1.5b")
    _, tb = _port_inputs(model)
    first, f_info = _generate(model, tb, 6)
    kept = (first.clone(), f_info["logits"].clone())
    other = dict(tb, tokens=(tb["tokens"] + 7) % 256)
    second, _ = _generate(model, other, 6)
    assert torch.equal(first, kept[0])
    assert torch.equal(f_info["logits"], kept[1])
    assert not torch.equal(first, second)
    # the graphed prefill's output is the caller's too
    prefill = steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 6)
    _, (logits, caches, _) = prefill(tb)
    kept = pytree.tree_map(lambda x: x.clone(), (logits, caches))
    prefill(other)
    for a, b in zip(pytree.tree_leaves((logits, caches)),
                    pytree.tree_leaves(kept)):
        assert torch.equal(a, b)


def test_serve_graphs_are_an_lru(monkeypatch):
    """One graph per model, kind and shapes: a second call at the same
    shapes reuses it, another budget captures anew, and past
    ``SERVE_GRAPHS_MAX`` the oldest is released."""
    emulate_graphs(monkeypatch)
    monkeypatch.setattr(steps_lib, "SERVE_GRAPHS_MAX", 2)
    _, _, model = fam.models("yi-9b")
    _, tb = _port_inputs(model)
    a = steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 2)
    assert steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 2) is a
    a(tb)
    b = steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 3)
    assert b is not a and a.carry is not None
    b(tb)
    c = steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 4)
    assert a.carry is None and b.carry is not None    # a released
    assert len(steps_lib._SERVE_GRAPHS) == 2
    assert steps_lib.compiled_prefill(model, tb, max_seq=SEQ + 2) is not a
    assert b.carry is None                            # then b
    steps_lib.release_serve_graphs(model)
    assert not steps_lib._SERVE_GRAPHS and c.carry is None


def test_serve_steps_are_jit01_roots():
    """The analyzer holds the serve steps handed to StepGraph to JIT01, and
    its callgraph follows them into the model's decode step, so a host
    read there could not come back unseen."""
    from repro_torch.analysis.engine import collect_python_files
    from repro_torch.analysis.passes import purity
    from repro_torch.analysis.symbols import load_project
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    project = load_project(collect_python_files(
        [os.path.join(repo, "src", "repro_torch")], root=repo))
    _, jit, _ = purity._collect_roots(project)
    roots = {"repro_torch.launch.steps.serve_prefill_step",
             "repro_torch.launch.steps.serve_decode_step"}
    assert roots <= jit
    reach = purity._reachable(project, roots)
    assert {"repro_torch.models.model.Model.decode",
            "repro_torch.models.model.Model.prefill",
            "repro_torch.models.attention.decode_step",
            "repro_torch.models.mlp.gelu_tanh"} <= set(reach)
