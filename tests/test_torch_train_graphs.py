"""The compiled train and PBT steps on the CPU: ``launch/steps.py``'s
``train_graph_step``, ``hyper_train_step`` and ``eval_graph_step``, the
donating ``core/graphed.py::StepGraph`` that replays them, and
``launch/train.py::train`` and ``launch/evolve.py::run_pbt``, which replay
them on the card as the reference jits them (``repro/launch/train.py``,
``repro/launch/evolve.py``).

Smoke configs under emulated graphs (``tests/_torch_capture.py``:
``emulate_graphs`` records each operation of a capture, autograd's
backward and remat's recompute included, and replays it with Python
values frozen):

* ``capture_faults`` finds no host read, host constant or write into the
  batch in the train step (minicpm-2b and rwkv6-3b, accumulation 1 and
  2), PBT's step or the eval; the old ``_correction`` and ``clip_scale``
  would have been caught;
* the graphed ``train`` equals ``graphs=False`` bit for bit (every step's
  metrics, the final state leaf for leaf, the first call included), and a
  graphed resume equals the uninterrupted run bit for bit;
* the graphed step stays within ``tests/test_torch_train.py``'s
  tolerances of the reference's jitted step (the loss rtol 2e-6, lr
  exact, gnorm rtol 1e-6 and 2e-4, parameters and moments atol 1e-6 and
  3e-4), from the reference's ``init_train_state(key(0))`` carried by
  ``convert``;
* the donated buffers are the caller's tensors (no clone), a release
  leaves them to the caller, and the graph counts the wrapper launches
  the eager calls count (its first call's warm-up was a real step);
* the graphed ``run_pbt`` gives the reference's history and pool
  (``tests/test_torch_pbt.py``'s comparisons: exact decisions and hypers,
  the validation losses within atol 2e-5) and equals the eager run bit
  for bit; no member's state is written by another member's replay;
* the batch draw (the reference's jitted ``_gen``) replays as a graph with
  the eager draw's bits;
* ``host_scalar`` of a float is the f32 fill ``torch.tensor(v,
  dtype=float32)`` gives, and the analyzer roots the three steps (JIT01)
  and follows them into ``Model.loss`` and ``optim/``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_threefry_partitionable", True)

from _torch_capture import capture_faults, emulate_graphs  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch.evolve import run_pbt as j_run_pbt  # noqa: E402
from repro.launch.steps import init_train_state as j_init  # noqa: E402
from repro.launch.steps import make_train_step as j_make_step  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import make_schedule as j_schedule  # noqa: E402
from repro_torch import convert, rand  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import graphed  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import evolve  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw, clip, make_schedule  # noqa: E402

# tests/test_torch_train.py's tolerances against the reference
TOL = {"minicpm-2b": dict(gnorm=1e-6, params=1e-6),
       "rwkv6-3b": dict(gnorm=2e-4, params=3e-4)}
LOSS_RTOL = 2e-6
PBT_VAL_ATOL = 2e-5          # tests/test_torch_pbt.py's
SMALL = dict(batch=4, seq=32)
PBT_RUN = dict(arch="minicpm-2b", members=3, epochs=3, steps_per_epoch=2,
               batch=8, seq=64, seed=0, verbose=False)


def _state_and_batch(arch, seed=0, batch=4, seq=32):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(seed))
    state = steps_lib.init_train_state(model)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed, device="cpu")
    return model, state, data


def _leaves(state):
    return [t for t in pytree.tree_leaves(state)
            if isinstance(t, torch.Tensor)]


def _clone(tree):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _assert_equal_trees(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), i
        else:
            assert x == y, i


# ---------------------------------------------------------------------------
# host values and constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [3e-3, 0.1, 1 / 3, 1e-5, 0.95, 2.0 ** -140,
                                   3.4e38, 7.0])
def test_host_scalar_of_a_float_is_an_f32_fill(value):
    got = graphed.host_scalar(value, torch.device("cpu"))
    want = torch.tensor(value, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # ints and bools keep their dtypes
    assert graphed.host_scalar(3, "cpu").dtype == torch.int32
    assert graphed.host_scalar(True, "cpu").dtype == torch.bool


def _old_correction(b, step):
    b32 = torch.tensor(b, dtype=torch.float32).double().to(step.device)
    return 1.0 - torch.pow(b32, step.double()).float()


def _old_clip_scale(norm, max_norm):
    top = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(top / torch.clamp(norm, min=1e-12), max=1.0)


def test_the_old_constants_would_have_been_caught():
    """The earlier ``_correction`` and ``clip_scale`` copied a Python
    value from host memory (``lift_fresh``), which a capture refuses; the
    fills that replace them are clean and give the same bits."""
    step = torch.full((), 3, dtype=torch.int32)
    norm = torch.full((), 2.5, dtype=torch.float32)
    for old, new, args in ((_old_correction, adamw._correction,
                            (0.95, step)),
                           (_old_clip_scale, clip.clip_scale, (norm, 1.0))):
        faults = capture_faults(old, *args)
        assert faults and all("host constant" in f for f in faults), faults
        assert capture_faults(new, *args) == []
        assert torch.equal(old(*args), new(*args))


@pytest.mark.parametrize("arch,accum", [("minicpm-2b", 1), ("minicpm-2b", 2),
                                        ("rwkv6-3b", 1), ("rwkv6-3b", 2)])
def test_train_step_is_capture_clean(arch, accum):
    """The train step, backward and AdamW included: no host read, no host
    constant, no write into the batch (the state is written by design)."""
    model, state, data = _state_and_batch(arch)
    step = steps_lib.make_train_step(model, schedule=make_schedule(
        model.cfg.schedule, 3e-3, 10, 2), accum_steps=accum)
    batch = data.batch_for_step(0)
    faults = capture_faults(steps_lib.train_graph_step, step,
                            (state, batch), writes=_leaves(state))
    assert faults == []


def test_pbt_step_and_eval_are_capture_clean():
    """PBT's step with its hypers as 0-d f32 tensors, and the eval, which
    writes nothing at all."""
    model, state, data = _state_and_batch("minicpm-2b")
    batch = data.batch_for_step(0)
    lr, wd = (graphed.host_scalar(v, "cpu") for v in (3e-4, 0.05))
    assert capture_faults(steps_lib.hyper_train_step, model,
                          model.leaf_groups(), (state, batch), lr, wd,
                          writes=_leaves(state)) == []
    assert capture_faults(steps_lib.eval_graph_step, model,
                          (state.params, batch)) == []


# ---------------------------------------------------------------------------
# the donating StepGraph
# ---------------------------------------------------------------------------
def test_donated_buffers_are_the_callers(monkeypatch):
    """The graph's static buffers are the caller's tensors (same
    ``data_ptr``, no clone); each call steps them in place as the eager
    step would; a release drops the graph and leaves them with the
    caller."""
    emulate_graphs(monkeypatch)
    model, state, data = _state_and_batch("minicpm-2b")
    step = steps_lib.make_train_step(model, schedule=make_schedule(
        "constant", 3e-3, 1))
    want = _clone(state)
    ptrs = [t.data_ptr() for t in _leaves(state)]
    graph = steps_lib.compiled_train_step(step)
    assert graph.donate
    batches = [data.batch_for_step(i) for i in range(3)]
    for i, b in enumerate(batches):
        (got, _), gm = graph((state, b))
        want, wm = step(want, b)
        assert [t.data_ptr() for t in _leaves(got)] == ptrs
        assert all(x is y for x, y in zip(_leaves(got), _leaves(state)))
        _assert_equal_trees(got, want)
        _assert_equal_trees(gm, wm)
        state = got
    assert graph.captures == 1 and int(state.opt.step) == 3
    graph.release()
    assert graph.carry is None
    assert [t.data_ptr() for t in _leaves(state)] == ptrs
    _assert_equal_trees(state, want)
    with pytest.raises(ValueError, match="no evolve"):
        graphed.StepGraph(lambda c: (c, None), evolve=lambda x: x, gens=1,
                          donate=True)


def test_donated_graph_counts_the_launches_eager_counts(monkeypatch):
    """A wrapper's launch counted inside a donating graph's step: the
    first call (its warm-up a real step) counts it once, each replay
    once, as the eager calls would."""
    from repro_torch import kernels
    emulate_graphs(monkeypatch)

    def step(carry, scale):
        kernels.LAUNCHES["trap_fitness"] += 1
        x, = carry
        x.mul_(scale).add_(1.0)
        return (x,), x.sum()

    x = torch.arange(4, dtype=torch.float32)
    want = x.clone()
    graph = graphed.StepGraph(step, donate=True)
    eager = graphed.EagerStep(step, "cpu")
    counts = {}
    for name, run, carry in (("graphed", graph, x), ("eager", eager, want)):
        seen, totals = [], []
        for _ in range(3):
            before = kernels.LAUNCHES["trap_fitness"]
            (got,), total = run((carry,), 0.5)
            assert got is carry
            seen.append(kernels.LAUNCHES["trap_fitness"] - before)
            totals.append(total)
        counts[name] = (seen, totals)
    assert counts["graphed"][0] == counts["eager"][0] == [1, 1, 1]
    assert all(torch.equal(a, b) for a, b in zip(counts["graphed"][1],
                                                  counts["eager"][1]))
    assert torch.equal(x, want)
    assert graph.launches == {"trap_fitness": 1}


def test_donated_graph_copies_in_another_state(monkeypatch):
    """A carry that is not the static one is copied into the static
    buffers (a PBT member's adopted payload), the caller's tensors of that
    carry left as they were."""
    emulate_graphs(monkeypatch)
    model, state, data = _state_and_batch("minicpm-2b")
    step = steps_lib.make_train_step(model, schedule=make_schedule(
        "constant", 3e-3, 1))
    graph = steps_lib.compiled_train_step(step)
    (state, _), _ = graph((state, data.batch_for_step(0)))
    other = steps_lib.init_train_state(model, torch.Generator().manual_seed(5))
    kept = _clone(other)
    want, wm = step(_clone(other), data.batch_for_step(1))
    (got, _), gm = graph((other, data.batch_for_step(1)))
    assert all(x is y for x, y in zip(_leaves(got), _leaves(state)))
    _assert_equal_trees(got, want)
    _assert_equal_trees(gm, wm)
    _assert_equal_trees(other, kept)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------
def _run_train(arch, graphs, accum=1, steps=4, **kw):
    seen = []

    def on_step(i, state, metrics):
        seen.append({k: v.clone() for k, v in metrics.items()})

    state, losses = train_mod.train(arch, smoke=True, steps=steps,
                                    accum=accum, verbose=False, device="cpu",
                                    graphs=graphs, on_step=on_step,
                                    **SMALL, **kw)
    return state, losses, seen


@pytest.mark.parametrize("arch,accum", [("minicpm-2b", 1), ("minicpm-2b", 2),
                                        ("rwkv6-3b", 1)])
def test_graphed_train_equals_eager(monkeypatch, arch, accum):
    """4 steps replayed (emulated) against ``graphs=False``: every step's
    metrics (ce, the loss and aux terms, grad_norm, lr) and the final
    state, bit for bit, the first (capturing) call included."""
    want_state, want, want_m = _run_train(arch, False, accum)
    emulate_graphs(monkeypatch)
    captures = []
    real = steps_lib.compiled_train_step

    def spy(step):
        captures.append(real(step))
        return captures[-1]
    monkeypatch.setattr(train_mod, "compiled_train_step", spy)
    got_state, got, got_m = _run_train(arch, True, accum)
    assert len(captures) == 1 and captures[0].captures == 1
    assert captures[0].carry is None        # released at the end
    assert got == want
    for g, w in zip(got_m, want_m):
        _assert_equal_trees(g, w)
    _assert_equal_trees(got_state, want_state)
    # a mesh's step is no longer refused: it replays as a donating chain
    # cut at its collectives (tests/test_torch_mesh_graphs.py runs it)
    from repro_torch.launch.mesh import Mesh
    model = Model(get_config(arch, smoke=True), "meta")
    mesh_step = steps_lib.make_train_step(
        model, schedule=make_schedule("constant", 3e-3, 10),
        mesh=Mesh((1, 2), ("data", "model")))
    cut = steps_lib.compiled_train_step(mesh_step)
    assert isinstance(cut, graphed.CutGraph) and cut.donate


def test_graphed_resume_equals_the_uninterrupted_run(monkeypatch, tmp_path):
    """Graphed: 6 steps with checkpoints every 3, the last removed, then a
    resume (its graph adopts the restored state): the ce of steps 3-5 and
    the final state equal the uninterrupted graphed run's and the eager
    run's bit for bit."""
    eager, eager_losses = train_mod.train(
        "minicpm-2b", smoke=True, steps=6, verbose=False, device="cpu",
        graphs=False, **SMALL)
    emulate_graphs(monkeypatch)
    kw = dict(smoke=True, steps=6, ckpt_every=3, verbose=False,
              device="cpu", **SMALL)
    whole, losses = train_mod.train("minicpm-2b",
                                    ckpt_dir=str(tmp_path / "a"), **kw)
    part = str(tmp_path / "b")
    train_mod.train("minicpm-2b", ckpt_dir=part, **kw)
    shutil.rmtree(os.path.join(part, "step_00000006"))
    resumed, tail = train_mod.train("minicpm-2b", ckpt_dir=part,
                                    resume=True, **kw)
    assert losses == eager_losses and tail == losses[3:]
    _assert_equal_trees(resumed, whole)
    _assert_equal_trees(whole, eager)
    assert int(resumed.opt.step) == 6


@functools.lru_cache(maxsize=None)
def _reference_pair(arch):
    j_model = JModel(j_get_config(arch, smoke=True))
    state = jax.tree.map(np.asarray, j_init(j_model, jax.random.key(0)))
    return j_model, state, Model(get_config(arch, smoke=True), device="cpu")


@pytest.mark.parametrize("arch,accum", [("minicpm-2b", 1), ("minicpm-2b", 2),
                                        ("rwkv6-3b", 1)])
def test_graphed_step_matches_reference(monkeypatch, arch, accum):
    """Three replayed steps (WSD schedule, warmup 2) from the reference's
    initial state against its jitted step: ce and loss within rtol 2e-6,
    lr exact, gnorm, parameters and moments within
    ``tests/test_torch_train.py``'s tolerances."""
    emulate_graphs(monkeypatch)
    j_model, state, model = _reference_pair(arch)
    tol = TOL[arch]
    j_step = jax.jit(j_make_step(j_model, schedule=j_schedule(
        "wsd", 3e-3, 10, 2), accum_steps=accum), donate_argnums=(0,))
    graph = steps_lib.compiled_train_step(steps_lib.make_train_step(
        model, schedule=make_schedule("wsd", 3e-3, 10, 2),
        accum_steps=accum))
    js = jax.tree.map(jnp.asarray, state)
    ts = convert.train_state_from_numpy(model, state, device="cpu")
    jd = JSyntheticLM(vocab_size=256, seq_len=64, global_batch=8, seed=0)
    td = SyntheticLM(vocab_size=256, seq_len=64, global_batch=8, seed=0,
                     device="cpu")
    for i in range(3):
        js, wm = j_step(js, jd.batch_for_step(i))
        (ts, _), gm = graph((ts, td.batch_for_step(i)))
        assert set(wm) == set(gm)
        for k in ("ce", "loss"):
            np.testing.assert_allclose(float(gm[k]), float(wm[k]),
                                       rtol=LOSS_RTOL)
        assert float(gm["lr"]) == float(wm["lr"])
        np.testing.assert_allclose(float(gm["grad_norm"]),
                                   float(wm["grad_norm"]), rtol=tol["gnorm"])
        assert int(ts.opt.step) == int(js.opt.step)
        for got, want in ((ts.params, js.params), (ts.opt.m, js.opt.m)):
            got = convert.params_to_numpy(model, got)
            jax.tree.map(lambda g, w: np.testing.assert_allclose(
                g, np.asarray(w), atol=tol["params"]), got, want)
    assert graph.captures == 1


@pytest.mark.parametrize("vocab,seq", [(256, 64), (122_753, 32)])
def test_graphed_batch_draw_equals_eager(monkeypatch, vocab, seq):
    """``SyntheticLM.batch_for_step`` replays its draw (the reference's
    jitted ``_gen``) as a graph, one per shape and instance, capture-clean,
    and gives the eager draw's bits at every step and shard."""
    from repro_torch.data import synthetic
    data = SyntheticLM(vocab_size=vocab, seq_len=seq, global_batch=8,
                       seed=3, device="cpu")
    key = rand.fold_in(rand.fold_in(rand.key(3, torch.device("cpu")), 0), 0)
    assert capture_faults(synthetic.gen_step, 8, seq, vocab, 0.15, 8,
                          key) == []
    cases = [(0, 0, 1), (1, 0, 1), (7, 1, 2), (7, 0, 2), (2, 0, 1)]
    want = [data.batch_for_step(*c) for c in cases]
    emulate_graphs(monkeypatch)
    got = [data.batch_for_step(*c) for c in cases]
    for g, w in zip(got, want):
        _assert_equal_trees(g, w)
    assert sorted(data._graphs) == [(4, seq, vocab, 0.15, 8),
                                    (8, seq, vocab, 0.15, 8)]
    assert all(g.captures == 1 for g in data._graphs.values())


# ---------------------------------------------------------------------------
# PBT
# ---------------------------------------------------------------------------
def _port_pbt(monkeypatch, graphs, **kw):
    run = dict(PBT_RUN, **kw)
    j_model = JModel(j_get_config(PBT_RUN["arch"], smoke=True))

    def init(model, generator):
        state = j_init(j_model, jax.random.key(generator.initial_seed()))
        return convert.train_state_from_numpy(
            model, jax.tree.map(np.asarray, state), device="cpu")

    seen = []
    with monkeypatch.context() as mp:
        mp.setattr(evolve, "init_train_state", init)
        ctrl = evolve.run_pbt(device="cpu", graphs=graphs,
                              on_step=lambda m, met: seen.append(
                                  (m.uuid, _clone(met))), **run)
    return ctrl, seen


@pytest.fixture(scope="module")
def pbt_runs():
    """(reference controller, eager port controller and its per-step
    metrics, graphed port controller and its per-step metrics, the
    graphs made)."""
    mp = pytest.MonkeyPatch()
    try:
        want = j_run_pbt(**PBT_RUN)
        eager, eager_m = _port_pbt(mp, False)
        emulate_graphs(mp)
        made = []
        real = (evolve.steps_lib.compiled_hyper_step,
                evolve.steps_lib.compiled_eval)
        mp.setattr(evolve.steps_lib, "compiled_hyper_step",
                   lambda m: made.append(real[0](m)) or made[-1])
        mp.setattr(evolve.steps_lib, "compiled_eval",
                   lambda m: made.append(real[1](m)) or made[-1])
        got, got_m = _port_pbt(mp, True)
        yield want, (eager, eager_m), (got, got_m), made
    finally:
        mp.undo()


def test_graphed_pbt_matches_reference(pbt_runs):
    """``tests/test_torch_pbt.py``'s comparisons for the graphed run: the
    history's decisions and hypers exactly, the validation losses within
    atol 2e-5, the pool's PUTs and GETs, the members' hypers, exploits and
    fitness, the best member."""
    want, _, (got, _), made = pbt_runs
    assert len(got.history) == len(want.history) == 9
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        for k in ("epoch", "member", "exploited", "lr", "weight_decay"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"],
                                   atol=PBT_VAL_ATOL)
    assert any(h["exploited"] for h in got.history)
    ws, gs = want.pool.stats(), got.pool.stats()
    assert gs["puts"] == ws["puts"] == 9
    assert gs["gets"] == ws["gets"] and gs["size"] == ws["size"]
    for g, w in zip(got.members, want.members):
        assert (g.uuid, g.hypers, g.exploits, g.epochs) == (
            w.uuid, w.hypers, w.exploits, w.epochs)
        np.testing.assert_allclose(g.fitness, w.fitness, atol=PBT_VAL_ATOL)
    assert got.best_member().uuid == want.best_member().uuid
    # a step graph and an eval graph a member, each captured once, each
    # released at the end of the run
    assert len(made) == 2 * PBT_RUN["members"]
    assert all(g.donate and g.captures == 1 and g.carry is None
               for g in made)


def test_graphed_pbt_equals_eager(pbt_runs):
    """The graphed run equals the eager one bit for bit: the history, the
    pool, every step's metrics and each member's final state."""
    _, (eager, eager_m), (got, got_m), _ = pbt_runs
    assert got.history == eager.history
    assert len(got_m) == len(eager_m) == 3 * 3 * 2
    for (gu, g), (wu, w) in zip(got_m, eager_m):
        assert gu == wu
        _assert_equal_trees(g, w)
    for g, w in zip(got.members, eager.members):
        _assert_equal_trees(g.state, w.state)
    assert got.pool.stats() == eager.pool.stats()


def test_members_keep_their_own_states(monkeypatch):
    """Each member's graphs hold that member's state: replaying one
    member's step and eval changes no bit of another member's state, and
    each member's graphed epoch equals its eager epoch."""
    emulate_graphs(monkeypatch)
    ctrl, _ = _port_pbt(monkeypatch, True, members=2, epochs=1)
    eager, _ = _port_pbt(monkeypatch, False, members=2, epochs=1)
    data = SyntheticLM(vocab_size=256, seq_len=64, global_batch=8,
                       device="cpu")
    a, b = ctrl.members
    kept = _clone(b.state)
    for m, e in ((a, eager.members[0]), (b, eager.members[1])):
        # the run released its graphs: this epoch captures again, from the
        # member's own (donated) state
        got = ctrl.train_epoch(m, (data.batch_for_step(s) for s in
                                   range(2)), data.batch_for_step(99))
        want = eager.train_epoch(e, (data.batch_for_step(s) for s in
                                     range(2)), data.batch_for_step(99))
        assert got == want
        _assert_equal_trees(m.state, e.state)
        if m is a:
            _assert_equal_trees(b.state, kept)


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------
def test_train_steps_are_jit01_roots():
    """The analyzer holds the steps handed to the donating StepGraph to
    JIT01, and its callgraph follows them through ``functional_call``'s
    objective into ``Model.loss`` and into ``optim/``, so a host read or
    a host constant there could not come back unseen."""
    from repro_torch.analysis.engine import collect_python_files
    from repro_torch.analysis.passes import purity
    from repro_torch.analysis.symbols import load_project
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    project = load_project(collect_python_files(
        [os.path.join(repo, "src", "repro_torch")], root=repo))
    _, jit, _ = purity._collect_roots(project)
    roots = {"repro_torch.launch.steps.train_graph_step",
             "repro_torch.launch.steps.hyper_train_step",
             "repro_torch.launch.steps.eval_graph_step"}
    assert roots <= jit
    reach = purity._reachable(project, roots)
    assert {"repro_torch.launch.steps.train_step",
            "repro_torch.launch.steps.loss_grads",
            "repro_torch.launch.steps.loss_value",
            "repro_torch.launch.steps._Objective.forward",
            "repro_torch.models.model.Model.loss",
            "repro_torch.optim.adamw.adamw_update",
            "repro_torch.optim.adamw._correction",
            "repro_torch.optim.clip.clip_scale",
            "repro_torch.optim.clip.global_norm",
            "repro_torch.rand.const"} <= set(reach)


def test_rand_const_rounds_as_torch_tensor():
    """The fills that replaced the host constants keep their bits."""
    for v in (0.9, 0.95, 1e-8, 0.1, 3e-3):
        assert torch.equal(rand.const(v, torch.float32, "cpu"),
                           torch.tensor(v, dtype=torch.float32))
