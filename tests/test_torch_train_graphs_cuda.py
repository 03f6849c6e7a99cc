"""The compiled train and PBT steps on the card: ``train`` and ``run_pbt``
replay their steps as CUDA graphs by default, against ``graphs=False``.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_graphs_cuda.py

The smoke configs (f32) and minicpm-2b ``reduced()`` in bf16 with its f32
master: the graphed step runs the eager step's kernels on the same
buffers, so every step's metrics and the final state must be equal bit
for bit, the first (capturing) call included; PBT's members keep their
own states; the graphed batch draw gives the eager draw's bits.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import functools

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_config
from repro_torch.core import graphed
from repro_torch.data import SyntheticLM
from repro_torch.launch import evolve
from repro_torch.launch import steps as steps_lib
from repro_torch.launch import train as train_mod
from repro_torch.models import Model
from repro_torch.optim import make_schedule

pytestmark = pytest.mark.cuda
SEED = 11


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return torch.device("cuda")


def _leaves(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bits(metrics):
    return torch.stack([metrics[k].float() for k in sorted(metrics)]).view(
        torch.int32)


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch,accum", [("minicpm-2b", 1), ("minicpm-2b", 2),
                                        ("rwkv6-3b", 1), ("rwkv6-3b", 2)])
def test_graphed_train_equals_eager_on_the_card(card, arch, accum):
    runs = {}
    for graphs in (False, True):
        seen = []
        state, losses = train_mod.train(
            arch, smoke=True, steps=4, batch=4, seq=32, accum=accum,
            seed=SEED, verbose=False, device="cuda", graphs=graphs,
            on_step=lambda i, s, m: seen.append(_bits(m)))
        runs[graphs] = (state, losses, seen)
    (gs, gl, gm), (es, el, em) = runs[True], runs[False]
    assert gl == el
    assert all(torch.equal(a, b) for a, b in zip(gm, em))
    assert _equal_trees(gs, es)


def test_graphed_bf16_step_keeps_its_master_on_the_card(card):
    """bf16 parameters with the f32 master (the published cells' dtypes),
    through ``compiled_train_step``: 3 steps bit for bit, the donated
    buffers the caller's, the parameters the master rounded."""
    cfg = get_config("minicpm-2b").reduced(param_dtype=torch.bfloat16,
                                           activation_dtype=torch.bfloat16)
    model = Model(cfg, device=card,
                  generator=torch.Generator(device=card).manual_seed(SEED))
    state = steps_lib.init_train_state(model)
    want = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    step = steps_lib.make_train_step(model, schedule=make_schedule(
        "wsd", 3e-3, 10, 2))
    graph = steps_lib.compiled_train_step(step)
    eager = graphed.EagerStep(functools.partial(steps_lib.train_graph_step,
                                                step), card)
    data = SyntheticLM(cfg.vocab_size, 64, 8, SEED, device=card)
    ptrs = [t.data_ptr() for t in _leaves(state)]
    for i in range(3):
        b = data.batch_for_step(i)
        (state, _), gm = graph((state, b))
        (want, _), wm = eager((want, b))
        assert torch.equal(_bits(gm), _bits(wm))
    assert [t.data_ptr() for t in _leaves(state)] == ptrs
    assert _equal_trees(state, want) and graph.captures == 1
    assert all(torch.equal(p, state.opt.master[k].to(torch.bfloat16))
               for k, p in state.params.items())
    graph.release()


def test_graphed_pbt_equals_eager_and_members_keep_their_states(card):
    runs = {}
    for graphs in (False, True):
        seen = []
        ctrl = evolve.run_pbt(members=3, epochs=2, steps_per_epoch=3,
                              seed=SEED, verbose=False, graphs=graphs,
                              on_step=lambda m, met: seen.append(
                                  (m.uuid, _bits(met))))
        runs[graphs] = (ctrl, seen)
    (g_ctrl, gs), (e_ctrl, es) = runs[True], runs[False]
    assert g_ctrl.history == e_ctrl.history
    assert len(gs) == len(es) == 3 * 2 * 3
    assert all(gu == eu and torch.equal(g, e)
               for (gu, g), (eu, e) in zip(gs, es))
    for g, e in zip(g_ctrl.members, e_ctrl.members):
        assert _equal_trees(g.state, e.state)
    # a member's replays write no other member's state
    data = SyntheticLM(256, 64, 8, device=card)
    a, b = g_ctrl.members[:2]
    kept = [t.clone() for t in _leaves(b.state)]
    g_ctrl.train_epoch(a, (data.batch_for_step(s) for s in range(2)),
                       data.batch_for_step(99))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(b.state), kept))


def test_graphed_batch_draw_equals_eager_on_the_card(card):
    from repro_torch import rand
    from repro_torch.data import synthetic
    data = SyntheticLM(122_753, 512, 8, SEED, device=card)
    for step in range(3):
        key = rand.fold_in(rand.fold_in(rand.key(SEED, card), step), 0)
        want = synthetic._gen(key, 8, 512, 122_753, 0.15, 8)
        got = data.batch_for_step(step)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert [g.captures for g in data._graphs.values()] == [1]
