"""The mesh's compiled steps on the card: a rank's step replayed as a
chain of CUDA graphs cut at its collectives
(``core/graphed.py::CutGraph``), against the same step called eagerly.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_graphs_cuda.py

* The thread rule: a cut inside autograd's backward ends, on autograd's
  device thread, a segment the step's thread began. In the ``relaxed``
  capture mode the chain replays bit for bit with the eager step; in
  ``thread_local`` mode CUDA refuses to end the capture there. Each mode
  runs in a world of one rank (gloo, the gathers through the card) of
  its own process.
* Two ranks sharing the card (gloo with host copies, the gathers through
  the card by CUDA IPC) train yi-9b's smoke config on (1, 2) and serve it
  (the prefill and 3 decode steps, three times): graphed equals eager
  bit for bit on every rank, and the donated state's tensors stay the
  caller's.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.core import sharded

pytestmark = pytest.mark.cuda
WORLD_TIMEOUT = 300.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return torch.device("cuda", 0)


def test_cut_inside_backward_replays_relaxed(card):
    res = sharded.spawn(ranks.backward_cut, 1, "gloo", card,
                        timeout=WORLD_TIMEOUT, args=("relaxed",))[0]
    assert res[0] == "ok", res
    _, equal, cuts, other_thread = res
    assert equal and cuts == 2 and other_thread, res


def test_thread_local_capture_refuses_a_cut_in_the_backward(card):
    res = sharded.spawn(ranks.backward_cut, 1, "gloo", card,
                        timeout=WORLD_TIMEOUT, args=("thread_local",))[0]
    print(f"thread_local: {res}")
    assert res[0] == "raised", res
    assert "capture" in res[1].lower(), res


def _case(name, what, **kw):
    c = {"name": name, "kind": "graphs", "W": 2, "what": what,
         "arch": "yi-9b", "mesh": (1, 2), "seed": 5, "B": 4, "T": 16,
         "steps": 3, "accum": 1, "new": 4, "device": "cuda"}
    c.update(kw)
    return c


def test_mesh_steps_replay_bit_for_bit_on_the_card(card):
    cases = [_case("train", "train"), _case("serve", "serve")]
    per_rank = sharded.spawn(ranks.graph_cases, 2, "gloo", card,
                             timeout=WORLD_TIMEOUT, args=(cases,))
    for r, res in enumerate(per_rank):
        got, want = res["train"]["got"], res["train"]["want"]
        assert got["chain"][0] == 1 and got["chain"][2] > 0, got["chain"]
        assert got["callers"], f"rank {r}: the donated state moved"
        for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in b:
                assert np.array_equal(a[k], b[k]), (r, i, k)
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["state"], want["state"])), r
        assert got["bytes"] == want["bytes"], r
        got, want = res["serve"]["got"], res["serve"]["want"]
        for i, ((ta, la), (tb, lb)) in enumerate(zip(got["runs"],
                                                     want["runs"])):
            assert np.array_equal(ta, tb) and np.array_equal(la, lb), (r, i)
        assert got["bytes"] == want["bytes"], r
