"""The mesh's compiled steps on the CPU: a rank's train, prefill and
decode step on a bound mesh replayed as a chain of CUDA graphs cut at its
collectives (``core/graphed.py::CutGraph``), the counterpart of the
reference's ``jax.jit`` with ``in_shardings`` (``repro/launch/train.py``,
``repro/launch/dryrun.py``'s sharded train, prefill and decode steps).

One spawned world of 2 gloo ranks on the CPU (``tests/_torch_mesh_ranks.py``)
runs every case twice, with graphs emulated
(``tests/_torch_capture.py::emulate_graphs``: a segment's capture records
its operations, ends at a collective, which runs as it is, and begins
again; a replay writes into the capture's tensors) and eagerly, and the
two must agree bit for bit on every rank:

* the train step of yi-9b on (1, 2) (the heads over ``model``) and of
  olmoe-1b-7b on (2, 1) (ZeRO-1 over ``data``), 3 steps (the graph's
  eager call, its capture, a replay), accumulation 1 and 2: each step's
  metrics, every leaf of the state, the donated state still the
  caller's tensors, the collective bytes and calls;
* ``generate`` of yi-9b and rwkv6-3b on (1, 2), three times (the
  prefill's eager call, capture and replay; 3 decode steps each): the
  tokens and every step's logits;
* ``launch/train.py``'s loop on the world's mesh, replayed and eager.

Besides: each step is capture-clean with its collectives as cuts
(``capture_faults(..., cuts=True)``); a rank that cuts where its peer does
not raises on every rank; and one graphed train case (yi-9b on (1, 2),
3 steps) against the reference's ``make_train_step`` jitted with its
``NamedSharding``s on 2 fake devices, at the model-family tolerances of
``tests/test_torch_mesh_train.py`` (ROADMAP Queue C), its subprocess
running beside the world.

Sizes: the smoke configs, 8 x 16 tokens (train), 4 x 16 prompts and 4
new tokens (serve).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_harness as harness  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

SEED = 5


def _case(name, what, arch, mesh, **kw):
    c = {"name": name, "kind": "graphs", "port_only": True, "W": 2,
         "what": what, "arch": arch, "mesh": mesh, "seed": SEED, "B": 8,
         "T": 16, "steps": 3, "accum": 1, "new": 4}
    c.update(kw)
    return c


STEP_CASES = [
    _case("train-yi-1x2", "train", "yi-9b", (1, 2)),
    _case("train-yi-1x2-accum2", "train", "yi-9b", (1, 2), accum=2),
    _case("train-olmoe-2x1", "train", "olmoe-1b-7b", (2, 1)),
    _case("train-olmoe-2x1-accum2", "train", "olmoe-1b-7b", (2, 1),
          accum=2),
    _case("serve-yi-1x2", "serve", "yi-9b", (1, 2), B=4),
    _case("serve-rwkv-1x2", "serve", "rwkv6-3b", (1, 2), B=4),
]
LOOP = _case("train-loop", "loop", "yi-9b", (1, 2))
FAULT_CASES = [
    _case("faults-train-yi-1x2", "train", "yi-9b", (1, 2), faults=True),
    _case("faults-train-olmoe-2x1", "train", "olmoe-1b-7b", (2, 1),
          faults=True, accum=2),
    _case("faults-serve-yi-1x2", "serve", "yi-9b", (1, 2), B=4,
          faults=True),
    _case("faults-serve-rwkv-1x2", "serve", "rwkv6-3b", (1, 2), B=4,
          faults=True),
]
UNEVEN = _case("uneven", "uneven", "yi-9b", (1, 2))
# (ce rtol, gnorm rtol, parameter atol): tests/test_torch_mesh_train.py's
REF_TOL = (1e-6, 1e-6, 2e-4)
REF_STEPS = 3


def _reference_case():
    cfg = get_config("yi-9b", smoke=True)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (8, 16), dtype=np.int32)
    return {"name": "reference-yi-1x2", "kind": "train", "W": 2,
            "arch": "yi-9b", "mesh": (1, 2), "mode": "train",
            "fsdp": False, "init": True, "graphs": True,
            "batch": {"tokens": toks, "labels": np.roll(toks, -1, axis=1)},
            "lr": 3e-3, "steps": REF_STEPS}


@pytest.fixture(scope="module")
def world():
    cases = STEP_CASES + [LOOP] + FAULT_CASES + [UNEVEN, _reference_case()]
    with tempfile.TemporaryDirectory() as tmp:
        port, ref = harness.run_both(cases, tmp, devices=2)
    return port[2], ref


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[c["name"] for c in STEP_CASES])
def test_graphed_mesh_step_equals_eager(world, case):
    ranks, _ = world
    for r, res in enumerate(ranks):
        got, want = res[case["name"]]["got"], res[case["name"]]["want"]
        assert got["bytes"] == want["bytes"], (r, got["bytes"])
        assert got["calls"] == want["calls"], (r, got["calls"])
        if case["what"] == "train":
            captures, segments, cuts = got["chain"]
            assert captures == 1 and cuts > 0 and segments == cuts + 1
            assert got["callers"], f"rank {r}: the donated state moved"
            for i, (a, b) in enumerate(zip(got["metrics"],
                                           want["metrics"])):
                for k in b:
                    assert _same(a[k], b[k]), (r, i, k, a[k], b[k])
            assert len(got["state"]) == len(want["state"])
            for i, (a, b) in enumerate(zip(got["state"], want["state"])):
                assert _same(a, b), (r, "state leaf", i)
        else:
            for kind, (captures, segments, cuts) in got["chain"].items():
                assert captures == 1 and cuts > 0, (kind, got["chain"])
                assert segments == cuts + 1, (kind, got["chain"])
            for i, ((ta, la), (tb, lb)) in enumerate(zip(got["runs"],
                                                         want["runs"])):
                assert _same(ta, tb) and _same(la, lb), (r, "run", i)


def test_train_loop_replays_on_the_group(world):
    """``launch/train.py``'s loop on a group replays its step (graphs
    emulated) and equals ``graphs=False`` bit for bit."""
    ranks, _ = world
    for r, res in enumerate(ranks):
        got, want = res[LOOP["name"]]["got"], res[LOOP["name"]]["want"]
        assert got["losses"] == want["losses"], r
        assert all(_same(a, b) for a, b in zip(got["state"],
                                               want["state"])), r


@pytest.mark.parametrize("case", FAULT_CASES,
                         ids=[c["name"] for c in FAULT_CASES])
def test_mesh_step_is_capture_clean(world, case):
    """Between its collectives a rank's step reads nothing on the host,
    copies no host constant and writes no input but its donated state or
    its ring caches."""
    ranks, _ = world
    for r, res in enumerate(ranks):
        for step, faults in res[case["name"]].items():
            assert faults == [], (r, step, faults)


def test_uneven_cuts_raise_on_every_rank(world):
    ranks, _ = world
    for r, res in enumerate(ranks):
        msg = res[UNEVEN["name"]]["raised"]
        assert msg and "would hang its peers" in msg, (r, msg)
    assert "captured 1 segments and 0 cuts" in ranks[0][UNEVEN["name"]][
        "raised"]
    assert "captured 2 segments and 1 cuts" in ranks[1][UNEVEN["name"]][
        "raised"]


def test_graphed_train_matches_reference(world):
    ranks, ref = world
    name = "reference-yi-1x2"
    want = ref[name]
    ce_tol, gnorm_tol, atol = REF_TOL
    got = [r[name] for r in ranks]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    assert len(got[0]["metrics"]) == REF_STEPS
    for i, (g, w) in enumerate(zip(got[0]["metrics"], want["metrics"])):
        for k, tol in (("ce", ce_tol), ("grad_norm", gnorm_tol)):
            harness.assert_close(g[k], w[k], tol, 0.0, f"{name} step {i} {k}")
    gathered = got[0]["global"]
    for key, leaf in _flat(want["params"]).items():
        node = gathered
        for p in key:
            node = node[p]
        harness.assert_close(node, leaf, 0.0, atol, f"{name} {key}")


def test_cut_graphs_are_jit01_roots():
    """The analyzer roots the steps handed to a CutGraph, and its
    callgraph follows the mesh's serve steps into the model's sharded
    layers, ``decode_step_sharded`` among them, which reads no host value
    now (no pragma)."""
    from repro_torch.analysis.engine import collect_python_files
    from repro_torch.analysis.passes import purity
    from repro_torch.analysis.symbols import load_project
    assert "repro_torch.core.graphed.CutGraph" in purity.GRAPHED_CALLABLES
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    project = load_project(collect_python_files(
        [os.path.join(repo, "src", "repro_torch")], root=repo))
    _, jit, _ = purity._collect_roots(project)
    roots = {"repro_torch.launch.steps.train_graph_step",
             "repro_torch.launch.steps.serve_prefill_step",
             "repro_torch.launch.steps.serve_decode_step"}
    assert roots <= jit
    reach = purity._reachable(project, roots)
    assert {"repro_torch.models.attention.decode_step_sharded",
            "repro_torch.models.attention.attend_sharded",
            "repro_torch.models.moe.apply_sharded"} <= set(reach)
    with open(os.path.join(repo, "src", "repro_torch", "models",
                           "attention.py")) as f:
        assert "JIT01" not in f.read()


def _flat(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
    else:
        out[path] = tree
    return out
