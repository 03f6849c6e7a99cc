"""The sharded drivers' compiled form on the CPU: each rank's generations
replayed as a CUDA graph (``core/graphed.py::RankGraph``) between the
exchange's collectives, the counterpart of the reference's jitted
``shard_map`` (``repro/core/sharded.py``: ``make_sharded_epoch``,
``run_fused_sharded``'s and ``run_fused_sharded_async``'s segments).

One spawned world of 2 gloo ranks on the CPU runs every case twice, with
graphs emulated (``tests/_torch_capture.py::emulate_graphs``: the capture
records the operations, a replay writes into the capture's tensors) and
eagerly, and the two must agree bit for bit, every rank's global state
(and so its pool replica) equal to rank 0's. The cases: ``run_sharded``
under the pool topology and under the torus with the server down for an
epoch (the host loop's Python ``up`` and epoch reach the eager tail);
``run_fused_sharded`` with stats and counters and W², and stopping early;
``run_fused_sharded_async`` degenerate and churned; each under ``pallas``
(the epoch unit: the kernels' plain versions run on the CPU) and ``jnp``
(the generation unit). Besides: one capture serving two runs, two groups
of the same ranks that never share a runner, a snapshot and resume equal
to the uninterrupted run, and one graphed case against the reference's
jitted ``run_fused_sharded`` on 4 fake devices (``_sharded_harness``),
whose subprocess runs beside the world.

Sizes: trap 8x4 (onemax 16 where a run stops early), 2 islands a rank,
``max_pop`` 32, ``min_pop`` 16, 3 generations an epoch, 3 epochs (6
where a run stops early), capacity 16.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import os

import numpy as np
import pytest
import torch

import _sharded_harness as harness
import _torch_sharded_ranks as ranks
from _torch_capture import capture_faults
from repro_torch import rand
from repro_torch.core import EAConfig, make_trap, sharded
from repro_torch.core import island as island_lib

CFG = {"max_pop": 32, "min_pop": 16, "generations_per_epoch": 3,
       "mutation_rate": 0.05}
TRAP = ["trap", 8, 4]
ACFG = {"min_rate": 0.25, "max_rate": 1.0, "staleness": 3,
        "churn_fraction": 0.25}
IMPLS = ("pallas", "jnp")
WORLD_TIMEOUT = 300.0


def _case(name, kind, impl, **kw):
    kw.setdefault("problem", TRAP)
    return harness.driver(f"{name}-{impl}", kind, 2,
                          cfg=dict(CFG, impl=impl), **kw)


def _cases():
    out = []
    for impl in IMPLS:
        out += [
            _case("host-pool", "run_sharded", impl),
            _case("host-torus-down", "run_sharded", impl, topology="torus",
                  down=[2]),
            _case("fused-w2", "run_fused_sharded", impl, w2=True,
                  stats=True, obs=True),
            _case("fused-early-stop", "run_fused_sharded", impl,
                  problem=["onemax", 16], epochs=6, stats=True, obs=True),
            _case("async-degenerate", "run_fused_sharded_async", impl,
                  acfg={}, w2=True, stats=True, astate=True, obs=True),
            _case("async-churned", "run_fused_sharded_async", impl,
                  acfg=ACFG, w2=True, stats=True, astate=True, obs=True),
        ]
    return out


DRIVER_CASES = _cases()
TWO_RUNS = _case("two-runs", "two_runs", "pallas")
TWO_GROUPS = _case("two-groups", "two_groups", "jnp")
# against the reference: the harness's configuration (impl pallas_ref,
# the generation unit), stats and counters
REFERENCE = harness.driver("reference-fused", "run_fused_sharded", 2,
                           stats=True, obs=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("graphs"))
    resume = [dict(_case(f"resume-{k}", "resume", "pallas", stats=True,
                         epochs=4, **extra),
                   every=1, drop=True, dir=os.path.join(tmp, f"snap-{k}"))
              for k, extra in (("fused", {}), ("async", {"acfg": ACFG}))]
    cases = DRIVER_CASES + [TWO_RUNS, TWO_GROUPS, REFERENCE] + resume
    handle = harness.start_reference([REFERENCE], tmp)
    try:
        per_rank = sharded.spawn(ranks.graph_cases, 2, "gloo", "cpu",
                                 timeout=WORLD_TIMEOUT, args=(cases,),
                                 threads=1)
    finally:
        ref = harness.reference_results(handle)
    return per_rank, ref


def _checked(world, name):
    """The case's graphed and eager results, after holding every rank's
    to rank 0's; every graphed run captured once a runner."""
    per_rank, _ = world
    for side in ("got", "want"):
        harness.same_on_every_rank([r[name] for r in per_rank], side)
    res = per_rank[0][name]
    assert res["info"]["captures"] and all(
        n == 1 for n in res["info"]["captures"]), res["info"]
    return res


@pytest.mark.parametrize("case", DRIVER_CASES,
                         ids=[c["name"] for c in DRIVER_CASES])
def test_graphed_equals_eager(world, case):
    res = _checked(world, case["name"])
    harness.assert_same(res["got"], res["want"], case["name"])
    if "stats.epoch" in res["want"]:
        assert res["want"]["stats.epoch"].shape == (case["epochs"],)


def test_early_stop_freezes_under_graphs(world):
    for impl in IMPLS:
        res = _checked(world, f"fused-early-stop-{impl}")
        assert int(res["got"]["epochs"]) < 6


def test_one_capture_serves_two_runs(world):
    res = _checked(world, TWO_RUNS["name"])
    assert res["info"]["captures"] == [1]
    assert res["info"]["first_kept"]
    harness.assert_same(res["got"], res["want"], TWO_RUNS["name"])


def test_two_groups_never_share_a_runner(world):
    res = _checked(world, TWO_GROUPS["name"])
    n, keyed, distinct, both_called = res["info"]["facts"]
    assert (n, keyed, distinct, both_called) == (2, True, True, True)
    assert res["info"]["captures"] == [1, 1]
    harness.assert_same(res["got"], res["want"], TWO_GROUPS["name"])


@pytest.mark.parametrize("kind", ["fused", "async"])
def test_resume_equals_uninterrupted_under_graphs(world, kind):
    name = f"resume-{kind}-pallas"
    res = _checked(world, name)
    harness.assert_same(res["got"], res["want"], name)


def test_graphed_matches_reference(world):
    _, ref = world
    res = _checked(world, REFERENCE["name"])
    harness.assert_same(res["got"], ref[REFERENCE["name"]],
                        REFERENCE["name"])


@pytest.mark.parametrize("impl", IMPLS)
def test_captured_stretch_is_capturable(impl):
    """What a rank captures, the generations of an epoch (or one), reads
    nothing on the host, copies no host constant and writes no input."""
    problem = make_trap(8, 4)
    cfg = EAConfig(impl=impl, **CFG)
    islands = island_lib.init_islands(rand.key(3), 2, problem, cfg,
                                      device="cpu")
    assert capture_faults(island_lib.island_epoch, islands, problem,
                          cfg) == []
    assert capture_faults(island_lib.generation_step, islands, problem,
                          cfg) == []


def test_spawn_runs_on_the_card_by_default():
    """With no device, spawn resolves the card: here, with none visible,
    it raises before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        sharded.spawn(ranks.raise_on_rank_one, 2, timeout=5)
