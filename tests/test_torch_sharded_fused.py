"""The fused sharded driver (``repro_torch.core.sharded.run_fused_sharded``)
on 2 gloo ranks on the CPU against the reference's ``run_fused_sharded``
on as many fake devices, bit for bit with the stats and the counters:
every topology under ``always`` and under ``elitist``, and W² on trap
once. ``tests/test_torch_sharded_fused4.py`` holds 4 ranks.

The stats are the global ones on every rank (the reference's
``pmax``/``psum``; the mean is each rank's mean summed in rank order over
the world size, which at 4 ranks gives the reference's bits too). The
counters are harvested over every rank, their ledger balances (delivered
= accepted + rejected), and the early-stop epoch is replicated.

Sizes: onemax 24 (trap 8x4), ``max_pop`` 32, ``min_pop`` 16, 2
generations an epoch, 2 islands a rank, 3 epochs, capacity 16.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import numpy as np
import pytest

pytest.importorskip("torch")

import _sharded_harness as harness  # noqa: E402

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")


def fused_cases(W):
    return [harness.driver(f"{topo}-{policy}-w{W}", "run_fused_sharded", W,
                           topo, policy, stats=True, obs=True)
            for topo in TOPOLOGIES for policy in ("always", "elitist")]


CASES = fused_cases(2) + [harness.driver(
    "pool-w2trap-w2", "run_fused_sharded", 2, w2=True,
    problem=["trap", 8, 4], stats=True, obs=True)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return harness.run_both(CASES, str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_run_fused_sharded_matches_reference(both, case):
    check(both, case)


def check(both, case):
    port, ref = both
    got = harness.same_on_every_rank(port[case["W"]], case["name"])
    harness.assert_same(got, ref[case["name"]], case["name"])
    delivered = got["obs.delivered"]
    assert np.array_equal(delivered, got["obs.accepted"]
                          + got["obs.rejected"])
    assert delivered.shape == (case["W"] * case["per"],)
    assert got["stats.epoch"].shape == (case["epochs"],)
