"""The asynchronous sharded driver
(``repro_torch.core.sharded.run_fused_sharded_async``) on gloo ranks on the
CPU against the reference's on as many fake devices, bit for bit with the
stats, the async state and the counters: churned volunteers (rates in
[0.5, 1], staleness 2, a quarter of the islands down for a while, inboxes
of 3) under every topology at 2 ranks, under the pool and the ring at 4,
and under ``elitist`` once. Each rank's fire mask is
the topologies' vector availability of its islands. In the degenerate
configuration (``AsyncConfig()``) the driver equals
``run_fused_sharded`` bit for bit, at 2 and 4 ranks.

Sizes: onemax 24, ``max_pop`` 32, ``min_pop`` 16, 2 generations an epoch,
2 islands a rank, 5 ticks (3 in the degenerate cases), capacity 16.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import numpy as np
import pytest

pytest.importorskip("torch")

import _sharded_harness as harness  # noqa: E402

CHURN = {"min_rate": 0.5, "max_rate": 1.0, "staleness": 2,
         "churn_fraction": 0.5, "inbox_capacity": 3}
ASYNC = "run_fused_sharded_async"


def _cases():
    out = []
    for W, topos in ((2, ("pool", "ring", "torus", "random_graph",
                          "broadcast_best")),
                     (4, ("pool", "ring"))):
        for topo in topos:
            out.append(harness.driver(f"{topo}-churn-w{W}", ASYNC, W, topo,
                                      acfg=CHURN, epochs=5, stats=True,
                                      astate=True, obs=True))
    out.append(harness.driver("pool-churn-elitist-w2", ASYNC, 2, "pool",
                              "elitist", acfg=CHURN, epochs=5, stats=True,
                              astate=True, obs=True))
    for W in (2, 4):
        out.append(harness.driver(f"degenerate-w{W}", ASYNC, W, acfg={},
                                  stats=True, obs=True))
        out.append(harness.driver(f"sync-w{W}", "run_fused_sharded", W,
                                  stats=True, obs=True))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return harness.run_both(CASES, str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sharded_drivers_match_reference(both, case):
    port, ref = both
    got = harness.same_on_every_rank(port[case["W"]], case["name"])
    harness.assert_same(got, ref[case["name"]], case["name"])
    assert np.array_equal(got["obs.delivered"],
                          got["obs.accepted"] + got["obs.rejected"])


@pytest.mark.parametrize("W", [2, 4])
def test_degenerate_async_is_the_sync_driver(both, W):
    port, _ = both
    asyn = harness.same_on_every_rank(port[W], f"degenerate-w{W}")
    sync = harness.same_on_every_rank(port[W], f"sync-w{W}")
    harness.assert_same(asyn, sync, f"degenerate-w{W}",
                        skip=("obs.churn_down",))
    assert set(asyn) == set(sync)


@pytest.mark.parametrize("W", [2, 4])
def test_churn_took_islands_down_and_fires_lag(both, W):
    """The churned cases did what they test: an island was down on some
    rank, and the fires are fewer than the island-ticks."""
    port, _ = both
    got = harness.same_on_every_rank(port[W], f"pool-churn-w{W}")
    assert got["obs.churn_down"].sum() > 0
    assert got["astate.fires"].sum() < 5 * got["astate.fires"].shape[0]
