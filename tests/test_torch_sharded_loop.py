"""The sharded host loop (``repro_torch.core.sharded.run_sharded``) on 2
and 4 gloo ranks on the CPU against the reference's ``run_sharded`` on as
many fake devices, bit for bit: every topology under ``always`` (with the
pool server down at epoch 2) and under ``elitist``, the classic operators
(``impl="jnp"``) once, and W² on trap once. Every rank returns the global
islands and its pool replica; each must equal rank 0's.

Sizes: onemax 24 (trap 8x4), ``max_pop`` 32, ``min_pop`` 16, 2
generations an epoch, 2 islands a rank, 3 epochs, capacity 16.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import pytest

pytest.importorskip("torch")

import _sharded_harness as harness  # noqa: E402

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")


def _cases():
    out = []
    for W in (2, 4):
        for topo in TOPOLOGIES:
            out.append(harness.driver(f"{topo}-always-w{W}", "run_sharded",
                                      W, topo, down=[2]))
            out.append(harness.driver(f"{topo}-elitist-w{W}", "run_sharded",
                                      W, topo, "elitist"))
    out.append(harness.driver("pool-jnp-w2", "run_sharded", 2,
                              cfg=dict(harness.CFG, impl="jnp")))
    out.append(harness.driver("pool-w2trap-w2", "run_sharded", 2, w2=True,
                              problem=["trap", 8, 4]))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return harness.run_both(CASES, str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_run_sharded_matches_reference(both, case):
    port, ref = both
    got = harness.same_on_every_rank(port[case["W"]], case["name"])
    harness.assert_same(got, ref[case["name"]], case["name"])
