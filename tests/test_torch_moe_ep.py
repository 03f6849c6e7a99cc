"""Expert parallelism (``repro_torch.models.moe.apply_sharded``, the
reference's ``USE_EP`` / ``_apply_ep``) on 4 gloo ranks, (2, 2), against
the reference's loss under ``set_mesh`` on 4 fake devices, olmoe-1b-7b
smoke (4 experts, top 2), from ``Model.init(key(0))`` on one seeded
4 x 16 batch.

With ``USE_EP`` each rank routes its data shard's tokens and runs its 2
local experts, with the capacity of its own token count; the loss and
``dropped_frac`` (which counts every rank's kept choices) are held to the
reference's EP, far closer than the reference's own 0.05 between EP and
the scatter path (``tests/test_moe_ep.py``). With ``USE_EP`` off both
run the scatter path on the global batch (the port gathers the rows).
The gradients are finite on every rank.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_harness as harness  # noqa: E402

# loss rtol (ROADMAP Queue C); dropped_frac counts choices: exact
LOSS_RTOL = 1e-6


def case(ep):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (4, 16), dtype=np.int32)
    return {"name": f"ep={ep}", "kind": "moe_ep", "W": 4,
            "arch": "olmoe-1b-7b", "mesh": (2, 2), "ep": ep, "init": True,
            "batch": {"tokens": toks, "labels": toks}}


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_both([case(True), case(False)], tmp, devices=4,
                                procs=2)


@pytest.mark.parametrize("ep", [True, False])
def test_moe_matches_reference_on_2x2(results, ep):
    port, ref = results
    want = ref[f"ep={ep}"]
    ranks = [r[f"ep={ep}"] for r in port[4]]
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["finite"]
    got = ranks[0]
    assert want["finite"]
    harness.assert_close(got["loss"], want["loss"], LOSS_RTOL, 0.0,
                         f"ep={ep} loss")
    for k in ("ce", "load_balance", "router_z"):
        harness.assert_close(got["metrics"][k], want["metrics"][k],
                             LOSS_RTOL, 0.0, f"ep={ep} {k}")
    assert got["metrics"]["dropped_frac"] == want["metrics"]["dropped_frac"]
    assert 0.0 <= got["metrics"]["dropped_frac"] < 0.5


def test_ep_differs_from_scatter_as_the_reference_does(results):
    """Local capacity drops other tokens than the global one: the port's
    two routes differ as the reference's do."""
    port, ref = results
    ep, sc = port[4][0]["ep=True"], port[4][0]["ep=False"]
    assert abs(ep["loss"] - sc["loss"]) < 0.05
    np.testing.assert_allclose(ep["loss"] - sc["loss"],
                               ref["ep=True"]["loss"]
                               - ref["ep=False"]["loss"], atol=1e-5)
