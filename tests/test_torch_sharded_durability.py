"""The sharded drivers' durability, the host bridge and ``ea --sharded``
on gloo ranks on the CPU, against the reference on as many fake devices.

* Kill and resume: a fused sharded run (sync, and async with churn) on 2
  ranks snapshots every 2 epochs; its newest snapshot is dropped, as a
  kill after the one before leaves it, and a fresh world of 2 resumes
  from the rest. The resumed run equals the uninterrupted one and the
  reference's resumed run bit for bit.
* Elastic: the 2-rank snapshot (4 islands) resumes on 4 ranks of 2
  islands (the joiners seeded from the pool), equal to the reference's
  resume on a mesh of 4.
* ``run_sharded(host_bridge=)``: rank 0 alone syncs with the server and
  broadcasts the pool, so the server sees one PUT a sync, as the
  reference's single controller gives it: islands, pool, the server's and
  the bridge's counts all equal the reference's (a solved volunteer
  genome in the server ends the run early in both).
* ``ea --sharded --device cpu --shards 2`` (host loop, ``--fused``,
  ``--runtime async``) prints the reference's lines (``XLA`` on 2 fake
  devices), the time and the backend aside.

Sizes: onemax 96 for the resumed runs (no early stop before the last
snapshot), onemax 24 otherwise; ``max_pop`` 32, 2 generations an epoch, 2
islands a rank.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import contextlib
import io
import os
import re

import pytest

pytest.importorskip("torch")

from repro_torch.launch import evolve  # noqa: E402

import _sharded_harness as harness  # noqa: E402

CHURN = {"min_rate": 0.5, "max_rate": 1.0, "staleness": 2,
         "churn_fraction": 0.5, "inbox_capacity": 3}
RESUMES = {
    "sync": dict(W=2, W2=2, per=2, per2=2, acfg=None),
    "async": dict(W=2, W2=2, per=2, per2=2, acfg=CHURN),
    "elastic": dict(W=2, W2=4, per=2, per2=2, acfg=None),
}
BRIDGE = {"capacity": 16, "seed": 5, "every": 1, "pull": 2,
          "volunteers": [3.0, 24.0]}
EA = ["ea", "--islands", "4", "--epochs", "3", "--max-pop", "16",
      "--min-pop", "8", "--gens-per-epoch", "2", "--impl", "pallas_ref"]
EA_RUNS = {"loop": [], "fused": ["--fused"],
           "async": ["--runtime", "async", "--churn", "0.5"]}


def _resume_case(name, tmp, side, W, W2, per, per2, acfg):
    """The reference's case (a run of ``W`` ranks, its newest snapshot
    dropped, a resume on ``W2``) and the port's two (the run in a world of
    ``W``, the resume in a world of ``W2``)."""
    c = harness.driver(name, "resume", W, problem=["onemax", 96],
                       epochs=6, every=2, drop=True, acfg=acfg,
                       dir=os.path.join(tmp, f"{side}-{name}"), per=per,
                       W2=W2, per2=per2)
    return c, [dict(c, kind="snapshot", name=f"{name}-full"), dict(c, W=W2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("durable"))
    ref_cases, port_cases = [], []
    for name, spec in RESUMES.items():
        ref_cases.append(_resume_case(name, tmp, "ref", **spec)[0])
        port_cases += _resume_case(name, tmp, "port", **spec)[1]
    bridge = harness.driver("bridge", "run_sharded", 2, bridge=BRIDGE,
                            epochs=4)
    ref_cases.append(bridge)
    port_cases.append(bridge)
    for name, flags in EA_RUNS.items():
        ref_cases.append({"name": f"ea-{name}", "kind": "ea", "W": 2,
                          "argv": EA + ["--sharded"] + flags})
    handle = harness.start_reference(ref_cases, tmp)
    try:
        port = {W: harness.port_world(port_cases, W) for W in (2, 4)}
        ea = {name: _ea(flags) for name, flags in EA_RUNS.items()}
    finally:
        ref = harness.reference_results(handle)
    return port, ref, ea


def _ea(flags):
    """The port's ``ea --sharded`` on 2 CPU ranks (one thread each):
    its lines and its ``(islands, pool)``."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with contextlib.redirect_stdout(buf):
            out = evolve.main(EA + ["--sharded", "--shards", "2", "--device",
                                    "cpu"] + flags)
    return buf.getvalue().splitlines(), out


@pytest.mark.parametrize("name", list(RESUMES))
def test_resume_matches_reference(runs, name):
    port, ref, _ = runs
    W2 = RESUMES[name]["W2"]
    got = harness.same_on_every_rank(port[W2], name)
    harness.assert_same(got, ref[name], name)
    assert int(got["epochs"]) == 6


@pytest.mark.parametrize("name", ["sync", "async"])
def test_killed_and_resumed_equals_uninterrupted(runs, name):
    port, _, _ = runs
    full = harness.same_on_every_rank(port[2], f"{name}-full")
    resumed = harness.same_on_every_rank(port[2], name)
    harness.assert_same(resumed, full, name)


def test_elastic_resume_grows_to_eight_islands(runs):
    port, _, _ = runs
    got = harness.same_on_every_rank(port[4], "elastic")
    assert got["islands.uuid"].tolist() == list(range(8))


def test_host_bridge_matches_reference_one_put_a_sync(runs):
    port, ref, _ = runs
    state = [{k: v for k, v in r["bridge"].items()
              if not k.startswith(("server", "bridge"))} for r in port[2]]
    harness.same_on_every_rank([{"bridge": s} for s in state], "bridge")
    got = port[2][0]["bridge"]
    harness.assert_same(got, ref["bridge"], "bridge")
    # every rank built a bridge; only rank 0's talked to its server
    assert port[2][1]["bridge"]["bridge"].tolist() == [0, 0, 0]
    assert port[2][1]["bridge"]["server"].tolist()[1] == 2
    size, puts, _, gets, _ = got["server"].tolist()
    epochs = int(got["epochs"])
    pushed, pulled, lost = got["bridge"].tolist()
    # two volunteer PUTs, then one PUT a sync, not one a rank
    assert puts == 2 + epochs and pushed == epochs and lost == 0
    assert gets == pulled


def _untimed(line):
    return re.sub(r" \(\d+\.\ds\)( backend=\S+)?$", "", line)


@pytest.mark.parametrize("name", list(EA_RUNS))
def test_ea_sharded_prints_the_references_lines(runs, name):
    _, ref, ea = runs
    lines, (isl, _) = ea[name]
    want = [str(x) for x in ref[f"ea-{name}"]["lines"]]
    assert [_untimed(x) for x in lines] == [_untimed(x) for x in want]
    assert lines[-2].endswith(" backend=gloo")
    assert lines[-1].startswith(
        f"final best={float(isl.best_fitness.max())!r} ")
    assert isl.pop.shape[0] == 4
