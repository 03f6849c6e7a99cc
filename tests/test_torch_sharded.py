"""The shard group (``repro_torch.core.sharded``) and the SPMD branch of
every topology (``repro_torch.core.migration`` with ``axis=``) on gloo
ranks on the CPU, against the reference's ``shard_map`` on as many fake
devices.

* The group's collectives at 2 and 3 ranks: the tiled and stacked
  gathers in rank order, ``ppermute`` (a ring, and a partial permutation
  whose other ranks get zeros), integer sums, max, ``any``, the float sum
  in rank order (a ``-0.0`` and a ``+0.0`` sum to ``+0.0``), broadcast,
  bools through the wire; a float all-reduce sum is refused.
* ``spawn``: a rank that raises fails its world with its traceback; a
  rank that never joins fails it within the timeout; ``make_host_group``
  inside a rank is that rank's group; the backend and device choice;
  ``ea --sharded`` under ``torchrun`` (2 processes, the default group
  from the environment) prints the lines of the spawned world's run.
* ``migrate(axis=group)`` at 2 and 4 ranks equals the reference's
  ``migrate(axis="islands")`` inside ``shard_map`` bit for bit: every
  topology (torus on both parities), a dead server, fire masks, the
  elitist PUT into a prefilled pool, ties, and the elite's ``-0.0`` gene
  (kept at one rank, ``+0.0`` past one, as the reference's ``psum`` gives
  it). Beside it the reference's SPMD properties
  (``tests/test_migration.py``): the pool replicas equal and every best
  PUT, each best delivered once by the permutes, the ring moving whole
  slabs, every island receiving the elite, a dead server a no-op.

Sizes: 2 islands a rank, genomes of 8 genes, capacity 32.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import contextlib
import io
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import sharded  # noqa: E402
from repro_torch.launch import evolve  # noqa: E402

import _sharded_harness as harness  # noqa: E402
import _torch_sharded_ranks as ranks  # noqa: E402

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")
PER = 2


def _mig(name, W, topology, **kw):
    case = {"name": name, "kind": "migrate", "W": W, "per": PER,
            "mig": {"topology": topology, "pool_capacity": 32},
            "epoch": 1, "seed": 7}
    case.update(kw)
    return case


def _cases():
    out = []
    for W in (2, 4):
        for topo in TOPOLOGIES:
            out.append(_mig(f"{topo}-w{W}", W, topo))
        out.append(_mig(f"torus-even-w{W}", W, "torus", epoch=0))
        out.append(_mig(f"pool-elitist-w{W}", W, "pool", prefill=True,
                        mig={"topology": "pool", "pool_capacity": 4,
                             "acceptance": ["elitist", 0.0]}))
        out.append(_mig(f"broadcast-ties-w{W}", W, "broadcast_best",
                        ties=True))
    for topo in TOPOLOGIES:
        out.append(_mig(f"{topo}-down-w2", 2, topo, available=False))
    mask = [True, False, False, True]
    for topo in ("pool", "ring", "broadcast_best"):
        out.append(_mig(f"{topo}-mask-w2", 2, topo, available=mask))
    for W in (1, 2, 4):
        out.append(_mig(f"negzero-w{W}", W, "broadcast_best",
                        inputs="negzero"))
    return out


CASES = _cases()
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    port, ref = harness.run_both(CASES, str(tmp_path_factory.mktemp("ref")))
    got = {c["name"]: harness.assemble_migrate(port[c["W"]], c["name"])
           for c in CASES}
    return got, ref


@pytest.mark.parametrize("name", NAMES)
def test_spmd_migrate_matches_reference(both, name):
    got, ref = both
    harness.assert_same(got[name], ref[name], name)


@pytest.mark.parametrize("W", [2, 4])
def test_pool_replicas_equal_and_every_best_put(both, W):
    got, _ = both
    pools = got[f"pool-w{W}"]
    for k, v in pools.items():
        if k.startswith("pools."):
            assert all(np.array_equal(v[0], v[r]) for r in range(W)), k
    assert int(pools["pools.count"][0]) == W * PER


@pytest.mark.parametrize("topo", ["ring", "torus", "torus-even",
                                  "random_graph"])
@pytest.mark.parametrize("W", [2, 4])
def test_permutes_deliver_each_best_once(both, topo, W):
    got, _ = both
    imm_f = got[f"{topo}-w{W}"]["imm_f"]
    assert sorted(imm_f.tolist()) == list(range(W * PER))


def test_ring_moves_whole_slabs_and_broadcast_sends_the_elite(both):
    got, _ = both
    for W in (2, 4):
        f = np.arange(W * PER, dtype=np.float32)
        want = np.roll(f.reshape(W, PER), 1, axis=0).ravel()
        assert np.array_equal(got[f"ring-w{W}"]["imm_f"], want)
        b = got[f"broadcast_best-w{W}"]
        assert (b["imm_f"] == W * PER - 1).all()
        assert (b["imm_g"] == W * PER - 1).all()


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_a_dead_server_is_a_no_op(both, topo):
    res = both[0][f"{topo}-down-w2"]
    assert np.isneginf(res["imm_f"]).all()
    assert int(res["pools.count"][0]) == 0
    assert not res["delivered"].any()


@pytest.mark.parametrize("W", [1, 2, 4])
def test_elite_negative_zero_gene(both, W):
    """The elite's genome crosses ranks as an f32 sum of its owner's row
    and the other ranks' zeros: a ``-0.0`` gene stays ``-0.0`` at one rank
    and reads ``+0.0`` past one, in both packages."""
    got, ref = both
    g = got[f"negzero-w{W}"]["imm_g"]
    sign = np.signbit(g[:, 0])
    assert sign.all() if W == 1 else not sign.any()
    assert (g[:, 2] == -1.5).all()
    assert np.array_equal(np.signbit(ref[f"negzero-w{W}"]["imm_g"]),
                          np.signbit(g))


# ---------------------------------------------------------------------------
# the group and spawn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W", [2, 3])
def test_collectives_on_gloo(W):
    out = sharded.spawn(ranks.collectives, W, "gloo", "cpu", timeout=60,
                        threads=1)
    xs = [np.arange(6, dtype=np.int8).reshape(2, 3) + 10 * r
          for r in range(W)]
    for r, res in enumerate(out):
        assert np.array_equal(res["gather"], np.concatenate(xs))
        assert np.array_equal(res["stack"], np.stack(xs))
        assert np.array_equal(res["ring"], xs[(r - 1) % W])
        want = xs[0] if r == W - 1 else np.zeros_like(xs[0])
        assert np.array_equal(res["partial"], want)
        assert res["sum"].tolist() == [sum(range(W)), W]
        assert float(res["max"]) == W - 1
        assert bool(res["any"]) and not bool(res["none"])
        assert res["ordered"][0] == sum_in_rank_order(W)
        assert res["ordered"][1] == 0 and not np.signbit(res["ordered"][1])
        assert np.array_equal(res["bcast"], xs[W - 1])
        assert res["bool_gather"].dtype == np.bool_
        assert res["bool_gather"].tolist() == [k == W - 1 for k in range(W)]
        assert int(res["calls"]) == 12
        assert "sum_in_order" in str(res["float_sum_refused"])


def sum_in_rank_order(W):
    """The ranks' ``0.1 * (rank + 1)`` in f32, summed left to right."""
    values = [np.float32(0.1 * (r + 1)) for r in range(W)]
    acc = values[0]
    for v in values[1:]:
        acc = np.float32(acc + v)
    return acc


def test_a_rank_that_raises_fails_its_world():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*rank one refuses"):
        sharded.spawn(ranks.raise_on_rank_one, 2, "gloo", "cpu", timeout=60,
                      threads=1)


def test_a_rank_that_never_joins_fails_within_the_timeout():
    t = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        sharded.spawn(ranks.hang_on_rank_one, 2, "gloo", "cpu", timeout=6,
                      threads=1)
    assert time.monotonic() - t < 40


def test_make_host_group_inside_a_rank_and_the_backend_choice(monkeypatch):
    got = sharded.spawn(ranks.host_group, 2, "gloo", "cpu", timeout=60,
                        threads=1)
    assert got == [(0, 2, "cpu", "gloo"), (1, 2, "cpu", "gloo")]
    assert sharded.choose_backend("cpu", 4) == ("gloo", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.choose_backend("cuda", 2) == ("nccl", False)
    assert sharded.choose_backend("cuda", 4) == ("gloo", True)
    assert sharded.rank_device("nccl", "cuda", 1) == torch.device("cuda", 1)
    assert sharded.rank_device("gloo", "cuda", 3) == torch.device("cuda", 1)
    assert sharded.rank_device("gloo", "cpu", 3) == torch.device("cpu")


def test_ea_sharded_under_torchrun_prints_the_spawned_runs_lines(
        monkeypatch):
    argv = ["ea", "--device", "cpu", "--sharded", "--islands", "4",
            "--epochs", "2", "--max-pop", "8", "--min-pop", "8",
            "--gens-per-epoch", "1", "--fused"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(harness.REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.evolve"] + argv,
        env=env, cwd=harness.REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evolve.main(argv + ["--shards", "2"])

    def lines(text):
        return [re.sub(r" \(\d+\.\ds\)", "", x)
                for x in text.splitlines()
                if x.startswith(("[sharded", "final"))]
    got = lines(proc.stdout)
    assert got == lines(buf.getvalue()) and len(got) == 2
