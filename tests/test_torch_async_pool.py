"""The port's host PoolServer (``repro_torch.core.async_pool``): the
reference's REST semantics, thread safety, failure injection,
overflow-drop detection, O(1) ring eviction and acceptance-policy
mirror, each case as the reference's tests hold it; then
``pool_insert_host`` against the reference's, the same server draws from
the same seed in both packages, and the outage demo of the reference's
``tests/test_fault.py`` against the reference.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert, rand
from repro_torch.core.async_pool import PoolClient, PoolServer, PoolUnavailable
from repro_torch.core.types import AcceptanceConfig


class TestPoolServer:
    def test_put_get_roundtrip(self):
        s = PoolServer()
        s.put(np.ones(4), 2.0, uuid=7)
        g, f = s.get_random()
        assert f == 2.0
        np.testing.assert_array_equal(g, np.ones(4))

    def test_get_empty_raises(self):
        s = PoolServer()
        with pytest.raises(PoolUnavailable):
            s.get_random()

    def test_best_tracking(self):
        s = PoolServer()
        s.put(np.zeros(2), 1.0)
        s.put(np.ones(2), 5.0)
        s.put(np.zeros(2), 3.0)
        _, f = s.get_best()
        assert f == 5.0

    def test_capacity_ring(self):
        s = PoolServer(capacity=3)
        for i in range(10):
            s.put(np.array([i]), float(i))
        assert s.stats()["size"] == 3

    def test_reset_bumps_experiment(self):
        s = PoolServer()
        s.put(np.zeros(2), 1.0)
        assert s.reset() == 1
        assert s.stats()["size"] == 0
        with pytest.raises(PoolUnavailable):
            s.get_random()

    def test_kill_revive(self):
        s = PoolServer()
        s.put(np.zeros(2), 1.0)
        s.kill()
        with pytest.raises(PoolUnavailable):
            s.put(np.zeros(2), 2.0)
        with pytest.raises(PoolUnavailable):
            s.get_random()
        s.revive()
        g, f = s.get_random()
        assert f == 1.0  # state survived the outage

    def test_journal(self, tmp_path):
        path = tmp_path / "journal.jsonl"
        s = PoolServer(journal_path=str(path))
        s.put(np.zeros(2), 1.0, uuid=3)
        s.get_random()
        s.reset()
        s.close()
        lines = path.read_text().strip().splitlines()
        assert len(lines) == 3

    def test_thread_safety(self):
        s = PoolServer(capacity=128)
        errors = []

        def worker(uid):
            try:
                for i in range(200):
                    s.put(np.array([uid, i]), float(i), uuid=uid)
                    s.get_random()
            except PoolUnavailable:
                pass
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(u,)) for u in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        st = s.stats()
        assert st["puts"] == 8 * 200
        assert st["size"] == 128


class TestGetSinceOverflow:
    def test_eviction_gap_is_detected_and_counted(self):
        """Capacity overflow between drains: the evicted seqs are reported
        as dropped, not silently skipped (exactly-once -> *detected*
        at-most-once)."""
        s = PoolServer(capacity=3)
        for i in range(10):
            s.put(np.array([i]), float(i))
        fresh, cur, dropped = s.get_since(-1, limit=64)
        assert dropped == 7                     # seqs 0..6 evicted unseen
        assert [e.seq for e in fresh] == [7, 8, 9]
        assert cur == 9
        # the gap is charged exactly once
        fresh, cur, dropped = s.get_since(cur, limit=64)
        assert fresh == [] and dropped == 0 and cur == 9

    def test_cursor_advances_past_gap_even_when_empty(self):
        s = PoolServer(capacity=2)
        for i in range(6):
            s.put(np.array([i]), float(i))
        # consumer saw nothing; everything resident is beyond the gap
        _, cur, dropped = s.get_since(-1, limit=64)
        assert dropped == 4 and cur == 5
        s.reset()                               # clears residents
        fresh, cur, dropped = s.get_since(cur, limit=64)
        assert fresh == [] and dropped == 0
        s.put(np.array([9]), 9.0)
        fresh, cur2, dropped = s.get_since(cur, limit=64)
        assert [e.seq for e in fresh] == [6] and dropped == 0

    def test_reset_gap_counts_as_dropped(self):
        s = PoolServer(capacity=8)
        for i in range(3):
            s.put(np.array([i]), float(i))
        s.reset()
        _, cur, dropped = s.get_since(-1, limit=64)
        assert dropped == 3 and cur == 2        # cleared before the drain

    def test_limit_truncation_never_skips_seqs(self):
        s = PoolServer(capacity=8)
        for i in range(6):
            s.put(np.array([i]), float(i))
        seen = []
        cur = -1
        for _ in range(4):
            fresh, cur, dropped = s.get_since(cur, limit=2)
            assert dropped == 0
            seen += [e.seq for e in fresh]
        assert seen == [0, 1, 2, 3, 4, 5]

    def test_partial_overlap_of_gap_and_cursor(self):
        """Entries the consumer already saw don't count as dropped when
        they are later evicted."""
        s = PoolServer(capacity=4)
        for i in range(4):
            s.put(np.array([i]), float(i))
        _, cur, dropped = s.get_since(-1, limit=64)
        assert cur == 3 and dropped == 0
        for i in range(4, 10):                  # evicts 0..5; 2,3 were seen
            s.put(np.array([i]), float(i))
        fresh, cur, dropped = s.get_since(cur, limit=64)
        assert dropped == 2                     # only unseen 4, 5
        assert [e.seq for e in fresh] == [6, 7, 8, 9]


class TestEviction:
    def test_ring_preserves_insertion_order(self):
        s = PoolServer(capacity=3)
        for i in range(7):
            s.put(np.array([i]), float(i))
        assert [e.seq for e in s._entries] == [4, 5, 6]
        assert s.stats()["size"] == 3

    def test_put_flood_is_linear_not_quadratic(self):
        """deque(maxlen) eviction: a 20k-put flood at full capacity stays
        fast (the old list.pop(0) path was O(capacity) per PUT)."""
        import time
        s = PoolServer(capacity=4096)
        g = np.zeros(16, np.int8)
        for i in range(4096):
            s.put(g, float(i))
        t0 = time.perf_counter()
        for i in range(20_000):
            s.put(g, float(i))
        dt = time.perf_counter() - t0
        assert s.stats()["size"] == 4096
        assert dt < 5.0                         # generous CI headroom


class TestAcceptanceMirror:
    def test_elitist_keeps_best_and_counts_rejections(self):
        s = PoolServer(capacity=2,
                       acceptance=AcceptanceConfig(policy="elitist"))
        s.put(np.zeros(4, np.int8), 5.0)
        s.put(np.ones(4, np.int8), 6.0)
        s.put(np.ones(4, np.int8), 1.0)          # full, worse -> rejected
        s.put(np.ones(4, np.int8), 9.0)          # replaces the 5.0
        st = s.stats()
        assert st["size"] == 2 and st["rejected"] == 1
        assert sorted(e.fitness for e in s._entries) == [6.0, 9.0]

    def test_dedup_rejects_clones_even_when_not_full(self):
        acc = AcceptanceConfig(policy="dedup", epsilon=0.0)
        s = PoolServer(capacity=8, acceptance=acc)
        g = np.array([1, 0, 1, 0], np.int8)
        s.put(g, 5.0)
        s.put(g.copy(), 9.0)                     # exact clone -> rejected
        assert s.stats()["size"] == 1
        assert s.stats()["rejected"] == 1
        s.put(np.array([1, 0, 1, 1], np.int8), 9.0)
        assert s.stats()["size"] == 2

    def test_replacement_drop_is_visible_to_get_since(self):
        """An entry replaced by the acceptance policy before the consumer
        drained it counts as dropped."""
        s = PoolServer(capacity=1,
                       acceptance=AcceptanceConfig(policy="elitist"))
        s.put(np.zeros(2, np.int8), 1.0)         # seq 0
        s.put(np.ones(2, np.int8), 2.0)          # seq 1 replaces seq 0
        fresh, cur, dropped = s.get_since(-1, limit=8)
        assert dropped == 1 and [e.seq for e in fresh] == [1]

    def test_mid_ring_replacement_drop_is_detected(self):
        """A replaced victim that is *not* the oldest resident leaves a
        hole between surviving seqs — it must still be counted."""
        s = PoolServer(capacity=2,
                       acceptance=AcceptanceConfig(policy="elitist"))
        s.put(np.zeros(2, np.int8), 5.0)         # seq 0
        s.put(np.ones(2, np.int8), 1.0)          # seq 1 (now full)
        s.put(np.ones(2, np.int8), 3.0)          # seq 2 replaces seq 1
        fresh, cur, dropped = s.get_since(-1, limit=8)
        assert [e.seq for e in fresh] == [0, 2]
        assert cur == 2 and dropped == 1         # seq 1 vanished mid-ring
        _, _, dropped = s.get_since(cur, limit=8)
        assert dropped == 0                      # charged exactly once

    def test_unmirrored_policy_rejected_at_construction(self):
        """A device-only custom policy must fail fast, not KeyError on the
        first PUT mid-run."""
        with pytest.raises(ValueError, match="no host mirror"):
            PoolServer(acceptance=AcceptanceConfig(policy="my_custom"))


class TestKillReviveRace:
    def test_single_locked_liveness_check(self):
        """kill()/revive() racing a request hammer must never produce
        anything but a clean result or PoolUnavailable — the TOCTOU pair
        (unlocked pre-check + locked check) is gone, so there is exactly
        one consistent liveness decision per verb."""
        s = PoolServer(capacity=64)
        s.put(np.zeros(2, np.int8), 1.0)
        errors = []
        stop = threading.Event()

        def toggler():
            while not stop.is_set():
                s.kill()
                s.revive()

        def hammer(uid):
            for i in range(500):
                try:
                    s.put(np.array([uid, i], np.int32), float(i), uuid=uid)
                    s.get_random()
                    s.get_since(-1, limit=2)
                    s.get_best()
                except PoolUnavailable:
                    pass
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        t = threading.Thread(target=toggler)
        workers = [threading.Thread(target=hammer, args=(u,))
                   for u in range(4)]
        t.start()
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        stop.set()
        t.join()
        assert not errors


class TestPoolClient:
    def test_client_swallows_failures(self):
        s = PoolServer()
        c = PoolClient(s, uuid=1)
        s.kill()
        assert c.put(np.zeros(2), 1.0) is False
        assert c.get_random() is None
        assert c.lost_puts == 1 and c.lost_gets == 1
        s.revive()
        assert c.put(np.zeros(2), 1.0) is True
        got = c.get_random()
        assert got is not None and got[1] == 1.0


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def test_same_seed_draws_the_references_entries():
    """random.Random(seed) draws: the same PUTs then GETs give the same
    genomes in both packages, and the same stats."""
    from repro.core.async_pool import PoolServer as JPoolServer
    a, b = PoolServer(capacity=8, seed=11), JPoolServer(capacity=8, seed=11)
    g = np.random.default_rng(0)
    for i in range(13):
        genome, fit = g.integers(0, 2, 5).astype(np.int8), float(i % 4)
        a.put(genome, fit, uuid=i)
        b.put(genome, fit, uuid=i)
    for _ in range(20):
        (ga, fa), (gb, fb) = a.get_random(), b.get_random()
        np.testing.assert_array_equal(ga, gb)
        assert fa == fb
    assert a.get_random_entry().seq == b.get_random_entry().seq
    assert a.stats() == b.stats()


@pytest.mark.parametrize("policy", ["always", "elitist", "crowding",
                                    "dedup"])
def test_pool_insert_host_matches_reference(policy):
    """Host genomes into a device pool through each policy: the stack cast
    to the pool's dtype, the fitness to f32, the key of HostBridge's
    pulls (fold_in(key(17), epoch))."""
    from repro.core import pool as j_pool
    from repro.core.types import AcceptanceConfig as JAcceptanceConfig
    from repro.core.types import GenomeSpec as JGenomeSpec
    from repro_torch.core import pool as t_pool
    from repro_torch.core.types import GenomeSpec
    with jax.threefry_partitionable(True):
        g = np.random.default_rng(4)
        jpool = j_pool.pool_init(6, JGenomeSpec("binary", 10))
        tpool = t_pool.pool_init(6, GenomeSpec("binary", 10), device="cpu")
        for epoch in range(1, 5):
            genomes = [g.integers(0, 2, 10).astype(np.int64)
                       for _ in range(3)]
            fits = [float(x) for x in g.integers(0, 10, 3)]
            jpool = j_pool.pool_insert_host(
                jpool, genomes, fits,
                acc=JAcceptanceConfig(policy=policy, epsilon=1.0),
                rng=jax.random.fold_in(jax.random.key(17), epoch))
            tpool = t_pool.pool_insert_host(
                tpool, genomes, fits,
                acc=AcceptanceConfig(policy=policy, epsilon=1.0),
                rng=rand.fold_in(rand.key(17, device="cpu"), epoch))
        assert tpool.genomes.dtype == torch.int8
        for a, b in zip(convert.to_numpy(tpool), jpool):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_outage_and_recovery_matches_reference():
    """The reference's tests/test_fault.py outage demo: the server is down
    for epochs 3-5, the islands improve meanwhile, the pool is frozen and
    fills again after; each epoch's best and pool size equal the
    reference's."""
    from repro.core import EAConfig as JEAConfig
    from repro.core import MigrationConfig as JMigrationConfig
    from repro.core import evolution as j_evolution
    from repro.core import island as j_island
    from repro.core import make_trap as j_make_trap
    from repro.core import pool as j_pool
    from repro_torch.core import EAConfig, MigrationConfig, evolution
    from repro_torch.core import island as t_island
    from repro_torch.core import make_trap
    from repro_torch.core import pool as t_pool
    from repro_torch.runtime import FailureInjector
    cfg = dict(max_pop=32, min_pop=16, generations_per_epoch=10,
               mutation_rate=0.03)
    runs = []
    with jax.threefry_partitionable(True):
        for pkg in ("port", "ref"):
            inj = FailureInjector([("server", e) for e in (3, 4, 5)])
            if pkg == "port":
                problem, c, m = make_trap(n_traps=12, l=4), EAConfig(**cfg), \
                    MigrationConfig(pool_capacity=16)
                islands = t_island.init_islands(rand.key(0, device="cpu"), 4,
                                                problem, c, device="cpu")
                pool = t_pool.pool_init(16, problem.genome, device="cpu")
                rng, step = rand.key(1, device="cpu"), evolution.epoch_step
            else:
                problem, c, m = j_make_trap(n_traps=12, l=4), \
                    JEAConfig(**cfg), JMigrationConfig(pool_capacity=16)
                islands = j_island.init_islands(jax.random.key(0), 4,
                                                problem, c)
                pool = j_pool.pool_init(16, problem.genome)
                rng, step = jax.random.key(1), j_evolution.epoch_step
            bests, sizes = [], []
            for e in range(1, 9):
                if pkg == "port":
                    rng, k = rand.split(rng, 2)
                else:
                    rng, k = jax.random.split(rng)
                up = not inj.fires("server", e)
                islands, pool = step(islands, pool, k, problem, c, m, False,
                                     up)
                bests.append(float(islands.best_fitness.max()))
                sizes.append(int(pool.count))
            runs.append((bests, sizes, inj.fired))
    bests, sizes, fired = runs[0]
    assert runs[0] == runs[1]
    assert sizes[2] == sizes[1] == sizes[3]
    assert bests[4] >= bests[1] and sizes[-1] >= sizes[2]
    assert fired == [("server", 3), ("server", 4), ("server", 5)]


def test_volunteer_demo_prints_the_references_lines(capsys, monkeypatch):
    """``python -m repro_torch.launch.volunteer_sim``'s sync demo (server
    killed at epoch 3, revived at 6, joins, leaves, the straggler demo)
    prints the lines of the reference's ``examples/volunteer_sim.py``."""
    import os
    import runpy
    import sys
    from repro_torch.launch import volunteer_sim
    volunteer_sim.main(["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    example = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "volunteer_sim.py")
    monkeypatch.setattr(sys, "argv", [example])
    with jax.threefry_partitionable(True):
        runpy.run_path(example, run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    assert port == ref
    assert any(line.startswith("epoch  3 [server DOWN]") for line in port)
    assert port[-1].startswith("  worker 3: work_scale=0.28")
