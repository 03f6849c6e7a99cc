"""The host tier's bridges against the reference's: ``run_experiment``
with ``HostBridge(PoolServer(capacity=256, seed=1), pull=4)`` or
``host_pool=`` under every generation impl and the ``always`` and
``elitist`` policies (mirrored on the server), the server killed for two
epochs; then ``AsyncHostBridge`` (exactly once, no echo, loss counted,
overflow drops counted, the cursor surviving a bridge restart) and
``run_experiment_async(host_bridge=)``.

On binary genomes everything must equal the reference bit for bit:
islands, pool, stats rows (``mean_best``, an f32 mean summed in another
order, to 1e-6 relative), the bridge's counts, the server's entries (seq,
uuid, fitness, genome bytes) and ``stats()``. The reference runs its
``jnp`` and ``pallas_ref`` impls; the port's ``pallas`` and
``pallas_tiled`` run their plain versions on the CPU and must give
``pallas_ref``'s bits, as the kernel family does in the reference. The
bridged F15 run is held to Queue C's F15 tolerances. AsyncHostBridge is
timed by its worker thread, so it is held to its ledger, not to bits.

Small size: 4 islands, trap 12x4, ``max_pop`` 16, ``min_pop`` 8, 3
generations per epoch, 5 epochs.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax
import numpy as np
import pytest
import torch

from repro.core import AcceptanceConfig as JAcceptanceConfig
from repro.core import EAConfig as JEAConfig
from repro.core import HostBridge as JHostBridge
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import PoolServer as JPoolServer
from repro.core import make_trap as j_trap
from repro.core import run_experiment as j_run_experiment
from repro_torch import convert
from repro_torch.core import (AcceptanceConfig, AsyncConfig, AsyncHostBridge,
                              EAConfig, HostBridge, MigrationConfig,
                              PoolServer, make_trap, run_experiment,
                              run_experiment_async)
from repro_torch.core import pool as pool_lib
from repro_torch.core.types import GenomeSpec

CFG = dict(max_pop=16, min_pop=8, generations_per_epoch=3)
N_ISLANDS, EPOCHS, SEED, DOWN = 4, 5, 3, (2, 3)
MEAN_RTOL = 1e-6
GEN = GenomeSpec("binary", 16)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        if name == "mean_best":
            np.testing.assert_allclose(g, np.asarray(w), rtol=MEAN_RTOL)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}.{name}")


def _killing(server):
    """server_up that also takes the host server down for DOWN epochs."""
    def up(epoch):
        alive = epoch not in DOWN
        server.revive() if alive else server.kill()
        return alive
    return up


def _entries(server):
    server.revive()
    entries, _, _ = server.get_since(-1, limit=10_000)
    return [(e.seq, e.uuid, e.fitness, e.genome.tobytes(),
             str(e.genome.dtype)) for e in entries], server.stats()


def _run(pkg, impl, policy, mode):
    """One bridged (``mode`` "bridge") or host-pool run of either
    package; returns its result, the bridge's counts and the server."""
    if pkg == "ref":
        acc = JAcceptanceConfig(policy=policy)
        server = JPoolServer(capacity=256, seed=1,
                             acceptance=None if policy == "always" else acc)
        bridge = JHostBridge(server, pull=4, acceptance=acc)
        res = j_run_experiment(
            j_trap(12, 4), JEAConfig(impl=impl, **CFG),
            JMigrationConfig(acceptance=acc), n_islands=N_ISLANDS,
            max_epochs=EPOCHS, rng=jax.random.key(SEED),
            server_up=_killing(server),
            **({"host_bridge": bridge} if mode == "bridge"
               else {"host_pool": server}))
    else:
        acc = AcceptanceConfig(policy=policy)
        server = PoolServer(capacity=256, seed=1,
                            acceptance=None if policy == "always" else acc)
        bridge = HostBridge(server, pull=4, acceptance=acc)
        res = run_experiment(
            make_trap(12, 4), EAConfig(impl=impl, **CFG),
            MigrationConfig(acceptance=acc), n_islands=N_ISLANDS,
            max_epochs=EPOCHS, rng=SEED, server_up=_killing(server),
            device="cpu",
            **({"host_bridge": bridge} if mode == "bridge"
               else {"host_pool": server}))
    return res, bridge.stats(), server


_REF = {}


def _ref(impl, policy, mode):
    family = "jnp" if impl == "jnp" else "pallas_ref"
    key = (family, policy, mode)
    if key not in _REF:
        res, stats, server = _run("ref", family, policy, mode)
        _REF[key] = (res, stats, _entries(server))
    return _REF[key]


@pytest.mark.parametrize("mode", ["bridge", "host_pool"])
@pytest.mark.parametrize("policy", ["always", "elitist"])
@pytest.mark.parametrize("impl", ["jnp", "pallas_ref", "pallas",
                                  "pallas_tiled"])
def test_bridged_run_matches_reference(impl, policy, mode):
    want, want_stats, want_server = _ref(impl, policy, mode)
    got, got_stats, server = _run("port", impl, policy, mode)
    for field in ("success", "epochs", "evaluations",
                  "evaluations_to_solution"):
        assert getattr(got, field) == getattr(want, field), field
    assert len(got.stats) == len(want.stats)
    for g, w in zip(got.stats, want.stats):
        _equal(g, _np(w), "stats row")
    islands = want.islands._replace(rng=jax.random.key_data(want.islands.rng))
    _equal(convert.to_numpy(got.islands), _np(islands), "islands")
    _equal(convert.to_numpy(got.pool), _np(want.pool), "pool")
    assert got_stats == want_stats
    if mode == "bridge":
        assert got_stats["lost"] > 0 and got_stats["pulled"] > 0
    assert _entries(server) == want_server


def test_bridged_f15_run_within_queue_c_tolerances():
    """The float path bridged: F15 at D 64, m 8, blend, sigma 0.3, the
    reference's constants; integer fields exact, genes 2e-6, fitness
    rtol 2e-4 atol 1e-3 (Queue C); the server holds as many entries."""
    from repro.core.problems import make_f15 as j_f15
    from repro_torch.core import make_f15
    jp = j_f15(jax.random.key(4), dim=64, group=8)
    consts = {k: np.asarray(v) for k, v in jp.consts.items()}
    cfg = dict(CFG, crossover="blend", mutation_sigma=0.3,
               impl="pallas_ref")
    jserver, server = JPoolServer(capacity=256, seed=1), PoolServer(
        capacity=256, seed=1)
    want = j_run_experiment(jp, JEAConfig(**cfg), JMigrationConfig(),
                            n_islands=N_ISLANDS, max_epochs=3,
                            rng=jax.random.key(SEED),
                            host_bridge=JHostBridge(jserver, pull=4))
    got = run_experiment(make_f15(consts, dim=64, group=8, device="cpu"),
                         EAConfig(**cfg), MigrationConfig(),
                         n_islands=N_ISLANDS, max_epochs=3, rng=SEED,
                         device="cpu", host_bridge=HostBridge(server, pull=4))
    gi, wi = convert.to_numpy(got.islands), _np(want.islands._replace(
        rng=jax.random.key_data(want.islands.rng)))
    for name, g, w in zip(wi._fields, gi, wi):
        if name in ("pop", "best_genome"):
            np.testing.assert_allclose(g, w, atol=2e-6, err_msg=name)
        elif np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-3,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert server.stats()["size"] == jserver.stats()["size"]
    assert server.stats()["puts"] == jserver.stats()["puts"] == 3


# ---------------------------------------------------------------------------
# AsyncHostBridge: the reference's tests of its ledger, on the port
# ---------------------------------------------------------------------------
def _pool(capacity, fits=()):
    pool = pool_lib.pool_init(capacity, GEN, device="cpu")
    if fits:
        pool = pool_lib.pool_put_batch(
            pool, torch.ones((len(fits), GEN.length), dtype=GEN.dtype),
            torch.tensor(fits, dtype=torch.float32))
    return pool


def test_exactly_once_delivery_under_async_firing():
    """Every volunteer entry reaches the device pool exactly once,
    however the syncs interleave with the PUTs."""
    server = PoolServer(capacity=256, seed=0)
    bridge = AsyncHostBridge(server, pull=16, uuid=-7)
    pool = _pool(128)
    vol_fits, rng, next_fit = [], np.random.default_rng(0), 1000.0
    for tick in range(1, 13):
        for _ in range(rng.integers(0, 3)):
            g = rng.integers(0, 2, GEN.length).astype(np.int8)
            server.put(g, next_fit, uuid=42)
            vol_fits.append(next_fit)
            next_fit += 1.0
        pool = bridge.sync(pool, tick)
    pool = bridge.flush(pool)
    bridge.close()
    fits = pool.fitness.numpy()
    for f in vol_fits:
        assert (fits == f).sum() == 1, f"entry {f} delivered != once"
    assert bridge.pulled == len(vol_fits)
    stats = bridge.stats()
    assert stats["pulled"] + stats["dropped"] == len(vol_fits)


def test_own_pushes_never_echo():
    server = PoolServer(capacity=64, seed=0)
    bridge = AsyncHostBridge(server, pull=16, uuid=-7)
    pool = _pool(32, [50.0])
    for tick in range(1, 6):
        pool = bridge.sync(pool, tick)
    pool = bridge.flush(pool)
    bridge.close()
    assert bridge.pushed >= 1
    assert bridge.pulled == 0
    assert (pool.fitness.numpy() == 50.0).sum() == 1


def test_server_loss_is_counted_not_raised():
    server = PoolServer(capacity=64, seed=0)
    server.kill()
    bridge = AsyncHostBridge(server, pull=4)
    pool = _pool(8, [1.0])
    before = pool.fitness.clone()
    pool = bridge.sync(pool, 1)
    pool = bridge.flush(pool)
    bridge.close()
    assert torch.equal(pool.fitness, before)
    assert bridge.lost >= 1


def test_overflow_drops_are_counted_in_bridge_stats():
    """A flood past a tiny server's capacity between syncs: the entries
    the cursor never saw are counted, pulled + dropped = the volunteer
    PUTs."""
    server = PoolServer(capacity=4, seed=0)
    bridge = AsyncHostBridge(server, pull=64, uuid=-7)
    pool = _pool(64)
    rng = np.random.default_rng(1)
    for i in range(24):
        server.put(rng.integers(0, 2, GEN.length).astype(np.int8),
                   1000.0 + i, uuid=42)
    pool = bridge.sync(pool, 1)
    pool = bridge.flush(pool)
    bridge.close()
    stats = bridge.stats()
    assert stats["dropped"] == 24 - 4 and stats["pulled"] == 4
    assert stats["dropped"] + stats["pulled"] == 24


def test_bridge_cursor_survives_bridge_restart(tmp_path):
    jp = str(tmp_path / "journal.jsonl")
    server = PoolServer(capacity=16, journal_path=jp)
    for i in range(5):
        server.put(np.full(GEN.length, 1, np.int8), float(i), uuid=7)
    pool = _pool(8)
    b1 = AsyncHostBridge(server, pull=64, cursor_id="pod")
    pool = b1.flush(b1.sync(pool))
    b1.close()
    assert b1.pulled == 5
    # a new bridge with no local position: the server-side cursor
    # prevents any re-delivery, also after the server's own restart
    server.close()
    server = PoolServer(capacity=16, journal_path=jp, resume=True)
    b2 = AsyncHostBridge(server, pull=64, cursor_id="pod")
    pool = b2.flush(b2.sync(pool))
    b2.close()
    assert b2.pulled == 0 and b2.dropped == 0
    server.close()


def test_async_host_loop_with_bridge_balances_its_ledger():
    """run_experiment_async with an AsyncHostBridge and a volunteer PUTting
    before each tick (through the server_up hook): every volunteer entry
    is pulled exactly once (none dropped: the server holds 256) and lands
    in the device pool (64 slots, not yet full), and the bridge's own
    pushes never come back. An island that absorbed one may PUT it into
    the device pool again as its best, so a value can sit there twice."""
    server = PoolServer(capacity=256, seed=1)
    bridge = AsyncHostBridge(server, pull=4, uuid=-1)
    rng = np.random.default_rng(2)
    puts = []

    def volunteer(tick):
        g = rng.integers(0, 2, 48).astype(np.int8)
        server.put(g, 1000.0 + tick, uuid=100)
        puts.append(1000.0 + tick)
        return True

    res = run_experiment_async(
        make_trap(12, 4), EAConfig(**CFG), MigrationConfig(),
        AsyncConfig(min_rate=0.5, max_rate=1.0, staleness=2), n_islands=4,
        max_ticks=6, rng=SEED, server_up=volunteer, stop_on_success=False,
        host_bridge=bridge, device="cpu")
    pool = bridge.flush(res.pool)
    bridge.close()
    stats = bridge.stats()
    assert stats["pulled"] == len(puts) == 6 and stats["dropped"] == 0
    assert stats["lost"] == 0 and stats["pushed"] >= 1
    assert np.isin(np.float32(puts), pool.fitness.numpy()).all()
