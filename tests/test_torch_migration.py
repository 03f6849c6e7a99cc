"""Migration and acceptance (``repro_torch.core.migration``, ``.acceptance``)
against the reference's ``repro.core.migration`` and ``.acceptance``.

Every topology x acceptance policy pair goes through ``migrate(...,
with_ledger=True)`` on the same seeded inputs (binary genomes, a pool
partly filled, bests with ties), and the pool, the immigrants and both
ledger masks must equal the reference's bit for bit, under the sync
drivers' scalar gate and under the async runtime's per-island fire mask
(a vector ``available``); so must the dead server, the empty pool, the torus on odd and even epochs and on a prime
island count, ``gate_immigrants``, ``apply_policy`` (dedup at epsilon 0
and above it, more candidates than slots) and the numpy mirror
``host_accept``.

On float genomes the L2 distances of crowding and dedup are held to rtol
2.4e-7 (the sum of squares is ordered differently by XLA and PyTorch);
the policies' decisions on the seeded float inputs are exact.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acceptance as j_acc
from repro.core import migration as j_mig
from repro.core.types import AcceptanceConfig as JAcceptanceConfig
from repro.core.types import MigrationConfig as JMigrationConfig
from repro.core.types import PoolState as JPoolState
from repro_torch import convert
from repro_torch.core import acceptance, migration
from repro_torch.core.types import AcceptanceConfig, MigrationConfig
from repro_torch.core.types import PoolState

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")
POLICIES = ("always", "elitist", "crowding", "dedup")
N_ISL, L, CAP = 6, 24, 8
DIST_RTOL = 2.4e-7


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


def _inputs(seed, n=N_ISL, filled=5, kind="binary"):
    """Pool residents in ``filled`` of CAP slots, bests of n islands (two
    tied), key words."""
    g = np.random.default_rng(seed)
    if kind == "binary":
        def genomes(*s):
            return g.integers(0, 2, s).astype(np.int8)
    else:
        def genomes(*s):
            return g.uniform(-5, 5, s).astype(np.float32)
    pool_g = genomes(CAP, L)
    pool_f = np.full(CAP, -np.inf, np.float32)
    pool_f[:filled] = g.integers(0, 8, filled).astype(np.float32)
    pool_g[filled:] = 0
    best_g = genomes(n, L)
    best_f = g.integers(0, 10, n).astype(np.float32)
    best_f[1] = best_f[0]
    if filled:
        best_g[2] = pool_g[0]                 # a clone of a resident
    words = g.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    pool = (pool_g, pool_f, np.int32(filled % CAP), np.int32(filled))
    return pool, best_g, best_f, words


def _jpool(pool):
    return JPoolState(*(jnp.asarray(a) for a in pool))


def _tpool(pool):
    return PoolState(*(torch.from_numpy(np.array(a)) for a in pool))


def _check(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g = convert.to_numpy(g)
        if isinstance(w, tuple):
            _check(g, w, f"{what}[{i}]")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}[{i}]")


def _both(topo, policy, pool, best_g, best_f, words, *, eps=0.0, epoch=3,
          available=True):
    jm = JMigrationConfig(topology=topo, acceptance=JAcceptanceConfig(
        policy=policy, epsilon=eps))
    tm = MigrationConfig(topology=topo, acceptance=AcceptanceConfig(
        policy=policy, epsilon=eps))
    want = j_mig.migrate(_jpool(pool), jnp.asarray(best_g),
                         jnp.asarray(best_f),
                         jax.random.wrap_key_data(jnp.asarray(words)), jm,
                         epoch=epoch, available=available, with_ledger=True)
    got = migration.migrate(_tpool(pool), torch.from_numpy(best_g),
                            torch.from_numpy(best_f),
                            torch.from_numpy(words.astype(np.int64)), tm,
                            epoch=epoch, available=available,
                            with_ledger=True)
    return got, want


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_migrate_matches_reference(topo, policy):
    args = _inputs(TOPOLOGIES.index(topo) * 10 + POLICIES.index(policy))
    got, want = _both(topo, policy, *args)
    _check(got[0], want[0], "pool")
    _check(got[1:], want[1:], "immigrants and ledger")
    delivered, accepted = got[3], got[4]
    assert bool((accepted <= delivered).all())


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_fire_mask_matches_reference(topo, policy):
    """A vector ``available`` (the async runtime's fire mask): the pool
    takes only the firing islands' PUTs and answers only their GETs; the
    other topologies mask the silent *sources* and deliver unmasked."""
    args = _inputs(50 + TOPOLOGIES.index(topo) * 4 + POLICIES.index(policy))
    mask = np.array([True, False, False, True, True, False])
    got, want = _both(topo, policy, *args, eps=1.0 if policy == "dedup"
                      else 0.0, available=mask)
    _check(got[0], want[0], "pool")
    _check(got[1:], want[1:], "immigrants and ledger")
    if topo == "pool":
        assert not bool(torch.isfinite(got[2][~torch.from_numpy(mask)]).any())
    # nobody fires: the pool is untouched and nothing is delivered
    none = np.zeros(N_ISL, dtype=bool)
    got, want = _both(topo, policy, *args, available=none)
    _check(got, want, "no island fires")
    _check(got[0], args[0], "pool unchanged")
    assert not bool(got[3].any())


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_dead_server_is_a_no_op(topo):
    pool, best_g, best_f, words = _inputs(40)
    got, want = _both(topo, "elitist", pool, best_g, best_f, words,
                      available=False)
    _check(got, want, "dead server")
    _check(got[0], pool, "pool unchanged")
    assert bool(torch.isinf(got[2]).all()) and not bool(got[3].any())


@pytest.mark.parametrize("policy", POLICIES)
def test_empty_pool(policy):
    pool, best_g, best_f, words = _inputs(41, filled=0)
    got, want = _both("pool", policy, pool, best_g, best_f, words)
    _check(got, want, "empty pool")
    assert int(got[0].count) == min(N_ISL, CAP)


@pytest.mark.parametrize("n", [6, 9, 5])
@pytest.mark.parametrize("epoch", [2, 3])
def test_torus_alternates_on_epoch_parity(n, epoch):
    pool, best_g, best_f, words = _inputs(42 + n, n=n)
    got, want = _both("torus", "always", pool, best_g, best_f, words,
                      epoch=epoch)
    _check(got, want, "torus")
    rows = {6: 2, 9: 3, 5: 1}[n]
    cols = n // rows
    src = np.arange(n).reshape(rows, cols)
    src = np.roll(src, 1, axis=1 if (epoch % 2 == 0 or rows == 1) else 0)
    np.testing.assert_array_equal(got[2].numpy(), best_f[src.reshape(-1)])
    # an epoch held as a tensor, as the fused driver passes it
    tm = MigrationConfig(topology="torus")
    again = migration.migrate(_tpool(pool), torch.from_numpy(best_g),
                              torch.from_numpy(best_f),
                              torch.from_numpy(words.astype(np.int64)), tm,
                              epoch=torch.tensor(epoch, dtype=torch.int32))
    assert torch.equal(again[2], got[2])


@pytest.mark.parametrize("eps", [0.0, 3.0])
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_dedup_at_and_above_epsilon_zero(eps, kind):
    pool, best_g, best_f, words = _inputs(50, kind=kind)
    best_g[4] = best_g[3]                         # two clones in one batch
    if kind == "float":
        best_g[5] = best_g[3] + 0.2               # within eps 3 in L2
    got, want = _both("pool", "dedup", pool, best_g, best_f, words, eps=eps)
    _check(got, want, f"dedup eps {eps}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_apply_policy_more_candidates_than_slots(policy, kind):
    pool, _, _, words = _inputs(60, kind=kind)
    _, best_g, best_f, _ = _inputs(61, n=CAP + 5, kind=kind)
    valid = np.ones(CAP + 5, bool)
    valid[[1, 7]] = False
    jc = JAcceptanceConfig(policy=policy)
    want = j_acc.apply_policy(_jpool(pool), jnp.asarray(best_g),
                              jnp.asarray(best_f), jnp.asarray(valid),
                              jax.random.wrap_key_data(jnp.asarray(words)),
                              jc)
    got = acceptance.apply_policy(
        _tpool(pool), torch.from_numpy(best_g), torch.from_numpy(best_f),
        torch.from_numpy(valid), torch.from_numpy(words.astype(np.int64)),
        AcceptanceConfig(policy=policy))
    _check(got, want, f"apply {policy}")
    # no key: key(0), as the reference
    want0 = j_acc.apply_policy(_jpool(pool), jnp.asarray(best_g),
                               jnp.asarray(best_f), None, None, jc)
    got0 = acceptance.apply_policy(_tpool(pool), torch.from_numpy(best_g),
                                   torch.from_numpy(best_f), None, None,
                                   AcceptanceConfig(policy=policy))
    _check(got0, want0, f"apply {policy} without key")


@pytest.mark.parametrize("policy", ["elitist", "crowding", "dedup"])
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_gate_immigrants_matches_reference(policy, kind):
    _, dest_g, dest_f, words = _inputs(70, kind=kind)
    _, imm_g, imm_f, _ = _inputs(71, kind=kind)
    imm_g[0] = dest_g[0]                       # an exact clone
    imm_f[0] = dest_f[0] + 1
    imm_f[3] = -np.inf                         # no delivery
    acc_kw = dict(policy=policy, epsilon=1.0)
    want = j_acc.gate_immigrants(
        jnp.asarray(dest_g), jnp.asarray(dest_f), jnp.asarray(imm_g),
        jnp.asarray(imm_f), jax.random.wrap_key_data(jnp.asarray(words)),
        JAcceptanceConfig(**acc_kw))
    got = acceptance.gate_immigrants(
        torch.from_numpy(dest_g), torch.from_numpy(dest_f),
        torch.from_numpy(imm_g), torch.from_numpy(imm_f),
        torch.from_numpy(words.astype(np.int64)), AcceptanceConfig(**acc_kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_distances_within_rtol():
    g = np.random.default_rng(80)
    res = g.uniform(-5, 5, (CAP, 1000)).astype(np.float32)
    cand = g.uniform(-5, 5, (N_ISL, 1000)).astype(np.float32)
    cfg = dict(policy="crowding")
    want = np.asarray(j_acc._distances(jnp.asarray(res), jnp.asarray(cand),
                                       JAcceptanceConfig(**cfg)))
    got = acceptance._distances(torch.from_numpy(res), torch.from_numpy(cand),
                                AcceptanceConfig(**cfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=DIST_RTOL)
    ham = acceptance._distances(torch.from_numpy(res > 0),
                                torch.from_numpy(cand > 0),
                                AcceptanceConfig(metric="hamming")).numpy()
    np.testing.assert_array_equal(ham, np.asarray(j_acc._distances(
        jnp.asarray(res > 0), jnp.asarray(cand > 0),
        JAcceptanceConfig(metric="hamming"))))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_host_accept_mirrors_reference(policy, kind):
    g = np.random.default_rng(90)
    cfg = dict(policy=policy, epsilon=2.0 if kind == "binary" else 7.0)
    res_g, res_f = [], []
    for step in range(40):
        cand = (g.integers(0, 2, 12).astype(np.int8) if kind == "binary"
                else g.uniform(-2, 2, 12).astype(np.float32))
        fit = float(g.integers(0, 20))
        rg = np.array(res_g) if res_g else None
        args = (rg, np.array(res_f, np.float32), cand, fit)
        want = j_acc.host_accept(*args, JAcceptanceConfig(**cfg), 10)
        got = acceptance.host_accept(*args, AcceptanceConfig(**cfg), 10)
        assert got == want, (step, got, want)
        if got == acceptance.APPEND:
            res_g.append(cand)
            res_f.append(fit)
        elif got is not None:
            res_g[got], res_f[got] = cand, fit


def test_registries_and_what_still_raises():
    assert migration.available_topologies() == tuple(sorted(TOPOLOGIES))
    assert acceptance.available_policies() == tuple(sorted(POLICIES))
    pool, best_g, best_f, words = _inputs(95)
    args = (_tpool(pool), torch.from_numpy(best_g), torch.from_numpy(best_f),
            torch.from_numpy(words.astype(np.int64)))

    @migration.register_topology("test_self")
    def self_topology(pool, g, f, rng, *, mig, axis=None, epoch=0,
                      available=True):
        return pool, g, f

    @acceptance.register_policy("test_none")
    def none_policy(pool_g, pool_f, cand_g, cand_f, valid, rng, *, ptr,
                    count, acc):
        return torch.full_like(cand_f, pool_f.shape[0], dtype=torch.int32), \
            ptr, count

    try:
        out = migration.migrate(*args, MigrationConfig(
            topology="test_self", acceptance=AcceptanceConfig(
                policy="test_none")), with_ledger=True)
        assert bool(out[3].all()) and not bool(out[4].any())
    finally:
        migration.TOPOLOGIES.pop("test_self")
        acceptance.ACCEPTANCE_POLICIES.pop("test_none")
    with pytest.raises(KeyError):
        migration.get_topology("no_such_topology")
    # a per-island fire mask (the async runtime's vector ``available``)
    # runs, as the reference's does
    mask = np.array([True, False, True, True, False, True])
    got, want = _both("ring", "always", pool, best_g, best_f, words,
                      available=mask)
    _check(got, want, "ring under a fire mask")
    # the SPMD context runs: every topology on one gloo rank equals the
    # reference's shard_map over a mesh of this process's one device
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro_torch.core import sharded
    import _torch_sharded_ranks as ranks
    got = sharded.spawn(ranks.migrate_every_topology, 1, "gloo", "cpu",
                        timeout=60, args=(pool, best_g, best_f, words, 3,
                                          "elitist"), threads=1)[0]
    mesh = Mesh(np.array(jax.devices()[:1]), ("islands",))
    for topo in TOPOLOGIES:
        jm = JMigrationConfig(topology=topo, acceptance=JAcceptanceConfig(
            policy="elitist"))
        fn = jax.jit(shard_map(
            lambda p, g, f, k, jm=jm: j_mig.migrate(
                p, g, f, k, jm, axis="islands", epoch=3, with_ledger=True),
            mesh=mesh, in_specs=(JPoolState(*[P()] * 4), P("islands"),
                                 P("islands"), P()),
            out_specs=(JPoolState(*[P()] * 4),) + (P("islands"),) * 4,
            check=False))
        want = fn(_jpool(pool), jnp.asarray(best_g), jnp.asarray(best_f),
                  jax.random.wrap_key_data(jnp.asarray(words)))
        _check(got[topo], want, f"{topo} on one rank")


def test_pool_put_hands_its_key_to_the_policy():
    """The pool's PUT passes ``fold_in(rng, 0xACC)`` to the policy, as the
    reference's does, and the receive gate ``fold_in(rng, 0x5EED)`` split
    per island: a policy that reads its key sees the same words in both
    packages. (The built-in policies ignore their key.)"""
    def j_keyed(pool_g, pool_f, cand_g, cand_f, valid, rng, *, ptr, count,
                acc):
        cap, k = pool_f.shape[0], cand_f.shape[0]
        pick = jax.random.randint(rng, (), 0, cap)
        first = (jnp.arange(k) == 0) & valid
        return jnp.where(first, pick, cap).astype(jnp.int32), ptr, count

    def t_keyed(pool_g, pool_f, cand_g, cand_f, valid, rng, *, ptr, count,
                acc):
        from repro_torch import rand
        cap, k = pool_f.shape[0], cand_f.shape[0]
        pick = rand.keyed_randint(rng, (), 0, cap)
        first = (torch.arange(k) == 0) & valid
        return torch.where(first, pick, cap).to(torch.int32), ptr, count

    j_acc.register_policy("test_keyed")(j_keyed)
    acceptance.register_policy("test_keyed")(t_keyed)
    try:
        for seed in (96, 97, 98):
            got, want = _both("pool", "test_keyed", *_inputs(seed))
            _check(got, want, f"keyed policy, seed {seed}")
    finally:
        j_acc.ACCEPTANCE_POLICIES.pop("test_keyed")
        acceptance.ACCEPTANCE_POLICIES.pop("test_keyed")
