"""Every migration topology x acceptance policy through both drivers.

This file runs the pairs of the ``always`` and ``elitist`` policies,
``tests/test_torch_engine_distance.py`` those of the distance policies
(``crowding``, ``dedup``) through :func:`check_pair`. For each pair,
``run_fused(..., return_stats=True, return_obs=True)`` under the default
classic impl runs from the same seed
in the reference and in the port (4 islands, trap 8x4, ``max_pop`` 32,
``min_pop`` 16, 4 generations per epoch, 3 epochs, W²): the islands, the
pool, the epoch count, the stats rows (``mean_best`` within 1e-6
relative, an f32 mean summed in another order) and the harvested ledger
must be equal, and the ledger must balance. The port's host loop
``run_experiment`` from the same seed must reach the fused driver's
state and stats, since both walk the same keys.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import jax
import numpy as np
import pytest

from repro.core import AcceptanceConfig as JAcceptanceConfig
from repro.core import EAConfig as JEAConfig
from repro.core import MigrationConfig as JMigrationConfig
from repro.core import make_trap as j_trap
from repro.core import run_fused as j_run_fused
from repro_torch import convert
from repro_torch.core import (AcceptanceConfig, EAConfig, MigrationConfig,
                              make_trap, run_experiment, run_fused)

TOPOLOGIES = ("pool", "ring", "torus", "random_graph", "broadcast_best")
CFG = dict(max_pop=32, min_pop=16, generations_per_epoch=4)
N_ISLANDS, MAX_EPOCHS, SEED = 4, 3, 5
MEAN_RTOL = 1e-6
J_PROBLEM = j_trap(8, 4)


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


def _equal(got, want, what):
    for name, g, w in zip(want._fields, got, want):
        if name == "mean_best":
            np.testing.assert_allclose(g, w, rtol=MEAN_RTOL)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{what}.{name}")


def check_pair(topology, policy):
    acc = dict(policy=policy, epsilon=1.0 if policy == "dedup" else 0.0)
    want = j_run_fused(
        J_PROBLEM, JEAConfig(**CFG),
        JMigrationConfig(topology=topology,
                         acceptance=JAcceptanceConfig(**acc)),
        n_islands=N_ISLANDS, max_epochs=MAX_EPOCHS, rng=jax.random.key(SEED),
        w2=True, return_stats=True, return_obs=True)
    problem = make_trap(8, 4)
    mig = MigrationConfig(topology=topology,
                          acceptance=AcceptanceConfig(**acc))
    isl, pool, ep, stats, obs = run_fused(
        problem, EAConfig(**CFG), mig, n_islands=N_ISLANDS,
        max_epochs=MAX_EPOCHS, rng=SEED, w2=True, return_stats=True,
        return_obs=True, device="cpu")
    j_isl = want[0]._replace(rng=jax.random.key_data(want[0].rng))
    _equal(convert.to_numpy(isl), jax.tree.map(np.asarray, j_isl), "islands")
    _equal(convert.to_numpy(pool), jax.tree.map(np.asarray, want[1]), "pool")
    assert int(ep) == int(want[2])
    _equal(convert.to_numpy(stats), jax.tree.map(np.asarray, want[3]),
           "stats")
    assert obs == want[4]
    t = obs["totals"]
    assert t["fired"] == N_ISLANDS * MAX_EPOCHS
    assert t["delivered"] == t["accepted"] + t["rejected"]

    res = run_experiment(problem, EAConfig(**CFG), mig, n_islands=N_ISLANDS,
                         max_epochs=MAX_EPOCHS, rng=SEED, w2=True,
                         device="cpu")
    _equal(convert.to_numpy(res.islands), convert.to_numpy(isl),
           "run_experiment islands")
    _equal(convert.to_numpy(res.pool), convert.to_numpy(pool),
           "run_experiment pool")
    for row, st in enumerate(res.stats):
        _equal(st, convert.to_numpy(stats._replace(
            **{f: getattr(stats, f)[row] for f in stats._fields})),
            f"run_experiment stats row {row}")


@pytest.mark.parametrize("policy", ["always", "elitist"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_drivers_match_reference(topology, policy):
    check_pair(topology, policy)
