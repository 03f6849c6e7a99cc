"""The asynchronous runtime's heterogeneous parity matrix under the
distance policies (``crowding``, ``dedup`` at epsilon 1), every topology
and every generation impl; ``tests/test_torch_async.py`` holds the case
(its ``check_hetero``) and the ``always`` and ``elitist`` pairs."""
import jax
import pytest

from test_torch_async import IMPLS, TOPOLOGIES, check_hetero


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("policy", ["crowding", "dedup"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_hetero_run_matches_reference(topology, policy, impl):
    check_hetero(topology, policy, impl)
