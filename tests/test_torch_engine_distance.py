"""Every migration topology under the distance policies (``crowding``,
``dedup`` at epsilon 1) through both drivers, held as
``tests/test_torch_engine.py`` holds the other pairs (its
:func:`check_pair`)."""
import jax
import pytest

from test_torch_engine import TOPOLOGIES, check_pair


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("policy", ["crowding", "dedup"])
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_distance_policies_match_reference(topology, policy):
    check_pair(topology, policy)
