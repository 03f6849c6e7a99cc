"""The fused sharded driver (``repro_torch.core.sharded.run_fused_sharded``)
on 4 gloo ranks on the CPU against the reference's ``run_fused_sharded``
on 4 fake devices, bit for bit with the stats and the counters: every
topology under ``always`` and under ``elitist``
(``tests/test_torch_sharded_fused.py`` holds 2 ranks and says what is
checked). At 4 ranks the stats' mean is a float reduction of more than
two terms: the port sums the ranks' means in rank order, and so, on these
inputs, does the reference's ``psum``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import pytest

pytest.importorskip("torch")

import _sharded_harness as harness  # noqa: E402
from test_torch_sharded_fused import check, fused_cases  # noqa: E402

CASES = fused_cases(4)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return harness.run_both(CASES, str(tmp_path_factory.mktemp("ref")))


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_run_fused_sharded_on_four_ranks_matches_reference(both, case):
    check(both, case)
