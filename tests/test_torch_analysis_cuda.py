"""The analyzer's static registry matrix against the runtime registries
with the CUDA wrappers imported on the card: the test form of
``chip_smoke.py`` phase 16.

Marked ``cuda``: the test skips where no card is visible. On a machine
with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analysis_cuda.py
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import importlib
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.engine import collect_python_files  # noqa: E402
from repro_torch.analysis.passes.registry import (  # noqa: E402
    collect_registrations)
from repro_torch.analysis.symbols import load_project  # noqa: E402

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_WRAPPERS = ("repro_torch.kernels.ga.generation",
                 "repro_torch.kernels.ga.tiling",
                 "repro_torch.kernels.trap.trap",
                 "repro_torch.kernels.rastrigin.f15",
                 "repro_torch.kernels.rwkv6.ops",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.ga.ops", "repro_torch.core.ga")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return torch.device("cuda")


def test_registry_matrix_matches_runtime_on_the_card(card):
    for name in CUDA_WRAPPERS:
        importlib.import_module(name)
    from repro_torch.core import acceptance as acc_lib
    from repro_torch.core import migration as mig_lib
    from repro_torch.kernels.ga.registry import get_kernel, registered_kernels

    regs = collect_registrations(load_project(collect_python_files(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO)))
    runtime = set(registered_kernels())
    assert {r.key for r in regs if r.family == "kernel"} == runtime
    assert {r.key[0] for r in regs if r.family == "topology"} == \
        set(mig_lib.TOPOLOGIES)
    assert {r.key[0] for r in regs if r.family == "acceptance"} == \
        set(acc_lib.ACCEPTANCE_POLICIES) <= set(acc_lib.HOST_MIRRORED)
    for impl in ("pallas", "pallas_tiled", "pallas_ref"):
        for op in ("generation", "generation_eval"):
            for kind in ("binary", "float"):
                assert callable(get_kernel(op, kind, impl))
