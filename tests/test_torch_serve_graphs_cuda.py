"""The compiled serve path on the card: ``generate`` replays its prefill and
decode graphs by default, against ``generate(..., graphs=False)``.

Marked ``cuda``: each test skips where no card is visible (the check runs
inside the ``card`` fixture, never at import). On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_graphs_cuda.py

Every arch at ``reduced()`` (bf16, random weights from a seed), 2 x 16
prompt tokens and 8 new: the graphed call runs the eager call's kernels on
the same shapes, so its tokens and every step's logits must be equal bit
for bit; a second call at the same shapes replays without a capture and
launches what the eager call launches.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import generate, make_inputs
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda
BATCH, PROMPT, NEW, SEED = 2, 16, 8, 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    steps_lib.release_serve_graphs()
    yield torch.device("cuda")
    steps_lib.release_serve_graphs()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_graphed_generate_equals_eager_on_the_card(card, arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, card,
                        torch.Generator(device=card).manual_seed(SEED))
    prompts, extra = make_inputs(cfg, BATCH, PROMPT, SEED + 1, card)
    kernels.reset_launches()
    want, w_info = generate(model, prompts, NEW, graphs=False,
                            keep_logits=True, **extra)
    eager_launches = dict(kernels.LAUNCHES)
    got, g_info = generate(model, prompts, NEW, keep_logits=True, **extra)
    assert g_info["graphs"] and g_info["capture_s"] > 0
    assert g_info["pool_bytes"] > 0
    assert torch.equal(got, want)
    assert torch.equal(g_info["logits"], w_info["logits"])
    kernels.reset_launches()
    again, a_info = generate(model, prompts, NEW, keep_logits=True, **extra)
    assert a_info["capture_s"] == 0
    assert all(g.captures == 1 for _, g in steps_lib.serve_graphs(model))
    assert dict(kernels.LAUNCHES) == eager_launches
    assert torch.equal(again, want)
    assert torch.equal(a_info["logits"], w_info["logits"])
