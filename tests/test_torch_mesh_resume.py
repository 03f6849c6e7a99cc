"""The training driver's checkpoint across worlds
(``repro_torch.launch.train``): rank 0 gathers the global state for the
checkpointer, so a checkpoint written on 2 ranks resumes on 1 and one
written on 1 resumes on 2, with the uninterrupted run's losses after the
resume (minicpm-2b smoke, 4 steps, a checkpoint after 2; the two-rank
runs are one spawned gloo world).
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sharded import spawn  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402

import _torch_mesh_harness as harness  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """minicpm-2b smoke, 4 steps with a checkpoint after 2, on one rank
    and on two; each run's checkpoint at step 2 resumed on the other
    count. Returns {(written on, resumed on): (uninterrupted losses,
    losses after the resume)}."""
    tmp = tmp_path_factory.mktemp("resume")
    one, two = str(tmp / "one"), str(tmp / "two")
    kw = dict(arch="minicpm-2b", smoke=True, steps=4, batch=8, seq=16,
              lr=3e-3, accum=1, ckpt_every=2, seed=0, log_every=10,
              verbose=False)
    _, whole1 = train_lib.train(ckpt_dir=one, device="cpu", **kw)
    shutil.rmtree(f"{one}/step_00000004")
    whole2, rest_one = spawn(ranks.resume_world, 2, "gloo", "cpu",
                             timeout=harness.WORLD_TIMEOUT,
                             args=(kw, two, one), threads=1)[0]
    shutil.rmtree(f"{two}/step_00000004")
    _, rest_two = train_lib.train(ckpt_dir=two, resume=True, device="cpu",
                                  **kw)
    return {(1, 2): (whole1, rest_one), (2, 1): (whole2, rest_two)}


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)])
def test_checkpoint_resumes_on_another_world(resumed, first, then):
    """A checkpoint written on ``first`` ranks and resumed on ``then``
    ranks gives the uninterrupted run's losses after the resume."""
    whole, rest = resumed[(first, then)]
    assert len(rest) == 2
    np.testing.assert_allclose(rest, whole[2:], rtol=1e-6)
