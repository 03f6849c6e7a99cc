"""The port's population-based training (``repro_torch.core.pbt`` and
``launch/evolve.py``'s ``run_pbt``) against the JAX reference's, at the
smoke size on the CPU.

Three members start from the reference's initial states (carried across
with ``convert.train_state_from_numpy``) and train on the same batches;
their pool is a ``PoolServer(capacity=64, seed=0)`` on each side. The
controllers' histories agree: epochs, members, the exploit decisions and
the hypers (numpy on both sides) exactly, the validation losses within
atol 2e-5 (the train step's tolerance over a few steps, ROADMAP Queue
C); the pools count the same PUTs and GETs.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_threefry_partitionable", True)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import pbt as j_pbt  # noqa: E402
from repro.launch.evolve import run_pbt as j_run_pbt  # noqa: E402
from repro.launch.steps import init_train_state as j_init  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PoolServer, pbt  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import evolve  # noqa: E402
from repro_torch.models import Model  # noqa: E402

RUN = dict(arch="minicpm-2b", members=3, epochs=3, steps_per_epoch=2,
           batch=8, seq=64, seed=0, verbose=False)


def test_hyper_codec_matches_reference():
    """``encode``/``decode``/``perturb`` and the specs' sampling are the
    reference's numpy, draw for draw."""
    hypers = {"lr": 3e-4, "weight_decay": 0.05}
    np.testing.assert_array_equal(pbt.encode(hypers), j_pbt.encode(hypers))
    vec = pbt.encode(hypers)
    assert pbt.decode(vec) == j_pbt.decode(vec)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(20):
        assert pbt.perturb(hypers, a, 0.5) == j_pbt.perturb(hypers, b, 0.5)
    assert [s.sample(a) for s in pbt.DEFAULT_SPECS] == [
        s.sample(b) for s in j_pbt.DEFAULT_SPECS]
    assert pbt.DEFAULT_SPECS == tuple(pbt.HyperSpec(s.name, s.low, s.high)
                                      for s in j_pbt.DEFAULT_SPECS)


@pytest.fixture(scope="module")
def both_runs():
    """(reference controller, port controller) of :data:`RUN`; each port
    member starts from the reference's state of its seed (``seed +
    uid``, read from the generator the port would draw from)."""
    want = j_run_pbt(**RUN)
    j_model = JModel(j_get_config(RUN["arch"], smoke=True))

    def init(model, generator):
        state = j_init(j_model, jax.random.key(generator.initial_seed()))
        return convert.train_state_from_numpy(
            model, jax.tree.map(np.asarray, state), device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evolve, "init_train_state", init)
        got = evolve.run_pbt(device="cpu", **RUN)
    return want, got


def test_pbt_history_matches_reference(both_runs):
    want, got = both_runs
    assert len(got.history) == len(want.history) == 9
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        for k in ("epoch", "member", "exploited", "lr", "weight_decay"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], atol=2e-5)
    assert any(h["exploited"] for h in got.history)


def test_pbt_pool_and_members_match_reference(both_runs):
    """The pool saw one PUT and one GET a member and epoch; members end
    with the reference's hypers, exploit counts and (within tolerance)
    fitness, and the same best member."""
    want, got = both_runs
    ws, gs = want.pool.stats(), got.pool.stats()
    assert gs["puts"] == ws["puts"] == RUN["members"] * RUN["epochs"]
    assert gs["gets"] == ws["gets"] and gs["size"] == ws["size"]
    for g, w in zip(got.members, want.members):
        assert (g.uuid, g.hypers, g.exploits, g.epochs) == (
            w.uuid, w.hypers, w.exploits, w.epochs)
        np.testing.assert_allclose(g.fitness, w.fitness, atol=2e-5)
    assert got.best_member().uuid == want.best_member().uuid
    # an adopted payload landed on the member's device as tensors
    for m in got.members:
        assert m.state.opt.step.device.type == "cpu"
        assert all(isinstance(v, torch.Tensor) for v in
                   m.state.params.values())


def test_dead_pool_member_trains_on(both_runs):
    """``examples/evolve_lm.py``'s fault demo: with the server killed a
    member trains an epoch and ``migrate`` returns False, no PUT lands."""
    _, ctrl = both_runs
    ctrl.pool.kill()
    try:
        data = SyntheticLM(vocab_size=256, seq_len=64, global_batch=8,
                           device="cpu")
        m = ctrl.members[0]
        puts = ctrl.pool._n_puts
        before = {k: v.clone() for k, v in m.state.params.items()}
        stats = ctrl.train_epoch(m, (data.batch_for_step(s) for s in
                                     range(2)), data.batch_for_step(99_999))
        assert np.isfinite(stats["val_loss"])
        assert not all(torch.equal(before[k], v)
                       for k, v in m.state.params.items())
        assert ctrl.migrate(m) is False
        assert ctrl.pool._n_puts == puts
    finally:
        ctrl.pool.revive()


def test_migrate_adopts_a_fitter_entry():
    """A fitter pool entry is adopted (weights copied onto the member's
    device, hypers perturbed within the specs); its own, no fitter, is
    not."""
    states = {}

    def init(uid):
        return evolve.init_train_state(
            Model(get_config("minicpm-2b", smoke=True), device="cpu"),
            torch.Generator().manual_seed(uid))

    pool = PoolServer(capacity=8, seed=0)
    ctrl = pbt.PBTController(step_fn=None, eval_fn=None, init_state_fn=init,
                             pool=pool, seed=1)
    a, b = ctrl.add_member(), ctrl.add_member()
    a.fitness, b.fitness = -1.0, -5.0
    assert ctrl.migrate(a) is False          # its own entry: not fitter
    states["a"] = {k: v.clone() for k, v in a.state.params.items()}
    # b adopts once the random GET draws a's entry (its own is no fitter)
    tries = [ctrl.migrate(b) for _ in range(12)]
    assert True in tries and tries.count(True) == 1
    assert b.fitness == -1.0 and b.exploits == 1
    for k, v in b.state.params.items():
        assert torch.equal(v, states["a"][k])
    for s in pbt.DEFAULT_SPECS:
        assert s.low <= b.hypers[s.name] <= s.high


def test_pbt_command_runs(capsys):
    """``evolve pbt`` on the CPU prints a line per member and epoch and
    the best member, as the reference's command does."""
    ctrl = evolve.main(["pbt", "--device", "cpu", "--members", "2",
                        "--epochs", "2", "--steps-per-epoch", "1"])
    out = capsys.readouterr().out.splitlines()
    assert len([x for x in out if x.startswith("  epoch ")]) == 4
    assert out[-1].startswith(f"best member {ctrl.best_member().uuid}: "
                              f"val=")
    assert ctrl.pool.stats()["puts"] == 4
