"""Pool-based training: the NodIO mechanism as a meta-optimizer for LMs.

Port of ``repro/core/pbt.py``. Pods as islands: each member trains a model
with chromosome-encoded hyperparameters (log-lr, log-weight-decay). Every
``steps_per_epoch`` training steps (the paper's 100 generations) a member

    PUTs  (hyper-chromosome, fitness = -val_loss, weights payload)
    GETs  a random pool member; if it is fitter, the member adopts its
          weights and hyperparameters (exploit) and perturbs the hypers
          (explore): restart-on-solution generalized to restart-on-better.

Everything flows through :class:`~repro_torch.core.async_pool.PoolServer`,
so the paper's systems properties carry over: a member tolerates a dead
server (it keeps training), members may join or leave at any time, and
there is no barrier. The payload is a host copy of the member's state
(:func:`repro_torch.convert.to_numpy`); adopting it copies it back onto
the member's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import convert
from .async_pool import PoolServer, PoolUnavailable


@dataclasses.dataclass(frozen=True)
class HyperSpec:
    """A log-uniform hyperparameter dimension."""
    name: str
    low: float
    high: float

    def sample(self, rng: np.random.Generator) -> float:
        return float(np.exp(rng.uniform(math.log(self.low),
                                        math.log(self.high))))


DEFAULT_SPECS = (
    HyperSpec("lr", 1e-5, 1e-2),
    HyperSpec("weight_decay", 1e-3, 0.3),
)


def encode(hypers: Dict[str, float], specs=DEFAULT_SPECS) -> np.ndarray:
    return np.array([math.log(hypers[s.name]) for s in specs], np.float32)


def decode(vec: np.ndarray, specs=DEFAULT_SPECS) -> Dict[str, float]:
    return {s.name: float(np.exp(v)) for s, v in zip(specs, vec)}


def perturb(hypers: Dict[str, float], rng: np.random.Generator,
            sigma: float = 0.3, specs=DEFAULT_SPECS) -> Dict[str, float]:
    out = {}
    for s in specs:
        v = hypers[s.name] * float(np.exp(rng.normal(0.0, sigma)))
        out[s.name] = float(min(max(v, s.low), s.high))
    return out


@dataclasses.dataclass
class PBTMember:
    uuid: int
    hypers: Dict[str, float]
    state: Any                      # TrainState
    fitness: float = -np.inf
    exploits: int = 0
    epochs: int = 0


class PBTController:
    """Drives N members against a PoolServer.

    ``step_fn(state, batch, lr, weight_decay, member) -> (state,
    metrics)``: the hypers are Python floats (the step fills them on the
    device, so one step function serves every member) and ``member`` is
    the member's uuid (the card's step keeps a graph a member, whose
    buffers are that member's state). ``eval_fn(state, batch, member)`` ->
    a scalar loss. ``on_step(member, metrics)``, when given, is called
    after each step. An adopted payload goes to the device of the
    member's state."""

    def __init__(self, step_fn: Callable, eval_fn: Callable,
                 init_state_fn: Callable[[int], Any],
                 pool: Optional[PoolServer] = None,
                 specs=DEFAULT_SPECS, seed: int = 0,
                 exploit_margin: float = 0.0,
                 explore_sigma: float = 0.3,
                 store_weights: bool = True,
                 on_step: Optional[Callable] = None):
        self.step_fn = step_fn
        self.eval_fn = eval_fn
        self.on_step = on_step
        self.pool = pool if pool is not None else PoolServer(capacity=256)
        self.specs = specs
        self.rng = np.random.default_rng(seed)
        self.exploit_margin = exploit_margin
        self.explore_sigma = explore_sigma
        self.store_weights = store_weights
        self._init_state_fn = init_state_fn
        self.members: List[PBTMember] = []
        self.history: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ setup
    def add_member(self) -> PBTMember:
        uid = len(self.members)
        hypers = {s.name: s.sample(self.rng) for s in self.specs}
        m = PBTMember(uuid=uid, hypers=hypers,
                      state=self._init_state_fn(uid))
        self.members.append(m)
        return m

    # ------------------------------------------------------------------ epoch
    def train_epoch(self, member: PBTMember, batches,
                    eval_batch) -> Dict[str, float]:
        for batch in batches:
            member.state, metrics = self.step_fn(
                member.state, batch, member.hypers["lr"],
                member.hypers["weight_decay"], member.uuid)
            if self.on_step is not None:
                self.on_step(member, metrics)
        val = float(self.eval_fn(member.state, eval_batch, member.uuid))
        member.fitness = -val
        member.epochs += 1
        return {"val_loss": val, **{k: float(v) for k, v in
                                    member.hypers.items()}}

    def migrate(self, member: PBTMember) -> bool:
        """PUT own chromosome, GET random, maybe exploit. Never raises on a
        dead pool: the member just continues (the paper's fault
        tolerance). Returns True when an exploit happened."""
        try:
            payload = (convert.to_numpy(member.state)
                       if self.store_weights else None)
            self.pool.put_with_payload(
                encode(member.hypers, self.specs), member.fitness,
                uuid=member.uuid, payload=payload)
            got = self.pool.get_random_entry()
        except PoolUnavailable:
            return False
        if got is None or got.fitness <= member.fitness + self.exploit_margin:
            return False
        member.hypers = perturb(decode(np.asarray(got.genome), self.specs),
                                self.rng, self.explore_sigma, self.specs)
        if got.payload is not None:
            member.state = convert.to_device(got.payload,
                                             member.state.opt.step.device)
        member.fitness = got.fitness
        member.exploits += 1
        return True

    # ------------------------------------------------------------------ run
    def run(self, n_members: int, epochs: int, batches_per_epoch_fn,
            eval_batch_fn, verbose: bool = False) -> List[Dict[str, Any]]:
        while len(self.members) < n_members:
            self.add_member()
        for epoch in range(epochs):
            for m in self.members:
                stats = self.train_epoch(
                    m, batches_per_epoch_fn(m.uuid, epoch),
                    eval_batch_fn(m.uuid, epoch))
                exploited = self.migrate(m)
                rec = {"epoch": epoch, "member": m.uuid,
                       "exploited": exploited, **stats}
                self.history.append(rec)
                if verbose:
                    print(f"  epoch {epoch} member {m.uuid}: "
                          f"val {stats['val_loss']:.4f} "
                          f"lr {m.hypers['lr']:.2e}"
                          f"{'  <- exploit' if exploited else ''}")
        return self.history

    def best_member(self) -> PBTMember:
        return max(self.members, key=lambda m: m.fitness)
