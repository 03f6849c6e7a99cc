"""Deterministic synthetic LM data with learnable structure.

Port of ``repro/data/synthetic.py``. Every batch is a pure function of
(seed, step, shard): no filesystem, no state, the same bits after a
restart and on any number of hosts. The token stream is a noisy affine
recurrence

    x_{t+1} = (a_c * x_t + b_c) mod V     with probability 1 - noise
    x_{t+1} ~ U[0, V)                     otherwise

whose coefficients (a_c, b_c) switch between C regimes per sequence.

The draws are the reference's ``jax.random`` streams through the port's
keyed recipes (:mod:`repro_torch.rand`), so a batch equals the
reference's bit for bit. The reference's recurrence runs in int32: ``a *
x`` passes 2**31 once V is past about 33,000 (minicpm-2b's V = 122,753
reaches 3.0e10) and wraps, and ``%`` is then the floor modulus of the
wrapped value. The port computes in int64, wraps to int32 as the
reference's multiply and add do, and takes the floor modulus
(``torch.remainder``).

The reference jits the draw (``_gen``, its shapes static); on the card
the port replays it as a CUDA graph (:func:`gen_step` in a
:class:`~repro_torch.core.graphed.StepGraph`, one per shape and
instance), the key copied in before each replay and the batch cloned out:
an eager draw launches thousands of small kernels (the keyed draws and
the recurrence's loop over the sequence), which the train loop and PBT
would otherwise wait on between their replayed steps. The replay gives
the eager draw's bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch

from .. import rand
from .._device import DeviceLike, resolve_device
from ..core import graphed


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.15
    n_regimes: int = 8
    device: DeviceLike = None
    # the draw's graphs by batch shape (the card only)
    _graphs: Dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def batch_for_step(self, step: int, shard: int = 0,
                       n_shards: int = 1) -> Dict[str, torch.Tensor]:
        """Batch slice for one data shard (``global_batch % n_shards ==
        0``): ``tokens`` and ``labels`` (B, S) int32 on ``device`` (the
        card unless given)."""
        assert self.global_batch % n_shards == 0
        b = self.global_batch // n_shards
        dev = resolve_device(self.device)
        key = rand.fold_in(rand.fold_in(rand.key(self.seed, dev), int(step)),
                           int(shard))
        shape = (b, self.seq_len, self.vocab_size, self.noise,
                 self.n_regimes)
        if not graphed.graphs_on(dev):
            return _gen(key, *shape)
        if shape not in self._graphs:
            self._graphs[shape] = graphed.StepGraph(
                functools.partial(gen_step, *shape))
        return self._graphs[shape](key)[1]


def gen_step(batch: int, seq: int, vocab: int, noise: float, n_regimes: int,
             key: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """The draw as a graphed step: the key is its carry, returned as it
    came; its output is the batch."""
    return key, _gen(key, batch, seq, vocab, noise, n_regimes)


def _gen(key: torch.Tensor, batch: int, seq: int, vocab: int, noise: float,
         n_regimes: int) -> Dict[str, torch.Tensor]:
    k_reg, k_x0, k_noise, k_rand, k_which = rand.split(key, 5).unbind(0)
    # per-sequence regime coefficients (odd multiplier for a full cycle)
    a = rand.keyed_randint(k_reg, (batch, n_regimes), 1, vocab).long() * 2 + 1
    bb = rand.keyed_randint(rand.fold_in(k_reg, 1), (batch, n_regimes), 0,
                            vocab).long()
    which = rand.keyed_randint(k_which, (batch, seq), 0, n_regimes).long()
    x = rand.keyed_randint(k_x0, (batch,), 0, vocab).long()
    noisy = rand.keyed_bernoulli(k_noise, noise, (batch, seq))
    rnd = rand.keyed_randint(k_rand, (batch, seq), 0, vocab).long()
    # the coefficients each step reads, gathered once: (B, S)
    a_t = a.gather(1, which)
    b_t = bb.gather(1, which)
    toks = []
    for t in range(seq):
        nxt = torch.remainder(rand._to_i32(a_t[:, t] * x + b_t[:, t]).long(),
                              vocab)
        x = torch.where(noisy[:, t], rnd[:, t], nxt)
        toks.append(x)
    tokens = torch.stack(toks, dim=1).to(torch.int32)       # (batch, seq)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": tokens, "labels": labels}


def make_batch_specs(vocab: int, batch: int, seq: int
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of a batch."""
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}
