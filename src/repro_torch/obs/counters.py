"""On-device observability counters, carried through the drivers' epochs.

The port of ``repro.obs.counters``. :class:`ObsCounters` is a small tuple
of int32 tensors that rides beside the island and pool state. Everything
here is pure accumulation, integer adds driven by masks the drivers
already compute, so the counters cost no host read until :func:`harvest`,
and with ``acceptance='always'`` their totals do not depend on the
generation impl.

Counter semantics (per island, int32):

fired:        migration exchanges attempted: one per epoch the server was
              available.
delivered:    finite immigrants delivered by the topology, before the gate.
accepted:     deliveries that passed the acceptance gate.
rejected:     deliveries the gate refused; ``delivered == accepted +
              rejected`` by construction.
churn_down:   ticks inside a churn down-window (the sync drivers: 0).
inbox_age_hist: ``(n, AGE_BINS)``, the age in ticks of each absorbed
              immigrant, clipped into the last bin (the sync drivers
              absorb at delivery: age 0).
early_stop_epoch: scalar, the 1-based epoch the early-success latch first
              fired; -1 while running (and for W² runs).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from .._device import as_device

AGE_BINS = 8


class ObsCounters(NamedTuple):
    fired: torch.Tensor             # (n,) int32
    delivered: torch.Tensor         # (n,) int32
    accepted: torch.Tensor          # (n,) int32
    rejected: torch.Tensor          # (n,) int32
    churn_down: torch.Tensor        # (n,) int32
    inbox_age_hist: torch.Tensor    # (n, AGE_BINS) int32
    early_stop_epoch: torch.Tensor  # () int32, -1 = never


def init_obs(n_islands: int, *, device=None) -> ObsCounters:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return ObsCounters(
        fired=zeros(n_islands), delivered=zeros(n_islands),
        accepted=zeros(n_islands), rejected=zeros(n_islands),
        churn_down=zeros(n_islands),
        inbox_age_hist=zeros(n_islands, AGE_BINS),
        early_stop_epoch=torch.tensor(-1, dtype=torch.int32, device=device))


def _i32(mask) -> torch.Tensor:
    return torch.as_tensor(mask).to(torch.int32)


def record_exchange(obs: ObsCounters, fired, delivered,
                    accepted) -> ObsCounters:
    """One migration step's ledger from boolean masks per island."""
    d, a = _i32(delivered), _i32(accepted)
    return obs._replace(
        fired=obs.fired + _i32(fired),
        delivered=obs.delivered + d,
        accepted=obs.accepted + a,
        rejected=obs.rejected + (d - a))


def record_churn(obs: ObsCounters, down) -> ObsCounters:
    return obs._replace(churn_down=obs.churn_down + _i32(down))


def record_absorb(obs: ObsCounters, consumed, age) -> ObsCounters:
    """Histogram the age (in ticks) of each absorbed immigrant."""
    bins = torch.clamp(_i32(age), 0, AGE_BINS - 1)
    lanes = torch.arange(AGE_BINS, dtype=torch.int32, device=bins.device)
    one_hot = (lanes[None, :] == bins[:, None]) & \
        torch.as_tensor(consumed)[:, None]
    return obs._replace(inbox_age_hist=obs.inbox_age_hist + _i32(one_hot))


def record_early_stop(obs: ObsCounters, stopped, epoch) -> ObsCounters:
    """Latch the first epoch the stop flag is up (idempotent after)."""
    dev = obs.early_stop_epoch.device
    fresh = (obs.early_stop_epoch < 0) & as_device(stopped, torch.bool, dev)
    return obs._replace(early_stop_epoch=torch.where(
        fresh, as_device(epoch, torch.int32, dev), obs.early_stop_epoch))


def harvest(obs: ObsCounters, axis=None) -> Dict[str, Any]:
    """Device to host: per-island lists plus summable totals, as plain
    Python values (JSON-ready). Under ``axis`` (a shard group) the rows of
    every rank are gathered first, in rank order, so each rank returns
    the global ledger; ``early_stop_epoch`` is replicated."""
    rows = obs[:6] if axis is None else [axis.gather(t) for t in obs[:6]]
    fired, delivered, accepted, rejected, churn, ages = (
        t.cpu().numpy() for t in rows)
    return {
        "n_islands": int(fired.shape[0]),
        "fired": fired.tolist(),
        "delivered": delivered.tolist(),
        "accepted": accepted.tolist(),
        "rejected": rejected.tolist(),
        "churn_down": churn.tolist(),
        "inbox_age_hist": ages.tolist(),
        "early_stop_epoch": int(obs.early_stop_epoch),
        "totals": {
            "fired": int(fired.sum()),
            "delivered": int(delivered.sum()),
            "accepted": int(accepted.sum()),
            "rejected": int(rejected.sum()),
            "churn_down": int(churn.sum()),
            "inbox_age_hist": ages.sum(axis=0).tolist(),
        },
    }
