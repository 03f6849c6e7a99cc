"""Elastic island scaling: volunteers joining and leaving between runs.

The port of ``repro.runtime.elastic``. A resize reshapes the island batch:

* grow: new islands start fresh and take one pool GET each, as a joining
  browser bootstraps from the server;
* shrink: the islands past the new count go; their last PUTs live on in
  the pool.

The fused drivers call :func:`resize_experiment` when a resumed snapshot
holds another island count than the run asks for. Joiners take uuids
from the monotonic watermark ``ExperimentState.next_uuid``, never from the
batch size, so a shrink then a grow never hands a new volunteer a
departed island's identity.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import rand
from ..core import island as island_lib
from ..core import pool as pool_lib
from ..core.problems import Problem
from ..core.types import EAConfig, ExperimentState, IslandState, PoolState
from ..obs import counters as obs_lib

# a joiner's down-window opens beyond every int32 tick: it never churns
NEVER_CHURN = 2**31 - 1


def shrink_islands(islands: IslandState, keep: int) -> IslandState:
    """The first ``keep`` islands (the rest closed their tabs)."""
    n = int(islands.pop.shape[0])
    if keep > n:
        raise ValueError(f"shrink to {keep} > current {n}")
    return IslandState(*(x[:keep] for x in islands))


def grow_islands(islands: IslandState, n_new: int, problem: Problem,
                 cfg: EAConfig, pool: Optional[PoolState],
                 rng: torch.Tensor,
                 next_uuid: Union[torch.Tensor, int, None] = None
                 ) -> IslandState:
    """``n_new`` fresh islands appended, each seeded by a pool GET when a
    pool is given. Joiners get uuids ``next_uuid ..
    next_uuid + n_new - 1``; the default ``max(uuid) + 1`` is right only
    for histories that never shrank (pass the watermark otherwise). The
    keys are the reference's: ``k_init, k_get = split(rng)``, joiner ``i``
    from ``split(k_init, n_new)[i]``."""
    dev = islands.pop.device
    if next_uuid is None:
        next_uuid = islands.uuid.max() + 1
    k_init, k_get = rand.split(rng.to(dev), 2)
    uuids = torch.as_tensor(next_uuid, dtype=torch.int32, device=dev) + \
        torch.arange(n_new, dtype=torch.int32, device=dev)
    fresh = island_lib.init_islands(k_init, n_new, problem, cfg,
                                    device=dev)._replace(uuid=uuids)
    if pool is not None:
        genomes, fits = pool_lib.pool_get_random(pool,
                                                 rand.split(k_get, n_new))
        fresh = island_lib.receive_immigrant(fresh, genomes, fits)
    return IslandState(*(torch.cat([a, b]) for a, b in zip(islands, fresh)))


def grow_async_state(astate, n_new: int):
    """An :class:`~repro_torch.core.async_migration.AsyncState` with
    ``n_new`` joiner rows: a zero clock, the batch's mean rate (an f32
    mean), an empty inbox, no fires and a down-window that never opens (a
    joining browser does not inherit a departed volunteer's schedule)."""
    def joiner(name: str) -> torch.Tensor:
        x = getattr(astate, name)
        shape = (n_new,) + tuple(x.shape[1:])
        if name == "rate":
            return x.mean().expand(shape).clone()
        if name in ("down_start", "down_end"):
            value = NEVER_CHURN
        elif name == "inbox_fitness":
            value = pool_lib.NEG_INF
        elif name == "inbox_born":
            value = -1
        else:
            value = 0
        return torch.full(shape, value, dtype=x.dtype, device=x.device)

    return type(astate)(*(torch.cat([getattr(astate, f), joiner(f)])
                          for f in astate._fields))


def resize_experiment(state: ExperimentState, n_islands: int,
                      problem: Problem, cfg: EAConfig) -> ExperimentState:
    """``state`` (restored from a snapshot) resized to ``n_islands``.

    shrink: the first ``n_islands`` islands (and async rows);
    grow: fresh islands seeded by a pool GET, uuids from the
    ``next_uuid`` watermark; async rows (when the state has an
    ``AsyncState``) join by :func:`grow_async_state`.

    The joiners' keys come from ``fold_in(state.key, 0x05A1)`` without
    consuming the loop key, so a resized run stays seeded. The counters
    (``state.obs``) restart from zero at the new count: a row index names
    no island across a resize."""
    n_now = int(state.islands.pop.shape[0])
    if n_islands == n_now:
        return state
    if hasattr(state.obs, "_fields"):
        state = state._replace(obs=obs_lib.init_obs(
            n_islands, device=state.islands.pop.device))
    has_astate = hasattr(state.astate, "_fields")
    if n_islands < n_now:
        islands = shrink_islands(state.islands, n_islands)
        astate = (type(state.astate)(*(x[:n_islands] for x in state.astate))
                  if has_astate else state.astate)
        return state._replace(islands=islands, astate=astate)
    n_new = n_islands - n_now
    k_join = rand.fold_in(state.key, 0x05A1)
    islands = grow_islands(state.islands, n_new, problem, cfg, state.pool,
                           k_join, next_uuid=state.next_uuid)
    astate = (grow_async_state(state.astate, n_new)
              if has_astate else state.astate)
    return state._replace(islands=islands, astate=astate,
                          next_uuid=state.next_uuid + n_new)
