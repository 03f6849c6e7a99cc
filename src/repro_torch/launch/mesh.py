"""The shard group of the sharded drivers: the counterpart of the
reference's ``make_host_mesh``.

The reference builds a 1-D mesh over the host's (possibly fake) devices;
the port's sharded drivers take a
:class:`~repro_torch.core.sharded.ShardGroup`, one rank per process. The
reference's production mesh (pods x data x model) is not ported (ROADMAP,
Queue A item 14).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..core.sharded import ShardGroup, choose_backend, rank_device


def make_host_group(device: DeviceLike = None,
                    timeout: float = 1800.0) -> ShardGroup:
    """This process's :class:`ShardGroup` on ``device`` (None: the card).

    Where a process group is initialized (a rank of
    :func:`~repro_torch.core.sharded.spawn`, or the caller's), it is that
    group, on ``device`` (a card: the current one). Under ``torchrun``
    (``WORLD_SIZE`` in the environment) the default group is initialized
    from the environment, the backend by
    :func:`~repro_torch.core.sharded.choose_backend` over the host's ranks
    (``LOCAL_WORLD_SIZE``), each rank on the card of its ``LOCAL_RANK``.
    Otherwise it is a world of one rank. ``timeout`` seconds bound every
    collective of a group initialized here."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return ShardGroup.from_default(device=dev)
    env = os.environ
    world = int(env.get("WORLD_SIZE", "1"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    local_rank = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    backend = choose_backend(dev, local_world)[0]
    rdev = rank_device(backend, dev, local_rank)
    if rdev.type == "cuda":
        torch.cuda.set_device(rdev)
    limit = datetime.timedelta(seconds=timeout)
    if "WORLD_SIZE" in env:
        dist.init_process_group(backend, init_method="env://", timeout=limit)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=limit)
    return ShardGroup.from_default(device=rdev)
