"""Meshes over the ranks of a ``torch.distributed`` group: the counterpart
of ``repro/launch/mesh.py``, and the sharded drivers' shard group.

A :class:`Mesh` names its axes and their sizes, as a ``jax.sharding.Mesh``
does. It is *abstract* (no process group: what
:mod:`repro_torch.launch.shardings` and the dry run's shapes need) or
*bound* to this rank (:meth:`Mesh.bind`): then it knows the rank's
coordinate and holds one :class:`~repro_torch.core.sharded.ShardGroup`
per axis, the ranks that differ from this one along that axis alone.

A rank's coordinate is row-major in the rank, the last axis fastest: on
a (data 2, model 2) mesh rank 1 is (0, 1). ``jax.make_mesh`` may order
its devices otherwise (it follows the physical topology), so the tests
compare a rank's shards with the reference's addressable shard at the
same mesh coordinate, never at the same device id.

Production: 256 chips as (16, 16) ``("data", "model")``, or two pods as
(2, 16, 16) ``("pod", "data", "model")``; :func:`make_mesh_for_devices`
is the training driver's mesh over however many ranks exist.
:func:`make_host_group` is the sharded island drivers' group (the
reference's ``make_host_mesh``).
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from ..core.sharded import ShardGroup, choose_backend, rank_device


class Mesh:
    """Axis names and sizes; bound, also this rank's coordinate and a
    :class:`ShardGroup` per axis (``group(name)``) and over the world
    (``world``)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{sizes} and {axis_names} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, sizes)))
        self.size = math.prod(self.shape.values())
        self.world: Optional[ShardGroup] = None
        self.coord: Optional[Dict[str, int]] = None
        self._groups: Dict[str, ShardGroup] = {}

    def __repr__(self) -> str:
        dims = "x".join(str(self.shape[a]) for a in self.axis_names)
        state = "abstract" if self.world is None else f"rank {self.world.rank}"
        return f"Mesh({dims} {self.axis_names}, {state})"

    def coord_of(self, rank: int) -> Dict[str, int]:
        """The row-major coordinate of ``rank``."""
        out = {}
        for a in reversed(self.axis_names):
            out[a] = rank % self.shape[a]
            rank //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coord: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coord[a]
        return r

    def group(self, axis: str) -> ShardGroup:
        """The ranks along ``axis`` through this one, in coordinate
        order."""
        return self._groups[axis]

    def bind(self, world: ShardGroup) -> "Mesh":
        """This mesh bound to the rank of ``world`` (its size the mesh's).
        Every rank of the world must bind the same mesh: each axis's
        subgroups are made by ``dist.new_group`` over all of them, in the
        same order on every rank."""
        if world.world != self.size:
            raise ValueError(f"a world of {world.world} ranks cannot hold "
                             f"a mesh of {self.size}")
        m = Mesh([self.shape[a] for a in self.axis_names], self.axis_names)
        m.world = world
        m.coord = m.coord_of(world.rank)
        for a in m.axis_names:
            mine = None
            others = [b for b in m.axis_names if b != a]
            for fixed in _coords(m, others):
                ranks = [m.rank_of({**fixed, a: i})
                         for i in range(m.shape[a])]
                pg = (world.pg if m.shape[a] == m.size
                      else dist.new_group(ranks))
                if world.rank in ranks:
                    mine = pg
            m._groups[a] = ShardGroup(m.coord[a], m.shape[a], world.device,
                                      pg=mine, backend=world.backend,
                                      host_copies=world.host_copies)
        return m


def _coords(mesh: Mesh, axes: Sequence[str]):
    """Every coordinate over ``axes``, row-major."""
    if not axes:
        yield {}
        return
    for i in range(mesh.shape[axes[0]]):
        for rest in _coords(mesh, axes[1:]):
            yield {axes[0]: i, **rest}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"``."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh_for_devices(world: int) -> Mesh:
    """The training driver's (data, model) mesh over ``world`` ranks: the
    largest model parallelism of 16, 8, 4, 2, 1 that divides the world
    (``train.py:34-43`` of the reference; 1 rank -> (1, 1), 4 -> (1,
    4))."""
    model_par = next(c for c in (16, 8, 4, 2, 1) if world % c == 0)
    return Mesh((world // model_par, model_par), ("data", "model"))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes that carry data parallelism (the batch's)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, axes: Union[Tuple[str, ...], str]) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


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
