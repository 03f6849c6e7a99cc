"""Training driver: synthetic data -> train loop -> checkpoints.

Port of ``repro/launch/train.py``. The same code runs the smoke configs
on the CPU and the published ones on the card, on one device or over the
ranks of a group: ``world`` ranks spawned on this host (``--world N``),
or the ranks of an initialized group (a spawned world's, ``torchrun``'s;
:func:`~repro_torch.launch.mesh.make_host_group`), on
:func:`~repro_torch.launch.mesh.make_mesh_for_devices` of their count
under the ``train`` rules (:mod:`repro_torch.launch.partition`). Each
data rank takes its rows of the loader's global batch. Rank 0 gathers the
global state for the checkpointer, so a checkpoint written on any number
of ranks resumes on any other. ``--resume`` picks up the latest
checkpoint (parameters, optimizer and the data step); on the same ranks
it continues bit for bit.

On one card the loop replays the train step as a CUDA graph
(:func:`~repro_torch.launch.steps.compiled_train_step`, the counterpart
of the reference's ``jax.jit(step_fn, donate_argnums=(0,))``): the graph
takes the state's tensors as its static buffers, the batch is copied in
before each replay, the metrics come out cloned, and the host read of
``ce``, the batch draw and the checkpoints stay between replays.
``graphs=False`` runs the same step eagerly. Each rank of a group on the
card replays its step too (the counterpart of the reference's
``jax.jit(step_fn, in_shardings=..., donate_argnums=(0,))`` over its
mesh): a chain of graphs cut at the step's collectives
(:class:`~repro_torch.core.graphed.CutGraph`), each collective run
eagerly between two segments, as gloo's host copies need.

On the card (minicpm-2b at its published size):

    python -m repro_torch.launch.train --arch minicpm-2b --full \\
        --steps 6 --batch 8 --seq 512

and on the CPU, one rank or four:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --smoke --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        --device cpu [--world 4]
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import convert
from .._device import DeviceLike, resolve_device
from ..checkpoint import Checkpointer, latest_step, restore
from ..configs import ARCHS, get_config
from ..core import graphed
from ..core.sharded import choose_backend, spawn
from ..data import ShardedLoader, SyntheticLM
from ..models import build_model
from ..optim import make_schedule
from . import partition
from .mesh import make_host_group, make_mesh_for_devices
from .steps import (abstract_train_state, compiled_train_step, gather_state,
                    init_train_state, local_train_state, make_train_step,
                    shard_batch, shard_state, train_graph_step)


def train(arch: str, smoke: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, accum: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = False, seed: int = 0, log_every: int = 10,
          verbose: bool = True, device: DeviceLike = None,
          on_step=None, world: Optional[int] = None,
          graphs: Optional[bool] = None):
    """Train ``arch`` for ``steps`` steps; returns (state, per-step ce).

    The weights are drawn on the device from a generator seeded ``seed``
    (on a mesh each rank keeps its blocks as they are drawn, the same
    blocks at any rank count); after that the module keeps only their
    shapes (the state holds them).
    A checkpoint ``{"state", "data_step"}`` is written every
    ``ckpt_every`` steps and at the end. ``on_step(i, state, metrics)``,
    when given, is called after each step (the timing hook of the chip
    check).

    ``world`` > 1 spawns that many ranks on this host (gloo on the CPU;
    on cards NCCL, or gloo with host copies where ranks share one) and
    returns rank 0's (global state, ce); inside an initialized group the
    run is over its ranks (the state then this rank's blocks). Without
    either, one device.

    ``graphs`` (default: on the card) replays the step as a CUDA graph,
    on a group's ranks as a chain of graphs cut at its collectives; a
    capture that fails raises. ``graphs=False`` calls the same step
    eagerly. The returned state is the graph's donated buffers: the
    caller's from the start."""
    kw = dict(arch=arch, smoke=smoke, steps=steps, batch=batch, seq=seq,
              lr=lr, accum=accum, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              resume=resume, seed=seed, log_every=log_every,
              verbose=verbose, graphs=graphs)
    if world is not None and world > 1 and not dist.is_initialized():
        dev = resolve_device(device)
        backend, _ = choose_backend(dev, world)
        return spawn(_rank_train, world, backend, dev, timeout=3600.0,
                     args=(kw,))[0]
    dev = resolve_device(device)
    if not dist.is_initialized():
        return _train(device=dev, on_step=on_step, group=None, **kw)
    return _train(device=dev, on_step=on_step,
                  group=make_host_group(dev), **kw)


def _rank_train(group, kw):
    state, losses = _train(device=group.device, group=group, on_step=None,
                           **kw)
    return state, losses


def _train(arch, smoke, steps, batch, seq, lr, accum, ckpt_dir, ckpt_every,
           resume, seed, log_every, verbose, device, on_step, group,
           graphs=None):
    dev = device
    graphs = graphed.graphs_on(dev) if graphs is None else graphs
    cfg = get_config(arch, smoke=smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    schedule = make_schedule(cfg.schedule, lr, steps, warmup_steps=min(
        20, steps // 5 + 1))
    layout = None
    if group is None:
        model = build_model(cfg, dev, gen)
        state = init_train_state(model)
        step_fn = make_train_step(model, schedule=schedule,
                                  accum_steps=accum)
    else:
        # each rank draws its blocks alone: the global model is never
        # whole on one device
        mesh = make_mesh_for_devices(group.world).bind(group)
        model = partition.build_local(cfg, mesh, "train", dev, gen)
        layout = partition.param_layout(model, mesh, "train")
        state = local_train_state(dict(model.named_parameters()), layout)
        step_fn = make_train_step(model, schedule=schedule,
                                  accum_steps=accum, mesh=mesh, mode="train")
    model.to_empty(device="meta")        # the state holds the weights
    rank0 = group is None or group.rank == 0

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed, device=dev)
    loader = ShardedLoader(data)
    ckpt = Checkpointer(ckpt_dir, keep=3) if ckpt_dir and rank0 else None

    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        target = abstract_train_state(model) if layout else state
        blob = restore(ckpt_dir, target={"state": target, "data_step": 0})
        state = convert.to_device(blob["state"], dev)
        if layout is not None:
            state = shard_state(state, layout)
        start = int(blob["data_step"])
        loader.load_state_dict({"step": start})
        if verbose and rank0:
            print(f"resumed from step {start}")

    def snapshot(i):
        full = state if layout is None else gather_state(state, layout)
        if ckpt is not None:
            ckpt.save_async(i + 1, {"state": full, "data_step": i + 1})
        if group is not None:
            # a snapshot on disk is a point every rank has passed
            if ckpt is not None:
                ckpt.wait()
            group.barrier()

    # the graph adopts the state it is first given (at ``start``, after a
    # resume): its tensors are the state from then on
    run = (compiled_train_step(step_fn) if graphs else graphed.EagerStep(
        functools.partial(train_graph_step, step_fn), dev))
    losses = []
    t0 = time.perf_counter()
    for i in range(start, steps):
        batch_i = loader.next()
        if layout is not None:
            batch_i = shard_batch(batch_i, layout.mesh, "train")
        (state, _), metrics = run((state, batch_i))
        losses.append(float(metrics["ce"]))
        if on_step is not None:
            on_step(i, state, metrics)
        if verbose and rank0 and (i % log_every == 0 or i == steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {i:5d} ce={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} [{dt:.1f}s]", flush=True)
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            snapshot(i)
    if ckpt:
        ckpt.wait()
    if graphs:
        if verbose and rank0 and run.captures:
            cuts = (f", {run.segments} segments cut at {run.cuts} "
                    f"collectives" if layout is not None else "")
            print(f"CUDA graph captured in {run.capture_s:.2f} s "
                  f"({run.pool_bytes} B of pool{cuts})", flush=True)
        run.release()
    if layout is not None:
        state = gather_state(state, layout)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn on this host (a (data, model) "
                         "mesh over them)")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.smoke, args.steps, args.batch,
                      args.seq, args.lr, args.accum, args.ckpt_dir,
                      args.ckpt_every, args.resume, args.seed,
                      log_every=args.log_every, device=args.device,
                      world=args.world)
    print(f"final ce: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
