"""Training driver: synthetic data -> train loop -> checkpoints.

Port of ``repro/launch/train.py`` on one device (the reference's mesh on
one card is (1, 1); its shardings are not ported, ROADMAP Queue A item
14). The same code runs the smoke configs on the CPU and the published
ones on the card. ``--resume`` picks up the latest checkpoint (parameters,
optimizer and the data step) and continues bit for bit.

On the card (minicpm-2b at its published size):

    python -m repro_torch.launch.train --arch minicpm-2b --full \\
        --steps 6 --batch 8 --seq 512

and on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --smoke --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
        --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import convert
from .._device import DeviceLike, resolve_device
from ..checkpoint import Checkpointer, latest_step, restore
from ..configs import ARCHS, get_config
from ..data import ShardedLoader, SyntheticLM
from ..models import build_model
from ..optim import make_schedule
from .steps import init_train_state, make_train_step


def train(arch: str, smoke: bool = True, steps: int = 100, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, accum: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          resume: bool = False, seed: int = 0, log_every: int = 10,
          verbose: bool = True, device: DeviceLike = None,
          on_step=None):
    """Train ``arch`` for ``steps`` steps; returns (state, per-step ce).

    The weights are drawn on the device from a generator seeded ``seed``;
    after that the module keeps only their shapes (the state holds them).
    A checkpoint ``{"state", "data_step"}`` is written every
    ``ckpt_every`` steps and at the end. ``on_step(i, state, metrics)``,
    when given, is called after each step (the timing hook of the chip
    check)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, dev, torch.Generator(device=dev).manual_seed(
        seed))
    state = init_train_state(model)
    model.to_empty(device="meta")        # the state holds the weights
    schedule = make_schedule(cfg.schedule, lr, steps, warmup_steps=min(
        20, steps // 5 + 1))
    step_fn = make_train_step(model, schedule=schedule, accum_steps=accum)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed, device=dev)
    loader = ShardedLoader(data)
    ckpt = Checkpointer(ckpt_dir, keep=3) if ckpt_dir else None

    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        blob = restore(ckpt_dir, target={"state": state, "data_step": 0})
        state = convert.to_device(blob["state"], dev)
        start = int(blob["data_step"])
        loader.load_state_dict({"step": start})
        if verbose:
            print(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for i in range(start, steps):
        batch_i = loader.next()
        state, metrics = step_fn(state, batch_i)
        losses.append(float(metrics["ce"]))
        if on_step is not None:
            on_step(i, state, metrics)
        if verbose and (i % log_every == 0 or i == steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {i:5d} ce={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} [{dt:.1f}s]")
        if ckpt and ((i + 1) % ckpt_every == 0 or i == steps - 1):
            ckpt.save_async(i + 1, {"state": state, "data_step": i + 1})
    if ckpt:
        ckpt.wait()
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
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.smoke, args.steps, args.batch,
                      args.seq, args.lr, args.accum, args.ckpt_dir,
                      args.ckpt_every, args.resume, args.seed,
                      device=args.device)
    print(f"final ce: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
