"""LR schedules: cosine (default), WSD (minicpm's warmup-stable-decay) and
constant.

Port of ``repro/optim/schedules.py``, in f32 as the reference computes
them. ``cos``, ``log`` and ``exp`` are the f64 functions rounded once to
f32, so the CPU and the card give the same bits; XLA's f32 functions may
sit an ulp away (ROADMAP Queue C). A schedule takes the step as an int, a
float or a 0-d tensor and returns a 0-d f32 tensor on the step's device
(the CPU for a Python number). Every divisor is a tensor on that device:
CUDA divides by a host scalar as a product with its reciprocal, which can
round otherwise.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from .. import rand


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` filled as f32 on ``like``'s device (a CUDA graph captures the
    fill, where it refuses the copy from host memory)."""
    return rand.const(v, torch.float32, like.device)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int = 100,
                  final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = _step(step)
        warm = _f32(base_lr, step) * step / _f32(max(warmup_steps, 1), step)
        t = (step - float(warmup_steps)) / _f32(
            max(total_steps - warmup_steps, 1), step)
        t = torch.clamp(t, 0.0, 1.0)
        cos = torch.cos((_f32(math.pi, step) * t).double()).float()
        cos = _f32(final_frac, step) + _f32(
            (1 - final_frac) * 0.5, step) * (1 + cos)
        return torch.where(step < warmup_steps, warm,
                           _f32(base_lr, step) * cos)

    return lr


def wsd(base_lr: float, total_steps: int, warmup_steps: int = 100,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, a long flat stage, a
    short decay, linear in log, over the last ``decay_frac``."""
    decay_start = int(total_steps * (1 - decay_frac))

    def lr(step):
        step = _step(step)
        warm = _f32(base_lr, step) * step / _f32(max(warmup_steps, 1), step)
        t = (step - float(decay_start)) / _f32(
            max(total_steps - decay_start, 1), step)
        t = torch.clamp(t, 0.0, 1.0)
        log_final = torch.log(_f32(final_frac, step).double()).float()
        decay = _f32(base_lr, step) * torch.exp(
            (log_final * t).double()).float()
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < decay_start,
                                       _f32(base_lr, step), decay))

    return lr


def constant(base_lr: float) -> Callable:
    def lr(step):
        return _f32(base_lr, _step(step))

    return lr


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_steps: int = 100) -> Callable:
    if kind == "cosine":
        return warmup_cosine(base_lr, total_steps, warmup_steps)
    if kind == "wsd":
        return wsd(base_lr, total_steps, warmup_steps)
    if kind == "constant":
        return constant(base_lr)
    raise ValueError(f"unknown schedule {kind!r}")
