"""Optimizer: AdamW with an f32 master, LR schedules, global-norm
clipping, and gradient compression for the cross-group mean."""
from .adamw import AdamWState, adamw_init, adamw_update
from .schedules import make_schedule
from .clip import clip_by_global_norm, global_norm

__all__ = ["AdamWState", "adamw_init", "adamw_update", "make_schedule",
           "clip_by_global_norm", "global_norm"]
