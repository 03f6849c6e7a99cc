"""Snapshots of the port's run state, in the reference's on-disk layout."""
from .checkpointer import (Checkpointer, latest_step, restore, save,
                           sweep_tmp)

__all__ = ["Checkpointer", "save", "restore", "latest_step", "sweep_tmp"]
