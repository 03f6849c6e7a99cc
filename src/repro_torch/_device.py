"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` argument they resolve to ``cuda`` and raise when no card is
visible. They never drop to the CPU on their own.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; anything else is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def as_device(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a tensor of ``dtype`` on ``device``: a tensor is cast
    and moved, a Python value is filled there. A CUDA graph captures the
    fill, where it refuses the copy from host memory that
    ``torch.as_tensor`` makes of a Python value."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if isinstance(value, (bool, int, float)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)
