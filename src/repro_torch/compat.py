"""Version shims for torch's drift: the counterpart of ``repro/compat.py``.

The reference papers over jax's moves (``shard_map``, ``AbstractMesh``,
``set_mesh``); the port papers over torch's:

* :func:`all_gather_single` -- ``dist.all_gather_single`` where torch has
  it (2.10 and later deprecate ``all_gather_into_tensor`` in its favour),
  else ``dist.all_gather_into_tensor``;
* :func:`fake_store` and :func:`fake_tensor_mode` -- the in-process store
  of the ``fake`` process-group backend and ``FakeTensorMode``, from
  wherever this torch keeps them (the dry run's 256 or 512 ranks are one
  process posing as rank 0);
* :func:`flop_counter` -- ``FlopCounterMode`` and
  ``register_flop_formula``;
* :data:`MM_OUT_DTYPE` -- whether ``torch.mm`` takes ``out_dtype``
  (torch 2.8 and later: cuBLAS's GEMM of bf16 or f16 operands with an
  f32 result), and :func:`f32_product_route`, the route
  :func:`~repro_torch.launch.partition.f32_product` takes on a device.

The port does not use DTensor: its shards are plain tensors cut by
:mod:`repro_torch.launch.partition`, so ``torch.distributed.tensor``
against ``torch.distributed._tensor`` needs no shim.
"""
from __future__ import annotations

import importlib
from typing import Any, Tuple

import torch
import torch.distributed as dist


def all_gather_single(out: torch.Tensor, x: torch.Tensor, group=None
                      ) -> None:
    """Every rank's ``x`` concatenated along dim 0 into ``out``, in rank
    order."""
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


def _first(paths, name: str) -> Any:
    for mod in paths:
        try:
            return getattr(importlib.import_module(mod), name)
        except (ImportError, AttributeError):
            continue
    raise ImportError(f"{name} is in none of {paths}")


def fake_store():
    """A new ``FakeStore`` for ``init_process_group("fake", ...)``."""
    return _first(("torch.testing._internal.distributed.fake_pg",
                   "torch.distributed._fake_pg"), "FakeStore")()


def fake_tensor_mode(**kw):
    """A new ``FakeTensorMode``."""
    return _first(("torch._subclasses.fake_tensor",
                   "torch._subclasses"), "FakeTensorMode")(**kw)


def flop_counter() -> Tuple[Any, Any]:
    """``(FlopCounterMode, register_flop_formula)``."""
    mod = importlib.import_module("torch.utils.flop_counter")
    return mod.FlopCounterMode, mod.register_flop_formula


def torch_version() -> Tuple[int, int]:
    """(major, minor) of this torch."""
    major, minor = torch.__version__.split("+")[0].split(".")[:2]
    return int(major), int(minor)


MM_OUT_DTYPE = (torch_version() >= (2, 8)
                and hasattr(torch.ops.aten.mm, "dtype"))


def f32_product_route(device: torch.device) -> str:
    """``"mm out_dtype"`` where the card's GEMM returns its f32
    accumulator, ``"f32 operands"`` where the operands are cast to f32
    first (the CPU, and a torch before 2.8; the CPU has no kernel for
    ``mm.dtype``)."""
    if torch.device(device).type == "cuda" and MM_OUT_DTYPE:
        return "mm out_dtype"
    return "f32 operands"
