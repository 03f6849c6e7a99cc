"""Logical axes -> mesh specs: the port of ``repro/launch/shardings.py``.

Model code names every dim of every parameter, cache and input with a
*logical* axis (``Model.param_axes()``, ``cache_specs(axes_maker(),
...)``, :func:`repro_torch.launch.input_specs.input_specs`). These rules
turn (axes, shape) into a *spec*: a tuple with an entry per dim, None (the
dim is whole on every rank), a mesh axis name, or a tuple of names (the
dim cut over those axes, the first the slowest). A spec equals the
reference's ``PartitionSpec`` entry for entry; pure Python over an
abstract :class:`~repro_torch.launch.mesh.Mesh`.

A dim that does not divide is replicated rather than padded, and a mesh
axis shards at most one dim, earlier dims claiming first.

Modes, as the reference's:

* ``train`` -- tensor-parallel parameters over ``model``, the batch over
  the data axes (``pod``, ``data``), and from 25 B parameters up the
  weights also over ``data`` (FSDP, :func:`fsdp_train`); the optimizer
  state further cut over ``data`` (ZeRO-1, :func:`zero1_pspec`);
* ``train_dp`` -- pure data parallelism over every axis, the weights over
  (``data``, ``model``) and gathered a layer at a time;
* ``serve`` -- the weights over (``data``, ``model``), the KV caches over
  the batch and the kv heads, or the cache's sequence where the kv heads
  do not divide ``model``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..models.common import ModelConfig
from ..optim import AdamWState
from .mesh import Mesh, axis_size, dp_axes

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
MODES = ("train", "train_dp", "serve")


def _fits(dim: int, mesh: Mesh, axes) -> bool:
    return dim > 0 and dim % axis_size(mesh, axes) == 0


def fsdp_train(cfg: ModelConfig) -> bool:
    """Archs of 25 B parameters and more also shard their weights over
    ``data`` in training (tensor parallelism alone leaves them too large
    a rank)."""
    total, _ = cfg.param_count()
    return total >= 25e9


def _rules(cfg: ModelConfig, mesh: Mesh, mode: str) -> Dict[Any, Any]:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    dp = dp_axes(mesh)
    # caches cut the kv-head dim where it divides the model axis, else
    # the cache's sequence takes the model axis
    kv_shardable = cfg.n_kv_heads % mesh.shape["model"] == 0
    has_data = "data" in mesh.axis_names
    if mode == "train_dp":
        full = dp + ("model",)
        wide = ("data", "model") if has_data else ("model",)
        return {
            "embed": wide, "vocab": wide, "heads": wide, "kv": wide,
            "ff": wide, "experts": ("model",), "layers": None,
            "batch": full,
            "kv_head": None, "cache_seq": None, "heads_only": None,
            None: None,
        }
    wide_serve = mode == "serve" and has_data
    wide_train = mode == "train" and has_data and fsdp_train(cfg)
    wide = ("data", "model") if (wide_serve or wide_train) else ("model",)
    return {
        "embed": ("data",) if (wide_serve or wide_train) else None,
        "vocab": ("model",),
        "heads": wide,
        "kv": wide if mode == "serve" else ("model",),
        "ff": wide,
        "experts": ("model",),
        "layers": None,
        "batch": dp,
        "kv_head": ("model",) if kv_shardable else None,
        "cache_seq": None if kv_shardable else ("model",),
        "heads_only": ("model",),
        None: None,
    }


def pspec(axes, shape, cfg: ModelConfig, mesh: Mesh,
          mode: str = "train") -> Spec:
    """The spec of one tensor of logical ``axes`` and ``shape``."""
    rules = _rules(cfg, mesh, mode)
    entries = []
    used: set = set()
    for name, dim in zip(axes, shape):
        target = rules.get(name)
        if target is None:
            entries.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        # a mesh axis cuts at most one dim; earlier dims claim first
        target = tuple(a for a in target if a not in used)
        if target and _fits(dim, mesh, target):
            entries.append(target if len(target) > 1 else target[0])
            used.update(target)
        elif len(target) > 1 and _fits(dim, mesh, target[-1:]):
            entries.append(target[-1])
            used.add(target[-1])
        else:
            entries.append(None)
    return tuple(entries)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching)`` over the leaves of ``tree`` (dicts, lists
    and tuples are nodes, None stays None, anything else is a leaf), the
    other trees read at the same places (an axes or spec tree's leaves
    are its tuples)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *z) for z in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)


def tree_pspecs(axes_tree: Any, shape_tree: Any, cfg: ModelConfig,
                mesh: Mesh, mode: str = "train") -> Any:
    """The specs of matching (axes, stand-in) trees; a stand-in is any
    object with a ``shape``."""
    return tree_map(lambda sh, ax: pspec(tuple(ax), tuple(sh.shape), cfg,
                                         mesh, mode), shape_tree, axes_tree)


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer state's specs
# ---------------------------------------------------------------------------
def _flat(spec: Spec):
    return [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]


def zero1_pspec(param_spec: Spec, shape, mesh: Mesh) -> Spec:
    """A parameter's spec with ``data`` added on its largest replicated
    dim that divides (optimizer-state sharding, ZeRO stage 1); as it was
    where the spec already holds ``data`` (FSDP) or no dim fits."""
    if "data" not in mesh.axis_names:
        return tuple(param_spec)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if "data" in _flat(entries):
        return tuple(param_spec)
    best, best_dim = -1, 0
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % mesh.shape["data"] == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        entries[best] = "data"
    return tuple(entries)


def opt_state_pspecs(param_pspecs: Dict[str, Spec],
                     param_shapes: Dict[str, Any], mesh: Mesh,
                     zero1: bool = True) -> AdamWState:
    """The AdamW state's specs from the parameters' (dicts by name): the
    moments, and the f32 master where some parameter is not f32, on the
    ZeRO-1 layout; the step replicated."""
    moment = {k: (zero1_pspec(s, tuple(param_shapes[k].shape), mesh)
                  if zero1 else tuple(s)) for k, s in param_pspecs.items()}
    has_master = any(s.dtype != torch.float32 for s in param_shapes.values())
    return AdamWState(m=moment, v=dict(moment),
                      master=dict(moment) if has_master else None, step=())


def batch_pspecs(batch_specs: Dict[str, Any], mesh: Mesh,
                 mode: str = "train") -> Dict[str, Spec]:
    """Inputs: the batch dim over the data axes where it divides (every
    axis in ``train_dp``), else replicated."""
    dp = dp_axes(mesh) + (("model",) if mode == "train_dp" else ())
    out = {}
    for k, v in batch_specs.items():
        shape = tuple(v.shape)
        if not shape:
            out[k] = ()
            continue
        lead: Entry = None
        for cand in (dp, dp_axes(mesh), ("data",)):
            if all(a in mesh.axis_names for a in cand) \
                    and shape[0] % axis_size(mesh, cand) == 0:
                lead = cand
                break
        if isinstance(lead, tuple) and len(lead) == 1:
            lead = lead[0]
        out[k] = (lead,) + (None,) * (len(shape) - 1)
    return out


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec cuts over, in its dims' order."""
    return tuple(_flat(spec))


def local_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """A rank's shard shape (the reference's ``shard_shape``)."""
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        out.append(dim if e is None else dim // axis_size(
            mesh, e if isinstance(e, tuple) else (e,)))
    return tuple(out)


def mode_for(kind: str, sharding: str = "auto") -> str:
    """The rules' mode of a step kind (train, prefill, decode)."""
    if kind == "train":
        return "train_dp" if sharding == "dp" else "train"
    return "serve"

