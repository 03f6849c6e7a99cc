"""Checkpoint and restart of a tree of arrays (an experiment's islands,
pool, async state, keys, counters), with numpy and json only.

The port of ``repro.checkpoint.checkpointer`` with the same on-disk
layout, so a snapshot written by either package restores in the other::

    <dir>/step_00000042/
        manifest.json      {step, meta, keys: {path: {file, shape, dtype,
                                                      prng_impl}}}
        leaf_00000.npy     one file per leaf: its raw bytes as uint8
    <dir>/step_00000042.tmp  (the build directory, renamed when complete)

A tree is ``NamedTuple``s (their field names), tuples and lists
(``[i]``) and dicts (their keys, sorted) down to array leaves; a leaf's
path is its names joined by ``::`` (``islands::pop``), and the leaves are
numbered in the sorted order of their paths. ``()`` and ``None`` hold no
leaf. A leaf named ``rng`` or ``key`` is a Threefry key: its words are
stored as uint32 with ``prng_impl`` ``"threefry2x32"``, as the reference
stores ``jax.random.key_data`` of its keys.

Leaves may be numpy arrays or tensors on any device. numpy has no
bfloat16, so a bf16 tensor is held as its bits (:class:`BF16Bits`, an
int16 array) and written with the dtype ``bfloat16``, as the reference
writes its bf16 leaves; such a leaf restores as :class:`BF16Bits`, which
:func:`repro_torch.convert.to_device` turns back into bf16.
:meth:`Checkpointer.save_async` copies the leaves to host numpy on the
caller's thread before its writer thread starts, so the caller may go on
changing its tensors. :func:`restore` returns numpy
arrays (keys as their uint32 words); the caller puts them on a device.
The copy is the ``checkpoint.snapshot`` trace span, the write on the
writer thread ``checkpoint.write`` (:mod:`repro_torch.obs.trace`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..obs import trace as obs_trace

_SEP = "::"
_KEY_NAMES = ("rng", "key")
_PRNG_IMPL = "threefry2x32"


class BF16Bits(np.ndarray):
    """The bits of a bf16 array as int16 (numpy has no bfloat16)."""


def bf16_bits(t) -> "BF16Bits":
    """A host copy of a bf16 tensor's bits."""
    return t.detach().view(_torch().int16).cpu().numpy().copy().view(
        BF16Bits)


def _torch():
    import torch
    return torch


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs in the tree's own order."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (f"[{i}]",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, Any]:
    return {_SEP.join(p): leaf for p, leaf in _leaves(tree)}


def _rebuild(tree, flat: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with the leaves of ``flat``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, flat, prefix + (name,))
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, flat, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    return flat[_SEP.join(prefix)]


def _is_key(path: str) -> bool:
    return path.split(_SEP)[-1] in _KEY_NAMES


def _host(path: str, leaf) -> np.ndarray:
    """A host copy of ``leaf`` that owns its bytes; key words as uint32,
    bf16 tensors as their bits."""
    if hasattr(leaf, "detach"):
        if str(leaf.dtype) == "torch.bfloat16":
            return bf16_bits(leaf)
        leaf = leaf.detach().cpu().numpy()
    if isinstance(leaf, BF16Bits):
        return leaf.copy()
    arr = np.array(leaf, copy=True)
    if _is_key(path) and np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.uint32)
    return arr


def _host_tree(tree) -> Dict[str, np.ndarray]:
    return {path: _host(path, leaf) for path, leaf in _flatten(tree).items()}


def _write(directory: str, step: int, flat: Dict[str, np.ndarray],
           meta: Optional[Dict], keep: Optional[int]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "meta": meta or {}, "keys": {}}
    for i, (path, arr) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname),
                np.frombuffer(np.ascontiguousarray(arr).tobytes(),
                              dtype=np.uint8))
        key = _is_key(path) and arr.dtype == np.uint32
        dtype = "bfloat16" if isinstance(arr, BF16Bits) else str(arr.dtype)
        manifest["keys"][path] = {"file": fname, "shape": list(arr.shape),
                                  "dtype": dtype,
                                  "prng_impl": _PRNG_IMPL if key else None}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    if keep:
        _gc(directory, keep)
    return final


def save(directory: str, step: int, tree, meta: Optional[Dict] = None,
         keep: Optional[int] = None) -> str:
    """Blocking save; returns the published checkpoint's path."""
    return _write(directory, step, _host_tree(tree), meta, keep)


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(directory: str, keep: int) -> None:
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest published step. A ``step_*.tmp`` build directory (a
    writer killed mid-save) and a step directory without its manifest are
    never candidates."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def sweep_tmp(directory: str) -> List[str]:
    """Remove the ``step_*.tmp`` build directories a writer killed
    mid-save left behind, and return their paths. Safe only while no
    writer is live (:class:`Checkpointer` calls it when it is made)."""
    removed = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if re.fullmatch(r"step_\d+\.tmp", name):
                path = os.path.join(directory, name)
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
    return removed


def _load(path: str, info: Dict) -> np.ndarray:
    raw = np.load(os.path.join(path, info["file"]))
    bf16 = info["dtype"] == "bfloat16"
    dtype = np.dtype(np.int16 if bf16 else info["dtype"])
    shape = tuple(info["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if raw.dtype != np.uint8 or raw.size != want:
        raise ValueError(f"{info['file']}: {raw.size} bytes, want {want} "
                         f"for {info['dtype']} {list(shape)} (truncated?)")
    arr = np.frombuffer(raw.tobytes(), dtype=dtype).reshape(shape)
    return arr.view(BF16Bits) if bf16 else arr


def restore(directory: str, step: Optional[int] = None,
            target: Any = None) -> Any:
    """Load a checkpoint (the latest when ``step`` is None).

    With ``target`` (a tree whose *structure* is wanted; its leaves are
    ignored, so a snapshot of another island count restores into it) the
    leaves come back in that structure; without, as a flat dict
    ``{path: array}``. A snapshot whose paths are not the target's
    raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {k: _load(path, info) for k, info in manifest["keys"].items()}
    if target is None:
        return flat
    want = _flatten(target)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint/target mismatch: missing="
                         f"{missing[:5]} extra={extra[:5]}")
    return _rebuild(target, flat)


class Checkpointer:
    """Snapshots on the caller's thread, writes on a background thread.

    :meth:`save_async` copies the tree to host numpy before it returns,
    so the caller's tensors may change at once; the file writes run on a
    worker thread. :meth:`wait` joins the writers and raises the first
    write error (once: a raised error is consumed)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pending: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        # a process killed mid-save leaves a step_*.tmp build directory;
        # no writer of ours is live yet, so it is safe to sweep here
        sweep_tmp(directory)

    def save_async(self, step: int, tree, meta: Optional[Dict] = None
                   ) -> None:
        with obs_trace.span("checkpoint.snapshot", step=step):
            flat = _host_tree(tree)

        def work():
            try:
                with obs_trace.span("checkpoint.write", step=step):
                    _write(self.directory, step, flat, meta, self.keep)
            except Exception as e:  # noqa: BLE001  -- raised at wait()
                self._errors.append(e)

        # drop finished writers, so a long run's list stays short
        self._pending = [p for p in self._pending if p.is_alive()]
        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._pending.append(t)

    def wait(self) -> None:
        for t in self._pending:
            t.join()
        self._pending.clear()
        if self._errors:
            errors, self._errors = self._errors, []
            raise errors[0]

    def restore_latest(self, target=None):
        self.wait()
        return restore(self.directory, None, target)
