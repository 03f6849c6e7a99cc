"""Dry run of the production meshes: does each (arch x shape x mesh) cell
fit one rank's card? The port of ``repro/launch/dryrun.py``, without a
card.

One process poses as rank 0 of the production mesh: it joins a ``fake``
process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, builds the
cell's inputs (:mod:`repro_torch.launch.input_specs`) and this rank's
blocks of the parameters, the optimizer state and the inputs
(:mod:`repro_torch.launch.shardings`), all as ``FakeTensorMode`` tensors
with no storage, and runs the step (train, prefill or decode) once on
them through the same code that runs on the card. Per cell it records:

* ``argument_bytes``: the bytes of this rank's blocks of every argument
  (by construction the reference's ``argument_size_in_bytes``);
* ``temp_bytes``: the peak of the bytes the step holds beyond its
  arguments, from a dispatch mode that tracks the live fake storages;
* ``flops_per_device``: ``FlopCounterMode``'s count (the flash-attention
  and WKV kernels are custom ops with their own formulas, so the plain
  versions' score matrices never appear);
* ``collective_bytes_per_device``: bytes per kind, counted at the
  collectives of :mod:`repro_torch.launch.partition` with the
  reference's ring factors;
* ``accum`` (:func:`accum_for`; ``accum_run`` the microbatches that ran,
  fewer where a rank holds fewer rows) and ``sharding`` (``dp``: pure
  data parallelism, ``train_dp``).

A train step of ``n`` > 3 microbatches is traced at 2 and at 3
(``accum_traced``; ``--exact`` traces all ``n``): the microbatches are
alike, so the FLOPs and each collective's bytes are ``x(2) + (n - 2)
(x(3) - x(2))``, exactly, and the peak is the larger of the two (from
the second microbatch on, each holds the same: the f32 accumulator, one
microbatch's activations and its gradients).

The verdict is against the card's memory: ``--device-bytes``, else
``torch.cuda.get_device_properties(0).total_memory`` where a card is
visible (its name and power limit recorded beside it), else none.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
Writes a JSON per cell under ``--out`` (``build/dryrun_torch/``).
``--all`` runs both meshes and every cell but :data:`SLOW_CELLS`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .. import compat
from ..configs import ARCHS, get_config
from ..core.sharded import ShardGroup
from ..models import Model
from ..optim import AdamWState, make_schedule
from . import partition, shardings
from . import steps as steps_lib
from .input_specs import SHAPES, cell_supported, input_specs
from .mesh import Mesh, make_production_mesh

OUT_DIR = os.path.join("build", "dryrun_torch")
# cells ``--all`` leaves out (named with ``--archs``/``--shapes`` they run):
# rwkv6-3b trains through the plain sequential WKV (the kernel has no
# backward), whose trace is 4,096 steps a layer and microbatch, over two
# hours of CPU a mesh
SLOW_CELLS = {("rwkv6-3b", "train_4k"): "the sequential WKV's training "
              "trace takes over two hours of CPU; --archs rwkv6-3b "
              "--shapes train_4k runs it"}


def accum_for(cfg) -> int:
    """Gradient-accumulation microbatches for train_4k (the reference's
    memory policy)."""
    if cfg.d_model >= 8192 or (cfg.is_moe and cfg.d_model >= 6144):
        return 16
    if cfg.d_model >= 4096 or cfg.is_moe or cfg.family == "hybrid":
        return 8
    return 4


class LiveBytes(TorchDispatchMode):
    """The peak of the bytes of the storages made by the ops it sees that
    are still alive (a storage is counted once, however many tensors view
    it, and freed when the last of them is)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _drop(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[key]

    def _seen(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        known = set()
        for a in list(args) + list((kwargs or {}).values()):
            if isinstance(a, torch.Tensor):
                known.add(id(a))
        stack = [out]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                # meta tensors are stand-ins (the rules' shapes), no memory
                if id(x) not in known and x.device.type != "meta":
                    self._seen(x)
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        return out


def _nbytes(tree) -> int:
    total = [0]

    def add(t):
        total[0] += t.numel() * t.element_size()
        return t

    partition.tree_map(add, tree)
    return total[0]


def _local_empty(shape, spec, mesh, dtype) -> torch.Tensor:
    return torch.empty(shardings.local_shape(shape, spec, mesh), dtype=dtype)


def fake_world(size: int) -> ShardGroup:
    """Rank 0 of a ``fake`` process group of ``size`` ranks (this
    process's default group)."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks "
                               f"is already initialized")
    else:
        dist.init_process_group("fake", store=compat.fake_store(), rank=0,
                                world_size=size)
    return ShardGroup(0, size, torch.device("cpu"), pg=None, backend="fake")


def run_cell(arch: str, shape: str, mesh: Mesh, *, sharding: str = "auto",
             accum: Optional[int] = None, smoke: bool = False,
             batch: Optional[int] = None, seq: Optional[int] = None,
             layers: Optional[int] = None, exact: bool = False,
             mesh_name: str = "") -> Dict[str, Any]:
    """One cell on a bound ``mesh`` (rank 0 of a fake group). ``smoke``,
    ``batch``, ``seq`` and ``layers`` (the depth) shrink the cell (the
    tests' small meshes, the chip check's cells)."""
    cfg = get_config(arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    ok, why = cell_supported(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "mesh": mesh_name or "x".join(
                               str(mesh.shape[a]) for a in mesh.axis_names),
                           "supported": ok, "skip_reason": why,
                           "sharding": sharding}
    if not ok:
        return rec
    info = dict(SHAPES[shape])
    info["batch"] = batch or info["batch"]
    info["seq"] = seq or info["seq"]
    kind = info["kind"]
    mode = shardings.mode_for(kind, sharding)
    model = Model(cfg, device="meta")
    specs, axes = input_specs(cfg, model, shape, batch=info["batch"],
                              seq=info["seq"])
    layout = partition.param_layout(model, mesh, mode)
    t0 = time.perf_counter()
    counter_cls, _ = compat.flop_counter()
    with compat.fake_tensor_mode(allow_non_fake_inputs=True):
        params = {n: _local_empty(layout.shapes[n], layout.specs[n], mesh,
                                  cfg.param_dtype) for n in layout.specs}
        if kind == "train":
            n_acc = accum if accum is not None else accum_for(cfg)
            rec["accum"] = n_acc
            abstract = steps_lib.abstract_train_state(model)
            opt = abstract.opt

            def opt_tree(tree):
                return None if tree is None else {
                    n: _local_empty(layout.shapes[n], layout.opt[n], mesh,
                                    torch.float32) for n in tree}

            state = steps_lib.TrainState(params, AdamWState(
                m=opt_tree(opt.m), v=opt_tree(opt.v),
                master=opt_tree(opt.master),
                step=torch.zeros((), dtype=torch.int32)))
            bspecs = shardings.batch_pspecs(specs, mesh, mode)
            inputs = {k: _local_empty(tuple(v.shape), bspecs[k], mesh,
                                      v.dtype) for k, v in specs.items()}
            args_bytes = _nbytes(state) + _nbytes(inputs)
            # the port splits a rank's rows into the microbatches: where
            # it holds fewer rows than the policy's microbatches (dbrx and
            # the vision model on 2 x 16 x 16: 8 rows, 16 microbatches),
            # each microbatch is one row
            rows = inputs["tokens"].shape[0]
            if rows % n_acc:
                n_acc = math.gcd(rows, n_acc)
            rec["accum_run"] = n_acc
            traced = [n_acc] if exact or n_acc <= 3 else [2, 3]
            rec["accum_traced"] = traced
            per = rows // n_acc

            def run(n):
                step = steps_lib.make_train_step(
                    model, schedule=make_schedule(cfg.schedule, 3e-4,
                                                  10_000),
                    accum_steps=n,
                    remat_mode="layer" if cfg.n_layers < 40 else "nested",
                    mesh=mesh, mode=mode)
                return step(state, {k: v[:n * per]
                                    for k, v in inputs.items()})
        else:
            rec["accum"] = 1
            partition.load_local(model, layout, params)
            args_bytes = _nbytes(params)
            B = info["batch"]
            if kind == "prefill":
                bspecs = shardings.batch_pspecs(specs, mesh, mode)
                inputs = {k: _local_empty(tuple(v.shape), bspecs[k], mesh,
                                          v.dtype) for k, v in specs.items()}
                args_bytes += _nbytes(inputs)
                step = steps_lib.make_prefill_step(
                    model, mesh=mesh, mode=mode, batch=B, use_flash=True,
                    use_rwkv_kernel=True)
                run = lambda n: step(inputs)  # noqa: E731
            else:
                ctx = info["seq"]
                tree = {k: v for k, v in specs.items() if k != "index"}
                cspecs = shardings.tree_pspecs(
                    {k: axes[k] for k in tree}, tree, cfg, mesh, mode)
                bspecs = shardings.batch_pspecs({"token": specs["token"]},
                                                mesh, mode)
                cspecs["token"] = bspecs["token"]
                inputs = partition.tree_map(
                    lambda v, s: _local_empty(tuple(v.shape), s, mesh,
                                              v.dtype), tree, cspecs)
                args_bytes += _nbytes(inputs)
                step = steps_lib.make_decode_step(
                    model, mesh=mesh, mode=mode, batch=B, max_seq=ctx)
                inputs["index"] = ctx - 1 + cfg.n_meta_tokens
                run = lambda n: step(inputs)  # noqa: E731
            traced = [1]
        reads = []
        for n in traced:
            partition.reset_collectives()
            live = LiveBytes()
            with live, counter_cls(display=False) as flops:
                run(n)
            reads.append((float(flops.get_total_flops()),
                          partition.reset_collectives(), live.peak))
    if len(reads) == 1:
        total_flops, coll, peak = reads[0]
    else:
        # x(n) = x(2) + (n - 2) (x(3) - x(2)): microbatches are alike
        (f2, c2, p2), (f3, c3, p3) = reads
        more = rec["accum_run"] - 2
        total_flops = f2 + more * (f3 - f2)
        coll = {k: c2.get(k, 0.0) + more * (c3.get(k, 0.0) - c2.get(k, 0.0))
                for k in set(c2) | set(c3)}
        peak = max(p2, p3)
    rec.update(
        run_s=round(time.perf_counter() - t0, 2),
        argument_bytes=int(args_bytes),
        temp_bytes=int(peak),
        peak_bytes_per_device=int(args_bytes + peak),
        flops_per_device=float(total_flops),
        collective_bytes_per_device=coll,
    )
    return rec


def card_memory() -> Dict[str, Any]:
    """The visible card's name, memory and power limit, or {}."""
    if not torch.cuda.is_available():
        return {}
    props = torch.cuda.get_device_properties(0)
    out = {"device": props.name, "device_bytes": int(props.total_memory)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def verdict(rec: Dict[str, Any], card: Dict[str, Any]) -> None:
    if "peak_bytes_per_device" in rec and card.get("device_bytes"):
        rec["fits"] = rec["peak_bytes_per_device"] <= card["device_bytes"]
    rec.update({k: v for k, v in card.items()})


def summary(rec: Dict[str, Any]) -> str:
    if not rec.get("supported"):
        return f"[skip] {rec['arch']} x {rec['shape']} x {rec['mesh']}: " \
               f"{rec['skip_reason']}"
    gib = 2 ** 30
    co = rec["collective_bytes_per_device"].get("total", 0.0)
    fit = ("" if "fits" not in rec else
           f" of {rec['device_bytes'] / gib:.2f} GiB "
           f"({'fits' if rec['fits'] else 'does not fit'})")
    return (f"[ok]   {rec['arch']} x {rec['shape']} x {rec['mesh']}"
            f" ({rec['sharding']}): peak/rank "
            f"{rec['peak_bytes_per_device'] / gib:.2f} GiB{fit} = arg "
            f"{rec['argument_bytes'] / gib:.2f} + temp "
            f"{rec['temp_bytes'] / gib:.2f}; "
            f"{rec['flops_per_device'] / 1e12:.2f} TFLOP, "
            f"{co / gib:.3f} GiB wire; accum {rec['accum']}; "
            f"{rec['run_s']} s")


def save(rec: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    tag = rec["sharding"] if rec["sharding"] != "auto" else ""
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}" + (
        f"_{tag}" if tag else "") + ".json"
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--archs", default=None,
                    help="comma-separated archs (with --shapes: those cells)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shapes")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--sharding", choices=["auto", "dp"], default="auto")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL instead of the production mesh (a "
                         "small world for tests)")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="the depth, cut (the width stays)")
    ap.add_argument("--exact", action="store_true",
                    help="trace every microbatch of a train step (by "
                         "default 2 and 3 of them, the rest extrapolated)")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="the card's memory (default: read on the card)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        meshes = [(Mesh((d, m), ("data", "model")), args.mesh)]
    else:
        pods = ([False, True] if (args.both_meshes or args.all)
                else [args.multi_pod])
        meshes = [(make_production_mesh(multi_pod=mp),
                   "2x16x16" if mp else "16x16") for mp in pods]
    skipped = {}
    if args.all or args.archs or args.shapes:
        archs = args.archs.split(",") if args.archs else ARCHS
        shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
        if args.all and not (args.archs or args.shapes):
            skipped = {c: SLOW_CELLS[c] for c in cells if c in SLOW_CELLS}
            cells = [c for c in cells if c not in skipped]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, --archs/--shapes, or --all")
        cells = [(args.arch, args.shape)]
    card = card_memory()
    if args.device_bytes:
        card["device_bytes"] = args.device_bytes
    if card:
        print(f"card: {card}")
    for (arch, shape), why in skipped.items():
        print(f"[cut]  {arch} x {shape}: {why}")
    failures = 0
    # one fake group a process: the largest mesh's, the others bound to
    # a prefix of it is not possible, so each mesh size runs in turn
    for mesh, name in meshes:
        world = fake_world(mesh.size)
        bound = mesh.bind(world)
        for arch, shape in cells:
            try:
                rec = run_cell(arch, shape, bound, sharding=args.sharding,
                               accum=args.accum, smoke=args.smoke,
                               batch=args.batch, seq=args.seq,
                               layers=args.layers, exact=args.exact,
                               mesh_name=name)
                verdict(rec, card)
                save(rec, args.out)
                print(summary(rec), flush=True)
            except Exception as e:  # noqa: BLE001 -- reported per cell
                failures += 1
                print(f"[FAIL] {arch} x {shape} x {name}: "
                      f"{type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
