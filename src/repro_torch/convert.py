"""Carry state between the reference and the port, as numpy arrays.

The reference's state reaches this module as the same ``NamedTuple``
with numpy leaves and its keys as their data words (the caller applies
``jax.random.key_data`` and ``np.asarray``; nothing here imports JAX).
:func:`to_numpy` turns the port's state back into numpy, keys as uint32
words, for comparison with the reference. :func:`f15_consts_from_numpy`
carries F15's constants across, the weights of the float problems.
:func:`to_device` puts a whole tree of numpy arrays or tensors on a device
(a restored snapshot: its keys' uint32 words become the port's int64
words, bf16 bits bf16 tensors).

For the models, :func:`model_params_from_numpy` loads the reference's
parameter tree (numpy leaves, each segment's blocks stacked on a leading
``layers`` axis) into a port :class:`~repro_torch.models.Model`, and
:func:`caches_to_numpy` / :func:`caches_from_numpy` carry the decode
caches (per segment, a tuple of dicts of stacked arrays: RWKV states,
attention ring caches, hymba's ``{'attn', 'ssm'}`` pairs, None at
cross-attention positions) both ways, each leaf's dtype set by its name.
bf16 leaves go through f32, which holds them exactly.
:func:`train_state_from_numpy` carries the reference's ``TrainState``
(parameters, AdamW moments, master copy and step) into the port's, whose
trees are dicts by parameter name, one tensor a layer;
:func:`params_to_numpy` stacks such a dict back into the reference's tree.

The ``*_from_numpy`` helpers put their tensors on the card unless the
caller asks for another device, as every entry point of the port does
(``_device.resolve_device``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .checkpoint.checkpointer import BF16Bits, bf16_bits
from .core.types import ExperimentState, IslandState, PoolState
from .obs.counters import ObsCounters

_KEY_FIELDS = ("rng", "key")


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x)).to(dtype=dtype,
                                            device=resolve_device(device))


def key_from_numpy(words, device: DeviceLike = None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(words, dtype=np.uint32).astype(
        np.int64), device=resolve_device(device))


def _genome_dtype(x) -> torch.dtype:
    return torch.int8 if np.asarray(x).dtype == np.int8 else torch.float32


def f15_consts_from_numpy(consts: Mapping[str, Any],
                          device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """F15's ``o`` (D,), ``perm`` (D,) and ``M`` (G, m, m) as contiguous
    f32, int32 and f32 tensors on ``device`` (the kernels and
    ``index_select`` take int32 indices)."""
    return {"o": _tensor(consts["o"], torch.float32, device).contiguous(),
            "perm": _tensor(consts["perm"], torch.int32,
                            device).contiguous(),
            "M": _tensor(consts["M"], torch.float32, device).contiguous()}


def islands_from_numpy(isl: Any, device: DeviceLike = None) -> IslandState:
    """A batch of islands (leading axis) with reference dtypes."""
    g = _genome_dtype(isl.pop)
    i32 = torch.int32
    return IslandState(
        pop=_tensor(isl.pop, g, device),
        fitness=_tensor(isl.fitness, torch.float32, device),
        pop_size=_tensor(isl.pop_size, i32, device),
        rng=key_from_numpy(isl.rng, device),
        generation=_tensor(isl.generation, i32, device),
        evaluations=_tensor(isl.evaluations, i32, device),
        best_fitness=_tensor(isl.best_fitness, torch.float32, device),
        best_genome=_tensor(isl.best_genome, g, device),
        done=_tensor(isl.done, torch.bool, device),
        experiments=_tensor(isl.experiments, i32, device),
        uuid=_tensor(isl.uuid, i32, device),
    )


def pool_from_numpy(pool: Any, device: DeviceLike = None) -> PoolState:
    return PoolState(
        genomes=_tensor(pool.genomes, _genome_dtype(pool.genomes), device),
        fitness=_tensor(pool.fitness, torch.float32, device),
        ptr=_tensor(pool.ptr, torch.int32, device),
        count=_tensor(pool.count, torch.int32, device),
    )


def async_state_from_numpy(ast: Any, device: DeviceLike = None):
    """An ``AsyncState`` batch with reference dtypes (the inbox's genomes
    int8 or f32, as the genome)."""
    from .core.async_migration import AsyncState
    i32, f32 = torch.int32, torch.float32
    return AsyncState(
        clock=_tensor(ast.clock, f32, device),
        rate=_tensor(ast.rate, f32, device),
        down_start=_tensor(ast.down_start, i32, device),
        down_end=_tensor(ast.down_end, i32, device),
        inbox_genomes=_tensor(ast.inbox_genomes,
                              _genome_dtype(ast.inbox_genomes), device),
        inbox_fitness=_tensor(ast.inbox_fitness, f32, device),
        inbox_born=_tensor(ast.inbox_born, i32, device),
        inbox_ptr=_tensor(ast.inbox_ptr, i32, device),
        fires=_tensor(ast.fires, i32, device),
    )


def obs_from_numpy(obs: Any, device: DeviceLike = None) -> ObsCounters:
    return ObsCounters(*(_tensor(v, torch.int32, device) for v in obs))


def experiment_from_numpy(st: Any,
                          device: DeviceLike = None) -> ExperimentState:
    """An ``ExperimentState``: islands, pool, async state (or ``()``),
    key, epoch, stopped, next_uuid and counters (or ``()``); stats are
    left empty."""
    astate = getattr(st, "astate", ())
    obs = getattr(st, "obs", ())
    return ExperimentState(
        islands=islands_from_numpy(st.islands, device),
        pool=pool_from_numpy(st.pool, device),
        astate=(async_state_from_numpy(astate, device)
                if hasattr(astate, "_fields") else ()),
        key=key_from_numpy(st.key, device),
        epoch=_tensor(st.epoch, torch.int32, device),
        stopped=_tensor(st.stopped, torch.bool, device),
        stats=(),
        next_uuid=_tensor(st.next_uuid, torch.int32, device),
        obs=obs_from_numpy(obs, device) if hasattr(obs, "_fields") else (),
    )


def to_device(tree: Any, device: DeviceLike = None) -> Any:
    """Numpy arrays and tensors -> tensors on ``device`` through
    NamedTuples, tuples, lists and dicts; uint32 arrays (keys' words) become
    int64 words."""
    if isinstance(tree, torch.Tensor):
        return tree.to(resolve_device(device))
    if isinstance(tree, BF16Bits):
        return torch.from_numpy(np.array(tree, dtype=np.int16)).view(
            torch.bfloat16).to(resolve_device(device))
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.asarray(tree)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(resolve_device(device))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def to_numpy(tree: Any) -> Any:
    """Tensors -> numpy copies through NamedTuples, tuples and dicts; key
    fields become uint32 words, bf16 tensors their bits (``BF16Bits``)."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return bf16_bits(tree)
        a = tree.detach().cpu().numpy()
        # a CPU tensor's numpy view would follow its in-place updates
        return a.copy() if tree.device.type == "cpu" else a
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            to_numpy(v).astype(np.uint32) if name in _KEY_FIELDS
            and isinstance(v, torch.Tensor) else to_numpy(v)
            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------
def _from_numpy(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).astype(np.float32))).to(dtype=dtype, device=device)


def _load(dst: Any, src: Any, layer: Optional[int], where: str) -> None:
    if isinstance(dst, torch.Tensor):
        a = np.asarray(src)
        if layer is not None:
            a = a[layer]
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{where}: shape {a.shape}, want "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(_from_numpy(a, dst.dtype, dst.device))
        return
    if set(dst) != set(src):
        raise ValueError(f"{where}: keys {sorted(src)}, want {sorted(dst)}")
    for key in dst:
        _load(dst[key], src[key], layer, f"{where}.{key}")


def _load_tree(dst: Any, src: Any, where: str) -> None:
    """``_load`` over a model tree: a ``segments`` entry (the port's list
    over layers of each segment's blocks) takes the reference's stacked
    blocks layer by layer."""
    if not isinstance(dst, dict):
        _load(dst, src, None, where)
        return
    if set(dst) != set(src):
        raise ValueError(f"{where}: keys {sorted(src)}, want {sorted(dst)}")
    for key, sub in dst.items():
        if key != "segments":
            _load_tree(sub, src[key], f"{where}.{key}".lstrip("."))
            continue
        for si, seg in enumerate(sub):
            for layer, blocks in enumerate(seg):
                for j, block in enumerate(blocks):
                    _load(block, src[key][si][j], layer,
                          f"{where}.segments[{si}][{j}][layer {layer}]"
                          .lstrip("."))


def model_params_from_numpy(model, tree: Mapping[str, Any]) -> None:
    """Copy the reference's parameters (``Model.init``'s tree with numpy
    leaves) into ``model`` in place, layer by layer."""
    _load_tree(model.tree(), tree, "")


# cache leaves whose dtype is not the activations': the RWKV and SSM
# states and the ring caches' positions
CACHE_DTYPES = {"wkv": torch.float32, "h": torch.float32,
                "pos": torch.int32}


def _map_caches(fn, caches: List) -> List:
    """``fn(key, leaf)`` over every leaf of the caches (per segment, a
    tuple of nested dicts, None at cross-attention positions)."""
    def walk(key, c):
        if c is None:
            return None
        if isinstance(c, dict):
            return {k: walk(k, v) for k, v in c.items()}
        return fn(key, c)

    return [tuple(walk(None, c) for c in seg) for seg in caches]


def caches_to_numpy(caches: List) -> List:
    """The port's caches as numpy (bf16 as f32), in the reference's
    layout."""
    return _map_caches(lambda _, v: (
        v.detach().float() if v.dtype == torch.bfloat16
        else v.detach()).cpu().numpy(), caches)


def caches_from_numpy(caches: List, activation_dtype: torch.dtype,
                      device: DeviceLike = None) -> List:
    """The reference's caches as tensors: ``wkv`` and ``h`` f32, ``pos``
    int32, the others (``k``, ``v``, ``tm_prev``, ``cm_prev``, ``conv``)
    in ``activation_dtype``; None stays None."""
    device = resolve_device(device)

    def leaf(key, a) -> torch.Tensor:
        dtype = CACHE_DTYPES.get(key, activation_dtype)
        a = np.asarray(a).astype(np.float32 if dtype.is_floating_point
                                 else np.int32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype,
                                                             device=device)

    return _map_caches(leaf, caches)


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------
def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _by_name(model, tree, dtype_of, device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, (path, layer) in model.param_paths().items():
        a = np.asarray(_at(tree, path))
        if layer is not None:
            a = a[layer]
        out[name] = _from_numpy(a, dtype_of(name), device)
    return out


def train_state_from_numpy(model, state: Any, device: DeviceLike = None,
                           layout=None):
    """The reference's ``TrainState`` (numpy leaves: ``params`` in the
    model's parameter dtypes, ``opt.m``/``opt.v``/``opt.master`` f32 or a
    None master, ``opt.step``) as the port's
    :class:`~repro_torch.launch.steps.TrainState` on ``device``. With a
    ``layout`` (:func:`repro_torch.launch.partition.param_layout` on a
    bound mesh) this rank's blocks of it: the parameters cut by the rules,
    the optimizer state on the ZeRO-1 layout."""
    from .launch.steps import TrainState, shard_state
    from .optim import AdamWState
    if layout is not None:
        return to_device(shard_state(train_state_from_numpy(
            model, state, "cpu"), layout), device)
    dev = resolve_device(device)
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    f32 = lambda _: torch.float32  # noqa: E731
    opt = state.opt
    return TrainState(
        params=_by_name(model, state.params, dtypes.get, dev),
        opt=AdamWState(
            m=_by_name(model, opt.m, f32, dev),
            v=_by_name(model, opt.v, f32, dev),
            master=(None if opt.master is None
                    else _by_name(model, opt.master, f32, dev)),
            step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                              device=dev)))


def params_to_numpy(model, params: Mapping[str, torch.Tensor],
                    layout=None) -> Dict:
    """A dict of the port's parameters by name (a train state's) as the
    reference's tree: each segment's layers stacked, f32 numpy leaves.
    With a ``layout`` ``params`` are this rank's blocks, gathered first
    (a collective: every rank of the mesh calls it)."""
    if layout is not None:
        from .launch import partition
        params = {n: partition.gather(t, layout.specs[n], layout.mesh)
                  for n, t in params.items()}
    by_path: Dict[tuple, Dict] = {}
    for name, (path, layer) in model.param_paths().items():
        a = params[name].detach().float().cpu().numpy()
        by_path.setdefault(path, {})[layer] = a
    tree: Dict = {}
    for path, layers in by_path.items():
        leaf = (layers[None] if None in layers
                else np.stack([layers[i] for i in range(len(layers))]))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    # {si: {j: block}} -> [(block, ...), ...], the decoder's and the
    # encoder's
    for node in (tree, tree.get("encoder", {})):
        if "segments" in node:
            segs = node["segments"]
            node["segments"] = [tuple(segs[si][j] for j in sorted(segs[si]))
                                for si in sorted(segs)]
    return tree
