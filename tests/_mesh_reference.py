"""The reference's side of the mesh tests, run as a script:

    python tests/_mesh_reference.py DEVICES CASES.pkl OUT.pkl

``DEVICES`` fake CPU devices (``XLA_FLAGS`` is set before jax is
imported). Each case of CASES.pkl (a list of dicts with ``name`` and
``kind``) gives a result in OUT.pkl (``{name: result}``, numpy leaves):

* ``specs``: the rules' specs of every arch x mode x mesh (abstract
  meshes), the optimizer's, the decode caches' and cross caches', the
  batch's, ``param_axes()``, and ``input_specs`` of every arch x shape;
A case with ``init`` starts from ``Model.init(key(0))`` (the train
cases with its AdamW state, the vision model's cross gates set to the
case's ``gate``); these starting points are written first, to
``OUT.pkl.init``, so the port's worlds can start from them while the
reference runs.

* ``train``: ``make_train_step`` jitted with its ``NamedSharding``s on a
  (data, model) mesh of the first devices, from the case's numpy
  ``state``, ``steps`` steps on its ``batch``:
  the metrics per step, the parameters after them, and each parameter
  leaf's addressable shards as (mesh coordinate, index slices);
* ``serve``: the single-device ``prefill`` and ``decode`` (jitted) of the
  case's ``params`` on its prompt and next tokens;
* ``moe_ep``: the loss, metrics and the gradients' finiteness under
  ``set_mesh`` with ``moe.USE_EP`` as the case says;
* ``shard_bytes``: per-device argument bytes of a train cell from
  ``NamedSharding.shard_shape`` (nothing compiled).
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                           f"{sys.argv[1] if len(sys.argv) > 1 else 4}")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)

from repro.compat import abstract_mesh, make_mesh, set_mesh  # noqa: E402
from repro.configs import ARCHS, get_config  # noqa: E402
from repro.launch import shardings as sh  # noqa: E402
from repro.launch.input_specs import SHAPES, input_specs  # noqa: E402
from repro.launch.steps import (TrainState, abstract_train_state,  # noqa
                                make_train_step)
from repro.models import build_model, moe  # noqa: E402
from repro.models.common import axes_maker, shape_maker  # noqa: E402
from repro.optim import AdamWState, make_schedule  # noqa: E402

MODES = ("train", "train_dp", "serve")


def spec_tuple(p):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in p)


def flat(tree, is_leaf=None):
    """{path string: leaf} with dict keys and sequence indices joined by
    '/'."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf
    return out


def is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def is_spec(x):
    return isinstance(x, P)


def specs_case(c):
    from repro.launch.input_specs import cells
    out = {"cells": list(cells(ARCHS))}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        shapes = model.abstract_params()
        axes = model.param_axes()
        out[(arch, "axes")] = flat(axes, is_axes)
        out[(arch, "shapes")] = {k: tuple(v.shape)
                                 for k, v in flat(shapes).items()}
        for mesh_shape, names in c["meshes"]:
            mesh = abstract_mesh(tuple(mesh_shape), tuple(names))
            mkey = "x".join(map(str, mesh_shape))
            for mode in MODES:
                ps = sh.tree_pspecs(axes, shapes, cfg, mesh, mode)
                out[(arch, mkey, mode, "params")] = {
                    k: spec_tuple(v) for k, v in flat(ps, is_spec).items()}
                opt = sh.opt_state_pspecs(ps, shapes, mesh)
                out[(arch, mkey, mode, "opt")] = {
                    k: spec_tuple(v) for k, v in flat(opt.m,
                                                      is_spec).items()}
                out[(arch, mkey, mode, "master")] = opt.master is not None
            # decode caches and cross caches under the serve rules
            for shape in ("decode_32k", "long_500k"):
                S, B = SHAPES[shape]["seq"], SHAPES[shape]["batch"]
                ctx = S + cfg.n_meta_tokens
                cs = model.cache_specs(shape_maker(cfg.activation_dtype), B,
                                       ctx)
                ca = model.cache_specs(axes_maker(), B, ctx)
                out[(arch, mkey, shape, "caches")] = {
                    k: spec_tuple(v) for k, v in flat(
                        sh.tree_pspecs(ca, cs, cfg, mesh, "serve"),
                        is_spec).items()}
            for shape in SHAPES:
                specs, iaxes = input_specs(cfg, model, shape)
                batch = {k: v for k, v in specs.items()
                         if k in ("tokens", "labels", "token", "index")}
                out[(arch, mkey, shape, "batch")] = {
                    k: spec_tuple(v) for k, v in sh.batch_pspecs(
                        batch, mesh).items()}
        for shape in SHAPES:
            specs, iaxes = input_specs(cfg, model, shape)
            out[(arch, shape, "input_shapes")] = {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in flat(specs).items()}
            out[(arch, shape, "input_axes")] = flat(iaxes, is_axes)
        S, B = 64, 2
        out[(arch, "cache_shapes")] = {
            k: tuple(v.shape) for k, v in flat(model.cache_specs(
                shape_maker(cfg.activation_dtype), B, S)).items()}
        out[(arch, "cache_axes")] = flat(model.cache_specs(axes_maker(), B,
                                                           S), is_axes)
        xs = model.cross_kv_specs(shape_maker(cfg.activation_dtype), B, 16)
        if xs is not None:
            out[(arch, "cross_shapes")] = {k: tuple(v.shape)
                                           for k, v in flat(xs).items()}
            out[(arch, "cross_axes")] = flat(
                model.cross_kv_specs(axes_maker(), B, 16), is_axes)
    return out


def smoke_model(c):
    cfg = get_config(c["arch"], smoke=True)
    if c.get("over"):
        cfg = cfg.reduced(**c["over"])
    return cfg, build_model(cfg)


def to_state(model, c):
    params = jax.tree.map(jnp.asarray, c["state"]["params"])
    opt = c["state"]["opt"]
    return TrainState(params, AdamWState(
        m=jax.tree.map(jnp.asarray, opt["m"]),
        v=jax.tree.map(jnp.asarray, opt["v"]),
        master=(None if opt["master"] is None
                else jax.tree.map(jnp.asarray, opt["master"])),
        step=jnp.asarray(opt["step"], jnp.int32)))


def mesh_coords(mesh):
    devs = np.asarray(mesh.devices)
    return {d.id: tuple(int(i) for i in np.argwhere(devs == d)[0])
            for d in devs.flat}


def shard_index(arr, coords):
    out = []
    for s in arr.addressable_shards:
        idx = tuple((sl.start or 0, sl.stop if sl.stop is not None else n)
                    for sl, n in zip(s.index, arr.shape))
        out.append((coords[s.device.id], idx))
    return sorted(out)


def train_case(c):
    cfg, model = smoke_model(c)
    mesh = make_mesh(tuple(c["mesh"]), ("data", "model"))
    mode = c.get("mode", "train")
    saved = sh.fsdp_train
    if c.get("fsdp"):
        sh.fsdp_train = lambda cfg: True
    try:
        p_shapes = model.abstract_params()
        p_specs = sh.tree_pspecs(model.param_axes(), p_shapes, cfg, mesh,
                                 mode)
        p_shard = jax.tree.map(lambda s: NamedSharding(mesh, s), p_specs,
                               is_leaf=is_spec)
        opt_specs = sh.opt_state_pspecs(p_specs, p_shapes, mesh)
        state_shard = TrainState(
            params=p_shard,
            opt=jax.tree.map(lambda s: NamedSharding(mesh, s), opt_specs,
                             is_leaf=is_spec))
        batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
        bshard = {k: NamedSharding(mesh, v)
                  for k, v in sh.batch_pspecs(batch, mesh, mode).items()}
    finally:
        sh.fsdp_train = saved
    step = make_train_step(model, schedule=make_schedule("constant", c["lr"],
                                                         10))
    fn = jax.jit(step, in_shardings=(state_shard, bshard),
                 out_shardings=(state_shard, None))
    state = jax.device_put(to_state(model, c), state_shard)
    batch = jax.device_put(batch, bshard)
    metrics = []
    with set_mesh(mesh):
        for _ in range(c["steps"]):
            state, m = fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    coords = mesh_coords(mesh)
    return {"metrics": metrics,
            "params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   state.params),
            "param_shards": {k: shard_index(v, coords)
                             for k, v in flat(state.params).items()},
            "opt_shards": {k: shard_index(v, coords)
                           for k, v in flat(state.opt.m).items()}}


def serve_case(c):
    cfg, model = smoke_model(c)
    params = jax.tree.map(jnp.asarray, c["params"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    T = batch["tokens"].shape[1]
    new = c["next"].shape[1]
    max_seq = T + new + cfg.n_meta_tokens
    prefill = jax.jit(lambda p, b: model.prefill(p, b, max_seq=max_seq))
    decode = jax.jit(model.decode)
    logits, caches, xkv = prefill(params, batch)
    out = [np.asarray(logits, np.float32)]
    for i in range(new):
        tok = jnp.asarray(c["next"][:, i:i + 1])
        logits, caches = decode(params, tok,
                                jnp.int32(T + cfg.n_meta_tokens + i),
                                caches, xkv)
        out.append(np.asarray(logits, np.float32))
    return {"logits": out}


def moe_ep_case(c):
    cfg, model = smoke_model(c)
    params = jax.tree.map(jnp.asarray, c["params"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    mesh = make_mesh(tuple(c["mesh"]), ("data", "model"))
    saved = moe.USE_EP
    moe.USE_EP = c["ep"]
    try:
        with set_mesh(mesh):
            loss, metrics = jax.jit(model.loss)(params, batch)
            grads = jax.jit(jax.grad(lambda p: model.loss(p, batch)[0]))(
                params)
    finally:
        moe.USE_EP = saved
    finite = all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(grads))
    return {"loss": float(loss), "finite": finite,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def shard_bytes_case(c):
    """Argument bytes of rank (0, 0) of a train cell (the reference's
    ``build_cell`` layout, from ``shard_shape``)."""
    cfg, model = smoke_model(c)
    mesh = make_mesh(tuple(c["mesh"]), ("data", "model"))
    p_shapes = model.abstract_params()
    p_specs = sh.tree_pspecs(model.param_axes(), p_shapes, cfg, mesh,
                             "train")
    state = abstract_train_state(model)
    opt_specs = sh.opt_state_pspecs(p_specs, p_shapes, mesh)
    B, S = c["batch"], c["seq"]
    specs = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if cfg.n_encoder_layers:
        specs["src_embed"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                                  cfg.activation_dtype)
    if cfg.family == "vlm":
        specs["vision_embed"] = jax.ShapeDtypeStruct(
            (B, cfg.vision_seq, cfg.d_model), cfg.activation_dtype)
    bspecs = sh.batch_pspecs(specs, mesh)

    def nbytes(shapes, pspecs):
        total = 0
        for leaf, spec in zip(jax.tree.leaves(shapes),
                              jax.tree.leaves(pspecs, is_leaf=is_spec)):
            shp = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += int(np.prod(shp)) * jnp.dtype(leaf.dtype).itemsize
        return total

    total = (nbytes(state.params, p_specs)
             + nbytes(state.opt.m, opt_specs.m)
             + nbytes(state.opt.v, opt_specs.v)
             + (nbytes(state.opt.master, opt_specs.master)
                if state.opt.master is not None else 0)
             + 4                                           # the step
             + nbytes([specs[k] for k in sorted(specs)],
                      [bspecs[k] for k in sorted(specs)]))
    return {"argument_bytes": total}


KINDS = {"specs": specs_case, "train": train_case, "serve": serve_case,
         "moe_ep": moe_ep_case, "shard_bytes": shard_bytes_case}


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def initial(c):
    """The case's starting point from ``Model.init(key(0))``: a train
    case's state (with its AdamW state), another case's parameters."""
    from repro.launch.steps import init_train_state
    cfg, model = smoke_model(c)
    st = init_train_state(model, jax.random.key(0))
    if c.get("gate") is not None:
        st = st._replace(params=_gated(st.params, c["gate"]))
    if c["kind"] != "train":
        return {"params": np_tree(st.params)}
    return {"state": {"params": np_tree(st.params),
                      "opt": {"m": np_tree(st.opt.m),
                              "v": np_tree(st.opt.v),
                              "master": (None if st.opt.master is None
                                         else np_tree(st.opt.master)),
                              "step": int(st.opt.step)}}}


def _gated(params, gate):
    """Every cross layer's gate set to ``gate`` (zero at init, a cross
    layer would add nothing)."""
    segs = []
    for seg in params["segments"]:
        row = []
        for block in seg:
            mixer = block.get("mixer", {})
            if "gate" in mixer:
                mixer = dict(mixer, gate=jnp.full_like(mixer["gate"], gate))
                block = dict(block, mixer=mixer)
            row.append(block)
        segs.append(tuple(row))
    return dict(params, segments=segs)


def main():
    with open(sys.argv[2], "rb") as f:
        cases = pickle.load(f)
    # first the starting points the port waits for (``init`` cases)
    init = {}
    for c in cases:
        if c.get("init"):
            init[c["name"]] = initial(c)
            c.update(init[c["name"]])
    tmp = sys.argv[3] + ".init.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(init, f)
    os.replace(tmp, sys.argv[3] + ".init")
    out = {c["name"]: KINDS[c["kind"]](c) for c in cases}
    with open(sys.argv[3], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
