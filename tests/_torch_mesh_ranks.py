"""The port's side of the mesh tests: what each rank of a spawned world
runs (torch only, so a spawned rank imports no jax).

Every case carries its numpy inputs (the reference's weights, the batch);
each function runs the cases of its kind on a (data, model) mesh over the
world and returns, per case, this rank's results as numpy: its mesh
coordinate, its metrics, and its blocks with the global slices they
cover (so the test can hold them to the reference's addressable shards at
the same coordinate).
"""
import pickle
import types

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import partition
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build_model, moe
from repro_torch.optim import make_schedule


def smoke(c):
    cfg = get_config(c["arch"], smoke=True)
    return cfg.reduced(**c["over"]) if c.get("over") else cfg


def np_state(st):
    """The reference's train state as numpy attributes."""
    opt = st["opt"]
    return types.SimpleNamespace(
        params=st["params"], opt=types.SimpleNamespace(
            m=opt["m"], v=opt["v"], master=opt["master"], step=opt["step"]))


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _regions(layout, local, specs):
    return {n: tuple((s.start, s.stop) for s in partition.region(
        layout.shapes[n], specs[n], layout.mesh, layout.mesh.coord))
        for n in local}


def train_one(group, c, model, layout, state, steps):
    step = steps_lib.make_train_step(
        model, schedule=make_schedule("constant", c["lr"], 10),
        mesh=layout.mesh, mode=layout.mode)
    batch = steps_lib.shard_batch(tensors(c["batch"]), layout.mesh,
                                  layout.mode)
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def train_cases(group, cases):
    """Train cases: ``steps`` steps from the reference's state on the
    case's mesh under its ``mode`` (``fsdp`` forces the FSDP rules, as
    the reference's case patches them)."""
    from repro_torch.launch import shardings
    out = {}
    for c in cases:
        if c["W"] != group.world:
            continue
        saved = shardings.fsdp_train
        if c.get("fsdp"):
            shardings.fsdp_train = lambda cfg: True
        try:
            cfg = smoke(c)
            model = build_model(cfg, "cpu")
            mesh = Mesh(tuple(c["mesh"]), ("data", "model")).bind(group)
            layout = partition.param_layout(model, mesh, c.get("mode",
                                                               "train"))
            state = convert.train_state_from_numpy(
                model, np_state(c["state"]), "cpu", layout)
            state, metrics = train_one(group, c, model, layout, state,
                                       c["steps"])
            out[c["name"]] = {
                "coord": tuple(mesh.coord[a] for a in mesh.axis_names),
                "metrics": metrics,
                "local": {n: t.float().numpy()
                          for n, t in state.params.items()},
                "regions": _regions(layout, state.params, layout.specs),
                "opt_regions": _regions(layout, state.opt.m, layout.opt),
                "opt_local": {n: t.numpy() for n, t in state.opt.m.items()},
                "global": convert.params_to_numpy(model, state.params,
                                                  layout),
            }
        finally:
            shardings.fsdp_train = saved
    return out


def serve_cases(group, cases):
    """Prefill and decode under the serve rules: this rank's rows of the
    last-position logits of the prefill and of each decode step."""
    out = {}
    for c in cases:
        if c["W"] != group.world:
            continue
        cfg = smoke(c)
        model = build_model(cfg, "cpu")
        convert.model_params_from_numpy(model, c["params"])
        mesh = Mesh(tuple(c["mesh"]), ("data", "model")).bind(group)
        layout = partition.param_layout(model, mesh, "serve")
        steps_lib.shard_model(model, layout)
        batch = tensors(c["batch"])
        nxt = torch.from_numpy(np.asarray(c["next"]))
        B, T = batch["tokens"].shape
        new = nxt.shape[1]
        pre = steps_lib.make_prefill_step(model, max_seq=T + new, mesh=mesh,
                                          batch=B)
        dec = steps_lib.make_decode_step(model, mesh=mesh, batch=B,
                                         max_seq=T + new)
        logits, caches, xkv = pre(steps_lib.shard_batch(batch, mesh,
                                                        "serve"))
        outs = [logits.numpy()]
        for i in range(new):
            tok = steps_lib.shard_batch({"token": nxt[:, i:i + 1]}, mesh,
                                        "serve")["token"]
            logits, caches = dec({"token": tok,
                                  "index": T + cfg.n_meta_tokens + i,
                                  "caches": caches, "cross_kvs": xkv})
            outs.append(logits.numpy())
        out[c["name"]] = {"coord": tuple(mesh.coord[a]
                                         for a in mesh.axis_names),
                          "logits": outs}
    return out


def moe_ep_cases(group, cases):
    """The loss and metrics of the model's loss on the mesh (expert
    parallelism where ``moe.ep_applies``), and the gradients' finiteness
    on this rank."""
    out = {}
    for c in cases:
        if c["W"] != group.world:
            continue
        cfg = smoke(c)
        model = build_model(cfg, "cpu")
        convert.model_params_from_numpy(model, c["params"])
        mesh = Mesh(tuple(c["mesh"]), ("data", "model")).bind(group)
        layout = partition.param_layout(model, mesh, "train")
        params = {n: layout.local(n, p.detach())
                  for n, p in model.named_parameters()}
        grads_of = steps_lib.make_grad_fn(model, "layer", layout)
        batch = steps_lib.shard_batch(tensors(c["batch"]), mesh, "train")
        saved = moe.USE_EP
        moe.USE_EP = c["ep"]
        try:
            grads, metrics = grads_of(params, batch)
            metrics = steps_lib._global_metrics(model, layout, metrics)
        finally:
            moe.USE_EP = saved
        out[c["name"]] = {
            "loss": float(metrics["loss"]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "finite": all(bool(torch.isfinite(g).all())
                          for g in grads.values())}
    return out


def resume_world(group, kw, write, resume):
    """On this world: the whole run checkpointing into ``write``, then the
    run resumed from ``resume``. Returns (its losses, the resumed run's)."""
    from repro_torch.launch import train as train_lib
    _, whole = train_lib._train(device=group.device, on_step=None,
                                group=group, ckpt_dir=write, resume=False,
                                **kw)
    _, rest = train_lib._train(device=group.device, on_step=None,
                               group=group, ckpt_dir=resume, resume=True,
                               **kw)
    return whole, rest


KINDS = {"train": train_cases, "serve": serve_cases,
         "moe_ep": moe_ep_cases}


def run_cases_file(group, path):
    """:func:`run_cases` of the cases pickled at ``path``."""
    with open(path, "rb") as f:
        return run_cases(group, pickle.load(f))


def run_cases(group, cases):
    """Every case of this world size, by kind."""
    out = {}
    for kind, fn in KINDS.items():
        out.update(fn(group, [c for c in cases if c["kind"] == kind]))
    return out

