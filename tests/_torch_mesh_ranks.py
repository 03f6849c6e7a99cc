"""The port's side of the mesh tests: what each rank of a spawned world
runs (torch only, so a spawned rank imports no jax).

Every case carries its numpy inputs (the reference's weights, the batch);
each function runs the cases of its kind on a (data, model) mesh over the
world and returns, per case, this rank's results as numpy: its mesh
coordinate, its metrics, and its blocks with the global slices they
cover (so the test can hold them to the reference's addressable shards at
the same coordinate).
"""
import functools
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
    """``steps`` steps of the case; with ``graphs`` through
    ``compiled_train_step`` (graphs emulated: its first call eager, the
    second the capture, the rest replays)."""
    step = steps_lib.make_train_step(
        model, schedule=make_schedule("constant", c["lr"], 10),
        mesh=layout.mesh, mode=layout.mode)
    batch = steps_lib.shard_batch(tensors(c["batch"]), layout.mesh,
                                  layout.mode)

    def run():
        nonlocal state
        graph = steps_lib.compiled_train_step(step) if c.get("graphs") \
            else None
        metrics = []
        for _ in range(steps):
            if graph is None:
                state, m = step(state, batch)
            else:
                (state, _), m = graph((state, batch))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics
    metrics = _emulated(run) if c.get("graphs") else run()
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



# ---------------------------------------------------------------------------
# The mesh's compiled steps, graphs emulated on the CPU
# (tests/test_torch_mesh_graphs.py)
# ---------------------------------------------------------------------------
def _emulated(fn):
    """``fn()`` with CUDA graphs emulated (``_torch_capture``)."""
    import pytest

    from _torch_capture import emulate_graphs
    with pytest.MonkeyPatch.context() as mp:
        emulate_graphs(mp)
        return fn()


def _mesh(group, c):
    return Mesh(tuple(c["mesh"]), ("data", "model")).bind(group)


def _global_batch(cfg, c):
    rng = np.random.default_rng(c["seed"])
    toks = rng.integers(0, cfg.vocab_size, (c["B"], c["T"]), dtype=np.int32)
    dev = _device(c)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev)}


def _device(c):
    return torch.device(c.get("device", "cpu"))


def _local_model(c, mesh, mode):
    """This rank's blocks of the case's model, drawn from its seed."""
    dev = _device(c)
    return partition.build_local(
        smoke(c), mesh, mode, dev,
        torch.Generator(device=dev).manual_seed(c["seed"]))


def _bits(t):
    """A tensor's bits as numpy (bf16 as int16)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().copy()


def _axis_calls(mesh):
    return {a: (mesh.group(a).calls, mesh.group(a).host_s)
            for a in mesh.axis_names}


def _train_run(group, c, graphs):
    """``c["steps"]`` train steps of the case's model on its mesh from a
    seeded draw: graphed (``compiled_train_step``) or eagerly. Returns
    each step's metrics, the state's leaves, the collective bytes and
    calls, and the graph's chain."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import graphed
    cfg = smoke(c)
    mesh = _mesh(group, c)
    model = _local_model(c, mesh, "train")
    layout = partition.param_layout(model, mesh, "train")
    state = steps_lib.local_train_state(dict(model.named_parameters()),
                                        layout)
    step = steps_lib.make_train_step(
        model, schedule=make_schedule("constant", 3e-3, 10),
        accum_steps=c["accum"], mesh=mesh, mode="train")
    batch = steps_lib.shard_batch(_global_batch(cfg, c), mesh, "train")
    run = (steps_lib.compiled_train_step(step) if graphs else
           graphed.EagerStep(functools.partial(steps_lib.train_graph_step,
                                               step), _device(c)))
    ptrs = [t.data_ptr() for t in pytree.tree_leaves(state)
            if isinstance(t, torch.Tensor)]
    partition.reset_collectives()
    metrics = []
    for _ in range(c["steps"]):
        (state, _), m = run((state, batch))
        metrics.append({k: _bits(v) for k, v in m.items()})
    leaves = [t for t in pytree.tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    out = {"metrics": metrics,
           "state": [_bits(t) for t in leaves],
           "callers": [t.data_ptr() for t in leaves] == ptrs,
           "bytes": partition.reset_collectives(),
           "calls": {a: n for a, (n, _) in _axis_calls(mesh).items()}}
    if graphs:
        out["chain"] = (run.captures, run.segments, run.cuts)
        run.release()
    return out


def _serve_run(group, c, graphs):
    """``generate`` three times (prefill and ``c["new"] - 1`` decode
    steps each) on the case's mesh: graphed or eagerly. A graph's first
    call is eager, its second the capture: the three runs cover the
    prefill's eager call, capture and replay, the decode's eager step,
    capture and replays."""
    from repro_torch.launch import serve as serve_lib
    cfg = smoke(c)
    mesh = _mesh(group, c)
    model = _local_model(c, mesh, "serve")
    rows = steps_lib.shard_batch(
        {"tokens": _global_batch(cfg, c)["tokens"]}, mesh, "serve")
    partition.reset_collectives()
    runs = []
    for _ in range(3):
        toks, info = serve_lib.generate(model, rows["tokens"], c["new"],
                                        graphs=graphs, keep_logits=True,
                                        mesh=mesh, batch=c["B"])
        runs.append((_bits(toks), _bits(info["logits"])))
    out = {"runs": runs, "bytes": partition.reset_collectives(),
           "calls": {a: n for a, (n, _) in _axis_calls(mesh).items()}}
    if graphs:
        out["chain"] = {kind: (g.captures, g.segments, g.cuts)
                        for kind, g in steps_lib.serve_graphs(model)}
    steps_lib.release_serve_graphs(model)
    return out


def _train_loop(group, c, graphs):
    """``launch/train.py``'s loop on this rank of the world (the mesh of
    ``make_mesh_for_devices``), its steps replayed (``graphs``) or
    eager: the losses and the global state."""
    from repro_torch.launch import train as train_lib
    state, losses = train_lib._train(
        arch=c["arch"], smoke=True, steps=c["steps"], batch=c["B"],
        seq=c["T"], lr=3e-3, accum=c["accum"], ckpt_dir=None,
        ckpt_every=50, resume=False, seed=c["seed"], log_every=1,
        verbose=False, device=_device(c), on_step=None, group=group,
        graphs=graphs)
    return {"losses": losses,
            "state": [_bits(t) for t in _leaves(state)]}


def _leaves(tree):
    from torch.utils import _pytree as pytree
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _uneven_cuts(group, c):
    """A step in which rank 1 alone cuts (a collective over its own
    one-rank data axis): the capture raises on every rank, at the check
    of the ranks' cuts, where a replay would have hung."""
    from repro_torch.core import graphed
    mesh = _mesh(group, c)

    def step(carry):
        (y,) = carry
        y = y * 2
        if group.rank == 1:
            y = y + mesh.group("data").all_reduce(y.to(torch.int32))
        return (y,), y.sum()

    g = graphed.CutGraph(step, group=group)
    x = torch.ones(4)
    try:
        _emulated(lambda: [g((x,)) for _ in range(2)])
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _step_faults(group, c):
    """``capture_faults`` (cuts allowed) of the case's steps on this
    rank: the train step (its state's writes allowed), the prefill and a
    decode step (its caches' writes allowed)."""
    from _torch_capture import capture_faults
    cfg = smoke(c)
    mesh = _mesh(group, c)
    out = {}
    if c["what"] == "train":
        model = _local_model(c, mesh, "train")
        layout = partition.param_layout(model, mesh, "train")
        state = steps_lib.local_train_state(dict(model.named_parameters()),
                                            layout)
        step = steps_lib.make_train_step(
            model, schedule=make_schedule("constant", 3e-3, 10),
            accum_steps=c["accum"], mesh=mesh, mode="train")
        batch = steps_lib.shard_batch(_global_batch(cfg, c), mesh, "train")
        out["train"] = capture_faults(steps_lib.train_graph_step, step,
                                      (state, batch), writes=state,
                                      cuts=True)
        return out
    model = _local_model(c, mesh, "serve")
    rows = steps_lib.shard_batch(
        {"tokens": _global_batch(cfg, c)["tokens"]}, mesh, "serve")
    seq = c["T"] + c["new"] + cfg.n_meta_tokens
    serving = steps_lib.mesh_serving(model, mesh, c["B"], seq)
    out["prefill"] = capture_faults(
        steps_lib.serve_prefill_step, model, seq, True, True, rows,
        serving=serving, cuts=True)
    _, (logits, caches, xkv) = steps_lib.serve_prefill_step(
        model, seq, True, True, rows, serving=serving)
    carry = (logits.argmax(-1)[:, None], caches, xkv)
    index = torch.full((), c["T"] + cfg.n_meta_tokens, dtype=torch.int32)
    out["decode"] = capture_faults(
        steps_lib.serve_decode_step, model, carry, index, serving=serving,
        writes=caches, cuts=True)
    return out


def graph_cases(group, cases):
    """The ``graphs`` cases: ``train`` and ``serve`` run graphed (on the
    CPU with graphs emulated) and eagerly (name -> {"got", "want"}),
    ``uneven`` and ``faults`` cases as their functions say."""
    out = {}
    for c in cases:
        if c["W"] != group.world:
            continue
        what = c["what"]
        if c.get("faults"):
            out[c["name"]] = _step_faults(group, c)
        elif what == "uneven":
            out[c["name"]] = _uneven_cuts(group, c)
        else:
            run = {"train": _train_run, "serve": _serve_run,
                   "loop": _train_loop}[what]
            graphed_run = functools.partial(run, group, c, True)
            got = (_emulated(graphed_run) if _device(c).type == "cpu"
                   else graphed_run())
            out[c["name"]] = {"got": got, "want": run(group, c, False)}
    return out


class _SumBack(torch.autograd.Function):
    """The sum over the group's ranks in both directions: a collective in
    the forward and one in the backward, which autograd runs on its
    device thread."""

    @staticmethod
    def forward(ctx, x, group, threads):
        ctx.group, ctx.threads = group, threads
        return group.sum_in_order(x)

    @staticmethod
    def backward(ctx, g):
        import threading
        ctx.threads.append(threading.get_ident())
        return ctx.group.sum_in_order(g), None, None


def backward_cut(group, mode):
    """A step cut once in its forward and once in its backward, replayed
    as a donating ``CutGraph`` whose segments are captured in ``mode``,
    against the same step called eagerly: ``("ok", equal, cuts, the
    backward on another thread than the step)`` or ``("raised", what)``
    where the capture failed."""
    import threading

    from repro_torch.core import graphed
    graphed.CUT_CAPTURE_MODE = mode
    dev = group.device
    threads = []

    def step(carry):
        (w,) = carry
        with torch.enable_grad():
            leaf = w.detach().requires_grad_(True)
            y = _SumBack.apply(leaf * 2, group, threads).sin().sum()
            (g,) = torch.autograd.grad(y, [leaf])
        w.sub_(0.1 * g)
        return (w,), y.detach()

    w0 = torch.linspace(-1.0, 1.0, 1024, device=dev)
    eager = [w0.clone()]
    want = [step(tuple(eager))[1] for _ in range(4)]
    mine = w0.clone()
    run = graphed.CutGraph(step, group=group, donate=True)
    try:
        got = [run((mine,))[1] for _ in range(4)]
    except RuntimeError as e:
        return ("raised", str(e))
    equal = (all(torch.equal(a, b) for a, b in zip(got, want))
             and torch.equal(mine, eager[0]))
    other = all(t != threading.get_ident() for t in threads)
    return ("ok", equal, run.cuts, other)


KINDS["graphs"] = graph_cases
