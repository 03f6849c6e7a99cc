"""Step functions: train (with microbatch accumulation), prefill and
decode.

Port of ``repro/launch/steps.py``. Serving steps take the batch alone (the
parameters live in the model). The train step is functional over its
state: ``step(state, batch) -> (state, metrics)`` differentiates
``Model.loss`` with the state's parameters put in place of the module's
by ``torch.func.functional_call``, so one module serves any number of
states (the members of PBT share one). The gradients come from
``torch.autograd.grad`` through the plain PyTorch versions: the CUDA
kernels have no backward (the reference's Pallas kernels have none
either, and its gradient through ``use_flash`` fails), so the step
refuses ``use_flash`` and ``use_rwkv_kernel``. The step updates the
state's tensors in place and returns them (the reference's compiled step
donates its state): a state passed in is consumed.

The step runs under ``torch.use_deterministic_algorithms`` (the
embedding's backward accumulates by sort, not by atomics), so a resumed
run repeats the uninterrupted one bit for bit, on the card and on a CPU
of several threads.

With a bound ``mesh=`` and ``mode=`` (:mod:`repro_torch.launch.mesh`,
the rules' modes) the steps run on the ranks of the mesh
(:mod:`repro_torch.launch.partition`): a state's tensors and a serving
model's parameters are this rank's blocks (drawn as such by
:func:`~repro_torch.launch.partition.build_local`, a serving model's
also cut from global ones by :func:`shard_model`), a batch is
this rank's rows (:func:`shard_batch`). The train step's metrics are the
global ones: ``ce`` summed over the batch's ranks, the aux terms (each
rank's own, as the reference's expert-parallel shard_map returns them)
those of rank 0. Without a mesh the steps are the single-device ones,
bit for bit.

The compiled serve steps, the counterparts of the reference's jitted
prefill and decode (``repro/launch/serve.py``): :func:`serve_prefill_step`
and :func:`serve_decode_step` are steps in the sense of
:class:`~repro_torch.core.graphed.StepGraph`, and :func:`compiled_prefill`
and :func:`compiled_decode` keep one graph of each per model and shapes
(an LRU of :data:`SERVE_GRAPHS_MAX`; :func:`release_serve_graphs` drops
them). ``launch/serve.py::generate`` replays them on the card. On a
bound mesh the same steps take the rank's layout (``serving``:
:func:`mesh_serving`) and replay as
:class:`~repro_torch.core.graphed.CutGraph` s, a chain of graphs cut at
the step's collectives, keyed on the mesh (and so its group) too.

The compiled train, PBT and eval steps, the counterparts of the
reference's ``jax.jit(step_fn, donate_argnums=(0,))``
(``repro/launch/train.py``) and of PBT's jitted ``step_fn`` and
``eval_fn`` (``repro/launch/evolve.py``): :func:`train_graph_step`,
:func:`hyper_train_step` (the hyperparameters as the graph's host
values) and :func:`eval_graph_step` are steps in the sense of
:class:`~repro_torch.core.graphed.StepGraph`, and
:func:`compiled_train_step`, :func:`compiled_hyper_step` and
:func:`compiled_eval` build donating graphs of them, one per state (no
cache: the graph's buffers are the state). ``launch/train.py::train``
and ``launch/evolve.py::run_pbt`` replay them on the card. The mesh's
train step replays as a donating
:class:`~repro_torch.core.graphed.CutGraph` (the reference's
``jax.jit(..., in_shardings=..., donate_argnums=(0,))``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch import nn
from torch.utils import _pytree as pytree

from .. import rand
from ..core import graphed
from ..models.model import Model
from ..optim.adamw import (AdamWState, adamw_init, adamw_init_sharded,
                           adamw_update)
from . import partition

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Params          # the model's parameters by name
    opt: AdamWState


def init_train_state(model: Model,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """The model's parameters (their storage shared, not copied: a train
    step then updates the model's weights in place) and a fresh AdamW
    state; with ``generator``, parameters drawn anew from it on the
    model's device, as ``Model(cfg, device, generator)`` draws them."""
    if generator is not None:
        model = Model(model.cfg, model.device, generator)
    params = {n: p.detach() for n, p in model.named_parameters()}
    return TrainState(params=params, opt=adamw_init(params))


def abstract_train_state(model: Model) -> TrainState:
    """The train state's stand-ins (meta tensors): the parameters, the
    f32 moments and, where a parameter is not f32, the f32 master."""
    params = model.abstract_params()
    f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for k, p in params.items()}
    master = (dict(f32) if any(p.dtype != torch.float32
                               for p in params.values()) else None)
    return TrainState(params=params, opt=AdamWState(
        m=f32, v=dict(f32), master=master,
        step=torch.zeros((), dtype=torch.int32, device="meta")))


def local_train_state(local: Params, layout: "partition.Layout"
                      ) -> TrainState:
    """A fresh train state of this rank's blocks ``local`` (by name; a
    model of :func:`~repro_torch.launch.partition.build_local`, their
    storage shared): the AdamW state on the ZeRO-1 layout."""
    local = {n: p.detach() for n, p in local.items()}
    return TrainState(params=local, opt=adamw_init_sharded(local, layout))


def shard_state(state: TrainState, layout: "partition.Layout"
                ) -> TrainState:
    """This rank's blocks of a global train state (a resume)."""
    mesh, opt = layout.mesh, state.opt

    def cut(tree, specs):
        return (None if tree is None
                else partition.shard_tree(tree, specs, mesh, mesh.coord))

    return TrainState(
        params=cut(state.params, layout.specs),
        opt=AdamWState(m=cut(opt.m, layout.opt), v=cut(opt.v, layout.opt),
                       master=cut(opt.master, layout.opt),
                       step=opt.step.clone()))


def gather_state(state: TrainState, layout: "partition.Layout"
                 ) -> TrainState:
    """The global train state from every rank's blocks (a collective:
    every rank calls it)."""
    mesh, opt = layout.mesh, state.opt

    def full(tree, specs):
        return (None if tree is None
                else partition.gather_tree(tree, specs, mesh))

    return TrainState(
        params=full(state.params, layout.specs),
        opt=AdamWState(m=full(opt.m, layout.opt), v=full(opt.v, layout.opt),
                       master=full(opt.master, layout.opt), step=opt.step))


def shard_batch(batch: Dict, mesh, mode: str = "train") -> Dict:
    """This rank's rows of a global batch, cut as ``batch_pspecs`` cuts
    it."""
    from .shardings import batch_pspecs
    specs = batch_pspecs(batch, mesh, mode)
    return {k: partition.shard(v, specs[k], mesh, mesh.coord)
            for k, v in batch.items()}


def shard_model(model: Model, layout: "partition.Layout") -> Model:
    """``model`` holding this rank's blocks of its parameters in place of
    the global ones (for the serving steps)."""
    local = {n: layout.local(n, p.detach())
             for n, p in model.named_parameters()}
    partition.load_local(model, layout, local)
    return model


class _Objective(nn.Module):
    """``Model.loss`` as a module's forward, for ``functional_call``
    (called through the class, so the analyzer's callgraph follows a
    captured train step into the model)."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, batch, **kw):
        return Model.loss(self.model, batch, **kw)


_NO_KERNEL_GRAD = (
    "the train step runs the plain PyTorch versions: the {name} kernel has "
    "no backward kernel (a gradient through it would be silently zero), "
    "and the reference's gradient through its Pallas kernel fails too; "
    "train with {flag}=False")


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms for the step's duration (the previous
    setting restored after), without filling new memory. The embedding's
    backward accumulates by atomics on the card and, with more than one
    thread, on the CPU; under this setting it sorts."""
    det = torch.utils.deterministic if hasattr(torch.utils,
                                               "deterministic") else None
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory if det else None
    # warn only: cuBLAS is deterministic on one stream whatever its
    # workspace setting, which must precede the first CUDA call
    torch.use_deterministic_algorithms(True, warn_only=True)
    if det:
        det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        if det:
            det.fill_uninitialized_memory = fill


def loss_grads(model: Model, params: Params, batch: Dict,
               remat_mode: str = "layer",
               layout: Optional["partition.Layout"] = None
               ) -> Tuple[Params, Dict]:
    """``(grads, metrics)``: the gradient of ``model.loss`` at ``params``
    (a dict by parameter name, put in place of the module's), in the
    parameters' dtypes, and the loss's metrics (detached). On a mesh
    (``layout``) ``params`` and the gradients are this rank's blocks and
    the metrics its own."""
    with torch.enable_grad():
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        kw = {"remat_mode": remat_mode}
        if layout is not None:
            kw["sh"] = layout.shards().register(leaves)
        total, metrics = torch.func.functional_call(
            _Objective(model), {f"model.{k}": v for k, v in leaves.items()},
            (batch,), kw)
        grads = torch.autograd.grad(total, list(leaves.values()))
    return (dict(zip(leaves, grads)),
            {k: v.detach() for k, v in metrics.items()})


def loss_value(model: Model, params: Params, batch: Dict) -> Tuple:
    """``(total, metrics)`` of ``model.loss`` at ``params``, without
    autograd."""
    with torch.no_grad():
        return torch.func.functional_call(
            _Objective(model), {f"model.{k}": v for k, v in params.items()},
            (batch,))


def make_grad_fn(model: Model, remat_mode: str = "layer",
                 layout: Optional["partition.Layout"] = None
                 ) -> Callable[[Params, Dict], Tuple[Params, Dict]]:
    """``grads_of(params, batch) -> (grads, metrics)``: :func:`loss_grads`
    of ``model``."""
    return functools.partial(loss_grads, model, remat_mode=remat_mode,
                             layout=layout)


@dataclasses.dataclass(frozen=True, eq=False)
class TrainStep:
    """``train_step(state, batch) -> (state, metrics)`` as
    :func:`make_train_step` builds it: the model and the step's settings,
    called through :func:`train_step`."""
    model: Model
    schedule: Callable[[torch.Tensor], torch.Tensor]
    accum_steps: int
    weight_decay: float
    max_grad_norm: Optional[float]
    remat_mode: str
    order: Sequence[Sequence[str]]
    layout: Optional["partition.Layout"] = None

    def __call__(self, state: TrainState, batch: Dict
                 ) -> Tuple[TrainState, Dict]:
        return train_step(self, state, batch)


def make_train_step(model: Model, *,
                    schedule: Callable[[torch.Tensor], torch.Tensor],
                    accum_steps: int = 1,
                    weight_decay: float = 0.1,
                    max_grad_norm: Optional[float] = 1.0,
                    use_flash: bool = False,
                    use_rwkv_kernel: bool = False,
                    remat_mode: str = "layer", mesh=None,
                    mode: str = "train",
                    ) -> TrainStep:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``accum_steps > 1`` splits the batch into sequential microbatches (the
    same math, 1/k of the live activations): the gradients are summed in
    f32 as ``acc + g / k`` and the metrics averaged. ``metrics`` holds the
    loss's (``ce``, ``loss``, the aux terms), ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors.

    With a bound ``mesh`` the state is this rank's blocks
    (:func:`local_train_state`) under the rules' ``mode`` (``train`` or
    ``train_dp``) and the batch its rows (:func:`shard_batch`)."""
    if use_flash:
        raise NotImplementedError(_NO_KERNEL_GRAD.format(
            name="flash-attention", flag="use_flash"))
    if use_rwkv_kernel:
        raise NotImplementedError(_NO_KERNEL_GRAD.format(
            name="WKV", flag="use_rwkv_kernel"))
    layout = None if mesh is None else partition.param_layout(model, mesh,
                                                              mode)
    return TrainStep(model=model, schedule=schedule,
                     accum_steps=accum_steps, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm, remat_mode=remat_mode,
                     order=model.leaf_groups(), layout=layout)


def train_step(ts: TrainStep, state: TrainState, batch: Dict
               ) -> Tuple[TrainState, Dict]:
    """One train step of ``ts``'s settings (see :func:`make_train_step`);
    it updates ``state``'s tensors in place and returns them."""
    dev = state.opt.step.device
    k = ts.accum_steps
    with deterministic(dev):
        if k == 1:
            grads, metrics = loss_grads(ts.model, state.params, batch,
                                        ts.remat_mode, ts.layout)
        else:
            kf = rand.const(float(k), torch.float32, dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in state.params.items()}
            ms: List[Dict] = []
            for i in range(k):
                micro = {key: _micro(x, k, i) for key, x in batch.items()}
                g, m = loss_grads(ts.model, state.params, micro,
                                  ts.remat_mode, ts.layout)
                grads = {n: grads[n] + g[n].float() / kf for n in grads}
                ms.append(m)
            metrics = {key: torch.stack([m[key] for m in ms]).mean()
                       for key in ms[0]}
        if ts.layout is not None:
            metrics = _global_metrics(ts.model, ts.layout, metrics)
        lr = ts.schedule(state.opt.step)
        params, opt, om = adamw_update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=ts.weight_decay, max_grad_norm=ts.max_grad_norm,
            order=ts.order, layout=ts.layout)
    return TrainState(params, opt), {**metrics, **om}


def _global_metrics(model: Model, layout: "partition.Layout",
                    metrics: Dict) -> Dict:
    """The ranks' metrics as the reference reports them: ``ce`` summed
    over the batch's ranks (each holds its share of the mean), the aux
    terms rank 0's, ``loss`` from those."""
    mesh, cfg = layout.mesh, model.cfg
    sh = layout.shards()
    out = {k: partition.broadcast_axes(mesh, mesh.axis_names, v)
           for k, v in metrics.items()}
    out["ce"] = partition.sum_axes(mesh, sh.batch_axes, metrics["ce"])
    out["loss"] = (out["ce"] + cfg.router_aux_weight * out["load_balance"]
                   + cfg.router_z_weight * out["router_z"])
    return out


def _micro(x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    b = x.shape[0]
    assert b % k == 0, (b, k)
    return x[i * (b // k):(i + 1) * (b // k)]


def make_prefill_step(model: Model, *, max_seq: Optional[int] = None,
                      use_flash: bool = False,
                      use_rwkv_kernel: bool = False, mesh=None,
                      mode: str = "serve", batch: Optional[int] = None
                      ) -> Callable[[Dict], Tuple[torch.Tensor, List,
                                                  Optional[List]]]:
    """prefill(batch) -> (last-position logits (B, V), caches, cross_kvs
    or None). ``max_seq`` is the decode budget in tokens (the prompt and
    the new tokens); the ring caches hold the model's meta tokens
    besides. With ``use_flash`` every causal attention layer without a
    window runs the flash-attention kernel, with ``use_rwkv_kernel`` every
    RWKV layer the WKV kernel; each is ignored by the blocks without its
    mixer.

    With a bound ``mesh`` the model holds its blocks
    (:func:`~repro_torch.launch.partition.build_local`), ``batch`` is the
    global batch size and a call takes this rank's rows; the logits are
    its rows' (every vocab entry) and the caches come out as the serve
    rules store them."""
    if max_seq is not None:
        max_seq += model.cfg.n_meta_tokens
    layout = None if mesh is None else partition.param_layout(model, mesh,
                                                              mode)

    def prefill(inputs: Dict) -> Tuple[torch.Tensor, List, Optional[List]]:
        sh = None
        if layout is not None:
            seq = (max_seq if max_seq is not None else
                   inputs["tokens"].shape[1] + model.cfg.n_meta_tokens)
            sh = _serving(model, layout, batch, seq)
        return model.prefill(inputs, use_flash=use_flash,
                             use_rwkv_kernel=use_rwkv_kernel,
                             max_seq=max_seq, sh=sh)

    return prefill


def _serving(model: Model, layout: "partition.Layout", batch: int,
             seq: int) -> "partition.Shards":
    sh = layout.shards().register(dict(model.named_parameters()))
    key = ("cache_specs", batch, seq)
    if key not in layout.memo:
        layout.memo[key] = partition.cache_pspecs(model, layout.mesh, batch,
                                                  seq)
    sh.cache_specs = layout.memo[key]
    return sh


def make_decode_step(model: Model, *, mesh=None, mode: str = "serve",
                     batch: Optional[int] = None,
                     max_seq: Optional[int] = None
                     ) -> Callable[[Dict], Tuple[torch.Tensor, List]]:
    """decode({'token', 'index', 'caches'[, 'cross_kvs']}) -> (logits
    (B, V), caches); ``index`` counts the meta tokens. With a bound
    ``mesh``: the model holds its blocks, ``batch`` is the global batch
    size and ``max_seq`` the decode budget (as the prefill step was given
    it), a call takes this rank's rows and caches."""
    layout = None if mesh is None else partition.param_layout(model, mesh,
                                                              mode)
    if layout is not None and max_seq is not None:
        max_seq += model.cfg.n_meta_tokens

    def decode(inputs: Dict) -> Tuple[torch.Tensor, List]:
        sh = None
        if layout is not None:
            sh = _serving(model, layout, batch, max_seq)
        return model.decode(inputs["token"], inputs["index"],
                            inputs["caches"], inputs.get("cross_kvs"), sh=sh)

    return decode


# ---------------------------------------------------------------------------
# The compiled serve steps
# ---------------------------------------------------------------------------
def mesh_serving(model: Model, mesh, batch: int, seq: int
                 ) -> Callable[[], "partition.Shards"]:
    """A serving step's layout on a bound ``mesh`` for a global ``batch``
    and caches of ``seq`` slots (the meta tokens counted): the
    ``serving`` argument of :func:`serve_prefill_step` and
    :func:`serve_decode_step`."""
    layout = partition.param_layout(model, mesh, "serve")
    return functools.partial(_serving, model, layout, batch, seq)


def serve_prefill_step(model: Model, cache_len: int, use_flash: bool,
                       use_rwkv_kernel: bool, inputs: Dict,
                       serving: Optional[Callable] = None
                       ) -> Tuple[Dict, Tuple[torch.Tensor, List,
                                              Optional[List]]]:
    """The prefill as a graphed step: ``inputs`` (the tokens and the
    arch's other inputs) is its carry, returned as it came; its output is
    (last-position logits, caches of ``cache_len`` slots, cross_kvs or
    None). On a mesh ``serving`` (:func:`mesh_serving`) gives the rank's
    layout, and ``inputs`` are its rows. (``Model.prefill`` is called
    through the class, so the analyzer's callgraph follows the step into
    the model.)"""
    sh = None if serving is None else serving()
    return inputs, Model.prefill(model, inputs, use_flash=use_flash,
                                 use_rwkv_kernel=use_rwkv_kernel,
                                 max_seq=cache_len, sh=sh)


def serve_decode_step(model: Model, carry: Tuple, index: torch.Tensor,
                      serving: Optional[Callable] = None
                      ) -> Tuple[Tuple, torch.Tensor]:
    """One greedy decode step as a graphed step: ``carry`` is (token
    (B, 1), caches, cross_kvs or None), ``index`` the token's position
    (meta tokens counted) as a 0-d int32 device tensor. Returns the next
    carry (the greedy token, the caches, the ring caches updated in place,
    ``cross_kvs`` as they came) and the step's logits (B, V) f32: the
    next token never leaves the card. On a mesh ``serving``
    (:func:`mesh_serving`) gives the rank's layout: the carry is its rows
    and its caches, the logits its rows' (every vocab entry)."""
    token, caches, cross_kvs = carry
    sh = None if serving is None else serving()
    logits, caches = Model.decode(model, token, index, caches, cross_kvs,
                                  sh=sh)
    return (logits.argmax(-1)[:, None], caches, cross_kvs), logits


# One graph per model, kind and shapes, as the reference's jit keeps one
# executable per traced shape. The entry holds the model, so a live
# entry's id is never a recycled one. A prefill graph's private pool holds
# a prefill's activations and its caches (GBs at the published sizes,
# PERF.md §6), so the LRU keeps two generate shapes at most; an evicted
# graph releases its pool.
_SERVE_GRAPHS: "collections.OrderedDict[tuple, Tuple[Model, graphed.StepGraph]]" \
    = collections.OrderedDict()
SERVE_GRAPHS_MAX = 4


def _shapes(tree) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
        else t for t in leaves)


def _serve_graph(model: Model, key: tuple,
                 builder: Callable[[], graphed.StepGraph]
                 ) -> graphed.StepGraph:
    key = (id(model),) + key
    entry = _SERVE_GRAPHS.get(key)
    if entry is None or entry[0] is not model:
        if entry is not None:
            entry[1].release()
        _SERVE_GRAPHS[key] = entry = (model, builder())
        while len(_SERVE_GRAPHS) > SERVE_GRAPHS_MAX:
            _SERVE_GRAPHS.popitem(last=False)[1][1].release()
    _SERVE_GRAPHS.move_to_end(key)
    return entry[1]


def _mesh_key(mesh, batch: Optional[int]) -> tuple:
    return () if mesh is None else ("mesh", mesh.world, mesh, batch)


def compiled_prefill(model: Model, inputs: Dict, *,
                     max_seq: Optional[int] = None, use_flash: bool = False,
                     use_rwkv_kernel: bool = False, mesh=None,
                     batch: Optional[int] = None) -> graphed.StepGraph:
    """The graphed prefill for ``inputs``' shapes, the decode budget
    ``max_seq`` (in tokens, as :func:`make_prefill_step` takes it) and the
    kernel routes: ``graph(inputs) -> (inputs, (logits, caches,
    cross_kvs))``, the output cloned out of the graph's pool. On a bound
    ``mesh`` (``batch`` the global batch, ``inputs`` the rank's rows, as
    :func:`make_prefill_step` takes them) it is a
    :class:`~repro_torch.core.graphed.CutGraph`, one per mesh (and so per
    group) too."""
    cache_len = (inputs["tokens"].shape[1] if max_seq is None
                 else max_seq) + model.cfg.n_meta_tokens
    serving = (None if mesh is None
               else mesh_serving(model, mesh, batch, cache_len))
    step = functools.partial(serve_prefill_step, model, cache_len,
                             use_flash, use_rwkv_kernel, serving=serving)
    return _serve_graph(model, ("prefill", cache_len, use_flash,
                                use_rwkv_kernel, _shapes(inputs))
                        + _mesh_key(mesh, batch),
                        (lambda: graphed.StepGraph(step)) if mesh is None
                        else lambda: graphed.CutGraph(
                            step, group=mesh.world,
                            counters=(partition.COLLECTIVES,)))


def compiled_decode(model: Model, carry: Tuple, *, mesh=None,
                    batch: Optional[int] = None,
                    max_seq: Optional[int] = None) -> graphed.StepGraph:
    """The graphed greedy decode step for ``carry``'s shapes (the batch,
    the caches', the cross keys and values'): ``graph(carry, index) ->
    (carry', logits)``, ``carry'`` the graph's static buffers (hand them
    back to the next call; ``graph.detach`` clones what a caller keeps).
    On a bound ``mesh`` (``batch`` the global batch, ``max_seq`` the
    decode budget in tokens, as :func:`make_decode_step` takes them) it
    is a :class:`~repro_torch.core.graphed.CutGraph`, one per mesh too."""
    serving = None
    if mesh is not None:
        serving = mesh_serving(model, mesh, batch,
                               max_seq + model.cfg.n_meta_tokens)
    step = functools.partial(serve_decode_step, model, serving=serving)
    return _serve_graph(model, ("decode", _shapes(carry))
                        + _mesh_key(mesh, batch),
                        (lambda: graphed.StepGraph(step)) if mesh is None
                        else lambda: graphed.CutGraph(
                            step, group=mesh.world,
                            counters=(partition.COLLECTIVES,)))


def serve_graphs(model: Model) -> List[Tuple[str, graphed.StepGraph]]:
    """``model``'s serve graphs as (``"prefill"`` or ``"decode"``, graph),
    the least recently used first."""
    return [(key[1], g) for key, (m, g) in _SERVE_GRAPHS.items()
            if m is model]


def release_serve_graphs(model: Optional[Model] = None) -> None:
    """Drop the serve graphs (``model``'s, or all) and their pools."""
    for key in [k for k, (m, _) in _SERVE_GRAPHS.items()
                if model is None or m is model]:
        _SERVE_GRAPHS.pop(key)[1].release()


# ---------------------------------------------------------------------------
# The compiled train, PBT and eval steps
# ---------------------------------------------------------------------------
def train_graph_step(ts: TrainStep, carry: Tuple[TrainState, Dict]
                     ) -> Tuple[Tuple[TrainState, Dict], Dict]:
    """The train step as a graphed step: ``carry`` is (state, batch),
    returned with the state's tensors updated in place and the batch as it
    came; its output is the metrics (0-d f32 tensors)."""
    state, batch = carry
    state, metrics = train_step(ts, state, batch)
    return (state, batch), metrics


def hyper_train_step(model: Model, order: Sequence[Sequence[str]],
                     carry: Tuple[TrainState, Dict], lr: torch.Tensor,
                     weight_decay: torch.Tensor
                     ) -> Tuple[Tuple[TrainState, Dict], Dict]:
    """PBT's step (the reference's jitted ``step_fn``,
    ``repro/launch/evolve.py``) as a graphed step: ``carry`` is (state,
    batch) as :func:`train_graph_step` takes it; ``lr`` and
    ``weight_decay`` are the member's hyperparameters, 0-d f32 device
    tensors (a graph's host values, filled before each replay)."""
    state, batch = carry
    with deterministic(state.opt.step.device):
        grads, metrics = loss_grads(model, state.params, batch)
        params, opt, om = adamw_update(grads, state.opt, state.params,
                                       lr=lr, weight_decay=weight_decay,
                                       order=order)
    return (TrainState(params, opt), batch), {**metrics, **om}


def eval_graph_step(model: Model, carry: Tuple[Params, Dict]
                    ) -> Tuple[Tuple[Params, Dict], torch.Tensor]:
    """PBT's eval (the reference's jitted ``eval_fn``) as a graphed step:
    ``carry`` is (parameters, batch), returned as it came (nothing is
    written); its output the 0-d total loss."""
    params, batch = carry
    return carry, loss_value(model, params, batch)[0]


def compiled_train_step(step: TrainStep) -> graphed.StepGraph:
    """The graphed train step of ``step``: ``graph((state, batch)) ->
    ((state, batch), metrics)``, a donating
    :class:`~repro_torch.core.graphed.StepGraph` (the reference's
    ``donate_argnums=(0,)``) whose static buffers are the first state it
    is given; the metrics are cloned out. One graph per step and state, so
    nothing caches it: a second state of the same shapes handed to it
    would be copied into the first's tensors. A mesh's step (one with a
    layout) is a donating :class:`~repro_torch.core.graphed.CutGraph`
    over the mesh's world, cut at its collectives (the forward's fetches
    and sums, the backward's, the global metrics, the sharded norm)."""
    fn = functools.partial(train_graph_step, step)
    if step.layout is not None:
        return graphed.CutGraph(fn, group=step.layout.mesh.world,
                                donate=True,
                                counters=(partition.COLLECTIVES,))
    return graphed.StepGraph(fn, donate=True)


def compiled_hyper_step(model: Model) -> graphed.StepGraph:
    """A PBT member's graphed step: ``graph((state, batch), lr,
    weight_decay) -> ((state, batch), metrics)``, donating, the
    hyperparameters Python floats filled into the graph's f32 host
    tensors."""
    return graphed.StepGraph(functools.partial(
        hyper_train_step, model, model.leaf_groups()), donate=True)


def compiled_eval(model: Model) -> graphed.StepGraph:
    """A PBT member's graphed eval: ``graph((params, batch)) -> ((params,
    batch), total)``, donating: its static parameters are the member's,
    so it reads them where the member's step graph writes them."""
    return graphed.StepGraph(functools.partial(eval_graph_step, model),
                             donate=True)
