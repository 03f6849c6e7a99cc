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
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..models import Model
from ..optim import AdamWState, adamw_init, adamw_update

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


class _Objective(nn.Module):
    """``Model.loss`` as a module's forward, for ``functional_call``."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, batch, **kw):
        return self.model.loss(batch, **kw)


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


def make_grad_fn(model: Model, remat_mode: str = "layer"
                 ) -> Callable[[Params, Dict], Tuple[Params, Dict]]:
    """``grads_of(params, batch) -> (grads, metrics)``: the gradient of
    ``model.loss`` at ``params`` (a dict by parameter name, put in place
    of the module's), in the parameters' dtypes, and the loss's metrics
    (detached)."""
    objective = _Objective(model)

    def grads_of(params: Params, batch: Dict) -> Tuple[Params, Dict]:
        with torch.enable_grad():
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            total, metrics = torch.func.functional_call(
                objective, {f"model.{k}": v for k, v in leaves.items()},
                (batch,), {"remat_mode": remat_mode})
            grads = torch.autograd.grad(total, list(leaves.values()))
        return (dict(zip(leaves, grads)),
                {k: v.detach() for k, v in metrics.items()})

    return grads_of


def make_eval_fn(model: Model) -> Callable[[Params, Dict], Tuple]:
    """``loss_of(params, batch) -> (total, metrics)`` of ``model.loss`` at
    ``params``, without autograd."""
    objective = _Objective(model)

    def loss_of(params: Params, batch: Dict):
        with torch.no_grad():
            return torch.func.functional_call(
                objective, {f"model.{k}": v for k, v in params.items()},
                (batch,))

    return loss_of


def make_train_step(model: Model, *,
                    schedule: Callable[[torch.Tensor], torch.Tensor],
                    accum_steps: int = 1,
                    weight_decay: float = 0.1,
                    max_grad_norm: Optional[float] = 1.0,
                    use_flash: bool = False,
                    use_rwkv_kernel: bool = False,
                    remat_mode: str = "layer",
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``accum_steps > 1`` splits the batch into sequential microbatches (the
    same math, 1/k of the live activations): the gradients are summed in
    f32 as ``acc + g / k`` and the metrics averaged. ``metrics`` holds the
    loss's (``ce``, ``loss``, the aux terms), ``grad_norm`` (before
    clipping) and ``lr``, 0-d f32 tensors."""
    if use_flash:
        raise NotImplementedError(_NO_KERNEL_GRAD.format(
            name="flash-attention", flag="use_flash"))
    if use_rwkv_kernel:
        raise NotImplementedError(_NO_KERNEL_GRAD.format(
            name="WKV", flag="use_rwkv_kernel"))
    grads_of = make_grad_fn(model, remat_mode)
    order = model.leaf_groups()

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = state.opt.step.device
        with deterministic(dev):
            if accum_steps == 1:
                grads, metrics = grads_of(state.params, batch)
            else:
                k = torch.tensor(float(accum_steps), dtype=torch.float32,
                                 device=dev)
                grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for n, p in state.params.items()}
                ms: List[Dict] = []
                for i in range(accum_steps):
                    micro = {key: _micro(x, accum_steps, i)
                             for key, x in batch.items()}
                    g, m = grads_of(state.params, micro)
                    grads = {n: grads[n] + g[n].float() / k for n in grads}
                    ms.append(m)
                metrics = {key: torch.stack([m[key] for m in ms]).mean()
                           for key in ms[0]}
            lr = schedule(state.opt.step)
            params, opt, om = adamw_update(
                grads, state.opt, state.params, lr=lr,
                weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                order=order)
        return TrainState(params, opt), {**metrics, **om}

    return step


def _micro(x: torch.Tensor, k: int, i: int) -> torch.Tensor:
    b = x.shape[0]
    assert b % k == 0, (b, k)
    return x[i * (b // k):(i + 1) * (b // k)]


def make_prefill_step(model: Model, *, max_seq: Optional[int] = None,
                      use_flash: bool = False,
                      use_rwkv_kernel: bool = False
                      ) -> Callable[[Dict], Tuple[torch.Tensor, List,
                                                  Optional[List]]]:
    """prefill(batch) -> (last-position logits (B, V), caches, cross_kvs
    or None). ``max_seq`` is the decode budget in tokens (the prompt and
    the new tokens); the ring caches hold the model's meta tokens
    besides. With ``use_flash`` every causal attention layer without a
    window runs the flash-attention kernel, with ``use_rwkv_kernel`` every
    RWKV layer the WKV kernel; each is ignored by the blocks without its
    mixer."""
    if max_seq is not None:
        max_seq += model.cfg.n_meta_tokens

    def prefill(batch: Dict) -> Tuple[torch.Tensor, List, Optional[List]]:
        return model.prefill(batch, use_flash=use_flash,
                             use_rwkv_kernel=use_rwkv_kernel,
                             max_seq=max_seq)

    return prefill


def make_decode_step(model: Model
                     ) -> Callable[[Dict], Tuple[torch.Tensor, List]]:
    """decode({'token', 'index', 'caches'[, 'cross_kvs']}) -> (logits
    (B, V), caches); ``index`` counts the meta tokens."""

    def decode(batch: Dict) -> Tuple[torch.Tensor, List]:
        return model.decode(batch["token"], batch["index"], batch["caches"],
                            batch.get("cross_kvs"))

    return decode
