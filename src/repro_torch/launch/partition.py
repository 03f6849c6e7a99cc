"""Shards on a mesh, and the collectives that run model land on them.

The reference leaves execution over its mesh to GSPMD; the port makes it
explicit. Three parts:

* **Shards.** A spec (:mod:`repro_torch.launch.shardings`) cuts a global
  tensor into contiguous blocks, one per mesh coordinate, as
  ``NamedSharding`` cuts it: a dim cut over ``("data", "model")`` holds
  block ``data * |model| + model``. :func:`shard`, :func:`shard_tree`
  cut; :func:`gather`, :func:`gather_tree` put the global tensor back on
  a bound mesh.
* **Collectives over mesh axes**, each through the axis's
  :class:`~repro_torch.core.sharded.ShardGroup`: :func:`gather_dim`
  (all-gather along a dim) and :func:`sum_axes` (the float sum in rank
  order, ``sum_in_order``, one axis after another). A one-rank axis costs
  nothing. Each call adds its bytes to :data:`COLLECTIVES` by kind, with
  the reference's ring factors (``dryrun.py:58-60``): an all-gather its
  output's bytes, a sum twice its output's. A step replayed as a cut
  graph (``core/graphed.py::CutGraph``) adds at each replay what its
  capture added, so graphed and eager steps count alike.
* **The step's layout**, :class:`Shards`: which parameter has which
  spec, and how a block fetches its weights. Storage follows the rules
  exactly. Compute splits over ``model`` at head granularity where the
  heads divide (:func:`head_split`), over the FFN's ``ff`` dim, the
  experts and the vocab, and over the batch on the data axes; a weight
  whose stored cut is not the compute's is all-gathered just before its
  layer (:meth:`Shards.w`) and freed with the layer. Inside a
  tensor-parallel region (:meth:`Shards.enter` ... :meth:`Shards.leave`,
  Megatron's f and g) each rank computes its part; the region's output is
  summed over ``model`` in rank order.

Gradients: a weight fetched for a tensor-parallel region (``tp=True``)
takes every rank's contribution (summed over the whole mesh); a weight of
replicated compute is summed over the batch's axes alone (the ranks of
one batch shard hold the same gradient).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .. import compat
from .mesh import Mesh, axis_size, dp_axes
from .shardings import Spec, tree_map

# ring-collective bytes-on-wire factor per output element (the
# reference's _COLL_FACTOR)
COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
COLLECTIVES: Dict[str, float] = {}
# a sum over ranks of at least this many bytes goes in pieces
SUM_PIECE_BYTES = 1 << 24


def _count(kind: str, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    COLLECTIVES[kind] = COLLECTIVES.get(kind, 0.0) + nbytes * COLL_FACTOR[kind]


def reset_collectives() -> Dict[str, float]:
    """The counts so far (with a ``total``), and zero them."""
    out = dict(COLLECTIVES)
    out["total"] = sum(out.values())
    COLLECTIVES.clear()
    return out


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# Shards of global tensors
# ---------------------------------------------------------------------------
def block_index(entry, mesh: Mesh, coord: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of a coordinate's block along a dim cut over
    ``entry``."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + coord[a]
        n *= mesh.shape[a]
    return idx, n


def region(shape, spec: Spec, mesh: Mesh, coord: Dict[str, int]
           ) -> Tuple[slice, ...]:
    """The slices of a coordinate's block of a global ``shape``."""
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        idx, n = block_index(e, mesh, coord)
        size = dim // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def shard(x: torch.Tensor, spec: Spec, mesh: Mesh,
          coord: Dict[str, int]) -> torch.Tensor:
    """A coordinate's block of the global ``x`` (a copy)."""
    return x[region(x.shape, spec, mesh, coord)].clone()


def shard_tree(tree: Any, specs: Any, mesh: Mesh,
               coord: Dict[str, int]) -> Any:
    """Every leaf of a global tree cut to a coordinate's block."""
    return tree_map(lambda x, s: shard(x, s, mesh, coord), tree, specs)


def gather(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The global tensor of the local blocks ``x`` (a bound mesh)."""
    for i, e in enumerate(spec):
        if e is not None:
            x = gather_dim(mesh, e, x, i)
    return x


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    return tree_map(lambda x, s: gather(x, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# Collectives over mesh axes (counted)
# ---------------------------------------------------------------------------
def gather_dim(mesh: Mesh, entry, x: torch.Tensor, dim: int
               ) -> torch.Tensor:
    """The blocks of every rank along ``entry``'s axes concatenated along
    ``dim`` (the last axis the fastest)."""
    for a in reversed(_axes(entry)):
        if mesh.shape[a] == 1:
            continue
        g = mesh.group(a)
        stacked = g.gather_stack(x.movedim(dim, 0).contiguous())
        _count("all-gather", stacked)
        x = stacked.reshape((-1,) + tuple(stacked.shape[2:])).movedim(0, dim)
    return x


def sum_axes(mesh: Mesh, axes: Iterable[str], x: torch.Tensor
             ) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes``, each axis in rank order.
    The sum in order gathers every rank's copy, so a large ``x`` is summed
    in as many pieces as the axis has ranks: the copies held at once are
    then about one ``x`` (each element's sum keeps its order)."""
    for a in axes:
        if mesh.shape[a] == 1:
            continue
        g = mesh.group(a)
        if x.numel() * x.element_size() < SUM_PIECE_BYTES or x.numel() < \
                g.world:
            x = g.sum_in_order(x)
        else:
            flat = x.reshape(-1)
            size = -(-flat.numel() // g.world)
            x = torch.cat([g.sum_in_order(p) for p in flat.split(size)]
                          ).reshape(x.shape)
        _count("all-reduce", x)
    return x


def max_axes(mesh: Mesh, axes: Iterable[str], x: torch.Tensor
             ) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``."""
    for a in axes:
        if mesh.shape[a] == 1:
            continue
        x = mesh.group(a).all_reduce(x, "max")
        _count("all-reduce", x)
    return x


def broadcast_axes(mesh: Mesh, axes: Iterable[str], x: torch.Tensor
                   ) -> torch.Tensor:
    """Coordinate 0's ``x`` along ``axes`` on every rank."""
    for a in axes:
        if mesh.shape[a] > 1:
            x = mesh.group(a).gather_stack(x)[0]
    return x


def own_rows(mesh: Mesh, axes: Sequence[str], x: torch.Tensor,
             dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` cut over ``axes``."""
    idx, n = block_index(tuple(axes) or None, mesh, mesh.coord)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------
class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over axes."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_axes(ctx.mesh, ctx.axes, g), None, None


class _Leave(torch.autograd.Function):
    """Megatron's g: the sum over axes forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_axes(mesh, axes, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; the rank's own block of the
    (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_dim(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        return (own_rows(ctx.mesh, ctx.axes, g, ctx.dim).contiguous(),
                None, None, None)


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, the gradient summed
    over the axes and the rank's own block taken (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return gather_dim(mesh, axes, x, dim)

    @staticmethod
    def backward(ctx, g):
        total = sum_axes(ctx.mesh, ctx.axes, g)
        return (own_rows(ctx.mesh, ctx.axes, total, ctx.dim).contiguous(),
                None, None, None)


class _SumOwnRows(torch.autograd.Function):
    """The sum over axes and the rank's own block forward; the gradient
    all-gathered backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return own_rows(mesh, axes, sum_axes(mesh, axes, x),
                        dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(ctx.mesh, ctx.axes, g, ctx.dim), None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


@dataclasses.dataclass(frozen=True)
class _Fetch:
    spec: Spec
    shape: Tuple[int, ...]
    cut: Optional[Tuple[int, int, int]]     # (dim, lo, hi) or None
    tp: bool


class _FetchFn(torch.autograd.Function):
    """A weight's compute view from its stored block: every stored cut
    gathered, except a cut over ``model`` that is the compute's own
    block, then the compute's cut taken. Backward: the gradient put back
    in the gathered shape, summed over the ranks that hold a part of it
    (the whole mesh for a tensor-parallel weight, the batch's axes for
    replicated compute; never over ``model`` where the block stayed
    local) and the stored block taken."""

    @staticmethod
    def forward(ctx, w, shards, f: _Fetch):
        ctx.shards, ctx.f = shards, f
        keep, cut = shards.plan(f)
        t = w
        for i, e in enumerate(f.spec):
            if e is not None and i != keep:
                t = gather_dim(shards.mesh, e, t, i)
        if cut is not None:
            t = t.narrow(cut[0], cut[1], cut[2] - cut[1])
        return t if t is not w else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        shards, f = ctx.shards, ctx.f
        mesh = shards.mesh
        keep, cut = shards.plan(f)
        full = g
        if cut is not None:
            shape = list(f.shape)
            if keep is not None:
                shape[keep] = g.shape[keep]
            full = g.new_zeros(shape)
            full.narrow(cut[0], cut[1], cut[2] - cut[1]).copy_(g)
        axes = mesh.axis_names if f.tp else shards.batch_axes
        if keep is not None:
            axes = tuple(a for a in axes if a != "model")
        full = sum_axes(mesh, axes, full)
        sl = list(region(f.shape, f.spec, mesh, mesh.coord))
        if keep is not None:
            sl[keep] = slice(None)
        return full[tuple(sl)].clone(), None, None


# ---------------------------------------------------------------------------
# Head splits
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """A rank's query heads [q0, q1) and the kv heads [k0, k1) they read
    (GQA: query head h reads kv head h // G)."""
    q0: int
    q1: int
    k0: int
    k1: int


def head_split(n_heads: int, n_kv: int, m: int, rank: int
               ) -> Optional[HeadSplit]:
    """Contiguous query heads per rank when ``m`` divides them and each
    rank's heads keep whole GQA groups (or share one kv head); None when
    the heads do not split (the layer is computed whole on every rank)."""
    if n_heads % m:
        return None
    hl, g = n_heads // m, n_heads // n_kv
    if hl % g and g % hl:
        return None
    q0, q1 = rank * hl, (rank + 1) * hl
    return HeadSplit(q0, q1, q0 // g, (q1 - 1) // g + 1)


# ---------------------------------------------------------------------------
# The step's layout
# ---------------------------------------------------------------------------
class Shards:
    """One step's layout on a bound mesh: the rules' ``mode``, each
    parameter's spec (``specs``, by name) and global shape, the axes
    that cut the batch (``batch_axes``), and whether ``model`` splits
    compute (``tp``: every mode but ``train_dp``, whose batch takes every
    axis). :meth:`register` names the step's parameter tensors, so a
    block can fetch a weight from the tensor it holds."""

    def __init__(self, mesh: Mesh, mode: str, specs: Dict[str, Spec],
                 shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.mode = mesh, mode
        self.specs, self.shapes = specs, shapes
        self.tp = mode != "train_dp"
        self.batch_axes = dp_axes(mesh) + (() if self.tp else ("model",))
        self._by_id: Dict[int, str] = {}
        self._held: List[torch.Tensor] = []
        # the decode caches' specs in their stacked layout (serving)
        self.cache_specs: Optional[List] = None

    @property
    def m(self) -> int:
        return self.mesh.shape["model"] if self.tp else 1

    @property
    def rank(self) -> int:
        return self.mesh.coord["model"] if self.tp else 0

    def register(self, tensors: Dict[str, torch.Tensor]) -> "Shards":
        self._by_id = {id(t): n for n, t in tensors.items()}
        self._held = list(tensors.values())
        return self

    def name_of(self, t: torch.Tensor) -> str:
        return self._by_id[id(t)]

    def plan(self, f: _Fetch) -> Tuple[Optional[int], Optional[tuple]]:
        """(the dim whose stored block over ``model`` is the compute's
        cut, kept as it is, or None; the cut still to take after the
        gathers, or None)."""
        if f.cut is None:
            return None, None
        dim, lo, hi = f.cut
        # a cut over axes of one rank besides model is model's cut
        if tuple(a for a in _axes(f.spec[dim])
                 if self.mesh.shape[a] > 1) == ("model",):
            size = f.shape[dim] // self.mesh.shape["model"]
            if lo == self.mesh.coord["model"] * size and hi - lo == size:
                return dim, None
        return None, f.cut

    def w(self, t: torch.Tensor, cut: Optional[Tuple[int, int, int]] = None,
          tp: bool = False) -> torch.Tensor:
        """The compute view of the registered parameter ``t``: the whole
        tensor, or ``cut`` = (dim, lo, hi) of it; ``tp`` for a weight
        used inside a tensor-parallel region."""
        name = self.name_of(t)
        f = _Fetch(tuple(self.specs[name]), tuple(self.shapes[name]), cut,
                   bool(tp and self.tp))
        if not torch.is_grad_enabled() and self._identity(f):
            # serving: the stored block is the view (the tensor itself,
            # so a product takes the path it takes on one device)
            return t
        return _FetchFn.apply(t, self, f)

    def _identity(self, f: _Fetch) -> bool:
        keep, cut = self.plan(f)
        if cut is not None and (cut[1] != 0 or cut[2] != f.shape[cut[0]]):
            return False
        return all(e is None or i == keep
                   or axis_size(self.mesh, _axes(e)) == 1
                   for i, e in enumerate(f.spec))

    def cols(self, t: torch.Tensor, lo: int, hi: int, dim: int = -1
             ) -> torch.Tensor:
        """Columns [lo, hi) of ``dim`` for a tensor-parallel region."""
        dim = dim % len(self.shapes[self.name_of(t)])
        return self.w(t, (dim, lo, hi), tp=True)

    def chunk(self, n: int) -> Tuple[int, int]:
        """This rank's block [lo, hi) of ``n`` over ``model``."""
        size = n // self.m
        return self.rank * size, (self.rank + 1) * size

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` splits over ``model`` in compute."""
        return self.tp and n % self.mesh.shape["model"] == 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region (gradient summed over model)."""
        return _Enter.apply(x, self.mesh, ("model",)) if self.tp else x

    def leave(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """Out of a region: the ranks' parts summed over model (in their
        dtype; then cast to ``dtype`` where given)."""
        if self.tp:
            x = _Leave.apply(x, self.mesh, ("model",))
        return x if dtype is None else x.to(dtype)

    def product(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w``, the last product of a tensor-parallel region, whose
        parts the ranks sum. Serving a bf16 or f16 model where the region
        splits, the part is the product's f32 accumulator, unrounded
        (:func:`f32_product`), so the parts are summed in f32 and rounded
        once after :meth:`leave`, as one device rounds its product once.
        Otherwise (one rank, training) the product as it is."""
        if (self.tp and self.m > 1 and not torch.is_grad_enabled()
                and x.dtype in (torch.bfloat16, torch.float16)):
            return f32_product(x, w)
        return x @ w

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks along ``dim`` (the vocab's logits)."""
        return _GatherDim.apply(x, self.mesh, ("model",), dim) \
            if self.tp else x

    def gather_rows(self, x: torch.Tensor, axes: Sequence[str]
                    ) -> torch.Tensor:
        return _GatherRows.apply(x, self.mesh, tuple(axes), 0)

    def sum_own_rows(self, x: torch.Tensor, axes: Sequence[str]
                     ) -> torch.Tensor:
        return _SumOwnRows.apply(x, self.mesh, tuple(axes), 0)

    def batch_count(self) -> int:
        return axis_size(self.mesh, self.batch_axes)

    def head_split(self, n_heads: int, n_kv: int) -> Optional[HeadSplit]:
        if not self.tp:
            return None
        return head_split(n_heads, n_kv, self.m, self.rank)


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of low-precision operands with an f32 result: the
    product's f32 accumulator. The route is
    :func:`~repro_torch.compat.f32_product_route`'s: on the card cuBLAS's
    mixed-precision GEMM (``torch.mm(..., out_dtype=torch.float32)``)
    where this torch has it, else the product of the operands cast to
    f32, which is exact in the products and sums in f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if compat.f32_product_route(x.device) == "mm out_dtype":
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x``, its gradient times ``s``."""
    return _ScaleGrad.apply(x, s)




# ---------------------------------------------------------------------------
# A model's layout on a mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Layout:
    """A model's parameters on a mesh under the rules' ``mode``: each
    parameter's spec (``specs``) and global shape (``shapes``) by name,
    and the optimizer state's specs (``opt``, ZeRO-1 on each parameter's
    own shape)."""
    mesh: Mesh
    mode: str
    cfg: Any
    specs: Dict[str, Spec]
    shapes: Dict[str, Tuple[int, ...]]
    opt: Dict[str, Spec]
    memo: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    def shards(self) -> Shards:
        return Shards(self.mesh, self.mode, self.specs, self.shapes)

    def zero_dim(self, name: str) -> Optional[int]:
        """The dim ZeRO-1 cuts over ``data`` beyond the parameter's own
        cut, or None."""
        for i, (a, b) in enumerate(zip(self.specs[name], self.opt[name])):
            if a != b:
                return i
        return None

    def local(self, name: str, x: torch.Tensor, opt: bool = False
              ) -> torch.Tensor:
        """The block of the global ``x`` (a parameter or, ``opt``, an
        optimizer leaf) this rank holds."""
        return shard(x, (self.opt if opt else self.specs)[name], self.mesh,
                     self.mesh.coord)


def param_layout(model, mesh: Mesh, mode: str = "train") -> Layout:
    """The layout of ``model``'s parameters (``Model.param_axes()`` through
    the rules)."""
    from . import shardings
    cfg = model.cfg
    axes = model.param_axes()
    stand = model.abstract_params()
    specs = {n: shardings.pspec(axes[n], tuple(stand[n].shape), cfg, mesh,
                                mode) for n in axes}
    shapes = {n: tuple(stand[n].shape) for n in axes}
    opt = {n: shardings.zero1_pspec(specs[n], shapes[n], mesh)
           for n in axes}
    return Layout(mesh, mode, cfg, specs, shapes, opt)


def build_local(cfg, mesh: Mesh, mode: str = "train", device=None,
                generator: Optional[torch.Generator] = None,
                coord: Optional[Dict[str, int]] = None):
    """A ``Model`` of ``cfg`` holding this rank's blocks of its parameters
    under the rules' ``mode`` (at ``coord``, by default the bound mesh's):
    every parameter is drawn whole from ``generator`` in the global
    model's order, so the blocks are those of ``Model(cfg, device,
    generator)``, and cut at once, so a rank never holds more than its
    blocks and one whole parameter (the largest: its f32 draw)."""
    from ..models import Model
    from . import shardings
    at = mesh.coord if coord is None else coord

    def cut(x: torch.Tensor, axes) -> torch.Tensor:
        spec = shardings.pspec(axes, tuple(x.shape), cfg, mesh, mode)
        return shard(x, spec, mesh, at)

    return Model(cfg, device, generator, cut=cut)


def cache_pspecs(model, mesh: Mesh, batch: int, max_seq: int) -> List:
    """The decode caches' specs (stacked layout) for a global ``batch``
    and ``max_seq`` slots, under the serve rules."""
    from . import shardings
    from ..models.common import axes_maker, shape_maker
    cfg = model.cfg
    return shardings.tree_pspecs(
        model.cache_specs(axes_maker(), batch, max_seq),
        model.cache_specs(shape_maker(cfg.activation_dtype), batch, max_seq),
        cfg, mesh, "serve")


def load_local(model, layout: Layout, params: Dict[str, torch.Tensor]
               ) -> None:
    """Put this rank's blocks ``params`` (by name) in ``model`` in place
    of its parameters (a serving model holds its shards)."""
    from torch import nn
    for name, t in params.items():
        *path, leaf = name.split(".")
        mod = model
        for part in path:
            mod = getattr(mod, part)
        setattr(mod, leaf, nn.Parameter(t))
