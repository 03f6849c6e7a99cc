"""CUDA graphs of the drivers' steps: the port's ``jax.jit``.

The reference compiles its island drivers (``repro.core.evolution.
fused_jit``): ``run_fused``'s ``lax.scan`` segment, ``run_experiment``'s
jitted ``epoch_step`` and their asynchronous twins each run as one XLA
executable, with no host launch per operation; its serving loop jits the
prefill and the decode step (``repro.launch.serve``), its train loop the
train step with the state donated (``repro.launch.train``), and PBT its
step and eval (``repro.launch.evolve``). The port records the same unit
of work once as a CUDA graph and replays it: the island steps
(:mod:`repro_torch.core.evolution`,
:mod:`repro_torch.core.async_migration`), the serve steps and the train,
PBT and eval steps (:mod:`repro_torch.launch.steps`:
``serve_prefill_step``, ``serve_decode_step``, ``train_graph_step``,
``hyper_train_step``, ``eval_graph_step``). :class:`StepGraph` holds a
step's carry in static buffers:

* the first call clones the carry into the static buffers, runs the step
  once on a side stream (the warm-up: it builds the kernels, runs the
  tiled kernel's autotune, which times and synchronises, and settles the
  allocator), then captures the step and the copy of its result back into
  the static buffers;
* every call copies the caller's carry in (leaves that are the static
  buffers already are skipped), fills the host values of this step (the
  host loops' epoch or tick, the server's state, a PBT member's learning
  rate and weight decay) into 0-d static tensors, replays, and returns the
  static carry with a clone of the step's other output (a tree: the island
  steps' stats row, the decode step's logits, the prefill's logits, caches
  and cross keys and values, the train step's metrics). The driver loops
  hand the static carry straight back to the next call;
  :meth:`StepGraph.detach` clones it for the caller at the end of a run,
  so nothing a caller holds is overwritten by a later replay.

The donating form (``StepGraph(step, donate=True)``, the counterpart of
``donate_argnums``) is for a step that consumes its carry: the train
step's AdamW reads the moments, the master and the parameters it writes
in place, so a warm-up before the capture would step them once more than
the counter, and a clone of minicpm-2b's state (38.1 GB) beside the
caller's would not fit the card. Its rule: the first call adopts the
carry's tensors as the static buffers (no clone), runs the warm-up on
the side stream as that call's real step, assigns the warm-up's whole
result into the static buffers and returns it, then captures, which runs
nothing on the card; every later call replays. The caller's tensors are
the state from then on (a later replay updates them, as the eager step
would), and :meth:`StepGraph.release` drops the graph and its pool but
never the caller's tensors. A carry given later that is not the static
one is copied in, as in the other form: a PBT member's adopted payload
lands in its buffers at its next step.

A step may also update a carried leaf in place and return it as itself
(the decode step writes its token's key, value and position into the
ring caches): the copy back skips it. The warm-up then writes the static
buffers too; that is harmless only where the step writes before it reads
what it writes, so that a replay after the warm-up writes the same bits
(``tests/test_torch_serve_graphs.py`` holds the decode step to it). A
step that reads what it writes takes the donating form.

The train steps capture their backward: ``torch.autograd.grad`` runs
inside the capture (autograd's device thread launches on the capture's
stream), with remat's recompute (``torch.utils.checkpoint`` without the
RNG state, whose save reads the host) and the deterministic algorithms'
setting entered inside the step. Their graphed runs equal the eager ones
bit for bit (``tests/test_torch_train_graphs.py``, ``chip_smoke.py``
phase 13).

Units. The kernel impls (``pallas``, ``pallas_tiled``: about 200 launches
a generation) capture the whole step, ``generations_per_epoch``
generations and the exchange, as one graph. Where the generation is the
plain PyTorch operators on the card (``jnp``, ``pallas_ref``: thousands of
launches a generation), an epoch graph would hold hundreds of thousands of
nodes, so one generation is captured twice (from the carry's islands, and
from the evolved islands) and replayed ``generations_per_epoch`` times in
all, then a tail graph of the exchange reads the evolved islands
(:func:`unit_of`).

The sharded drivers' ranks (:mod:`repro_torch.core.sharded`, the
counterpart of the reference's jitted ``shard_map``) replay only their
generations: :class:`RankGraph` captures a rank's ``island_epoch`` (or
its generation, under the plain impls) and hands the evolved islands to
the rest of the step, called eagerly, whose exchange between ranks copies
to the host, synchronises and waits on the other ranks between replays.

The mesh's steps (a train, prefill or decode step on a bound mesh,
:mod:`repro_torch.launch.partition`, the counterpart of ``jax.jit`` with
``in_shardings``) hold many collectives a step, in the forward and in
autograd's backward. :class:`CutGraph` replays such a step as a chain cut
at its collectives: a *segment* is a CUDA graph of the work between two
collectives, a *collective node* the collective run eagerly on the
segment's static output. Every collective of a rank passes through
``ShardGroup._timed``, the one place that cuts (:func:`cutting`). The
first call is the eager step; the second captures segment by segment,
each segment replayed as soon as it is captured so that the collective
after it reads real values (that pass is the second call's step); every
later call replays the chain. Each rank's count of segments and cuts is
held equal across the world by one integer all-reduce after the capture:
a rank that cut elsewhere would hang its peer at the first replay. A
segment ends by copying the collective's input to an input buffer, the
node leaves its result in a result buffer, and the next segment begins
with a copy of it (one buffer of each a graph, grown as needed): so no
tensor of a segment outlives the step's last use of it, and the segments
reuse their pool as one graph would. A node that held its own input and
output pinned every collective's tensors, 195 of up to 128 MiB a rank in
yi-9b's (1, 2) prefill, and ran two ranks out of one card's memory.

The thread rule. A cut inside the backward falls on autograd's device
thread, so a segment may begin on one thread and end on another, which
``cudaStreamEndCapture`` allows only in the ``relaxed`` capture mode: in
``thread_local`` (and ``global``) mode it refuses the end of a capture
begun by another thread ("attempt to terminate a thread-local capture
sequence from another thread", ``cudaErrorStreamCaptureWrongThread``,
read on an H100 with torch 2.11, ``tests/test_torch_mesh_graphs_cuda.py``).
The segments are
captured ``relaxed`` (:data:`CUT_CAPTURE_MODE`); the steps' purity is
held by the capture checks on the CPU (``tests/_torch_capture.py``)
instead of by the mode.

A captured region reads no device value on the host and copies nothing
from host memory: the drivers' steps keep to that (their Python values
are kernel arguments or fills, :func:`repro_torch.rand.const`,
:func:`repro_torch._device.as_device`). What needs the host stays between
replays: the fused drivers' early-stop latch without W², a bridge's sync,
the host loops' stats read. A capture that fails raises; there is no
eager fallback on the card.

Launch counts. ``kernels.LAUNCHES`` counts Python calls to the wrappers,
and a replay makes none. The warm-up's and the capture's calls are taken
back out of the counts; each graph records the launches its capture saw
per wrapper, and each replay adds them (a donating graph's first call
adds them once for its warm-up, which was a real step), so a graphed run
counts what the eager run counts.
"""
from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import kernels
from . import evolution as evolution_lib
from . import island as island_lib

# generation impls that run plain PyTorch operators on the card: captured
# a generation at a time
PLAIN_IMPLS = ("jnp", "pallas_ref")


def graphs_on(device: torch.device) -> bool:
    """Whether the drivers replay graphs on ``device``: on the card, and
    nowhere else."""
    return device.type == "cuda"


def unit_of(cfg) -> str:
    """``"generation"`` where ``cfg.impl``'s generation is plain PyTorch
    on the card (and an epoch has generations), else ``"epoch"``."""
    if cfg.impl in PLAIN_IMPLS and cfg.generations_per_epoch > 0:
        return "generation"
    return "epoch"


def unit_args(problem, cfg) -> Dict[str, object]:
    """:class:`StepGraph`'s ``evolve`` and ``gens`` for ``cfg``'s unit
    (none for the epoch unit)."""
    if unit_of(cfg) == "epoch":
        return {}
    return {"evolve": functools.partial(island_lib.generation_step,
                                        problem=problem, cfg=cfg),
            "gens": cfg.generations_per_epoch}


def host_scalar(value, device) -> torch.Tensor:
    """A host loop's per-step Python value (a bool: the server's state; an
    int: the epoch or tick; a float: a PBT member's learning rate or weight
    decay) as the 0-d device tensor the step reads: bool, int32 or f32, a
    float rounded as ``torch.tensor(value, dtype=torch.float32)`` rounds
    it."""
    if isinstance(value, bool):
        dtype = torch.bool
    elif isinstance(value, float):
        dtype = torch.float32
    else:
        dtype = torch.int32
    return torch.full((), value, dtype=dtype, device=device)


class EagerStep:
    """The CPU's counterpart of :class:`StepGraph`: the step called
    directly, its host values made device scalars as the graph's are."""

    capture_s = 0.0
    pool_bytes = 0

    def __init__(self, step: Callable, device):
        self.step, self.device = step, torch.device(device)

    def __call__(self, carry, *host):
        return self.step(carry, *(host_scalar(v, self.device) for v in host))

    def detach(self, tree):
        return tree


def _assign(static: List[torch.Tensor], new: List[torch.Tensor]) -> None:
    """Copy ``new`` into ``static`` leaf by leaf. A new leaf that is its
    static buffer is skipped; one that shares storage with any static
    buffer is copied first (:func:`~repro_torch.core.evolution.
    unique_buffers`), so no copy reads what an earlier copy overwrote."""
    pending = [(s, n) for s, n in zip(static, new)
               if n is not s and isinstance(s, torch.Tensor)]
    if not pending:
        return
    for s, n in pending:
        if n.shape != s.shape or n.dtype != s.dtype:
            raise ValueError(
                f"graphed step: a carried leaf of {n.dtype} "
                f"{tuple(n.shape)} for the static {s.dtype} "
                f"{tuple(s.shape)}")
    fresh = evolution_lib.unique_buffers(
        list(static) + [n for _, n in pending])[len(static):]
    for (s, _), n in zip(pending, fresh):
        s.copy_(n)


class _Graph:
    """One captured graph, the times it replays per step and the wrapper
    launches its capture recorded."""

    def __init__(self, graph: torch.cuda.CUDAGraph, times: int,
                 launches: Dict[str, int]):
        self.graph, self.times, self.launches = graph, times, launches


class StepGraph:
    """A driver step replayed as CUDA graphs over static buffers.

    ``step(carry, *host, evolved=None) -> (carry', out)``: ``carry`` a
    tree of tensors (the island steps': the islands first), ``host`` the
    0-d tensors of the step's host values, ``out`` a tree of tensors or
    None (the packed stats row; the served logits, caches and cross keys
    and values). Under the generation unit ``evolve(islands) ->
    islands`` is one generation, replayed ``gens`` times before the step,
    which then takes the evolved islands as ``evolved``.

    ``donate=True`` is the form for a step that consumes its carry (the
    train step's in-place AdamW; the module docstring states its rule):
    the first call adopts the carry's tensors as the static buffers, its
    warm-up is that call's step, and :meth:`release` leaves them to the
    caller. It takes no ``evolve``.

    ``capture_s`` is the warm-up and capture time, ``pool_bytes`` the
    device memory of the graphs' private pool (its segments in
    ``torch.cuda.memory_snapshot``),
    ``launches`` the wrapper launches of one replayed step."""

    def __init__(self, step: Callable, *, evolve: Optional[Callable] = None,
                 gens: int = 0, donate: bool = False):
        if donate and evolve is not None:
            raise ValueError("graphed step: a donating step graph captures "
                             "the step whole (no evolve)")
        self.step, self.evolve, self.gens = step, evolve, gens
        self.donate = donate
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.captures = 0
        self._reset()

    def _reset(self) -> None:
        self.graphs: List[_Graph] = []
        self.carry = None
        self.host: Tuple[torch.Tensor, ...] = ()
        self._static: List[torch.Tensor] = []
        self._spec = None
        self._evolved: List[torch.Tensor] = []
        self.evolved = None
        self._out = None

    @property
    def launches(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self.graphs:
            for name, n in g.launches.items():
                out[name] = out.get(name, 0) + n * g.times
        return out

    def __call__(self, carry, *host):
        if self.carry is None and self.donate:
            return self._adopt(carry, host)
        if self.carry is None:
            self._capture(carry, host)
        else:
            leaves, spec = pytree.tree_flatten(carry)
            if spec != self._spec:
                raise ValueError("graphed step: the carry's structure "
                                 "changed since the capture")
            _assign(self._static, leaves)
        for t, v in zip(self.host, host):
            t.fill_(v)
        self._replay()
        return self.carry, pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            self._out)

    def _replay(self) -> None:
        for g in self.graphs:
            for _ in range(g.times):
                g.graph.replay()
            for name, n in g.launches.items():
                kernels.LAUNCHES[name] += n * g.times

    def detach(self, tree):
        """``tree`` with clones of the leaves that share storage with a
        static or an evolved buffer."""
        owned = {t.untyped_storage().data_ptr()
                 for t in self._static + self._evolved
                 if isinstance(t, torch.Tensor)}

        def own(x):
            if isinstance(x, torch.Tensor) and \
                    x.untyped_storage().data_ptr() in owned:
                return x.clone()
            return x
        return pytree.tree_map(own, tree)

    def release(self) -> None:
        """Drop the graphs, their private pool and the static buffers; a
        later call captures again. A donating graph's static buffers are
        the caller's tensors: they are dropped here, never freed."""
        for g in self.graphs:
            g.graph.reset()
        self._reset()

    # -- capture -----------------------------------------------------------
    def _capture(self, carry, host) -> None:
        leaves, self._spec = pytree.tree_flatten(carry)

        def record():
            self._static = [t.clone() if isinstance(t, torch.Tensor) else t
                            for t in leaves]
            self.carry = pytree.tree_unflatten(self._static, self._spec)
            dev = self._static_device()
            self.host = tuple(host_scalar(v, dev) for v in host)
            step = self.step
            if self.evolve is not None and self.gens > 0:
                self._record_evolve(self.carry[0])
                step = functools.partial(self.step, evolved=self.evolved)
            self._out = self._record(lambda: step(self.carry, *self.host),
                                     self._static, 1)
        self._captured(record)

    def _adopt(self, carry, host):
        """The donating form's first call: the carry's tensors become the
        static buffers, the warm-up on the side stream is this call's step
        (its whole result assigned into them, its other output returned
        cloned), then the capture records the step, running nothing. The
        warm-up's launches count once, as an eager call's would."""
        leaves, spec = pytree.tree_flatten(carry)
        first = []

        def record():
            self._spec = spec
            self._static = list(leaves)
            self.carry = pytree.tree_unflatten(self._static, spec)
            dev = self._static_device()
            self.host = tuple(host_scalar(v, dev) for v in host)

            def fn():
                return self.step(self.carry, *self.host)
            first.append(self._warm(fn, self._static, keep=True))
            self._out = self._record(fn, self._static, 1, warm=False)
        self._captured(record)
        for g in self.graphs:
            for name, n in g.launches.items():
                kernels.LAUNCHES[name] += n
        return self.carry, first[0]

    def _static_device(self) -> torch.device:
        return next(t for t in self._static
                    if isinstance(t, torch.Tensor)).device

    def _captured(self, record: Callable[[], None]) -> None:
        """Run ``record`` (which fills the static buffers and records the
        graphs), its wrapper launches taken back out of the counts, and
        time it; a capture that fails releases what it made and raises."""
        t0 = time.perf_counter()
        counts = dict(kernels.LAUNCHES)
        try:
            record()
        except BaseException:
            self.release()
            raise
        finally:
            kernels.LAUNCHES.update(counts)
        torch.cuda.synchronize(self._static_device())
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        pool = self.graphs[0].graph.pool()
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)

    def _record_evolve(self, islands) -> None:
        """Record the generations from the static ``islands`` into the
        evolved buffers (``self.evolved``): ``evolve`` once from
        ``islands``, then ``gens - 1`` times from the evolved islands."""
        i_leaves, i_spec = pytree.tree_flatten(islands)
        self._evolved = [t.clone() for t in i_leaves]
        self.evolved = pytree.tree_unflatten(self._evolved, i_spec)
        self._record(lambda: (self.evolve(islands), None), self._evolved, 1)
        if self.gens > 1:
            self._record(lambda: (self.evolve(self.evolved), None),
                         self._evolved, self.gens - 1)

    @staticmethod
    def _warm(fn, target: List[torch.Tensor], keep: bool = False):
        """Run ``fn`` once on a side stream (the warm-up). With ``keep`` its
        tree is assigned into ``target`` and its other output returned
        cloned (a donating graph's first step), else both are dropped."""
        dev = next(t for t in target if isinstance(t, torch.Tensor)).device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        out = None
        with torch.cuda.stream(side):
            tree, out = fn()
            if keep:
                leaves = pytree.tree_leaves(tree)
                if len(leaves) != len(target):
                    raise ValueError("graphed step: the step returned "
                                     "another carry than it was given")
                _assign(target, leaves)
                out = pytree.tree_map(
                    lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, out)
        main.wait_stream(side)
        return out if keep else None

    def _record(self, fn, target: List[torch.Tensor], times: int,
                warm: bool = True):
        """Warm ``fn`` up on a side stream (unless ``warm`` is False: a
        donating graph's caller ran it), then capture it and the copy of
        its tree into ``target`` as the next of this step's graphs, and
        return ``fn``'s other output. The graphs share one private pool:
        they replay in the order of their capture, each reading only the
        static buffers and its own temporaries. The capture's wrapper
        launches are recorded, not counted."""
        if warm:
            self._warm(fn, target)
        graph = torch.cuda.CUDAGraph()
        pool = self.graphs[0].graph.pool() if self.graphs else None
        before = dict(kernels.LAUNCHES)
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            tree, out = fn()
            leaves = pytree.tree_leaves(tree)
            if len(leaves) != len(target):
                raise ValueError("graphed step: the step returned another "
                                 "carry than it was given")
            _assign(target, leaves)
        self.graphs.append(_Graph(graph, times, {
            name: kernels.LAUNCHES[name] - n for name, n in before.items()
            if kernels.LAUNCHES[name] != n}))
        return out


class RankGraph(StepGraph):
    """A rank's step of the sharded drivers (:mod:`repro_torch.core.
    sharded`): its generations replayed as graphs, the rest of the step
    called eagerly.

    ``evolve(islands) -> islands`` is the captured stretch, replayed
    ``gens`` times a step: the rank's whole ``island_epoch`` (the epoch
    unit, ``gens`` 1) or one generation (the generation unit, captured
    from the carry's islands and from the evolved ones, as
    :class:`StepGraph` does). ``tail(carry, *host, evolved=islands)`` is
    the step after them: the exchange between ranks, the stats and the
    stop latch, whose collectives copy to the host, synchronise the
    stream and wait on the other ranks, which no graph holds. The tail
    gets the carry with its islands in their static buffers, the evolved
    islands in theirs and the host values as given, and its result is
    returned as it is.

    The tail may pass a static or an evolved buffer through into its
    result (a field the exchange leaves as it was); the next replay
    overwrites it, and :meth:`detach` clones it."""

    def __init__(self, evolve: Callable, tail: Callable, gens: int = 1):
        super().__init__(tail, evolve=evolve, gens=gens)

    def __call__(self, carry, *host):
        leaves, spec = pytree.tree_flatten(carry[0])
        if self.carry is None:
            def record():
                self._spec = spec
                self._static = [t.clone() for t in leaves]
                self.carry = pytree.tree_unflatten(self._static, spec)
                self._record_evolve(self.carry)
            self._captured(record)
        else:
            if spec != self._spec:
                raise ValueError("graphed step: the islands' structure "
                                 "changed since the capture")
            _assign(self._static, leaves)
        self._replay()
        return self.step((self.carry,) + tuple(carry[1:]), *host,
                         evolved=self.evolved)


def rank_graph(problem, cfg, tail: Callable) -> RankGraph:
    """The card's :class:`RankGraph` of a sharded driver's step ``tail``
    under ``cfg``'s unit: ``island_epoch`` captured whole, or a
    generation replayed ``generations_per_epoch`` times."""
    gen = unit_args(problem, cfg)
    if gen:
        return RankGraph(gen["evolve"], tail, gen["gens"])
    return RankGraph(functools.partial(island_lib.island_epoch,
                                       problem=problem, cfg=cfg), tail)


# The capture mode of a cut graph's segments: a cut inside the backward
# ends on autograd's device thread a capture begun on another thread (the
# module docstring's thread rule).
CUT_CAPTURE_MODE = "relaxed"

# the cut graph whose capture pass is running (None: no cut is taken)
_CUT: Optional["CutGraph"] = None


def cutting() -> Optional["CutGraph"]:
    """The :class:`CutGraph` whose capture pass is running, whose
    :meth:`~CutGraph.collective` a collective must go through; None
    outside a capture pass (every collective then runs as it is)."""
    return _CUT


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for the cut graphs' captures (its cuBLAS
    workspace made once, as ``torch.cuda.graph``'s shared stream)."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _snapshot(counters) -> List[Dict]:
    return [dict(c) for c in counters]


def _deltas(counters, before: List[Dict]) -> List[Dict]:
    return [{k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
            for c, b in zip(counters, before)]


class _Segment:
    """A cut graph's segment: its graph and what its capture added to
    each counter."""

    def __init__(self, graph: torch.cuda.CUDAGraph, added: List[Dict]):
        self.graph, self.added = graph, added


class _Node:
    """A cut graph's collective node: ``fn`` run by ``group`` on ``src``
    (where the segment before it left the collective's input), its result
    copied to ``dst`` (where the segment after it reads it)."""

    def __init__(self, group, fn: Callable, src: torch.Tensor,
                 dst: torch.Tensor):
        self.group, self.fn, self.src, self.dst = group, fn, src, dst
        # a served step's collectives ran under inference mode, and their
        # buffers' views are inference tensors, which only it writes
        self.inference = torch.is_inference_mode_enabled()

    def run(self) -> None:
        with (torch.inference_mode() if self.inference
              else torch.no_grad()):
            self.dst.copy_(self.group._run_timed(self.fn, self.src))


def _view(buffers: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """A contiguous view of ``like``'s shape and dtype at the start of the
    last of ``buffers`` (bytes), which grows by a new buffer where it is
    too small: an earlier one stays, as the graphs captured so far read
    it."""
    n = like.numel() * like.element_size()
    cap = buffers[-1].numel() if buffers else 0
    if n > cap:
        buffers.append(torch.empty(max(n, 2 * cap), dtype=torch.uint8,
                                   device=like.device))
    return buffers[-1][:n].view(like.dtype).view(like.shape)


class CutGraph:
    """A rank's step on a bound mesh replayed as a chain of CUDA graphs
    cut at its collectives (the module docstring).

    ``step(carry, *host) -> (carry', out)`` as :class:`StepGraph` takes
    it: the train step (:func:`~repro_torch.launch.steps.train_graph_step`,
    ``donate=True``: the first call adopts the caller's state as the
    static buffers, as the donating :class:`StepGraph` does) or a serve
    step (the plain
    form: the second call clones the carry into static buffers). ``group``
    is the world's :class:`~repro_torch.core.sharded.ShardGroup`, over
    which the ranks' cuts are held equal; ``counters`` are dicts of counts
    the step's Python adds to besides ``kernels.LAUNCHES`` (the mesh's
    collective bytes, ``partition.COLLECTIVES``): each segment records
    what its capture added, and each replay adds it.

    ``cuts`` and ``segments`` count the chain's nodes, ``capture_s`` is
    the capture pass's time (a real step), ``pool_bytes`` the segments'
    private pool, ``captures`` 1 once captured."""

    def __init__(self, step: Callable, *, group, donate: bool = False,
                 counters: Tuple[Dict, ...] = ()):
        self.step, self.group, self.donate = step, group, donate
        self.extra = tuple(counters)
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.captures = 0
        self._reset()

    def _reset(self) -> None:
        self.calls = 0
        self.chain: List[object] = []
        self.carry = None
        self.host: Tuple[torch.Tensor, ...] = ()
        self._static: List[torch.Tensor] = []
        self._spec = None
        self._out = None
        self._open = None       # (graph, counters before) while capturing
        # where a segment leaves a collective's input and where the
        # collective leaves its result for the next segment: one buffer
        # each (grown as needed), so no segment's tensor is held past its
        # last use and the pool is reused across segments as in one graph
        self._inputs: List[torch.Tensor] = []
        self._results: List[torch.Tensor] = []

    @property
    def counters(self) -> Tuple[Dict, ...]:
        return (kernels.LAUNCHES,) + self.extra

    @property
    def segments(self) -> int:
        return sum(isinstance(x, _Segment) for x in self.chain)

    @property
    def cuts(self) -> int:
        return sum(isinstance(x, _Node) for x in self.chain)

    def __call__(self, carry, *host):
        self.calls += 1
        leaves, spec = pytree.tree_flatten(carry)
        if self.calls == 1:
            return self._eager(carry, leaves, spec, host)
        if spec != self._spec and self._spec is not None:
            raise ValueError("graphed step: the carry's structure changed "
                             "since the first call")
        if not self.chain:
            return self._capture(leaves, spec, host)
        _assign(self._static, leaves)
        for t, v in zip(self.host, host):
            t.fill_(v)
        for x in self.chain:
            if isinstance(x, _Segment):
                x.graph.replay()
                for c, added in zip(self.counters, x.added):
                    for name, n in added.items():
                        c[name] = c.get(name, 0) + n
            else:
                x.run()
        return self.carry, self._cloned()

    def _cloned(self):
        return pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            self._out)

    def _eager(self, carry, leaves, spec, host):
        """The first call: the step run eagerly (it builds the kernels,
        the cuBLAS handles and the gathers' staging). The donating form
        adopts the carry's tensors as the static buffers and returns
        them."""
        dev = next(t for t in leaves if isinstance(t, torch.Tensor)).device
        tree, out = self.step(carry, *(host_scalar(v, dev) for v in host))
        if not self.donate:
            return tree, out
        self._spec, self._static = spec, list(leaves)
        self.carry = pytree.tree_unflatten(self._static, spec)
        new = pytree.tree_leaves(tree)
        if len(new) != len(self._static):
            raise ValueError("graphed step: the step returned another "
                             "carry than it was given")
        _assign(self._static, new)
        return self.carry, out

    def _capture(self, leaves, spec, host):
        """The second call: the step captured segment by segment, each
        segment replayed once captured (this call's step), then the cuts
        held equal across the world."""
        global _CUT
        if self.donate:
            _assign(self._static, leaves)
        else:
            self._spec = spec
            self._static = [t.clone() if isinstance(t, torch.Tensor) else t
                            for t in leaves]
            self.carry = pytree.tree_unflatten(self._static, spec)
        dev = next(t for t in self._static
                   if isinstance(t, torch.Tensor)).device
        self.host = tuple(host_scalar(v, dev) for v in host)
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        # as torch.cuda.graph does before a capture: the eager call's
        # freed temporaries go back to the card for the segments' pool
        gc.collect()
        torch.cuda.empty_cache()
        main = torch.cuda.current_stream(dev)
        side = _capture_stream(dev)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                _CUT = self
                try:
                    self._begin()
                    tree, self._out = self.step(self.carry, *self.host)
                    new = pytree.tree_leaves(tree)
                    if len(new) != len(self._static):
                        raise ValueError("graphed step: the step returned "
                                         "another carry than it was given")
                    _assign(self._static, new)
                    self._end()
                except BaseException:
                    # on the capture's stream, where its open segment ends
                    self._abort()
                    raise
        finally:
            _CUT = None
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        self._agree()
        pool = self.chain[0].graph.pool()
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)
        return self.carry, self._cloned()

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        pool = self.chain[0].graph.pool() if self.chain else None
        before = _snapshot(self.counters)
        graph.capture_begin(pool=pool, capture_error_mode=CUT_CAPTURE_MODE)
        self._open = (graph, before)

    def _end(self) -> None:
        graph, before = self._open
        self._open = None
        graph.capture_end()
        self.chain.append(_Segment(graph, _deltas(self.counters, before)))
        graph.replay()

    def collective(self, group, fn: Callable, x: torch.Tensor):
        """``fn(x)``, a collective of the step being captured (called by
        ``ShardGroup._timed``): the open segment copies ``x`` to the input
        buffer, ends and is replayed; ``fn`` runs eagerly on the buffer as
        the next node and its result goes to the result buffer; the next
        segment begins with its own copy of the result, which it returns
        (on the card its values exist once the segment replays)."""
        if self._open is None:
            raise RuntimeError("cut graph: a collective inside a "
                               "collective")
        with torch.no_grad():
            src = _view(self._inputs, x)
            src.copy_(x)
        self._end()
        out = group._run_timed(fn, src)
        if not isinstance(out, torch.Tensor):
            raise TypeError("cut graph: a collective must return one tensor")
        dst = _view(self._results, out)
        dst.copy_(out)
        self.chain.append(_Node(group, fn, src, dst))
        self._begin()
        with torch.no_grad():
            return dst.clone()

    def _abort(self) -> None:
        """A capture that failed: the open segment is ended (what it
        recorded is dropped) and the chain released."""
        if self._open is not None:
            graph = self._open[0]
            self._open = None
            try:
                graph.capture_end()
            except RuntimeError:
                pass
        self.release()

    def _agree(self) -> None:
        """Every rank's segments and cuts equal, or raise on every rank
        (one integer all-reduce of the counts and their negations, max)."""
        import torch.distributed as dist
        counts = [self.segments, self.cuts]
        t = torch.tensor(counts + [-c for c in counts], dtype=torch.int64)
        if self.group.backend == "nccl":
            t = t.to(self.group.device)
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self.group.pg)
        top = t.cpu().tolist()
        hi, lo = top[:2], [-x for x in top[2:]]
        if hi != lo:
            self.release()
            raise RuntimeError(
                f"cut graph: rank {self.group.rank} captured {counts[0]} "
                f"segments and {counts[1]} cuts, the world's ranks "
                f"{lo[0]}-{hi[0]} segments and {lo[1]}-{hi[1]} cuts: a "
                f"rank that cut elsewhere would hang its peers")

    def detach(self, tree):
        """``tree`` with clones of the leaves that share storage with a
        static buffer."""
        owned = {t.untyped_storage().data_ptr() for t in self._static
                 if isinstance(t, torch.Tensor)}

        def own(x):
            if isinstance(x, torch.Tensor) and \
                    x.untyped_storage().data_ptr() in owned:
                return x.clone()
            return x
        return pytree.tree_map(own, tree)

    def release(self) -> None:
        """Drop the chain, its pool and the static buffers; the next call
        is eager again. A donating graph's static buffers are the
        caller's tensors: dropped here, never freed."""
        for x in self.chain:
            if isinstance(x, _Segment):
                x.graph.reset()
        self._reset()


class Runner:
    """A driver's function with its step replayed by a :class:`StepGraph`
    (or a :class:`RankGraph`): ``driver(*args, step=graph, **kw)``, its
    results detached from the static buffers."""

    def __init__(self, driver: Callable, graph: StepGraph):
        self.driver, self.graph = driver, graph

    def __call__(self, *args, **kwargs):
        return self.graph.detach(self.driver(*args, step=self.graph,
                                             **kwargs))

    def release(self) -> None:
        self.graph.release()
