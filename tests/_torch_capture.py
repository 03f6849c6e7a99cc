"""What a CUDA graph's capture would refuse, found on the CPU.

A captured region may not read a device value on the host (``bool``,
``int``, ``float``, ``.item()``: ``aten::_local_scalar_dense``; under
``torch.inference_mode()`` the dispatcher shows them one level up, as
``aten::item`` and ``aten::is_nonzero``; ``torch.equal``), copy a Python value
from host memory (``torch.tensor``/``torch.as_tensor`` of one:
``aten::lift_fresh``) or size an output by the data (``aten::nonzero``).
A graphed step must also leave its inputs as they were: the warm-up runs
it once on the static buffers before the capture. :func:`capture_faults`
runs a function under a dispatch mode that records each such operation
with the port's source line that issued it, and each operation that
writes into an input's storage. A mesh's step is captured in segments cut
at its collectives (``core/graphed.py::CutGraph``), each collective run
eagerly between them: ``capture_faults(..., cuts=True)`` leaves what a
collective does unchecked, as the capture does.
"""
import traceback
from typing import List

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack,
                                          _pop_mode, _push_mode)

REFUSED = {"aten::_local_scalar_dense": "host read",
           "aten::item": "host read",
           "aten::is_nonzero": "host read",
           "aten::equal": "host read",
           "aten::lift_fresh": "host constant",
           "aten::lift_fresh_copy": "host constant",
           "aten::nonzero": "data-sized output"}


def _where() -> str:
    for frame in reversed(traceback.extract_stack()):
        if "repro_torch" in frame.filename:
            tail = frame.filename.split("repro_torch/")[-1]
            return f"{tail}:{frame.lineno} {frame.name}"
    return "?"


class _Recorder(TorchDispatchMode):
    def __init__(self, inputs, writes=()):
        super().__init__()
        allowed = {t.untyped_storage().data_ptr() for t in writes}
        self.inputs = {t.untyped_storage().data_ptr() for t in inputs
                       if t.numel()} - allowed
        self.faults: List[str] = []
        self.paused = False

    def collective(self, group, fn, x):
        """A cut (``ShardGroup._timed`` under ``cuts=True``): the
        collective runs eagerly, unchecked."""
        self.paused = True
        try:
            return group._run_timed(fn, x)
        finally:
            self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        name = func._schema.name
        if name in REFUSED:
            self.faults.append(f"{REFUSED[name]} {name} at {_where()}")
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(t, torch.Tensor) and t.numel() and \
                    t.untyped_storage().data_ptr() in self.inputs:
                self.faults.append(f"writes an input: {name} at {_where()}")
        return func(*args, **kwargs)


def capture_faults(fn, *args, writes=(), cuts=False, **kwargs
                   ) -> List[str]:
    """Run ``fn(*args, **kwargs)`` and list what a capture would refuse
    (empty: the function could be captured). ``writes`` are the inputs
    the step updates in place by design (the decode step's ring caches,
    the train step's donated state), whose writes are not reported.
    ``cuts``: a mesh's step, its collectives run unchecked as a cut
    graph's nodes."""
    from repro_torch.core import graphed
    inputs = [t for t in pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
    rec = _Recorder(inputs, _tensors(writes))
    saved = graphed._CUT
    if cuts:
        graphed._CUT = rec
    try:
        with rec:
            fn(*args, **kwargs)
    finally:
        graphed._CUT = saved
    return rec.faults


# ---------------------------------------------------------------------------
# CUDA graphs emulated on the CPU
# ---------------------------------------------------------------------------
def _tensors(x):
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


class FakeGraph:
    """A CUDA graph's semantics on the CPU: the capture records each
    operation with its arguments (Python values frozen, as a graph's
    kernel arguments are) and its outputs; a replay runs the operations
    again and writes each result into the output tensor the capture
    made, as a graph writes into the memory its capture allocated. What
    a capture refuses raises. A capture runs nothing on the card, so the
    emulated one puts back every tensor made before it that it wrote
    into."""

    def __init__(self):
        self.ops = []

    def replay(self):
        # inside inference mode, as a card's replay has no such check: a
        # capture's outputs made under it (a served step's) are inference
        # tensors, which refuse an in-place write outside it
        with torch.inference_mode():
            self._replay()

    def _replay(self):
        for func, args, kwargs, outs, fresh in self.ops:
            res = func(*args, **kwargs)
            for o, r, new in zip(_tensors(outs), _tensors(res), fresh):
                if new and o is not r:
                    # through .data: a card's replay bumps no autograd
                    # version, and a cut graph replays a segment inside
                    # the forward, whose tensors autograd may have saved
                    o.data.copy_(r)

    def reset(self):
        self.ops = []

    def pool(self):
        return None

    # a cut graph's segments (core/graphed.py::CutGraph): a capture begun
    # and ended by calls, the end maybe on autograd's thread of another
    # node than the begin
    def capture_begin(self, pool=None, capture_error_mode="global"):
        _OPEN[0] = _Capture(self)
        if not any(isinstance(m, _Segments)
                   for m in _get_current_dispatch_mode_stack()):
            _push_mode(_Segments())

    def capture_end(self):
        cap, _OPEN[0] = _OPEN[0], None
        cap.restore()
        stack = _get_current_dispatch_mode_stack()
        if stack and isinstance(stack[-1], _Segments):
            _pop_mode()


class _Capture(TorchDispatchMode):
    def __init__(self, graph: FakeGraph):
        super().__init__()
        self.graph = graph
        self.made = set()     # storages the capture allocated
        self.saved = []       # (tensor, its value before the capture)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.record(func, args, kwargs or {})

    def restore(self):
        # through .data: a cut's segment ends inside the forward, where
        # autograd may hold a tensor it wrote, and the put-back value is
        # no new version of it
        for t, value in reversed(self.saved):
            t.data.copy_(value)

    def record(self, func, args, kwargs):
        name = func._schema.name
        if name in REFUSED:
            raise RuntimeError(f"a CUDA graph's capture refuses {name} "
                               f"({REFUSED[name]}) at {_where()}")
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage().data_ptr() not in self.made:
                self.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        # outputs that alias an input (views, in-place results) follow
        # their base; only fresh outputs are written on replay. By storage,
        # not by the schema: under inference mode ``aten::to`` shows
        # undecomposed, and its schema marks the output an alias of the
        # input (it may return it) where it made a copy
        inputs = {t.untyped_storage().data_ptr()
                  for t in _tensors((args, kwargs))}
        fresh = [t.untyped_storage().data_ptr() not in inputs
                 for t in _tensors(out)]
        for t, new in zip(_tensors(out), fresh):
            if new:
                self.made.add(t.untyped_storage().data_ptr())
        self.graph.ops.append((func, args, kwargs, out, fresh))
        return out

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.restore()
        return out


# the open segment's capture, recorded through the one _Segments mode on
# the stack. Autograd runs each backward node under the mode stack of the
# call that started the backward, and restores it after the node, so a
# cut inside the backward cannot pop or push the recording mode for the
# nodes after it: the mode stays, and a cut only swaps what it records
# into (between segments, nothing: the collective runs as it is).
_OPEN: List = [None]


class _Segments(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        cap = _OPEN[0]
        if cap is None:
            return func(*args, **(kwargs or {}))
        return cap.record(func, args, kwargs or {})


class _FakeStream:
    def wait_stream(self, other):
        pass


class _fake_graph_context:
    def __init__(self, graph, pool=None, stream=None,
                 capture_error_mode="global"):
        self.mode = _Capture(graph)

    def __enter__(self):
        self.mode.__enter__()

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


class _null_context:
    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def emulate_graphs(monkeypatch) -> None:
    """Make the island drivers replay :class:`FakeGraph` s on the CPU:
    ``graphed.graphs_on`` answers yes, and the ``torch.cuda`` calls of a
    capture act on the CPU."""
    from repro_torch.core import graphed
    monkeypatch.setattr(graphed, "graphs_on", lambda device: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_graph_context)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", _null_context)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda *a, **k: [])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
