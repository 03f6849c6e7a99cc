"""Host trace spans — thread-safe, ring-buffered, Chrome-trace exportable.

A :class:`Tracer` records *complete* spans (Chrome trace-event ``ph: "X"``)
from any thread: the driver loop, the checkpoint writer, the host-bridge
worker, the server executor.  Timestamps come from ``time.perf_counter``
(monotonic — wall-clock ``time.time`` can step backwards under NTP, the
exact class repro-lint rule OBS01 bans for durations), the buffer is a
bounded ring so a week-long run cannot OOM the host, and the export is
the Chrome trace-event JSON array format, openable in Perfetto or
``chrome://tracing``.

Usage — explicit tracer::

    tracer = Tracer()
    with tracer.span("checkpoint.save", epoch=12):
        ...
    tracer.export_chrome("run_trace.json")

or the module-level tracer the runtime instruments against::

    from repro_torch.obs import trace
    trace.enable()                  # off by default — spans no-op until now
    ...
    trace.enable(None)  # or trace.disable()

Instrumented code calls :func:`span` unconditionally; when tracing is
disabled it returns a shared null context manager — one global read and
no allocation, which is what keeps the disabled overhead unmeasurable
(docs/observability.md records the numbers).

Span-name scheme (dotted ``component.verb``): ``bridge.sync``,
``bridge.put``, ``bridge.drain``, ``checkpoint.snapshot``,
``checkpoint.write``, ``server.<verb>``, ``pool.<verb>``,
``driver.segment``.  Stick to it — the timeline CLI groups by the prefix.

Stdlib-only: the torch-free server tier imports this module.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class _NullSpan:
    """Shared do-nothing context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records the X event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = tracer._clock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._record(self._name, self._t0, t1 - self._t0, self._args)
        return False


class Tracer:
    """Thread-safe ring buffer of completed spans.

    maxlen:  ring capacity — oldest events drop first (a long run keeps
             its tail, which is what you debug).
    clock:   injectable monotonic clock in *seconds* (tests pass a fake
             for deterministic golden fixtures); defaults to
             ``time.perf_counter``.
    pid:     the ``pid`` stamped on events (default 1 — one process per
             trace file; the timeline CLI re-pids merged files).

    Thread ids are stable small ints assigned in first-use order (not the
    OS ``get_ident`` — those are unstable across runs and huge), with the
    thread's name recorded so Perfetto labels the track.
    """

    def __init__(self, maxlen: int = 65536, clock=None, pid: int = 1):
        self._events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._clock = time.perf_counter if clock is None else clock
        self._pid = pid
        self._tids: Dict[int, int] = {}
        self._tid_names: Dict[int, str] = {}

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args: Any) -> _Span:
        """Context manager: records one complete ``ph:"X"`` event on exit."""
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker event."""
        self._record(name, self._clock(), 0.0, args)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
            self._tid_names[tid] = threading.current_thread().name
        return tid

    def _record(self, name: str, t0: float, dur: float,
                args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "ts": round(t0 * 1e6, 3), "dur": round(max(dur, 0.0) * 1e6, 3)}
        if args:
            ev["args"] = args
        with self._lock:
            ev["tid"] = self._tid()
            self._events.append(ev)

    # -- export --------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the recorded events (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (``traceEvents`` + thread-name
        metadata events), Perfetto-openable as-is."""
        with self._lock:
            events = list(self._events)
            names = dict(self._tid_names)
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": tid, "args": {"name": tname}}
                for tid, tname in sorted(names.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh, indent=1, sort_keys=True)
            fh.write("\n")


# ---------------------------------------------------------------------------
# Module-level tracer: what instrumented runtime code records against.
# Off by default; `span()` costs one global read + one `is None` when off.
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def enable(tracer: Optional[Tracer] = None, **kwargs: Any) -> Tracer:
    """Install (and return) the module-level tracer.  ``kwargs`` are
    forwarded to :class:`Tracer` when none is given."""
    global _TRACER
    _TRACER = Tracer(**kwargs) if tracer is None else tracer
    return _TRACER


def disable() -> None:
    """Uninstall the module-level tracer; :func:`span` no-ops again."""
    global _TRACER
    _TRACER = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **args: Any):
    """Span against the module-level tracer; a shared null context manager
    when tracing is disabled (the instrumentation's fast path)."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **args)


def instant(name: str, **args: Any) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **args)
