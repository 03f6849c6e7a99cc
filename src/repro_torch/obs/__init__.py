"""Observability of the port, in three tiers:

* :mod:`repro_torch.obs.counters`: the on-device counter ledger carried
  through the fused drivers (needs torch);
* :mod:`repro_torch.obs.trace`: host wall-clock spans, a thread-safe ring
  buffer exported as Chrome trace-event JSON (stdlib only);
* :mod:`repro_torch.obs.metrics`: the server's mergeable latency histogram
  and its Prometheus text for ``/metricz`` (stdlib only).

``python -m repro_torch.obs`` (:mod:`repro_torch.obs.__main__`) merges
trace files and harvested counters into a per-run timeline.

Tracing does nothing until :func:`repro_torch.obs.trace.enable` is called.
This ``__init__`` imports only the stdlib tiers, so the server, its wire
client and the timeline tool run without torch; the counter names
(``AGE_BINS``, ``ObsCounters``, ``harvest``, ``init_obs``) load
:mod:`~repro_torch.obs.counters` at first use.
"""
from __future__ import annotations

from . import metrics, trace  # noqa: F401  (stdlib-only tiers)
from .trace import Tracer, disable, enable, span  # noqa: F401

_COUNTERS = ("AGE_BINS", "ObsCounters", "harvest", "init_obs")

__all__ = ["Tracer", "enable", "disable", "span", "metrics", "trace",
           *_COUNTERS]


def __getattr__(name):
    if name in _COUNTERS or name == "counters":
        import importlib
        counters = importlib.import_module(".counters", __name__)
        return counters if name == "counters" else getattr(counters, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
