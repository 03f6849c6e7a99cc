"""Server metrics: mergeable latency histogram + Prometheus exposition.

The log-spaced fixed-bin histogram moved here from
``benchmarks/server_load.py`` so the load harness, the HTTP frontend's
per-verb latency tracking and the timeline CLI all share one binning
(mergeable across processes by integer bin-count addition).  Bounds cover
50 µs .. 120 s — a keep-alive verb on localhost up to a full-queue stall.

:func:`render_prometheus` renders counters/gauges/histograms in the
Prometheus text exposition format (``text/plain; version=0.0.4``):
counters and gauges one sample each, histograms as cumulative ``le``
buckets (the 256 internal bins are downsampled to ``PROM_BUCKETS``
boundaries so a scrape stays small) plus ``_sum``/``_count``.

Stdlib-only: the torch-free server tier and the subprocessed load-harness
workers import this module.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

# ---------------------------------------------------------------------------
# log-spaced latency histogram (mergeable across processes)
# ---------------------------------------------------------------------------
HIST_BINS = 256
HIST_LO_MS = 0.05
HIST_HI_MS = 120_000.0
_LOG_LO = math.log(HIST_LO_MS)
_LOG_SPAN = math.log(HIST_HI_MS) - _LOG_LO

# legacy spellings (benchmarks/server_load.py re-exports these)
_HIST_BINS = HIST_BINS
_HIST_LO_MS = HIST_LO_MS
_HIST_HI_MS = HIST_HI_MS


def hist_new() -> List[int]:
    """A fresh all-zero histogram."""
    return [0] * HIST_BINS


def hist_index(ms: float) -> int:
    if ms <= HIST_LO_MS:
        return 0
    i = int((math.log(ms) - _LOG_LO) / _LOG_SPAN * HIST_BINS)
    return min(max(i, 0), HIST_BINS - 1)


def hist_value(i: int) -> float:
    """Geometric midpoint of bin i — the value a percentile reports."""
    frac = (i + 0.5) / HIST_BINS
    return math.exp(_LOG_LO + frac * _LOG_SPAN)


def hist_upper(i: int) -> float:
    """Upper edge of bin i in ms (a Prometheus ``le`` boundary)."""
    frac = (i + 1) / HIST_BINS
    return math.exp(_LOG_LO + frac * _LOG_SPAN)


def hist_percentile(counts: List[int], q: float) -> float:
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= target:
            return hist_value(i)
    return hist_value(HIST_BINS - 1)


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
PROM_BUCKETS = 32          # downsampled `le` boundaries per histogram
_GROUP = HIST_BINS // PROM_BUCKETS


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(counters: Mapping[str, float] = (),
                      gauges: Mapping[str, float] = (),
                      histograms: Mapping[str, Tuple[List[int], float]] = (),
                      namespace: str = "repro",
                      ) -> str:
    """Render one scrape.

    counters:    name -> cumulative count.
    gauges:      name -> current value.
    histograms:  name -> (bin counts of length :data:`HIST_BINS` in ms,
                 sum in ms).  Exposed in *seconds* (Prometheus convention)
                 as cumulative buckets + ``_sum`` + ``_count``.
    """
    lines: List[str] = []
    for name, value in sorted(dict(counters).items()):
        metric = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {_fmt(value)}")
    for name, value in sorted(dict(gauges).items()):
        metric = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(value)}")
    for name, (counts, sum_ms) in sorted(dict(histograms).items()):
        metric = f"{namespace}_{_sanitize(name)}_seconds"
        lines.append(f"# TYPE {metric} histogram")
        cum = 0
        for g in range(PROM_BUCKETS):
            hi = (g + 1) * _GROUP - 1
            cum += sum(counts[g * _GROUP:(g + 1) * _GROUP])
            le = hist_upper(hi) / 1e3
            lines.append(f'{metric}_bucket{{le="{le:.6g}"}} {cum}')
        cum += sum(counts[PROM_BUCKETS * _GROUP:])
        lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{metric}_sum {_fmt(sum_ms / 1e3)}")
        lines.append(f"{metric}_count {cum}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Parse a text-format scrape back into ``{sample_name: value}`` —
    bucketed samples keyed as ``name{le="..."}``.  Round-trip helper for
    tests and the timeline CLI (not a full openmetrics parser)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        out[key] = float(value)
    return out
