"""Straggler detection for heterogeneous volunteer fleets (the port's own
copy of ``repro.runtime.straggler``: pure Python, no device).

The paper's system absorbs stragglers *by design* (asynchronous pool, no
barrier). This monitor makes the absorption measurable and actionable at
datacenter scale: per-worker epoch durations are tracked online; workers
slower than ``threshold``× the fleet median get flagged, and the driver can
shrink their per-epoch work (adaptive generations_per_epoch — the knob the
paper fixes at 100) instead of stalling a synchronous collective.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, List, Optional


class StragglerMonitor:
    def __init__(self, window: int = 16, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self._hist: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._open: Dict[int, float] = {}

    def start(self, worker: int) -> None:
        self._open[worker] = time.perf_counter()

    def stop(self, worker: int) -> Optional[float]:
        """Close the worker's open epoch and record its duration. A stop
        without a matching start (a worker that churned mid-epoch and
        re-announced itself) is a no-op returning None — it must not crash
        the driver loop."""
        t0 = self._open.pop(worker, None)
        if t0 is None:
            return None
        dt = time.perf_counter() - t0
        self._hist[worker].append(dt)
        return dt

    def record(self, worker: int, duration_s: float) -> None:
        self._hist[worker].append(duration_s)

    def median_of_medians(self) -> Optional[float]:
        meds = [sorted(h)[len(h) // 2] for h in self._hist.values() if h]
        if not meds:
            return None
        return sorted(meds)[len(meds) // 2]

    def stragglers(self) -> List[int]:
        med = self.median_of_medians()
        if med is None or med == 0:
            return []
        out = []
        for w, h in self._hist.items():
            if h and sorted(h)[len(h) // 2] > self.threshold * med:
                out.append(w)
        return sorted(out)

    def gauges(self) -> Dict[str, float]:
        """Current fleet state as Prometheus-style gauges, the shape the
        reference's ``PoolHTTPServer.add_gauge_source`` expects (the port's
        server tier comes with ROADMAP Queue A item 12)."""
        med = self.median_of_medians()
        return {
            "straggler_workers": float(len(self._hist)),
            "straggler_flagged": float(len(self.stragglers())),
            "straggler_median_epoch_seconds": float(med or 0.0),
            "straggler_threshold": float(self.threshold),
        }

    def work_scale(self, worker: int) -> float:
        """Suggested multiplier on generations_per_epoch for this worker
        (1.0 for median workers, <1 for stragglers) — keeps epoch wall time
        roughly uniform without any synchronization."""
        med = self.median_of_medians()
        h = self._hist.get(worker)
        if not med or not h:
            return 1.0
        mine = sorted(h)[len(h) // 2]
        if mine <= 0:
            return 1.0
        return float(min(1.0, max(0.1, med / mine)))
