"""Run-timeline tool: merge Chrome traces + counter harvests into one
per-run summary.

    PYTHONPATH=src python -m repro_torch.obs run_trace.json \
        --obs run_obs.json --json timeline.json

Inputs are what the instrumented runtime writes: Chrome trace-event JSON
files from :meth:`repro_torch.obs.trace.Tracer.export_chrome` (one per process
— they are re-pid'ed on merge so Perfetto shows one track group per
file) and the :func:`repro_torch.obs.counters.harvest` dict (e.g. from
``python -m repro_torch.launch.volunteer_sim --obs-json``).

The summary reports:

* per-span-name latency (count, total, p50/p99 from the shared
  log-binned histogram in :mod:`repro_torch.obs.metrics`) grouped by the
  ``component.verb`` naming scheme;
* driver throughput over time — ``driver.tick`` / ``driver.segment``
  spans bucketed into wall-clock windows (epochs/sec as the run warms
  up, stalls, finishes);
* counter-ledger rates — migration delivery rate per fire, rejection
  rate per delivery, churn occupancy (down island-ticks over all
  island-ticks, when the trace pins the tick count).

``--stamp BENCH_speed.json`` writes the summary under an
``obs_timeline`` key inside an existing benchmark artifact, so a
benchmarked run carries its own timeline next to its numbers.
``--merged merged_trace.json`` additionally writes the re-pid'ed merged
Chrome trace (openable in Perfetto as one multi-process timeline).

Stdlib-only, torch-free: runs anywhere the server tier runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from . import metrics as metrics_lib

_DRIVER_SPANS = ("driver.tick", "driver.segment")


def load_trace(path: str) -> List[Dict[str, Any]]:
    """One Chrome trace file -> its event list (array or object form)."""
    with open(path) as fh:
        obj = json.load(fh)
    events = obj["traceEvents"] if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace-event file")
    return events


def merge_traces(paths: List[str]) -> List[Dict[str, Any]]:
    """Concatenate traces, re-pid'ing file i to pid i+1 (each input file
    is one process; its own pids collapse into one track group)."""
    merged: List[Dict[str, Any]] = []
    for i, path in enumerate(paths):
        for ev in load_trace(path):
            ev = dict(ev)
            ev["pid"] = i + 1
            merged.append(ev)
    return merged


def span_summary(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-name latency summary over every complete (``ph: "X"``) span."""
    hists: Dict[str, List[int]] = {}
    sums: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "?")
        ms = float(ev.get("dur", 0.0)) / 1e3    # trace dur is µs
        h = hists.setdefault(name, metrics_lib.hist_new())
        h[metrics_lib.hist_index(ms)] += 1
        sums[name] = sums.get(name, 0.0) + ms
    return {
        name: {
            "count": sum(h),
            "total_ms": round(sums[name], 3),
            "p50_ms": round(metrics_lib.hist_percentile(h, 0.50), 3),
            "p99_ms": round(metrics_lib.hist_percentile(h, 0.99), 3),
        }
        for name, h in sorted(hists.items())
    }


def throughput_over_time(events: List[Dict[str, Any]],
                         windows: int = 8) -> List[Dict[str, float]]:
    """Bucket driver spans into wall-clock windows -> spans/sec series."""
    ts = sorted(float(ev["ts"]) for ev in events
                if ev.get("ph") == "X" and ev.get("name") in _DRIVER_SPANS)
    if len(ts) < 2:
        return []
    t0, t1 = ts[0], ts[-1]
    width = max((t1 - t0) / windows, 1.0)       # µs
    counts = [0] * windows
    for t in ts:
        counts[min(int((t - t0) / width), windows - 1)] += 1
    return [{"t0_s": round((t0 + i * width) / 1e6, 6),
             "span_per_sec": round(c / (width / 1e6), 3)}
            for i, c in enumerate(counts)]


def ledger_rates(harvest: Dict[str, Any],
                 n_ticks: Optional[int] = None) -> Dict[str, Any]:
    """Counter totals -> the run's migration/rejection/churn rates."""
    tot = harvest["totals"]
    fired, delivered = tot["fired"], tot["delivered"]
    accepted, rejected = tot["accepted"], tot["rejected"]
    out: Dict[str, Any] = {
        "totals": dict(tot),
        "n_islands": harvest["n_islands"],
        "early_stop_epoch": harvest.get("early_stop_epoch", -1),
        "ledger_balanced": delivered == accepted + rejected,
        "delivery_rate": round(delivered / fired, 4) if fired else None,
        "rejection_rate": (round(rejected / delivered, 4)
                           if delivered else None),
    }
    if n_ticks:
        out["churn_occupancy"] = round(
            tot["churn_down"] / (harvest["n_islands"] * n_ticks), 4)
    return out


def build_summary(trace_paths: List[str],
                  obs_path: Optional[str] = None) -> Dict[str, Any]:
    events = merge_traces(trace_paths)
    spans = span_summary(events)
    n_ticks = sum(spans[n]["count"] for n in _DRIVER_SPANS if n in spans)
    summary: Dict[str, Any] = {
        "traces": list(trace_paths),
        "events": sum(1 for ev in events if ev.get("ph") == "X"),
        "spans": spans,
        "throughput": throughput_over_time(events),
    }
    if obs_path:
        with open(obs_path) as fh:
            harvest = json.load(fh)
        summary["counters"] = ledger_rates(harvest, n_ticks or None)
    return summary


def stamp(bench_path: str, summary: Dict[str, Any]) -> None:
    """Attach the timeline to an existing BENCH_*.json artifact."""
    with open(bench_path) as fh:
        payload = json.load(fh)
    payload["obs_timeline"] = summary
    with open(bench_path, "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")


def _print_summary(summary: Dict[str, Any]) -> None:
    print(f"timeline: {summary['events']} spans "
          f"from {len(summary['traces'])} trace file(s)")
    for name, s in summary["spans"].items():
        print(f"  {name:24s} x{s['count']:<6d} total {s['total_ms']:9.1f}ms"
              f"  p50 {s['p50_ms']:8.2f}ms  p99 {s['p99_ms']:8.2f}ms")
    if summary["throughput"]:
        rates = ", ".join(f"{w['span_per_sec']:.1f}"
                          for w in summary["throughput"])
        print(f"  driver spans/sec over run: [{rates}]")
    c = summary.get("counters")
    if c:
        print(f"  ledger: delivered={c['totals']['delivered']} "
              f"accepted={c['totals']['accepted']} "
              f"rejected={c['totals']['rejected']} "
              f"balanced={'OK' if c['ledger_balanced'] else 'BROKEN'}")
        if c.get("delivery_rate") is not None:
            print(f"  delivery_rate={c['delivery_rate']} "
                  f"rejection_rate={c['rejection_rate']} "
                  f"churn_occupancy={c.get('churn_occupancy')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__.split("\n")[0])
    ap.add_argument("traces", nargs="+", metavar="TRACE.json",
                    help="Chrome trace-event files (Tracer.export_chrome)")
    ap.add_argument("--obs", default=None, metavar="OBS.json",
                    help="a harvested ObsCounters dict (volunteer_sim "
                         "--obs-json / run_fused(return_obs=True))")
    ap.add_argument("--json", default=None, metavar="OUT.json",
                    help="write the summary as JSON")
    ap.add_argument("--merged", default=None, metavar="OUT.json",
                    help="write the re-pid'ed merged Chrome trace")
    ap.add_argument("--stamp", default=None, metavar="BENCH.json",
                    help="attach the summary to an existing benchmark "
                         "artifact under an 'obs_timeline' key")
    args = ap.parse_args(argv)

    summary = build_summary(args.traces, args.obs)
    _print_summary(summary)
    if args.merged:
        with open(args.merged, "w") as fh:
            json.dump({"traceEvents": merge_traces(args.traces),
                       "displayTimeUnit": "ms"}, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote merged trace -> {args.merged}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote summary -> {args.json}")
    if args.stamp:
        stamp(args.stamp, summary)
        print(f"stamped obs_timeline into {args.stamp}")
    c = summary.get("counters")
    if c and not c["ledger_balanced"]:
        print("timeline: FAIL — counter ledger does not balance")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
