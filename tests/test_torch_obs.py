"""The port's stdlib observability tiers against the reference's
fixtures: :class:`repro_torch.obs.trace.Tracer` (thread-safe ring, the
Chrome export pinned by the reference's golden
``tests/data/golden_trace.json``), :mod:`repro_torch.obs.metrics` (the
log-binned histogram through Prometheus text) and the ``python -m
repro_torch.obs`` timeline CLI (exits 1 on an unbalanced ledger); then
the spans the port's drivers open (``driver.segment``,
``checkpoint.snapshot``/``write``, ``bridge.*``, ``pool.*``), by name and
count as the reference's open them, and each package's CLI on the other's
trace. The counters tier is held in ``tests/test_torch_async.py`` and
``tests/test_torch_migration.py``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import itertools
import json
import os
import subprocess
import sys
import threading

import jax
import pytest

from repro_torch.obs import __main__ as obs_cli
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "golden_trace.json")


@pytest.fixture(autouse=True)
def _module_tracer_off():
    """Tests that enable() the module tracer must not leak it."""
    yield
    obs_trace.disable()


# ---------------------------------------------------------------------------
# host tracer
# ---------------------------------------------------------------------------
def _golden_trace():
    """Deterministic trace: counter clock (1ms per reading), main thread."""
    ticks = itertools.count()
    tracer = Tracer(clock=lambda: next(ticks) * 1e-3)
    with tracer.span("driver.segment", segment=0):
        with tracer.span("driver.tick", tick=0):
            pass
        with tracer.span("driver.tick", tick=1):
            pass
    with tracer.span("checkpoint.snapshot", step=2):
        with tracer.span("checkpoint.write"):
            pass
    tracer.instant("server.down")
    return tracer.to_chrome()


class TestTracer:
    def test_span_records_complete_event(self):
        tracer = Tracer()
        with tracer.span("pool.put", n=3):
            pass
        (ev,) = tracer.events()
        assert ev["ph"] == "X" and ev["name"] == "pool.put"
        assert ev["dur"] >= 0 and ev["args"] == {"n": 3}
        assert ev["pid"] == 1 and ev["tid"] == 1

    def test_ring_keeps_the_tail(self):
        tracer = Tracer(maxlen=16)
        for i in range(100):
            with tracer.span("s", i=i):
                pass
        evs = tracer.events()
        assert len(evs) == 16
        assert [e["args"]["i"] for e in evs] == list(range(84, 100))

    def test_thread_safety_under_concurrent_spans(self):
        tracer = Tracer()
        n_threads, n_spans = 8, 200
        start = threading.Barrier(n_threads)

        def worker(k):
            start.wait()
            for i in range(n_spans):
                with tracer.span("worker.op", k=k, i=i):
                    pass

        threads = [threading.Thread(target=worker, args=(k,), name=f"w{k}")
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        evs = tracer.events()
        assert len(evs) == n_threads * n_spans
        # stable small-int tids, one per recording thread, names captured
        assert {e["tid"] for e in evs} == set(range(1, n_threads + 1))
        chrome = tracer.to_chrome()
        names = {ev["args"]["name"] for ev in chrome["traceEvents"]
                 if ev["ph"] == "M"}
        assert names == {f"w{k}" for k in range(n_threads)}
        # per-thread event order is preserved in the ring
        for k in range(n_threads):
            mine = [e["args"]["i"] for e in evs if e["args"]["k"] == k]
            assert mine == list(range(n_spans))

    def test_module_level_span_is_noop_when_disabled(self):
        obs_trace.disable()
        assert obs_trace.span("x") is obs_trace.span("y")
        tracer = obs_trace.enable()
        with obs_trace.span("pool.get_random"):
            pass
        obs_trace.instant("mark")
        assert [e["name"] for e in tracer.events()] == ["pool.get_random",
                                                        "mark"]
        obs_trace.disable()
        obs_trace.instant("dropped")
        assert len(tracer.events()) == 2

    def test_golden_chrome_trace(self):
        assert os.path.isfile(GOLDEN_PATH), (
            f"missing {GOLDEN_PATH} — regenerate with "
            f"`PYTHONPATH=src python tests/test_obs.py --regen` (the reference's)")
        with open(GOLDEN_PATH) as fh:
            golden = json.load(fh)
        live = _golden_trace()
        assert live == golden, (
            "Chrome trace export drifted from tests/data/golden_trace.json "
            "— if the format change is deliberate, regenerate with "
            "`PYTHONPATH=src python tests/test_obs.py --regen` (the reference's)")
        # and the fixture itself is a valid Chrome trace object
        assert golden["displayTimeUnit"] == "ms"
        xs = [e for e in golden["traceEvents"] if e["ph"] == "X"]
        assert all({"name", "ts", "dur", "pid", "tid"} <= set(e) for e in xs)


# ---------------------------------------------------------------------------
# metrics: histogram + Prometheus text round-trip
# ---------------------------------------------------------------------------
class TestMetrics:
    def test_hist_index_value_consistent(self):
        for ms in (0.01, 0.05, 1.0, 15.0, 1000.0, 500_000.0):
            i = obs_metrics.hist_index(ms)
            assert 0 <= i < obs_metrics.HIST_BINS
            assert obs_metrics.hist_value(i) <= obs_metrics.hist_upper(i)

    def test_percentiles(self):
        h = obs_metrics.hist_new()
        for ms in [1.0] * 98 + [1000.0] * 2:
            h[obs_metrics.hist_index(ms)] += 1
        assert obs_metrics.hist_percentile(h, 0.50) == pytest.approx(1.0,
                                                                     rel=0.1)
        assert obs_metrics.hist_percentile(h, 0.99) == pytest.approx(1000.0,
                                                                     rel=0.1)

    def test_prometheus_round_trip(self):
        h = obs_metrics.hist_new()
        samples = [0.2, 1.5, 1.5, 80.0, 2500.0]
        for ms in samples:
            h[obs_metrics.hist_index(ms)] += 1
        text = obs_metrics.render_prometheus(
            counters={"requests": 17}, gauges={"queue_depth": 3.5},
            histograms={"verb_put_latency": (h, sum(samples))})
        parsed = obs_metrics.parse_prometheus(text)
        assert parsed["repro_requests"] == 17
        assert parsed["repro_queue_depth"] == 3.5
        assert parsed['repro_verb_put_latency_seconds_bucket{le="+Inf"}'] \
            == len(samples)
        assert parsed["repro_verb_put_latency_seconds_count"] == len(samples)
        assert parsed["repro_verb_put_latency_seconds_sum"] == pytest.approx(
            sum(samples) / 1e3)
        # cumulative buckets are monotone and end at the total count
        buckets = [v for k, v in parsed.items() if "_bucket{" in k]
        assert buckets == sorted(buckets)
        assert buckets[-1] == len(samples)

    def test_prometheus_type_lines(self):
        text = obs_metrics.render_prometheus(counters={"a": 1},
                                             gauges={"b": 2})
        assert "# TYPE repro_a counter" in text
        assert "# TYPE repro_b gauge" in text


# ---------------------------------------------------------------------------
# timeline CLI
# ---------------------------------------------------------------------------
def _fake_harvest(fired=10, delivered=8, accepted=6, rejected=2,
                  churn=3, n=2):
    return {"n_islands": n, "fired": [fired // n] * n,
            "delivered": [delivered // n] * n,
            "accepted": [accepted // n] * n,
            "rejected": [rejected // n] * n, "churn_down": [churn // n] * n,
            "inbox_age_hist": [[0] * obs_counters.AGE_BINS] * n,
            "early_stop_epoch": -1,
            "totals": {"fired": fired, "delivered": delivered,
                       "accepted": accepted, "rejected": rejected,
                       "churn_down": churn,
                       "inbox_age_hist": [0] * obs_counters.AGE_BINS}}


class TestTimelineCLI:
    def test_span_summary(self):
        events = _golden_trace()["traceEvents"]
        spans = obs_cli.span_summary(events)
        assert spans["driver.tick"]["count"] == 2
        assert spans["driver.segment"]["count"] == 1
        assert spans["checkpoint.write"]["count"] == 1
        assert spans["driver.segment"]["total_ms"] \
            >= spans["driver.tick"]["total_ms"]
        assert spans["driver.tick"]["p50_ms"] <= spans["driver.tick"]["p99_ms"]

    def test_ledger_rates(self):
        rates = obs_cli.ledger_rates(_fake_harvest(), n_ticks=10)
        assert rates["ledger_balanced"]
        assert rates["delivery_rate"] == pytest.approx(0.8)
        assert rates["rejection_rate"] == pytest.approx(0.25)
        assert rates["churn_occupancy"] == pytest.approx(3 / 20)
        broken = obs_cli.ledger_rates(_fake_harvest(rejected=1))
        assert not broken["ledger_balanced"]

    def test_merge_traces_repids(self, tmp_path):
        for i in range(2):
            with open(tmp_path / f"t{i}.json", "w") as fh:
                json.dump(_golden_trace(), fh)
        merged = obs_cli.merge_traces([str(tmp_path / "t0.json"),
                                       str(tmp_path / "t1.json")])
        assert {e["pid"] for e in merged} == {1, 2}

    def _write_inputs(self, tmp_path, harvest):
        trace = tmp_path / "trace.json"
        obsj = tmp_path / "obs.json"
        with open(trace, "w") as fh:
            json.dump(_golden_trace(), fh)
        with open(obsj, "w") as fh:
            json.dump(harvest, fh)
        return str(trace), str(obsj)

    def test_cli_end_to_end_and_stamp(self, tmp_path):
        trace, obsj = self._write_inputs(tmp_path, _fake_harvest())
        bench = tmp_path / "BENCH.json"
        with open(bench, "w") as fh:
            json.dump({"rows": []}, fh)
        out = tmp_path / "summary.json"
        rc = obs_cli.main([trace, "--obs", obsj, "--json", str(out),
                           "--stamp", str(bench)])
        assert rc == 0
        with open(out) as fh:
            summary = json.load(fh)
        assert summary["counters"]["ledger_balanced"]
        assert summary["events"] == 6   # 5 spans + 1 instant marker
        with open(bench) as fh:
            stamped = json.load(fh)
        assert stamped["obs_timeline"]["spans"]["driver.tick"]["count"] == 2

    def test_cli_fails_on_unbalanced_ledger(self, tmp_path):
        trace, obsj = self._write_inputs(tmp_path,
                                         _fake_harvest(accepted=9))
        assert obs_cli.main([trace, "--obs", obsj]) == 1

    def test_cli_is_jax_free(self):
        """The timeline tool imports with neither torch nor jax."""
        code = ("import sys, repro_torch.obs.__main__, "
                "repro_torch.obs.metrics, repro_torch.obs.trace; "
                "assert 'jax' not in sys.modules, 'obs CLI pulled in jax'; "
                "assert 'torch' not in sys.modules, 'obs CLI pulled in torch'")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]




# ---------------------------------------------------------------------------
# the spans the drivers open, against the reference's
# ---------------------------------------------------------------------------
def _names(events):
    out = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def test_segments_and_snapshots_open_the_references_spans(tmp_path):
    """run_fused with snapshots every 2 of 5 epochs: the same
    driver.segment, checkpoint.snapshot and checkpoint.write spans (by
    name, count and args) as the reference's."""
    import repro.obs.trace as j_trace
    from repro.core import EAConfig as JEAConfig
    from repro.core import MigrationConfig as JMigrationConfig
    from repro.core import make_onemax as j_onemax
    from repro.core import run_fused as j_run_fused
    from repro_torch.core import (EAConfig, MigrationConfig, make_onemax,
                                  run_fused)
    cfg = dict(max_pop=16, min_pop=16, generations_per_epoch=2)
    tracer = obs_trace.enable()
    run_fused(make_onemax(40), EAConfig(**cfg), MigrationConfig(),
              n_islands=2, max_epochs=5, w2=True, rng=3, device="cpu",
              snapshot_every=2, snapshot_dir=str(tmp_path / "port"))
    obs_trace.disable()
    jt = j_trace.enable()
    try:
        with jax.threefry_partitionable(True):
            j_run_fused(j_onemax(40), JEAConfig(**cfg), JMigrationConfig(),
                        n_islands=2, max_epochs=5, w2=True,
                        rng=jax.random.key(3), snapshot_every=2,
                        snapshot_dir=str(tmp_path / "ref"))
    finally:
        j_trace.disable()
    got, want = tracer.events(), jt.events()
    assert _names(got) == _names(want) == {
        "driver.segment": 3, "checkpoint.snapshot": 3,
        "checkpoint.write": 3}

    def args(events, name):
        return sorted(json.dumps(e["args"], sort_keys=True)
                      for e in events if e["name"] == name)
    for name in _names(want):
        assert args(got, name) == args(want, name), name
    writes = [e for e in got if e["name"] == "checkpoint.write"]
    main = [e for e in got if e["name"] == "driver.segment"]
    assert {e["tid"] for e in writes}.isdisjoint({e["tid"] for e in main})


def test_bridged_run_opens_the_references_spans():
    """run_experiment with HostBridge over a PoolServer: bridge.sync,
    bridge.put, bridge.get and the pool verbs, as the reference counts
    them."""
    import repro.obs.trace as j_trace
    from repro.core import EAConfig as JEAConfig
    from repro.core import HostBridge as JHostBridge
    from repro.core import MigrationConfig as JMigrationConfig
    from repro.core import PoolServer as JPoolServer
    from repro.core import make_trap as j_trap
    from repro.core import run_experiment as j_run_experiment
    from repro_torch.core import (EAConfig, HostBridge, MigrationConfig,
                                  PoolServer, make_trap, run_experiment)
    cfg = dict(max_pop=16, min_pop=8, generations_per_epoch=2)
    tracer = obs_trace.enable()
    run_experiment(make_trap(8, 4), EAConfig(**cfg), MigrationConfig(),
                   n_islands=3, max_epochs=3, rng=0, device="cpu",
                   host_bridge=HostBridge(PoolServer(seed=1), pull=2),
                   host_pool=PoolServer(seed=2))
    obs_trace.disable()
    jt = j_trace.enable()
    try:
        with jax.threefry_partitionable(True):
            j_run_experiment(j_trap(8, 4), JEAConfig(**cfg),
                             JMigrationConfig(), n_islands=3, max_epochs=3,
                             rng=jax.random.key(0),
                             host_bridge=JHostBridge(JPoolServer(seed=1),
                                                     pull=2),
                             host_pool=JPoolServer(seed=2))
    finally:
        j_trace.disable()
    assert _names(tracer.events()) == _names(jt.events())
    assert _names(tracer.events())["bridge.sync"] == 3


def test_each_packages_cli_reads_the_others_files(tmp_path):
    """The reference's timeline CLI on a port trace and harvest, and the
    port's on the reference's golden trace, give the same summary as the
    other package's CLI."""
    from repro.obs import __main__ as j_cli
    trace = tmp_path / "trace.json"
    tracer = Tracer(clock=lambda c=itertools.count(): next(c) * 1e-3)
    with tracer.span("driver.tick", tick=1):
        with tracer.span("bridge.sync", epoch=1):
            pass
    tracer.export_chrome(str(trace))
    harvest = tmp_path / "obs.json"
    with open(harvest, "w") as fh:
        json.dump(_fake_harvest(), fh)
    outs = []
    for cli in (obs_cli, j_cli):
        out = tmp_path / f"{cli.__name__}.json"
        assert cli.main([str(trace), GOLDEN_PATH, "--obs", str(harvest),
                         "--json", str(out)]) == 0
        with open(out) as fh:
            outs.append(json.load(fh))
    assert outs[0] == outs[1]
