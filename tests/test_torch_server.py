"""The port's networked pool service (``repro_torch.server``) against
the reference's wire: the golden transcript, rate limiting,
backpressure, namespace isolation, sharded exactly-once, client/bridge
equivalence, spool resume; then across the two packages: each package's
client against the other's server, journals written by one and replayed
by the other, and a run bridged over the wire equal to the in-process
one. Every server listens on an ephemeral port and is torn down; the
port's ``aclose`` reaps idle keep-alive connections before
``Server.wait_closed()``, so it shuts down under Python 3.12.

The golden transcript is the reference's fixture,
``tests/data/server_wire_golden.json``.
"""
import _torch_threads  # noqa: F401  (first: one CPU thread)
import http.client
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.async_pool import PoolServer, PoolUnavailable
from repro_torch.server import wire
from repro_torch.server.client import RemotePoolServer
from repro_torch.server.http import background_server
from repro_torch.server.ratelimit import RateLimiter, TokenBucket
from repro_torch.server.service import (ExperimentConfig, HashRing,
                                        PoolService, check_name)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "server_wire_golden.json")


def _raw(server, method, path, body=None, client_id="golden"):
    """One raw HTTP round trip -> (status, headers-dict, parsed-json)."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=10)
    try:
        payload = (json.dumps(body, separators=(",", ":"))
                   if body is not None else None)
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json",
                              "X-Client-Id": client_id})
        resp = conn.getresponse()
        raw = resp.read()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                json.loads(raw) if raw else {})
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# golden wire transcript
# ---------------------------------------------------------------------------
def _golden_items():
    return wire.put_request([
        wire.put_item(np.array([1, 0, 1, 1], np.int8), 3.0, uuid=0),
        wire.put_item(np.array([0, 0, 0, 1], np.int8), 1.0, uuid=1),
        wire.put_item(np.array([1, 1, 1, 1], np.int8), 4.0, uuid=2),
        wire.put_item(np.array([0.5, -0.5], np.float32), 2.5, uuid=3),
    ])


#: (method, path, body) — every verb, happy paths and canonical errors.
#: All responses are deterministic: experiment RNGs are seeded, routing
#: is blake2b (process-stable), counters depend only on this sequence.
GOLDEN_STEPS = [
    ("GET", "/healthz", None),
    ("POST", "/v1/experiment/golden",
     {"capacity": 8, "shards": 2, "seed": 3}),
    ("POST", "/v1/experiment/golden",
     {"capacity": 8, "shards": 2, "seed": 3}),          # idempotent re-create
    ("POST", "/v1/experiment/golden", {"capacity": 4}),  # config conflict
    ("PUT", "/v1/experiment/golden/chromosomes", _golden_items()),
    ("GET", "/v1/experiment/golden/chromosomes/random?n=2", None),
    ("GET", "/v1/experiment/golden/chromosomes/since"
            "?seq=-1&limit=10&cursor_id=gold", None),
    # same named cursor, cold seq: the server-side position wins — an
    # amnesiac consumer never re-sees an entry
    ("GET", "/v1/experiment/golden/chromosomes/since"
            "?seq=-1&limit=10&cursor_id=gold", None),
    ("GET", "/v1/experiment/golden/best", None),
    ("GET", "/v1/experiment/golden/stats", None),
    ("DELETE", "/v1/experiment/golden", None),
    ("GET", "/v1/experiment/golden/best", None),         # 404: empty pool
    ("GET", "/v1/experiments", None),
    ("GET", "/v1/nope", None),                           # 404: no route
    ("POST", "/v1/experiment/golden/best", None),        # 405: wrong method
    ("PUT", "/v1/experiment/golden/chromosomes",
     {"items": "nope"}),                                 # 400: malformed
]


def run_golden_transcript():
    """Execute GOLDEN_STEPS against a fresh server; return the
    transcript as JSON-able dicts."""
    out = []
    with background_server(rate=100000, burst=100000) as server:
        for method, path, body in GOLDEN_STEPS:
            status, _, resp = _raw(server, method, path, body)
            out.append({"method": method, "path": path, "body": body,
                        "status": status, "response": resp})
    return out


def test_golden_wire_transcript():
    assert os.path.isfile(GOLDEN_PATH), (
        f"missing {GOLDEN_PATH} — regenerate with "
        f"`PYTHONPATH=src python tests/test_server.py --regen`")
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)
    assert golden["wire_version"] == wire.WIRE_VERSION, (
        "WIRE_VERSION bumped without regenerating the golden fixture")
    live = run_golden_transcript()
    assert len(live) == len(golden["transcript"])
    for i, (want, got) in enumerate(zip(golden["transcript"], live)):
        assert got == want, (
            f"wire drift at step {i} ({want['method']} {want['path']}):\n"
            f"  golden: {json.dumps(want, sort_keys=True)}\n"
            f"  live:   {json.dumps(got, sort_keys=True)}")


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------
def test_rate_limit_429_with_retry_after():
    with background_server(rate=0.5, burst=2) as server:
        ok = [_raw(server, "GET", "/v1/experiments", client_id="greedy")[0]
              for _ in range(2)]
        assert ok == [200, 200]
        status, headers, body = _raw(server, "GET", "/v1/experiments",
                                     client_id="greedy")
        assert status == 429
        assert body["error"] == "rate limited"
        assert body["retry_after"] > 0
        assert float(headers["retry-after"]) > 0
        # a different client id is a different bucket
        assert _raw(server, "GET", "/v1/experiments",
                    client_id="patient")[0] == 200
        # liveness bypasses throttling even for the greedy client
        assert _raw(server, "GET", "/healthz", client_id="greedy")[0] == 200


def test_backpressure_queue_depth():
    # max_queue=0: every verb is shed, liveness still answers
    with background_server(max_queue=0) as server:
        status, headers, body = _raw(server, "GET", "/v1/experiments")
        assert status == 429 and body["error"] == "server busy"
        assert "retry-after" in headers
        assert _raw(server, "GET", "/healthz")[0] == 200
        assert _raw(server, "GET", "/metricz?format=json")[2]["metrics"][
            "throttled_queue"] == 1


def _raw_text(server, method, path, client_id="golden"):
    """Raw round trip without JSON-decoding the body (text endpoints)."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=10)
    try:
        conn.request(method, path, headers={"X-Client-Id": client_id})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                resp.read().decode())
    finally:
        conn.close()


def test_metricz_prometheus_text():
    """Bare /metricz serves the Prometheus text format with per-verb
    latency histograms; ?format=json keeps the legacy dict shape."""
    from repro_torch.obs import metrics as obs_metrics

    with background_server() as server:
        c = RemotePoolServer(server.url, experiment="mz")
        c.put(np.ones(4, np.int8), 4.0, uuid=1)
        c.get_best()
        c.close()
        status, headers, text = _raw_text(server, "GET", "/metricz")
        assert status == 200
        assert headers["content-type"].startswith("text/plain; version=0.0.4")
        samples = obs_metrics.parse_prometheus(text)
        assert samples["repro_requests"] >= 2
        assert samples["repro_queue_depth"] == 0
        assert samples["repro_max_queue"] == server.max_queue
        # per-verb histogram: the PUT landed in exactly the bins the
        # cumulative +Inf bucket and _count agree on
        count = samples["repro_verb_put_latency_seconds_count"]
        assert count >= 1
        assert samples[
            'repro_verb_put_latency_seconds_bucket{le="+Inf"}'] == count
        assert samples["repro_verb_put_latency_seconds_sum"] > 0.0
        # legacy JSON view still served, now with latency summaries
        body = _raw(server, "GET", "/metricz?format=json")[2]
        assert body["metrics"]["requests"] >= 2
        assert body["latency"]["put"]["count"] == count


# ---------------------------------------------------------------------------
# namespaces
# ---------------------------------------------------------------------------
def test_namespace_isolation():
    with background_server() as server:
        a = RemotePoolServer(server.url, experiment="exp-a")
        b = RemotePoolServer(server.url, experiment="exp-b")
        a.put(np.ones(4, np.int8), 7.0, uuid=1)
        # b sees nothing from a
        assert b.stats()["size"] == 0
        with pytest.raises(PoolUnavailable):
            b.get_best()
        b.put(np.zeros(4, np.int8), 1.0, uuid=2)
        # resetting b leaves a intact
        assert b.reset() == 1
        assert b.stats()["size"] == 0
        g, f = a.get_best()
        assert f == 7.0 and a.stats()["experiment"] == 0
        np.testing.assert_array_equal(g, np.ones(4, np.int8))
        a.close(), b.close()


def test_create_config_conflict_and_bad_names():
    with background_server() as server:
        c = RemotePoolServer(server.url, experiment="cfg")
        assert c.create(capacity=32, shards=2)["created"] is True
        assert c.create(capacity=32, shards=2)["created"] is False
        with pytest.raises(PoolUnavailable, match="HTTP 409"):
            c.create(capacity=64)
        c.close()
        for bad in ("", "../etc", "a/b", "-lead", "x" * 65):
            with pytest.raises(ValueError):
                check_name(bad)
    with pytest.raises(ValueError, match="no host mirror"):
        ExperimentConfig.from_json({"acceptance": "no-such-policy"})
    with pytest.raises(ValueError):
        ExperimentConfig.from_json({"capacity": 0})


# ---------------------------------------------------------------------------
# sharded exactly-once over the wire
# ---------------------------------------------------------------------------
def test_sharded_drain_is_exactly_once():
    with background_server(rate=100000, burst=100000) as server:
        c = RemotePoolServer(server.url, experiment="sharded")
        c.create(capacity=64, shards=3, seed=1)
        n = 60
        c.put_batch([(np.array([i], np.int8), float(i), i)
                     for i in range(n)])
        seen, cursor, dropped = set(), -1, 0
        while True:
            entries, cursor, d = c.get_since(cursor, limit=7,
                                             cursor_id="drain")
            dropped += d
            for e in entries:
                key = (e.shard, e.seq)
                assert key not in seen, f"duplicate {key}"
                seen.add(key)
            if not entries:
                break
        assert len(seen) == n and dropped == 0
        # the ledger: every seq the cursors passed is delivered or dropped
        assert sum(cc + 1 for cc in cursor) == len(seen) + dropped
        # a second drain under the same cursor_id yields nothing
        entries, _, _ = c.get_since(-1, limit=100, cursor_id="drain")
        assert entries == []
        c.close()


# ---------------------------------------------------------------------------
# client equivalence: the wire surface behaves like the in-process one
# ---------------------------------------------------------------------------
def test_remote_matches_inprocess_semantics():
    puts = [(np.array([i, i + 1], np.int8), float(i % 5), i) for i in range(12)]
    local = PoolServer(capacity=8)
    for g, f, u in puts:
        local.put(g, f, uuid=u)
    with background_server() as server:
        remote = RemotePoolServer(server.url, experiment="equiv")
        remote.create(capacity=8, shards=1)
        remote.put_batch(puts)
        for key in ("size", "puts", "rejected", "best_fitness"):
            assert remote.stats()[key] == local.stats()[key], key
        # full drains agree entry-for-entry (single shard: same order)
        le, lc, ld = local.get_since(-1, limit=100)
        re_, rc, rd = remote.get_since(-1, limit=100)
        assert [e.seq for e in re_] == [e.seq for e in le]
        assert rc == [lc] and rd == ld
        for a, b in zip(re_, le):
            np.testing.assert_array_equal(a.genome, b.genome)
            assert (a.fitness, a.uuid) == (b.fitness, b.uuid)
        assert remote.get_best()[1] == local.get_best()[1]
        # the blocking surface also mirrors misuse guards
        with pytest.raises(ValueError):
            remote.put_with_payload(np.ones(2), 1.0, payload={"x": 1})
        assert remote.up is True
        remote.close()


def test_async_bridge_worker_over_wire():
    # the AsyncHostBridge worker loop (put + exactly-once drain + echo
    # filtering) against a networked service, no device pool needed; the
    # server shuts down although the bridge's keep-alive connection is
    # open until close() (Python 3.12's Server.wait_closed)
    from repro_torch.core.async_migration import AsyncHostBridge
    with background_server() as server:
        feeder = RemotePoolServer(server.url, experiment="bridge")
        feeder.create(capacity=32, shards=2)
        feeder.put(np.array([9, 9, 9], np.int8), 9.0, uuid=1)
        bridge = AsyncHostBridge(server.url, pull=8, uuid=42,
                                 cursor_id="bw", experiment="bridge")
        try:
            bridge._jobs.put((np.array([4, 4, 4], np.int8), 4.0))
            bridge._jobs.join()
            assert bridge.pushed == 1 and bridge.lost == 0
            with bridge._flock:
                fetched = list(bridge._fetched)
            # fetched the feeder's entry; its own push is filtered by uuid
            assert [f for _, f in fetched] == [9.0]
            # the service saw both puts
            assert feeder.stats()["puts"] == 2
        finally:
            bridge.close()
            feeder.close()


# ---------------------------------------------------------------------------
# durability: spool resume (in-process; chip_smoke.py phase 11b kills a
# `python -m repro_torch.server` child by SIGKILL and restarts it)
# ---------------------------------------------------------------------------
def test_spool_resume_restores_namespaces_and_cursors(tmp_path):
    spool = str(tmp_path / "spool")
    cfg = ExperimentConfig(capacity=16, shards=2, seed=4)
    svc = PoolService(spool_dir=spool)
    exp, created = svc.ensure("persist", cfg)
    assert created
    exp.put_batch([(np.array([i], np.int8), float(i), i) for i in range(10)])
    items, cursors, dropped = exp.get_since([-1, -1], limit=4,
                                            cursor_id="resume-test")
    first = {(shard, e.seq) for e, shard in items}
    assert len(first) == 4 and dropped == 0
    svc.close()

    svc2 = PoolService(spool_dir=spool, resume=True)
    assert svc2.experiments() == ["persist"]
    exp2, created2 = svc2.ensure("persist", cfg)   # config round-tripped
    assert not created2
    st = exp2.stats()
    assert st["puts"] == 10 and st["size"] == 10 and st["shards"] == 2
    # the named cursor survived: a cold (-1) drain skips the 4 delivered
    items2, cursors2, dropped2 = exp2.get_since([-1, -1], limit=100,
                                                cursor_id="resume-test")
    second = {(shard, e.seq) for e, shard in items2}
    assert not (first & second), "exactly-once violated across resume"
    assert len(first | second) == 10 and dropped2 == 0
    assert sum(c + 1 for c in cursors2) == 10
    svc2.close()


# ---------------------------------------------------------------------------
# unit: HashRing and TokenBucket
# ---------------------------------------------------------------------------
def test_hash_ring_balance_and_stability():
    ring4, ring5 = HashRing(4), HashRing(5)
    keys = range(2000)
    homes4 = [ring4.route(k) for k in keys]
    # balance: no shard owns a wildly disproportionate share
    counts = np.bincount(homes4, minlength=4)
    assert counts.min() > 0.5 * len(homes4) / 4
    # stability: growing 4 -> 5 moves only ~1/5 of the keyspace
    moved = sum(1 for k, h in zip(keys, homes4) if ring5.route(k) != h)
    assert moved / len(homes4) < 0.35
    # process-stable routing (blake2b, not salted hash())
    assert ring4.route("volunteer-7") == ring4.route("volunteer-7")
    with pytest.raises(ValueError):
        HashRing(0)


def test_token_bucket_injectable_clock():
    b = TokenBucket(rate=2.0, burst=2.0, now=0.0)
    assert b.allow(0.0) and b.allow(0.0)
    assert not b.allow(0.0)
    assert b.retry_after(0.0) == pytest.approx(0.5)
    assert b.allow(0.5)                      # one token accrued
    assert not b.allow(0.5)
    b2 = TokenBucket(rate=1.0, burst=5.0, now=0.0)
    for _ in range(5):
        assert b2.allow(100.0)               # refill caps at burst
    assert not b2.allow(100.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=0, burst=1)


def test_rate_limiter_lru_eviction():
    lim = RateLimiter(rate=1.0, burst=1.0, max_clients=2)
    assert lim.allow("a", now=0.0) and lim.allow("b", now=0.0)
    assert not lim.allow("a", now=0.0)       # a's bucket is dry (and MRU now)
    lim.allow("c", now=0.0)                  # evicts LRU ("b")
    assert len(lim) == 2
    assert not lim.allow("a", now=0.0)       # a survived, still dry
    assert lim.allow("b", now=0.0)           # evicted => fresh burst


def test_wire_cursor_codec():
    assert wire.decode_cursor(None, 3) == [-1, -1, -1]
    assert wire.decode_cursor("-1", 3) == [-1, -1, -1]    # scalar broadcast
    assert wire.decode_cursor("4,7,0", 3) == [4, 7, 0]
    assert wire.encode_cursor([4, 7, 0]) == "4,7,0"
    assert wire.encode_cursor(-1) == "-1"
    with pytest.raises(ValueError):
        wire.decode_cursor("1,2", 3)


def test_genome_codec_round_trip():
    for arr in (np.array([1, 0, 1], np.int8),
                np.array([0.25, -1.5], np.float32),
                np.arange(6, dtype=np.float64)):
        out = wire.decode_genome(json.loads(
            json.dumps(wire.encode_genome(arr))))
        assert out.dtype == arr.dtype
        np.testing.assert_array_equal(out, arr)




# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------
def test_golden_transcript_of_both_servers():
    """The raw golden steps give the fixture against the reference's
    server too, so the two speak one wire."""
    import repro.server.http as j_http
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)["transcript"]
    out = []
    with j_http.background_server(rate=100000, burst=100000) as server:
        for method, path, body in GOLDEN_STEPS:
            status, _, resp = _raw(server, method, path, body)
            out.append({"method": method, "path": path, "body": body,
                        "status": status, "response": resp})
    assert out == golden


def _client_transcript(client_cls, url):
    """Every verb of RemotePoolServer, as JSON-able values."""
    c = client_cls(url, experiment="xpkg", client_id="xpkg")
    out = [c.create(capacity=8, shards=2, seed=3),
           c.create(capacity=8, shards=2, seed=3)]
    try:
        c.create(capacity=4)
        out.append("no conflict")
    except Exception as e:  # noqa: BLE001 -- each package's PoolUnavailable
        out.append(str(e))
    items = [(np.array([1, 0, 1, 1], np.int8), 3.0, 0),
             (np.array([0, 0, 0, 1], np.int8), 1.0, 1),
             (np.array([1, 1, 1, 1], np.int8), 4.0, 2),
             (np.array([0.5, -0.5], np.float32), 2.5, 3)]
    out.append(c.put_batch(items))
    out.append(c.put(np.array([0, 1, 1, 0], np.int8), 2.0, uuid=5))
    g, f = c.get_random()
    out.append([g.tolist(), str(g.dtype), f])
    for _ in range(2):
        entries, cursor, dropped = c.get_since(-1, limit=3, cursor_id="gold")
        out.append([[e.seq, e.uuid, e.fitness, e.genome.tolist(),
                     str(e.genome.dtype), e.shard] for e in entries]
                   + [cursor, dropped])
    g, f = c.get_best()
    out += [[g.tolist(), f], c.stats(), c.reset(), c.up]
    try:
        c.get_best()
        out.append("not empty")
    except Exception as e:  # noqa: BLE001
        out.append(str(e))
    c.close()
    return out


def test_each_packages_client_against_the_others_server():
    """A reference RemotePoolServer against the port's server and a port
    RemotePoolServer against the reference's give one transcript, the
    same as each package's client against its own server."""
    import repro.server.client as j_client
    import repro.server.http as j_http
    runs = {}
    for sname, serve in (("port", background_server),
                         ("ref", j_http.background_server)):
        for cname, cls in (("port", RemotePoolServer),
                           ("ref", j_client.RemotePoolServer)):
            with serve(rate=100000, burst=100000) as server:
                runs[(cname, sname)] = _client_transcript(cls, server.url)
    want = runs[("ref", "ref")]
    for key, got in runs.items():
        assert got == want, key


def _journal_ops(server_cls, path, acceptance):
    srv = server_cls(capacity=4, journal_path=path, seed=5,
                     acceptance=acceptance)
    g = np.random.default_rng(3)
    for i in range(9):
        srv.put(g.integers(0, 2, 6).astype(np.int8), float(g.integers(0, 9)),
                uuid=i)
    srv.get_since(-1, limit=3, cursor_id="a")
    srv.get_since(-1, limit=2, cursor_id="b")
    srv.get_random()
    srv.reset()
    srv.put(np.ones(6, np.int8), 7.0, uuid=20)
    srv.put(np.zeros(6, np.float32), 1.5, uuid=21)
    srv.close()


def _state(srv):
    entries = [(e.seq, e.uuid, e.fitness, e.genome.tobytes(),
                str(e.genome.dtype), e.experiment) for e in srv._entries]
    return entries, dict(srv._cursors), srv._seq, srv.stats()


@pytest.mark.parametrize("policy", ["always", "elitist"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_replays_in_either_package(tmp_path, policy, writer):
    """A journal (puts, rejections, named cursors, a reset) written by
    either package replays in both with the same entries, seq, cursors
    and stats, and the lines have the same keys."""
    from repro.core.async_pool import PoolServer as JPoolServer
    from repro.core.types import AcceptanceConfig as JAcceptanceConfig
    from repro_torch.core.types import AcceptanceConfig
    accs = {"port": AcceptanceConfig(policy=policy),
            "ref": JAcceptanceConfig(policy=policy)}
    classes = {"port": PoolServer, "ref": JPoolServer}
    paths = {}
    for name in ("port", "ref"):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        _journal_ops(classes[name], paths[name],
                     None if policy == "always" else accs[name])
    lines = {n: [json.loads(x) for x in open(p)] for n, p in paths.items()}
    assert [sorted(r) for r in lines["port"]] == \
        [sorted(r) for r in lines["ref"]]
    assert [{k: v for k, v in r.items() if k != "t"}
            for r in lines["port"]] == [
        {k: v for k, v in r.items() if k != "t"} for r in lines["ref"]]
    states = []
    for name, cls in classes.items():
        srv = cls(capacity=4, journal_path=paths[writer], resume=True,
                  acceptance=None if policy == "always" else accs[name])
        states.append(_state(srv))
        srv.close()
    assert states[0] == states[1]
    assert sorted(states[0][1]) == ["a", "b"]


def test_torn_tail_is_healed_for_the_other_package(tmp_path):
    from repro.core.async_pool import PoolServer as JPoolServer
    path = str(tmp_path / "torn.jsonl")
    _journal_ops(PoolServer, path, None)
    with open(path, "ab") as fh:
        fh.write(b'{"op": "put", "uuid": 9')     # a kill mid-append
    srv = JPoolServer(capacity=4, journal_path=path, resume=True)
    srv.put(np.ones(6, np.int8), 9.0, uuid=30)
    srv.close()
    again = PoolServer(capacity=4, journal_path=path, resume=True)
    assert again.stats()["puts"] == 12 and again._seq == 12
    assert again._entries[-1].uuid == 30
    again.close()


def test_run_bridged_over_the_wire_equals_the_in_process_run():
    """run_experiment with a HostBridge given the URL of the port's
    server (one shard, experiment seed s) equals the run whose bridge
    holds PoolServer(seed=8191 * s) in process: islands, pool, stats,
    bridge stats, and the server's entries and stats."""
    from repro_torch import convert
    from repro_torch.core import (EAConfig, HostBridge, MigrationConfig,
                                  make_trap, run_experiment)
    s = 2
    problem = make_trap(8, 4)
    cfg = EAConfig(max_pop=16, min_pop=8, generations_per_epoch=3)
    run = dict(n_islands=4, max_epochs=3, rng=5, device="cpu",
               server_up=lambda e: e != 2)
    local = PoolServer(capacity=256, seed=8191 * s)
    want_bridge = HostBridge(local, pull=4)
    want = run_experiment(problem, cfg, MigrationConfig(),
                          host_bridge=want_bridge, **run)
    service = PoolService(default_config=ExperimentConfig(
        capacity=256, shards=1, seed=s))
    with background_server(service, rate=100000, burst=100000) as server:
        bridge = HostBridge(server.url, pull=4)
        got = run_experiment(problem, cfg, MigrationConfig(),
                             host_bridge=bridge, **run)
        entries, _, _ = bridge.server.get_since(-1, limit=1000)
        remote_stats = bridge.server.stats()
        bridge.server.close()
    for a, b in zip(convert.to_numpy(got.islands),
                    convert.to_numpy(want.islands)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.pool, want.pool):
        assert torch.equal(a, b)
    for a, b in zip(got.stats, want.stats):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert bridge.stats() == want_bridge.stats()
    le, _, _ = local.get_since(-1, limit=1000)
    assert [(e.seq, e.uuid, e.fitness, e.genome.tobytes()) for e in entries] \
        == [(e.seq, e.uuid, e.fitness, e.genome.tobytes()) for e in le]
    for key in ("size", "puts", "rejected", "best_fitness", "experiment"):
        assert remote_stats[key] == local.stats()[key], key


def test_client_wire_and_obs_import_without_torch_or_jax():
    code = ("import sys\n"
            "import repro_torch.server.client, repro_torch.server.wire\n"
            "import repro_torch.obs.__main__, repro_torch.obs.trace\n"
            "import repro_torch.obs.metrics\n"
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1",
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         timeout=60)
    assert out.stdout.strip() == "[]"
