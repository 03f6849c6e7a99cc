"""Asyncio HTTP/1.1 frontend for :class:`~repro_torch.server.service.PoolService`.

Pure stdlib (``asyncio.start_server`` + a minimal HTTP parser): the
container and CI runners need nothing beyond the Python baseline, and
the server stays a single auditable file.

Concurrency model — single event loop + a small worker pool:

  * Connection handling, parsing, routing, rate limiting and response
    writing run on the event loop. Frontend metrics (request counters,
    per-verb latency histograms) are mutated from *two* thread
    populations — the loop increments counters, the executor records
    verb latencies — so every mutation goes through ``_count``/
    ``_observe`` under ``_mlock`` (the earlier loop-only
    ``dict.get``+store pattern became a lost-update race the moment
    latency recording moved into the executor callable; LCK02 flags
    the class — see docs/invariants.md). The queue-depth gauge stays
    loop-confined and lock-free.
  * Pool verbs execute on a ThreadPoolExecutor (default 1 worker): the
    WAL journal write inside :meth:`PoolServer._put` is blocking file
    I/O, and pushing it off-loop keeps accept/parse latency flat while
    giving backpressure a real signal — the executor backlog *is* the
    queue depth.
  * Experiment creation (journal files open on disk) runs under an
    ``asyncio.Lock`` so two first-touch requests for the same namespace
    cannot double-create it across the executor await.

Load shedding: a request is refused with ``429`` + ``Retry-After``
either when its client's token bucket is dry (per-client rate limit,
keyed on ``X-Client-Id``) or when ``queue_depth >= max_queue``
(global backpressure). Clients are expected to back off and retry —
exactly the paper's lost-XHR discipline.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from repro_torch.core.async_pool import PoolUnavailable
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import wire
from .ratelimit import RateLimiter
from .service import ExperimentConfig, PoolService

_MAX_LINE = 64 * 1024
_MAX_BODY = 32 * 1024 * 1024

_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 409: "Conflict",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error", 503: "Service Unavailable"}

_EXP = r"([A-Za-z0-9][A-Za-z0-9_.-]{0,63})"
_ROUTES = [
    ("GET", re.compile(r"^/healthz$"), "healthz"),
    ("GET", re.compile(r"^/metricz$"), "metricz"),
    ("GET", re.compile(r"^/v1/experiments$"), "list_experiments"),
    ("POST", re.compile(rf"^/v1/experiment/{_EXP}$"), "create"),
    ("DELETE", re.compile(rf"^/v1/experiment/{_EXP}$"), "reset"),
    ("PUT", re.compile(rf"^/v1/experiment/{_EXP}/chromosomes$"), "put"),
    ("GET", re.compile(rf"^/v1/experiment/{_EXP}/chromosomes/random$"),
     "get_random"),
    ("GET", re.compile(rf"^/v1/experiment/{_EXP}/chromosomes/since$"),
     "get_since"),
    ("GET", re.compile(rf"^/v1/experiment/{_EXP}/best$"), "best"),
    ("GET", re.compile(rf"^/v1/experiment/{_EXP}/stats$"), "stats"),
]


class _HTTPError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def _json_response(status: int, body: Dict[str, Any],
                   extra_headers: Optional[Dict[str, str]] = None,
                   keep_alive: bool = True) -> bytes:
    payload = json.dumps(body, separators=(",", ":")).encode()
    head = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
            "Content-Type: application/json",
            f"Content-Length: {len(payload)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in (extra_headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode() + payload


def _text_response(status: int, body: str, content_type: str,
                   keep_alive: bool = True) -> bytes:
    payload = body.encode()
    head = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(payload)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + payload


async def _read_request(reader: asyncio.StreamReader,
                        ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    """One HTTP/1.1 request -> (method, target, headers, body); None on a
    clean EOF between requests (keep-alive connection closed)."""
    try:
        line = await reader.readline()
    except (asyncio.LimitOverrunError, ValueError):
        raise _HTTPError(400, "request line too long")
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3:
        raise _HTTPError(400, "malformed request line")
    method, target, _version = parts
    headers: Dict[str, str] = {}
    total = 0
    while True:
        line = await reader.readline()
        total += len(line)
        if total > _MAX_LINE:
            raise _HTTPError(400, "headers too large")
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > _MAX_BODY:
        raise _HTTPError(413, f"body exceeds {_MAX_BODY} bytes")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), target, headers, body


class PoolHTTPServer:
    """The networked pool frontend. ``await start()`` binds (port 0 =
    ephemeral; the bound port lands in ``self.port``); ``serve_forever``
    blocks until :meth:`stop`."""

    def __init__(self, service: PoolService, host: str = "127.0.0.1",
                 port: int = 0, *, rate: float = 200.0, burst: float = 400.0,
                 max_queue: int = 512, backlog: int = 4096,
                 executor_workers: int = 1):
        self.service = service
        self.host = host
        self.port = port
        self.max_queue = max_queue
        self._backlog = backlog
        self._limiter = RateLimiter(rate=rate, burst=burst)
        self._queue_depth = 0
        # metrics are written by the event loop (_count) AND the executor
        # threads (_observe): every mutation holds _mlock
        self._mlock = threading.Lock()
        self._metrics: Dict[str, int] = {}
        self._latency: Dict[str, List[int]] = {}    # verb -> log-bin counts
        self._latency_sum: Dict[str, float] = {}    # verb -> total ms
        # extra gauge providers (e.g. StragglerMonitor.gauges) merged into
        # the /metricz scrape; callables must be thread-safe and cheap
        self._gauge_sources: List[Callable[[], Dict[str, float]]] = []
        self._exp_lock = asyncio.Lock()
        self._executor = ThreadPoolExecutor(
            max_workers=executor_workers,
            thread_name_prefix="pool-verbs")
        self._server: Optional[asyncio.base_events.Server] = None
        self._stopped: Optional[asyncio.Event] = None
        self._conns: set = set()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _count(self, key: str, n: int = 1) -> None:
        with self._mlock:
            self._metrics[key] = self._metrics.get(key, 0) + n

    def _observe(self, verb: str, ms: float) -> None:
        """Record one verb latency (called from executor threads)."""
        with self._mlock:
            h = self._latency.get(verb)
            if h is None:
                h = self._latency[verb] = obs_metrics.hist_new()
            h[obs_metrics.hist_index(ms)] += 1
            self._latency_sum[verb] = self._latency_sum.get(verb, 0.0) + ms

    def add_gauge_source(self, fn: Callable[[], Dict[str, float]]) -> None:
        """Register an extra gauge provider (merged into every /metricz
        scrape) — e.g. ``StragglerMonitor.gauges`` from a co-hosted
        driver. Must be thread-safe; exceptions are swallowed per-scrape
        so a broken provider cannot take down the metrics endpoint."""
        self._gauge_sources.append(fn)

    def _gauges(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "queue_depth": float(self._queue_depth),
            "max_queue": float(self.max_queue),
            "rate_limited_clients": float(len(self._limiter)),
            "ratelimit_rate": float(self._limiter.rate),
            "ratelimit_burst": float(self._limiter.burst),
            "experiments": float(len(self.service.experiments())),
        }
        for fn in self._gauge_sources:
            try:
                out.update(fn())
            except Exception:  # noqa: BLE001 — a broken provider must not
                pass           # break the scrape
        return out

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> "PoolHTTPServer":
        self._stopped = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, backlog=self._backlog,
            limit=_MAX_LINE)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._stopped.wait()

    def stop(self) -> None:
        """Loop-threadsafe-callable shutdown trigger."""
        if self._stopped is not None and not self._stopped.is_set():
            self._stopped.set()

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
        # keep-alive connections idle in _read_request outlive the
        # listener — reap them first: since Python 3.12.1,
        # Server.wait_closed() waits for every open connection, so awaiting
        # it before the cancel never returns. One turn of the loop lets the
        # handlers of connections accepted just before close() register.
        await asyncio.sleep(0)
        while self._conns:
            conns = list(self._conns)
            for task in conns:
                task.cancel()
            await asyncio.gather(*conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
        self._executor.shutdown(wait=True)
        self.service.close()   # journals flushed + closed

    # -- connection loop ----------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername") or ("?", 0)
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _HTTPError as exc:
                    writer.write(_json_response(
                        exc.status, wire.error_body(str(exc)),
                        keep_alive=False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, target, headers, body = req
                resp = await self._dispatch(method, target, headers, body,
                                            peer)
                writer.write(resp)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()
            with contextlib.suppress(Exception):
                await writer.wait_closed()

    # -- dispatch -----------------------------------------------------------
    async def _dispatch(self, method: str, target: str,
                        headers: Dict[str, str], body: bytes,
                        peer: Tuple) -> bytes:
        split = urlsplit(target)
        query = {k: v[-1] for k, v in parse_qs(split.query).items()}
        handler = None
        path_matched = False
        for verb, pattern, name in _ROUTES:
            m = pattern.match(split.path)
            if m:
                path_matched = True
                if verb == method:
                    handler = (name, m.groups())
                    break
        self._count("requests")
        if handler is None:
            status = 405 if path_matched else 404
            self._count("errors")
            return _json_response(status, wire.error_body(
                f"no route for {method} {split.path}"))
        name, groups = handler

        # liveness/metrics bypass throttling — they must answer even
        # (especially) when the service is shedding load
        if name == "healthz":
            return _json_response(200, self._local_verb(name))
        if name == "metricz":
            if query.get("format") == "json":
                return _json_response(200, self._local_verb(name))
            return _text_response(200, self._metricz_text(),
                                  obs_metrics.PROM_CONTENT_TYPE)

        client = headers.get("x-client-id") or f"{peer[0]}:{peer[1]}"
        if not self._limiter.allow(client):
            retry = self._limiter.retry_after(client)
            self._count("throttled_rate")
            return _json_response(
                429, wire.error_body("rate limited", retry_after=retry),
                extra_headers={"Retry-After": f"{max(retry, 0.001):.3f}"})
        if self._queue_depth >= self.max_queue:
            retry = 0.02 * (self._queue_depth - self.max_queue + 1)
            self._count("throttled_queue")
            return _json_response(
                429, wire.error_body("server busy", retry_after=retry),
                extra_headers={"Retry-After": f"{retry:.3f}"})

        try:
            parsed = json.loads(body.decode() or "{}") if method in (
                "PUT", "POST") else {}
            if not isinstance(parsed, dict):
                raise ValueError("body must be a JSON object")
            fn = await self._bind_verb(name, groups, query, parsed)

            def timed():
                # runs on the executor thread: span + latency histogram
                t0 = time.perf_counter()
                try:
                    with obs_trace.span(f"server.{name}"):
                        return fn()
                finally:
                    self._observe(name,
                                  (time.perf_counter() - t0) * 1e3)

            loop = asyncio.get_running_loop()
            self._queue_depth += 1
            try:
                result = await loop.run_in_executor(self._executor, timed)
            finally:
                self._queue_depth -= 1
            return _json_response(200, result)
        except _HTTPError as exc:
            self._count("errors")
            return _json_response(exc.status, wire.error_body(str(exc)))
        except PoolUnavailable as exc:
            status = 404 if "empty" in str(exc) else 503
            self._count("errors")
            return _json_response(status, wire.error_body(str(exc)))
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as exc:
            self._count("errors")
            return _json_response(400, wire.error_body(
                f"{exc.__class__.__name__}: {exc}"))
        except Exception as exc:  # noqa: BLE001 — a handler bug must 500,
            # not tear down the connection loop for every other client
            self._count("errors")
            return _json_response(500, wire.error_body(
                f"internal error: {exc.__class__.__name__}: {exc}"))

    def _local_verb(self, name: str) -> Dict[str, Any]:
        if name == "healthz":
            return {"ok": True, "wire_version": wire.WIRE_VERSION,
                    "experiments": len(self.service.experiments())}
        with self._mlock:
            metrics = dict(sorted(self._metrics.items()))
            latency = {v: {"count": sum(h),
                           "p50_ms": obs_metrics.hist_percentile(h, 0.50),
                           "p99_ms": obs_metrics.hist_percentile(h, 0.99)}
                       for v, h in sorted(self._latency.items())}
        return {"metrics": metrics,
                "latency": latency,
                "queue_depth": self._queue_depth,
                "rate_limited_clients": len(self._limiter)}

    def _metricz_text(self) -> str:
        """One Prometheus text-format scrape (the default /metricz body)."""
        with self._mlock:
            counters = dict(self._metrics)
            hists = {f"verb_{v}_latency": (list(h),
                                           self._latency_sum.get(v, 0.0))
                     for v, h in self._latency.items()}
        return obs_metrics.render_prometheus(
            counters=counters, gauges=self._gauges(), histograms=hists)

    async def _ensure(self, name: str,
                      config: Optional[ExperimentConfig] = None):
        """First touch of a namespace opens journal files on disk — one
        creation at a time, and exactly once per name."""
        async with self._exp_lock:
            return self.service.ensure(name, config)

    async def _bind_verb(self, name: str, groups: Tuple, query: Dict[str, str],
                         body: Dict[str, Any]):
        """Resolve the route to a no-argument callable for the executor.
        Experiment resolution (the only map mutation) happens here on the
        loop, under the creation lock."""
        if name == "list_experiments":
            return lambda: {"experiments": self.service.experiments()}
        exp_name = groups[0]
        if name == "create":
            cfg = ExperimentConfig.from_json(body)
            try:
                exp, created = await self._ensure(exp_name, cfg)
            except ValueError as exc:
                # namespace exists with a different config
                raise _HTTPError(409, str(exc)) from exc
            return lambda: {"experiment_name": exp.name, "created": created,
                            "config": exp.config.__dict__.copy()}
        exp, _ = await self._ensure(exp_name)
        if name == "put":
            items = wire.decode_put_request(body)
            return partial(exp.put_batch, items)
        if name == "get_random":
            n = int(query.get("n", "1"))
            return lambda: {"items": [
                wire.random_item(e.genome, e.fitness)
                for e in exp.get_random(n)]}
        if name == "get_since":
            seqs = wire.decode_cursor(query.get("seq"), exp.config.shards)
            limit = int(query.get("limit", "64"))
            cursor_id = query.get("cursor_id") or None

            def drain():
                items, cursors, dropped = exp.get_since(
                    seqs, limit=limit, cursor_id=cursor_id)
                return {"items": [wire.since_item(e, shard)
                                  for e, shard in items],
                        "cursor": cursors, "dropped": dropped}
            return drain
        if name == "best":
            def best():
                g, f = exp.get_best()
                return wire.random_item(g, f)
            return best
        if name == "reset":
            return lambda: {"experiment": exp.reset()}
        if name == "stats":
            return exp.stats
        raise _HTTPError(500, f"unbound route {name}")


@contextlib.contextmanager
def background_server(service: Optional[PoolService] = None, **kw):
    """Run a :class:`PoolHTTPServer` on a daemon thread with its own
    event loop — the test/example harness. Yields the started server
    (``.url`` / ``.port`` are live); tears it down on exit."""
    service = service if service is not None else PoolService()
    server = PoolHTTPServer(service, **kw)
    ready = threading.Event()
    failure: list = []

    async def _main():
        try:
            await server.start()
        except Exception as exc:  # noqa: BLE001 — surface bind errors to
            failure.append(exc)   # the foreground thread, not the loop's
            ready.set()           # stderr
            return
        ready.set()
        await server.serve_forever()
        await server.aclose()

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=lambda: loop.run_until_complete(_main()),
                              daemon=True)
    thread.start()
    if not ready.wait(timeout=10.0):
        raise RuntimeError("server failed to start within 10s")
    if failure:
        raise failure[0]
    try:
        yield server
    finally:
        loop.call_soon_threadsafe(server.stop)
        thread.join(timeout=10.0)
        if thread.is_alive():  # wedged loop: don't hang the test session
            raise RuntimeError("server thread did not shut down")
        loop.close()
