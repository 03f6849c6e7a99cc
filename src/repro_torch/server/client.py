"""Wire-protocol clients.

:class:`RemotePoolServer` is the blocking client with the *verb surface
of* :class:`~repro_torch.core.async_pool.PoolServer` — ``put`` /
``get_random`` / ``get_since`` / ``get_best`` / ``reset`` / ``stats`` /
``up`` — so both bridges (:class:`~repro_torch.core.migration.HostBridge`,
:class:`~repro_torch.core.async_migration.AsyncHostBridge`) and
:class:`~repro_torch.core.async_pool.PoolClient` speak to a networked service
without knowing it; any transport failure surfaces as
:class:`~repro_torch.core.async_pool.PoolUnavailable`, which is exactly the
lost-XHR semantics every caller already tolerates. Construct a bridge
with a URL string and this is what it gets.

:class:`AsyncWireClient` is the volunteer-side asyncio client used by
``benchmarks/server_load.py``: one persistent keep-alive connection per
simulated browser tab, 429 ``Retry-After`` honored with bounded
retries, and request latencies surfaced to the caller.
"""
from __future__ import annotations

import asyncio
import http.client
import json
import socket
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union
from urllib.parse import urlencode, urlsplit

import numpy as np

from . import wire

Cursor = Union[int, List[int]]

if False:  # typing only — keep the module importable without torch
    from repro_torch.core.async_pool import PoolEntry, PoolUnavailable  # noqa


def _pool_types():
    """Deferred: ``repro_torch.core`` imports torch; a pure wire client (load
    harness worker, thin volunteer) must not pay that per process."""
    from repro_torch.core.async_pool import PoolEntry, PoolUnavailable
    return PoolEntry, PoolUnavailable


def _split_url(url: str) -> Tuple[str, int]:
    parts = urlsplit(url if "//" in url else f"http://{url}")
    if parts.scheme not in ("", "http"):
        raise ValueError(f"only http:// urls are supported, got {url!r}")
    return parts.hostname or "127.0.0.1", parts.port or 80


class RemotePoolServer:
    """Blocking wire client, PoolServer verb surface. Thread-compatible
    the way the bridges use it: each bridge worker owns its own instance
    (one underlying keep-alive connection, re-opened on failure)."""

    def __init__(self, url: str, experiment: str = "default",
                 timeout: float = 5.0, client_id: Optional[str] = None):
        self.host, self.port = _split_url(url)
        self.experiment = experiment
        self.timeout = timeout
        self.client_id = client_id or f"bridge-{id(self):x}"
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- transport ----------------------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None,
                 ) -> Tuple[int, Dict[str, Any]]:
        payload = (json.dumps(body, separators=(",", ":"))
                   if body is not None else None)
        headers = {"Content-Type": "application/json",
                   "X-Client-Id": self.client_id}
        try:
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=self.timeout)
            self._conn.request(method, path, body=payload, headers=headers)
            resp = self._conn.getresponse()
            raw = resp.read()
            return resp.status, (json.loads(raw) if raw else {})
        except (OSError, http.client.HTTPException, socket.timeout,
                json.JSONDecodeError) as exc:
            self.close()
            _, PoolUnavailable = _pool_types()
            raise PoolUnavailable(f"pool server unreachable: {exc}") from exc

    def _verb(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        status, out = self._request(method, path, body)
        if status == 200:
            return out
        _, PoolUnavailable = _pool_types()
        err = out.get("error", f"HTTP {status}")
        if status == 404 and "empty" in err:
            raise PoolUnavailable("pool is empty")
        # 429 (throttled), 5xx, config conflicts: all read as a lost XHR
        # to the caller — the bridges count and carry on
        raise PoolUnavailable(f"HTTP {status}: {err}")

    def _path(self, tail: str = "", **params) -> str:
        base = f"/v1/experiment/{self.experiment}{tail}"
        q = {k: v for k, v in params.items() if v is not None}
        return f"{base}?{urlencode(q)}" if q else base

    # -- PoolServer verb surface --------------------------------------------
    def put(self, genome: Any, fitness: float, uuid: int = 0) -> int:
        out = self._verb("PUT", self._path("/chromosomes"),
                         wire.put_request([wire.put_item(
                             np.asarray(genome), fitness, uuid)]))
        return int(out["experiment"])

    def put_with_payload(self, genome: Any, fitness: float, uuid: int = 0,
                         payload: Any = None) -> int:
        if payload is not None:
            raise ValueError("opaque payloads do not cross the wire "
                             "protocol; use the in-process PoolServer")
        return self.put(genome, fitness, uuid=uuid)

    def put_batch(self, items: Sequence[Tuple[Any, float, int]],
                  ) -> Dict[str, int]:
        out = self._verb("PUT", self._path("/chromosomes"),
                         wire.put_request([wire.put_item(np.asarray(g), f, u)
                                           for g, f, u in items]))
        return {k: int(out[k]) for k in ("experiment", "accepted",
                                         "rejected")}

    def get_random(self) -> Tuple[np.ndarray, float]:
        out = self._verb("GET", self._path("/chromosomes/random", n=1))
        items = out.get("items", [])
        if not items:
            _, PoolUnavailable = _pool_types()
            raise PoolUnavailable("pool is empty")
        it = items[0]
        return wire.decode_genome(it), float(it["fitness"])

    def get_random_entry(self) -> Optional["PoolEntry"]:
        PoolEntry, PoolUnavailable = _pool_types()
        try:
            g, f = self.get_random()
        except PoolUnavailable as exc:
            if "empty" in str(exc):
                return None
            raise
        return PoolEntry(g, f, 0, -1)

    def get_since(self, seq: Cursor, limit: int = 64,
                  cursor_id: Optional[str] = None,
                  ) -> Tuple[List["PoolEntry"], Cursor, int]:
        """The bridge's exactly-once drain. ``seq`` is opaque to callers:
        pass back whatever the previous call returned (``-1`` cold)."""
        PoolEntry, _ = _pool_types()
        out = self._verb("GET", self._path(
            "/chromosomes/since", seq=wire.encode_cursor(seq), limit=limit,
            cursor_id=cursor_id))
        entries = []
        for it in out.get("items", []):
            e = PoolEntry(wire.decode_genome(it), float(it["fitness"]),
                          int(it["uuid"]), int(it.get("experiment", -1)))
            e.seq = int(it["seq"])
            e.shard = int(it.get("shard", 0))  # dynamic attr: merge key
            entries.append(e)
        return entries, [int(c) for c in out["cursor"]], int(out["dropped"])

    def get_best(self) -> Tuple[np.ndarray, float]:
        out = self._verb("GET", self._path("/best"))
        return wire.decode_genome(out), float(out["fitness"])

    def reset(self) -> int:
        return int(self._verb("DELETE", self._path())["experiment"])

    def stats(self) -> Dict[str, Any]:
        return self._verb("GET", self._path("/stats"))

    def create(self, **config) -> Dict[str, Any]:
        return self._verb("POST", self._path(), config)

    @property
    def up(self) -> bool:
        _, PoolUnavailable = _pool_types()
        try:
            return bool(self._verb("GET", "/healthz").get("ok"))
        except PoolUnavailable:
            return False

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None


class AsyncWireClient:
    """One simulated volunteer: a persistent asyncio connection speaking
    the wire protocol, with 429 backoff and latency accounting.

    ``throttled``/``lost`` mirror the browser client's lost-XHR
    counters; ``latencies_ms`` is drained by the harness after each
    request via :meth:`pop_latencies`.
    """

    def __init__(self, url: str, experiment: str = "default",
                 client_id: str = "volunteer", timeout: float = 10.0,
                 max_retries: int = 3):
        self.host, self.port = _split_url(url)
        self.experiment = experiment
        self.client_id = client_id
        self.timeout = timeout
        self.max_retries = max_retries
        self.throttled = 0
        self.lost = 0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._latencies: List[float] = []

    async def _connect(self) -> None:
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port),
            timeout=self.timeout)

    async def aclose(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (OSError, asyncio.CancelledError):
                pass
            self._reader = self._writer = None

    async def _roundtrip(self, method: str, path: str,
                         body: Optional[Dict[str, Any]],
                         ) -> Tuple[int, Dict[str, str], Dict[str, Any]]:
        if self._writer is None:
            await self._connect()
        payload = (json.dumps(body, separators=(",", ":")).encode()
                   if body is not None else b"")
        head = (f"{method} {path} HTTP/1.1\r\n"
                f"Host: {self.host}:{self.port}\r\n"
                f"X-Client-Id: {self.client_id}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n\r\n")
        self._writer.write(head.encode() + payload)
        await self._writer.drain()
        status_line = await asyncio.wait_for(self._reader.readline(),
                                             timeout=self.timeout)
        if not status_line:
            raise ConnectionError("server closed connection")
        status = int(status_line.split()[1])
        headers: Dict[str, str] = {}
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        raw = await self._reader.readexactly(length) if length else b""
        return status, headers, (json.loads(raw) if raw else {})

    async def request(self, method: str, path: str,
                      body: Optional[Dict[str, Any]] = None,
                      ) -> Optional[Dict[str, Any]]:
        """One verb, with reconnect-once on a dead keep-alive connection
        and bounded 429 backoff. Returns None on a lost XHR."""
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                try:
                    status, headers, out = await self._roundtrip(
                        method, path, body)
                except (ConnectionError, asyncio.IncompleteReadError):
                    # keep-alive connection died between requests —
                    # reconnect once before charging a loss
                    await self.aclose()
                    await self._connect()
                    status, headers, out = await self._roundtrip(
                        method, path, body)
            except (OSError, asyncio.TimeoutError, ValueError,
                    asyncio.IncompleteReadError):
                await self.aclose()
                self.lost += 1
                return None
            self._latencies.append((time.perf_counter() - t0) * 1e3)
            if status == 429:
                self.throttled += 1
                if attempt >= self.max_retries:
                    return None
                retry = float(headers.get("retry-after", "0.05") or "0.05")
                await asyncio.sleep(min(retry, 2.0))
                continue
            if status != 200:
                self.lost += 1
                return None
            return out
        return None

    def pop_latencies(self) -> List[float]:
        out, self._latencies = self._latencies, []
        return out

    # -- volunteer verbs -----------------------------------------------------
    def _path(self, tail: str = "", **params) -> str:
        base = f"/v1/experiment/{self.experiment}{tail}"
        q = {k: v for k, v in params.items() if v is not None}
        return f"{base}?{urlencode(q)}" if q else base

    async def put_batch(self, items) -> Optional[Dict[str, Any]]:
        return await self.request(
            "PUT", self._path("/chromosomes"),
            wire.put_request([wire.put_item(np.asarray(g), f, u)
                              for g, f, u in items]))

    async def get_random(self, n: int = 1) -> Optional[List[Dict[str, Any]]]:
        out = await self.request("GET",
                                 self._path("/chromosomes/random", n=n))
        return None if out is None else out.get("items", [])

    async def get_since(self, seq: Cursor, limit: int = 64,
                        cursor_id: Optional[str] = None,
                        ) -> Optional[Dict[str, Any]]:
        return await self.request("GET", self._path(
            "/chromosomes/since", seq=wire.encode_cursor(seq), limit=limit,
            cursor_id=cursor_id))

    async def best(self) -> Optional[Dict[str, Any]]:
        return await self.request("GET", self._path("/best"))

    async def stats(self) -> Optional[Dict[str, Any]]:
        return await self.request("GET", self._path("/stats"))
