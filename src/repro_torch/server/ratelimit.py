"""Per-client token buckets + queue-depth backpressure accounting.

Misbehaving volunteers are the paper's operational reality: a browser
loop with no think time, a stuck tab re-PUTting the same chromosome, a
scripted client hammering ``/random``. The frontend throttles them
per-client (token bucket keyed on ``X-Client-Id``) and sheds load
globally (429 + ``Retry-After`` once the worker queue is deep) so one
bad client degrades itself, not the experiment.

Clocks are injectable (`now` arguments) so tests never sleep.
"""
from __future__ import annotations

import collections
import time
from typing import Optional


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec, capacity ``burst``.

    ``allow(now)`` consumes one token if available; ``retry_after(now)``
    is the seconds until the next token accrues (the 429 header value).
    """

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = now

    def _refill(self, now: float) -> None:
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now

    def allow(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self._tokens >= 1.0:
            return 0.0
        return (1.0 - self._tokens) / self.rate


class RateLimiter:
    """A token bucket per client id, LRU-capped.

    The cap (``max_clients``) bounds memory against client-id churn
    (10k+ volunteers, or an adversary minting fresh ids): the least
    recently *seen* bucket is evicted, which at worst grants an evicted
    client a fresh burst — the benign failure mode.
    """

    def __init__(self, rate: float = 50.0, burst: float = 100.0,
                 max_clients: int = 65536):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_clients = int(max_clients)
        self._buckets: "collections.OrderedDict[str, TokenBucket]" = \
            collections.OrderedDict()

    def _bucket(self, client: str, now: float) -> TokenBucket:
        b = self._buckets.get(client)
        if b is None:
            b = TokenBucket(self.rate, self.burst, now=now)
            self._buckets[client] = b
            while len(self._buckets) > self.max_clients:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(client)
        return b

    def allow(self, client: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return self._bucket(client, now).allow(now)

    def retry_after(self, client: str, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        return self._bucket(client, now).retry_after(now)

    def __len__(self) -> int:
        return len(self._buckets)
