"""Failure handling primitives for the volunteer runtime (the port's own
copy of ``repro.runtime.fault``: pure Python, no device).

The paper's stance: failures are *normal operation* — a volunteer closing a
tab, a server restart. So the runtime never aborts on pool loss; it retries
with backoff where retrying helps and degrades to standalone evolution where
it doesn't (see core.evolution).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Iterable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

# Default jitter stream for callers that don't care about determinism —
# module-owned, so seeding the *global* random module elsewhere neither
# perturbs nor is perturbed by retry backoff.
_JITTER = random.Random()


def retry(fn: Callable[[], T], *, retries: int = 3, base_delay: float = 0.01,
          max_delay: float = 1.0,
          exceptions: Tuple[Type[BaseException], ...] = (Exception,),
          on_give_up: Optional[Callable[[BaseException], T]] = None,
          sleep: Callable[[float], None] = time.sleep,
          rng: Optional[random.Random] = None) -> T:
    """Exponential backoff with jitter; ``on_give_up`` turns the final
    failure into a degraded-mode value instead of raising. ``rng`` (a
    ``random.Random``) seeds the jitter stream — pass one in tests so the
    backoff schedule is deterministic (the RNG02 discipline: no seeded
    code path may draw from the global ``random`` module)."""
    jitter = _JITTER if rng is None else rng
    delay = base_delay
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            if attempt == retries:
                break
            sleep(delay * (0.5 + jitter.random()))
            delay = min(delay * 2, max_delay)
    if on_give_up is not None:
        return on_give_up(last)  # type: ignore[arg-type]
    raise last  # type: ignore[misc]


class FailureInjector:
    """Deterministic failure schedule for tests/simulations.

    schedule: iterable of (kind, epoch) e.g. [("server", 3), ("island", 5)].
    Query with ``fires(kind, epoch)``."""

    def __init__(self, schedule: Iterable[Tuple[str, int]] = (),
                 p_random: float = 0.0, seed: int = 0):
        self._sched = set(schedule)
        self._rng = random.Random(seed)
        self._p = p_random
        self.fired = []

    def fires(self, kind: str, epoch: int) -> bool:
        hit = (kind, epoch) in self._sched or (
            self._p > 0 and self._rng.random() < self._p)
        if hit:
            self.fired.append((kind, epoch))
        return hit
