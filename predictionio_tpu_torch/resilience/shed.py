"""Load shedding: bounded admission instead of unbounded queueing.

The port of `predictionio_tpu/resilience/shed.py`. Under a burst beyond
capacity a bounded server rejects the excess at once with `Retry-After`,
so that clients back off and the admitted requests finish inside their
deadlines:

  - `OverloadedError`: raised at any full admission point; the HTTP
    layer answers it with 503 and a `Retry-After` header;
  - `InflightLimiter`: a non-blocking concurrency cap of an HTTP plane
    (the server's `max_inflight`); acquiring past the limit sheds with
    503 rather than queueing. The JAX limiter answers 429 here; the
    port answers 503, the status of a saturated server (429 is left to
    per-client quotas, which the port does not have yet).

Every shed is counted in `pio_shed_total{surface=...}` by the call site.
"""

from __future__ import annotations

import threading


class OverloadedError(Exception):
    """Admission denied: the named surface is at capacity."""

    status = 503

    def __init__(self, message: str, *, retry_after: float = 1.0):
        super().__init__(message)
        self.message = message
        self.retry_after = max(0.0, retry_after)


class InflightLimiter:
    """Non-blocking cap on concurrent requests; 0 = unlimited."""

    def __init__(self, limit: int = 0, *, surface: str = "http",
                 retry_after: float = 1.0):
        self.limit = max(0, limit)
        self.surface = surface
        self.retry_after = retry_after
        self._lock = threading.Lock()
        self._inflight = 0

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def __enter__(self) -> "InflightLimiter":
        if self.limit:
            with self._lock:
                if self._inflight >= self.limit:
                    raise OverloadedError(
                        f"{self.surface}: {self.limit} requests already "
                        "in flight", retry_after=self.retry_after)
                self._inflight += 1
        return self

    def __exit__(self, *exc) -> bool:
        if self.limit:
            with self._lock:
                self._inflight -= 1
        return False
