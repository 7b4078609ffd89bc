"""Per-source retry budgets: cap retry amplification under brownout.

The port of `predictionio_tpu/resilience/budget.py`.

Unbounded per-call retries are individually rational and collectively
catastrophic: when a backend browns out, N concurrent callers each
retrying 3x triple the offered load exactly when the backend can least
absorb it. A retry *budget* bounds the aggregate: a token bucket per
storage source where every retry spends one token and tokens refill at
a fixed rate (capacity/10 per second). When the bucket is empty the
retry is abandoned and the original error surfaces immediately — first
attempts are never budgeted, only retries.

Knob: ``PIO_STORAGE_SOURCES_<N>_RETRY_BUDGET`` (default 50 tokens;
``0`` or ``off`` disables budgeting for that source). Exhaustion is
counted in ``pio_retry_budget_exhausted_total{source}``.
"""

from __future__ import annotations

import threading
import time


class RetryBudget:
    """Thread-safe token bucket; one token per retry attempt.

    Refills continuously at ``capacity / 10`` tokens per second, so a
    sustained brownout settles at ~10% retry amplification instead of
    `attempts`x.
    """

    def __init__(self, capacity: float = 50.0,
                 refill_per_s: float = 0.0):
        if capacity <= 0:
            raise ValueError("capacity must be > 0 (use None budget to disable)")
        self.capacity = float(capacity)
        self.refill_per_s = refill_per_s if refill_per_s > 0 \
            else self.capacity / 10.0
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        elapsed = now - self._last
        if elapsed > 0:
            self._tokens = min(self.capacity,
                               self._tokens + elapsed * self.refill_per_s)
            self._last = now

    def try_acquire(self, tokens: float = 1.0) -> bool:
        """Spend *tokens* if available; False means the budget is exhausted."""
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def remaining(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens

    def __repr__(self) -> str:
        return (f"RetryBudget(capacity={self.capacity}, "
                f"remaining={self.remaining():.1f})")
