"""Half-open circuit breaker.

The port of `predictionio_tpu/resilience/breaker.py` (the reference
leans on akka supervision to keep a flaky storage backend from taking
the API planes down; this is the explicit analog). The three states:

  CLOSED    normal operation; `failure_threshold` consecutive transient
            failures trip it OPEN
  OPEN      every call fast-fails with `CircuitOpenError` (no backend
            round-trip, no thread pile-up) until `recovery_time` has
            passed
  HALF_OPEN after `recovery_time`, up to `half_open_max` concurrent
            probe calls go through; one success closes the breaker,
            one failure re-opens it with a fresh timer

Only the caller-declared failure types count toward the trip counter —
a constraint violation proves the backend is alive and resets the
streak. State is exported as the `pio_breaker_state` gauge
(0=closed, 1=open, 2=half-open) and transitions as the
`pio_breaker_transitions_total` counter, so an open breaker is visible
on every server's `/metrics` and flips `/ready` to 503.

The clock is injectable; tests drive recovery without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type

from predictionio_tpu_torch.obs import MetricsRegistry, get_logger, get_registry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

_log = get_logger("breaker")


class CircuitOpenError(Exception):
    """Fast-fail: the breaker is open (mapped to HTTP 503 + Retry-After)."""

    def __init__(self, name: str, retry_after: float):
        super().__init__(
            f"circuit breaker '{name}' is open; retry in "
            f"{retry_after:.1f}s")
        self.name = name
        self.retry_after = max(0.0, retry_after)


class CircuitBreaker:
    """One breaker, typically guarding one storage source."""

    def __init__(self, name: str, *,
                 failure_threshold: int = 5,
                 recovery_time: float = 30.0,
                 half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_time = recovery_time
        self.half_open_max = max(1, half_open_max)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes = 0
        metrics = metrics if metrics is not None else get_registry()
        self._gauge = metrics.gauge(
            "pio_breaker_state",
            "Circuit breaker state (0=closed, 1=open, 2=half-open)",
            labels=("name",))
        self._transitions = metrics.counter(
            "pio_breaker_transitions_total",
            "Circuit breaker state transitions", labels=("name", "to"))
        self._gauge.labels(name=self.name).set(0.0)

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        """State with the open->half-open timer applied (lock held)."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.recovery_time:
            self._set_state(HALF_OPEN)
            self._probes = 0
        return self._state

    def _set_state(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self._gauge.labels(name=self.name).set(_STATE_VALUE[state])
            self._transitions.labels(name=self.name, to=state).inc()
            _log.warning("breaker_transition", name=self.name, to=state)

    # -- protocol ------------------------------------------------------------
    def acquire(self) -> None:
        """Gate a call: raises CircuitOpenError instead of letting the
        call through while the breaker is open (or half-open with all
        probe slots taken)."""
        with self._lock:
            state = self._effective_state()
            if state == CLOSED:
                return
            if state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return
            remaining = self.recovery_time - (self._clock() - self._opened_at)
            raise CircuitOpenError(self.name, remaining)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh timer
                self._failures = self.failure_threshold
                self._opened_at = self._clock()
                self._set_state(OPEN)
                return
            self._failures += 1
            if self._failures >= self.failure_threshold and \
                    self._state == CLOSED:
                self._opened_at = self._clock()
                self._set_state(OPEN)

    def call(self, fn: Callable, *args,
             failure_types: Tuple[Type[BaseException], ...] = (Exception,),
             **kwargs):
        """Run `fn` under the breaker. Exceptions outside `failure_types`
        (client errors) propagate without tripping it — and count as
        proof of life."""
        self.acquire()
        try:
            result = fn(*args, **kwargs)
        except failure_types:
            self.record_failure()
            raise
        except BaseException:
            self.record_success()
            raise
        self.record_success()
        return result
