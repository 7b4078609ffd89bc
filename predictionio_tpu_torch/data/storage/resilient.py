"""Resilience proxy wrapping every storage DAO the registry hands out.

The port of `predictionio_tpu/data/storage/resilient.py` (the reference's
spray/akka stack keeps a flaky backend from cascading by actor
supervision; here the equivalent sits at the DAO boundary, where every
storage round trip of every driver passes):

  breaker( retry( fault-seam( dao.method(...) ) ) )

  - the fault seam (`storage.<source>.<dao>.<method>`) lets the chaos
    harness inject latency/failures without touching driver code
  - retry absorbs transient faults (`TRANSIENT_STORAGE_ERRORS`:
    StorageUnavailableError, OSError) with jittered backoff, counted in
    `pio_storage_retries_total{source}`
  - one circuit breaker per SOURCE (shared by all its DAOs — one dead
    Postgres is one dead Postgres) trips after the configured streak of
    post-retry failures and fast-fails with `CircuitOpenError`, which
    the HTTP planes map to 503 + Retry-After and `/ready` reports

A write whose reply was lost (`StorageOutcomeUnknownError`) is not
retried, since it may have been applied, but counts toward the trip.
Client errors (StorageWriteError and everything else non-transient)
pass straight through: they are not retried, and they RESET the breaker
streak, since a constraint violation proves the backend is alive.

Wrapping is attribute-level and lazy: non-callable and underscore
attributes pass through untouched, so driver-internal access and tests
poking at `dao.c` still work. Methods returning lazy iterators (`find`)
only have the CALL guarded — faults raised mid-iteration surface to the
consumer, the honest behavior for a cursor that dies mid-scan.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from predictionio_tpu_torch.data.storage.base import BREAKER_FAILURE_ERRORS
from predictionio_tpu_torch.obs import MetricsRegistry, get_registry
from predictionio_tpu_torch.resilience import (
    CircuitBreaker, RetryBudget, RetryPolicy, call_with_retry, faults,
)


class ResilientDAO:
    """Transparent retry/breaker/fault wrapper around one DAO instance."""

    def __init__(self, dao: object, seam: str, source: str,
                 breaker: CircuitBreaker, policy: RetryPolicy,
                 metrics: Optional[MetricsRegistry] = None,
                 budget: Optional[RetryBudget] = None):
        self._dao = dao
        self._seam = seam          # "storage.<source>.<dao>"
        self._source = source
        self._breaker = breaker
        self._policy = policy
        self._budget = budget      # shared per-source; None = unbudgeted
        self._wrapped: Dict[str, Callable] = {}
        metrics = metrics if metrics is not None else get_registry()
        self._retries = metrics.counter(
            "pio_storage_retries_total",
            "Storage operations retried after a transient failure",
            labels=("source",))
        self._budget_exhausted = metrics.counter(
            "pio_retry_budget_exhausted_total",
            "Retries abandoned because the per-source retry budget ran dry",
            labels=("source",))

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        if name.startswith("_"):
            # driver-internal surface: pass through unguarded
            return getattr(self._dao, name)
        cached = self._wrapped.get(name)
        if cached is not None:
            return cached
        attr = getattr(self._dao, name)
        if not callable(attr):
            return attr
        wrapped = self._wrap(name, attr)
        self._wrapped[name] = wrapped
        return wrapped

    def _wrap(self, name: str, method: Callable) -> Callable:
        seam = f"{self._seam}.{name}"
        breaker = self._breaker
        policy = self._policy

        def on_retry(attempt, exc, delay):
            budget = self._budget
            if budget is not None and not budget.try_acquire():
                # budget dry: abandon the retry loop, surface the
                # original error (raising from on_retry aborts retry)
                self._budget_exhausted.labels(source=self._source).inc()
                raise exc
            self._retries.labels(source=self._source).inc()

        def attempt(*args, **kwargs):
            faults().check(seam)
            return method(*args, **kwargs)

        def call(*args, **kwargs):
            return breaker.call(
                call_with_retry, attempt, *args,
                policy=policy, on_retry=on_retry,
                failure_types=BREAKER_FAILURE_ERRORS, **kwargs)

        call.__name__ = name
        return call

    def __repr__(self) -> str:
        return f"ResilientDAO({self._dao!r})"
