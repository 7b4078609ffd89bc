"""Request deadlines: parsing, propagation, expiry.

The port of `predictionio_tpu/resilience/deadline.py`. Clients send
`X-PIO-Deadline-Ms: <budget>` (the wall budget of the whole request);
without it a request has no deadline (`deadline_from_header` keeps the
JAX function's `default_ms` argument, which the port's servers leave
at 0). The HTTP middleware
parses the header into a `Deadline` and installs it in a contextvar for
the handler thread (`deadline_scope`), so the micro-batcher below the
handler sees the same budget without parameter plumbing; expiry raises
`DeadlineExceeded`, which the router answers with 504.

Deadlines are instants on the monotonic clock: they survive wall-clock
adjustments and cost one `time.monotonic()` per check.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

DEADLINE_HEADER = "X-PIO-Deadline-Ms"


class DeadlineExceeded(Exception):
    """The request's time budget ran out (HTTP 504)."""


class Deadline:
    """An absolute expiry instant on the monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = expires_at

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + ms / 1000.0)

    @classmethod
    def after_s(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining(self) -> float:
        """Seconds left; 0.0 once expired (never negative)."""
        return max(0.0, self.expires_at - time.monotonic())

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def check(self, what: str = "request") -> None:
        """Raise DeadlineExceeded if the budget is spent."""
        if self.expired:
            raise DeadlineExceeded(f"{what}: deadline exceeded")

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


def deadline_from_header(value: Optional[str],
                         default_ms: float = 0) -> Optional[Deadline]:
    """The request's Deadline from the raw header value.

    No header: the server default applies (0 = unbounded -> None). A
    malformed or non-positive header raises ValueError, which the HTTP
    layer answers with 400 (a garbage budget must not silently become an
    unbounded one)."""
    if value is None or value == "":
        return Deadline.after_ms(default_ms) if default_ms > 0 else None
    try:
        ms = float(value)
    except ValueError:
        raise ValueError(
            f"Invalid {DEADLINE_HEADER} header: {value!r} "
            "(expected milliseconds)") from None
    if ms <= 0:
        raise ValueError(
            f"Invalid {DEADLINE_HEADER} header: {value!r} "
            "(must be > 0)")
    return Deadline.after_ms(ms)


_current: contextvars.ContextVar[Optional[Deadline]] = contextvars.ContextVar(
    "pio_torch_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The deadline of the request being handled on this thread, if any."""
    return _current.get()


class deadline_scope:
    """Context manager installing a deadline for the enclosed code (the
    HTTP middleware wraps dispatch in one)."""

    __slots__ = ("deadline", "_token")

    def __init__(self, deadline: Optional[Deadline]):
        self.deadline = deadline

    def __enter__(self) -> Optional[Deadline]:
        self._token = _current.set(self.deadline)
        return self.deadline

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        return False
