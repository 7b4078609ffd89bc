"""Bounded retry with exponential backoff and full jitter.

The port of `RetryPolicy` and `call_with_retry` from
`predictionio_tpu/resilience/retry.py`: exponential backoff
(`base_delay * multiplier**attempt`, capped at `max_delay`), each delay
scaled by a random factor in [1 - jitter, 1], and an explicit allowlist
of retryable exceptions (anything else propagates at once), and
deadline awareness: when the request's `current_deadline()` has less
budget left than the next backoff, the last failure propagates at once.
The sleep is injectable so that tests run a schedule in microseconds.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from predictionio_tpu_torch.resilience.deadline import current_deadline


@dataclass(frozen=True)
class RetryPolicy:
    """How many attempts, how long between them, and what qualifies."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # delay *= uniform(1 - jitter, 1)
    retryable: Tuple[Type[BaseException], ...] = (OSError,)

    def backoff(self, attempt: int,
                rng: Callable[[], float] = random.random) -> float:
        """Delay before retry number `attempt` (0-based), jittered."""
        delay = min(self.max_delay,
                    self.base_delay * (self.multiplier ** attempt))
        return delay * (1.0 - self.jitter * rng())


def call_with_retry(fn: Callable, *args,
                    policy: Optional[RetryPolicy] = None,
                    sleep: Callable[[float], None] = time.sleep, **kwargs):
    """Run `fn`, retrying the policy's retryable exceptions; the last
    attempt's exception propagates unwrapped."""
    policy = policy or RetryPolicy()
    attempts = max(1, policy.attempts)
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except policy.retryable:
            if attempt == attempts - 1:
                raise
            delay = policy.backoff(attempt)
            deadline = current_deadline()
            if deadline is not None and deadline.remaining() <= delay:
                raise     # no budget to wait out the backoff
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
