"""Resilience primitives of the port: bounded retry with backoff."""

from predictionio_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy, call_with_retry,
)
