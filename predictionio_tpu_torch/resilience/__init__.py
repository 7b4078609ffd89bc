"""Resilience primitives of the port: deadlines, bounded retry with
backoff, load shedding and fault-injection seams."""

from predictionio_tpu_torch.resilience.deadline import (  # noqa: F401
    DEADLINE_HEADER, Deadline, DeadlineExceeded, current_deadline,
    deadline_from_header, deadline_scope,
)
from predictionio_tpu_torch.resilience.faults import (  # noqa: F401
    FaultError, FaultInjector, FaultRule, faults,
)
from predictionio_tpu_torch.resilience.retry import (  # noqa: F401
    RetryPolicy, call_with_retry,
)
from predictionio_tpu_torch.resilience.shed import (  # noqa: F401
    InflightLimiter, OverloadedError,
)
