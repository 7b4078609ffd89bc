"""Resilience primitives of the port: deadlines, bounded retry with
backoff, per-source retry budgets, circuit breakers, load shedding,
fault-injection seams, the thread watchdog and the memory-pressure
guard."""

from predictionio_tpu_torch.resilience.breaker import (  # noqa: F401
    CircuitBreaker, CircuitOpenError,
)
from predictionio_tpu_torch.resilience.budget import RetryBudget  # noqa: F401
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
from predictionio_tpu_torch.resilience.watchdog import (  # noqa: F401
    Beat, Superseded, Watchdog, watchdog,
)
from predictionio_tpu_torch.resilience.pressure import (  # noqa: F401
    MemoryGuard,
)
