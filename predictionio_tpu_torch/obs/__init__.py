"""Observability of the port: the metrics registry behind `GET
/metrics`, structured JSON logs with request ids, and the train-phase
report."""

from predictionio_tpu_torch.obs.logs import (  # noqa: F401
    StructuredLogger, get_logger, new_request_id,
)
from predictionio_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    get_registry,
)
from predictionio_tpu_torch.obs.report import (  # noqa: F401
    record_train_phases, train_report,
)
