"""Observability of the port: the metrics registry behind `GET
/metrics`, structured JSON logs with request ids, the train-phase
report, the flight recorder (`trace`), the time-series ring (`tsdb`),
the sampling profiler with the runtime gauges (`profiler`) and the
kernel build and launch probe (`kernelprobe`, in place of the JAX
package's `jaxprobe`), and prediction quality (`quality`: score sketches,
drift, the feedback join and the reload canary)."""

from predictionio_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    get_registry,
)
from predictionio_tpu_torch.obs.logs import (  # noqa: F401
    StructuredLogger, get_logger, new_request_id,
)
from predictionio_tpu_torch.obs.kernelprobe import (  # noqa: F401
    build_count, build_watch, install_kernel_probe,
)
from predictionio_tpu_torch.obs.report import (  # noqa: F401
    record_train_phases, train_report,
)
from predictionio_tpu_torch.obs.trace import (  # noqa: F401
    TRACE_HEADER, PendingTrace, TraceRecorder, get_recorder,
)
from predictionio_tpu_torch.obs.slo import (  # noqa: F401
    SLOTracker, dao_overrides_loader,
)
from predictionio_tpu_torch.obs.profiler import (  # noqa: F401
    HostSampler, SamplingProfiler, ensure_started, get_profiler,
    install_gc_callbacks, role_of, sample_device_memory,
)
from predictionio_tpu_torch.obs.tsdb import (  # noqa: F401
    Scraper, TSDB, series_key,
)
from predictionio_tpu_torch.obs.quality import (  # noqa: F401
    CanaryGate, CanaryVeto, QualityJoiner, QualityStats,
    QuantileSketch, js_divergence, psi, quality_enabled,
)
