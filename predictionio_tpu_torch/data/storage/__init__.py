"""Storage SPI and drivers (the reference's `data/.../storage/`);
`registry.storage()` is the process-wide entry point."""

from predictionio_tpu_torch.data.storage.base import (
    AccessKey, AccessKeys, App, Apps, Channel, Channels, EngineInstance,
    EngineInstanceStatus, EngineInstances, EvaluationInstance,
    EvaluationInstanceStatus, EvaluationInstances, EventStore, Lease, Leases,
    Model, Models, SLOObjective, SLOObjectives, StorageError,
    StorageUnavailableError, StorageWriteError, TenantQuota, TenantQuotas,
)
from predictionio_tpu_torch.data.storage.registry import (
    StorageRegistry, register_driver, set_default, storage,
)

__all__ = [
    "AccessKey", "AccessKeys", "App", "Apps", "Channel", "Channels",
    "EngineInstance", "EngineInstanceStatus", "EngineInstances",
    "EvaluationInstance", "EvaluationInstanceStatus", "EvaluationInstances",
    "EventStore", "Lease", "Leases", "Model", "Models", "SLOObjective",
    "SLOObjectives", "StorageError", "StorageUnavailableError",
    "StorageWriteError", "TenantQuota",
    "TenantQuotas",
    "StorageRegistry", "register_driver", "set_default", "storage",
]
