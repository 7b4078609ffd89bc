"""Storage SPI and drivers (the reference's `data/.../storage/`);
`registry.storage()` is the process-wide entry point."""

from predictionio_tpu_torch.data.storage.base import (
    AccessKey, AccessKeys, App, Apps, Channel, Channels, EngineInstance,
    EngineInstanceStatus, EngineInstances, EvaluationInstance,
    EvaluationInstanceStatus, EvaluationInstances, EventStore, Model, Models,
    StorageError, StorageWriteError,
)
from predictionio_tpu_torch.data.storage.registry import (
    StorageRegistry, register_driver, set_default, storage,
)

__all__ = [
    "AccessKey", "AccessKeys", "App", "Apps", "Channel", "Channels",
    "EngineInstance", "EngineInstanceStatus", "EngineInstances",
    "EvaluationInstance", "EvaluationInstanceStatus", "EvaluationInstances",
    "EventStore", "Model", "Models", "StorageError", "StorageWriteError",
    "StorageRegistry", "register_driver", "set_default", "storage",
]
