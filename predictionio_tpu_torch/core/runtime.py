"""RuntimeContext: the per-run context handed to DASE components.

The port of `predictionio_tpu/core/runtime.py` (WorkflowContext.scala,
WorkflowParams.scala). It carries the storage registry the components
read events from, the device the run computes on, the device mesh the
templates train over, and the workflow params that `cli train` flags
set.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional


@dataclass(frozen=True)
class WorkflowParams:
    """(WorkflowParams.scala:25-40; sparkEnv -> runtime_conf)"""
    batch: str = ""
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    runtime_conf: Mapping[str, Any] = field(default_factory=dict)


class RuntimeContext:
    """Execution context of one train or deploy. `registry` None means
    the process default (`data.storage.storage()`); `device` None means
    cuda (the components resolve it and raise without CUDA); `mesh`
    None means the one `runtime_conf["mesh"]` asks for (see `mesh`)."""

    def __init__(self, registry=None, device=None,
                 workflow_params: Optional[WorkflowParams] = None,
                 mesh=None):
        self._registry = registry
        self.device = device
        self._mesh = mesh
        self.workflow_params = workflow_params or WorkflowParams()
        # per-phase wall-clock that Engine.train fills (read, its ingest
        # stages, prepare, per algorithm, the trainers' own phases); the
        # workflow stores it on the engine instance
        self.phase_timings: dict = {}

    @property
    def registry(self):
        if self._registry is None:
            from predictionio_tpu_torch.data.storage import storage
            self._registry = storage()
        return self._registry

    @property
    def mesh(self):
        """The device mesh, built lazily from runtime_conf's 'mesh' spec
        (the analog of WorkflowContext building the SparkContext; no
        spec = data over every device) over this process's devices:
        every CUDA card when `device` is CUDA (None = cuda; raises
        without CUDA), else `device` (`parallel.local_devices`)."""
        if self._mesh is None:
            from predictionio_tpu_torch.parallel import (MeshSpec,
                                                         local_devices,
                                                         make_mesh)
            spec = MeshSpec.from_conf(dict(self.workflow_params.runtime_conf))
            self._mesh = make_mesh(spec, local_devices(self.device))
        return self._mesh

    def with_mesh(self, mesh) -> "RuntimeContext":
        return RuntimeContext(self._registry, self.device,
                              self.workflow_params, mesh)
