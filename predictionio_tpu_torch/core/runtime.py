"""RuntimeContext: the per-run context handed to DASE components.

The port of `predictionio_tpu/core/runtime.py`. It carries the device
the run computes on. Until the event store is ported, it also carries
the training ratings (`ratings`, a `RatingColumns` that `cli train`
reads from an `.npz`), which data sources read in its place; there is
no storage registry, no mesh and no workflow options (stop-after,
skip-sanity-check).
"""

from __future__ import annotations


class RuntimeContext:
    """Execution context for one train run. `device` None means cuda
    (the components resolve it and raise without CUDA)."""

    def __init__(self, device=None, ratings=None):
        self.device = device
        self.ratings = ratings
        # per-phase wall-clock that Engine.train fills (read, prepare,
        # per algorithm, and the trainers' own phases)
        self.phase_timings: dict = {}
