"""Deploy-time model preparation and serve warmup.

The port of `prepare_deploy`, `derive_warm_buckets` and `warm_deploy`
from `predictionio_tpu/core/workflow.py`. Models arrive as port models
(`ops.als.als_model_from_numpy` / `load_npz`), not as the JAX package's
pickled blob, which cannot be read without that package.

One difference from the JAX package: a warmup failure raises. The JAX
package logs it and serves through its generic paths, which here would
hide a kernel that does not build or launch.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.base import Algorithm, Serving
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.params import EngineParams

_log = logging.getLogger("pio.torch.workflow")


def prepare_deploy(engine: Engine, models: Sequence[Any],
                   engine_params: Optional[EngineParams] = None, *,
                   warm_batch_max: Optional[int] = None,
                   observed_sizes: Optional[Dict[int, int]] = None,
                   mesh=None) -> Tuple[List[Algorithm], List[Any], Serving]:
    """Instantiate the serving components for `models` (one per
    algorithm) and warm them; returns (algorithms, models, serving).

    `warm_batch_max` caps the batch buckets warmed through each
    algorithm's `warm_serving` (the server passes its micro-batcher
    `batch_max`); None skips warmup. `mesh` (a `ServeMesh` or
    `ShardSlice`) is the serving mesh; None takes
    `serve_mesh_from_conf()`, which shards only over two or more local
    CUDA cards."""
    _, _, algos, serving = engine.make_components(
        engine_params or EngineParams())
    models = list(models)
    if len(models) != len(algos):
        raise ValueError(
            f"{len(models)} model(s) for {len(algos)} algorithm(s)")
    for model in models:
        check = getattr(model, "sanity_check", None)
        if callable(check):
            check()
    if warm_batch_max is not None:
        if mesh is None:
            from predictionio_tpu_torch.ops.topk_sharded import (
                serve_mesh_from_conf)
            mesh = serve_mesh_from_conf()
        warm_deploy(algos, models, warm_batch_max, mesh=mesh,
                    observed_sizes=observed_sizes)
    return algos, models, serving


def derive_warm_buckets(warm_batch_max: int,
                        observed_sizes: Optional[Dict[int, int]] = None
                        ) -> List[int]:
    """The batch shapes a deploy should warm.

    No observation history -> the full pow2 ladder 1..warm_batch_max.
    With a recorded batch-size histogram, only the observed pow2 shapes
    (clamped to the ladder) plus bucket 1."""
    cap = max(1, int(warm_batch_max))
    ladder: List[int] = []
    b = 1
    while b <= cap:
        ladder.append(b)
        b *= 2
    if not observed_sizes:
        return ladder
    wanted = {1}
    for size, count in observed_sizes.items():
        try:
            size, count = int(size), int(count)
        except (TypeError, ValueError):
            continue
        if count <= 0 or size < 1:
            continue
        # clamp outsized observations (batch_max shrank between runs)
        wanted.add(max(s for s in ladder if s <= size))
    return [s for s in ladder if s in wanted]


def warm_deploy(algos: Sequence[Algorithm], models: Sequence[Any],
                warm_batch_max: int, mesh=None,
                observed_sizes: Optional[Dict[int, int]] = None) -> int:
    """Warm every algorithm's serve plan for the pow2 batch buckets up
    to `warm_batch_max`, pinning model state on the device or sharding
    it over `mesh`; returns the number of buckets warmed. Raises on any
    warmup failure."""
    buckets = derive_warm_buckets(warm_batch_max, observed_sizes)
    t0 = time.perf_counter()
    warmed = 0
    for algo, model in zip(algos, models):
        warmed += int(algo.warm_serving(model, buckets, mesh=mesh) or 0)
    _log.info("serve_warmup buckets=%s warmed=%d seconds=%.3f", buckets,
              warmed, time.perf_counter() - t0)
    return warmed
