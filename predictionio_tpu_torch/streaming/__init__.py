"""Streaming freshness: the layer between train and serve.

The port of `predictionio_tpu/streaming/`. A deployed model is kept
fresh under a stream of events without a retrain in the loop:

  - `delta`: the change summary between two `ingest_watermark`
    snapshots, from `EventStore.scan_columns(since=..., upto=...)`
    (bytes-bounded; `DeltaInvalidated` whenever a delete, a rewritten
    journal, an over-budget span or a driver without a delta path makes
    the incremental decode unsafe);
  - `updaters`: `FoldContext` and the closed-form ALS fold-in helpers
    the templates' `fold_in` hooks build on;
  - `refresher`: the `PredictionServer` thread that ticks every
    interval: delta scan -> fold-in on the device -> `swap_factors`
    into the warmed serve plans (same shape: the warmed buckets keep
    serving, nothing is re-warmed) -> publish, rolling back to the last
    good factors on any failure.

The periodic full retrain stays ground truth: folds live in memory only
and are never written to the model store.
"""

from predictionio_tpu_torch.streaming.delta import (  # noqa: F401
    Delta, scan_delta,
)
from predictionio_tpu_torch.streaming.refresher import (  # noqa: F401
    Refresher, locate_event_store,
)
from predictionio_tpu_torch.streaming.updaters import (  # noqa: F401
    FoldContext,
)
