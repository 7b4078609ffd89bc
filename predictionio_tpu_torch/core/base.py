"""DASE component contracts, serving side: Algorithm, Serving,
FirstServing.

The port of the serving half of `predictionio_tpu/core/base.py`. Every
component is constructed with one Params dataclass.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.core.params import EmptyParams, Params


class _Component:
    """Shared ctor: every DASE component takes one Params dataclass."""

    params_class: Type[Params] = EmptyParams

    def __init__(self, params: Optional[Params] = None):
        if params is None or (isinstance(params, EmptyParams)
                              and self.params_class is not EmptyParams):
            # an EmptyParams placeholder means "this component's defaults"
            params = self.params_class()
        self.params = params

    def __repr__(self):
        return f"{type(self).__name__}({self.params!r})"


class Algorithm(_Component):
    """Answer queries from a model (BaseAlgorithm.scala:58-125).

    `query_class` is the dataclass the server extracts incoming JSON
    into via `extract_params`; None = raw dict passthrough."""

    query_class: Optional[type] = None

    def train(self, ctx: Any, pd: Any) -> Any:
        raise NotImplementedError

    def predict(self, model: Any, query: Any) -> Any:
        raise NotImplementedError

    def batch_predict(self, model: Any, queries: Sequence[Tuple[int, Any]]
                      ) -> List[Tuple[int, Any]]:
        """Bulk inference; the default maps `predict`. Algorithms with
        device-batched inference override this."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def warm_serving(self, model: Any, buckets: Sequence[int],
                     mesh: Any = None) -> int:
        """Deploy-time warmup: pin model state on the device (or shard it
        over `mesh`, a `ops.topk_sharded.ServeMesh` or `ShardSlice`) and
        launch the serve kernels once for each batch-size bucket. Returns
        how many buckets were warmed; the default does nothing."""
        return 0


class Serving(_Component):
    """Query supplement + multi-algorithm result combination
    (BaseServing.scala:33-42)."""

    def supplement(self, query: Any) -> Any:
        return query

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        raise NotImplementedError


class FirstServing(Serving):
    """Serve the first algorithm's prediction (LFirstServing)."""

    def serve(self, query, predictions):
        return predictions[0]
