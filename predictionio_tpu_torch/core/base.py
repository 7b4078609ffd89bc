"""DASE component contracts: DataSource, Preparator, Algorithm, Serving.

The port of `predictionio_tpu/core/base.py`. Every component is
constructed with one Params dataclass. `Evaluator` is the base of
`core.evaluation.MetricEvaluator`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.core.params import EmptyParams, Params


class TrainingInterrupted(Exception):
    """Base of the stop-after-* interruptions (WorkflowUtils.scala:
    388-392)."""


class StopAfterReadInterruption(TrainingInterrupted):
    pass


class StopAfterPrepareInterruption(TrainingInterrupted):
    pass


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


class DataSource(_Component):
    """Reads training data (BaseDataSource.scala:37-54)."""

    def read_training(self, ctx: Any) -> Any:
        raise NotImplementedError

    def read_eval(self, ctx: Any) -> List[Tuple[Any, Any, list]]:
        """[(training data, eval info, [(query, actual)])] per fold
        (BaseDataSource.readEvalBase)."""
        raise NotImplementedError


class Preparator(_Component):
    """TD -> PD (BasePreparator.scala:36)."""

    def prepare(self, ctx: Any, td: Any) -> Any:
        raise NotImplementedError


class IdentityPreparator(Preparator):
    """PD = TD passthrough (controller/IdentityPreparator.scala:29-93)."""

    def prepare(self, ctx: Any, td: Any) -> Any:
        return td


class Algorithm(_Component):
    """Train a model and answer queries from it (BaseAlgorithm.scala:58-125).

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


class Evaluator(_Component):
    """Scores the output of `Engine.eval` (BaseEvaluator.scala:37-48);
    `core.evaluation.MetricEvaluator` is the implementation."""

    def evaluate(self, ctx: Any, engine: Any, engine_params_list: Any,
                 eval_data_set: Any = None) -> Any:
        raise NotImplementedError


def sanity_check(obj: Any) -> None:
    """Run an object's sanity_check hook if present (SanityCheck trait;
    called from Engine.train, Engine.scala:652-690)."""
    hook = getattr(obj, "sanity_check", None)
    if callable(hook):
        hook()
