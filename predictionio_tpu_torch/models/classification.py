"""Classification template: NaiveBayes + RandomForest (+ LogisticRegression)
on aggregated entity properties.

The port of `predictionio_tpu/models/classification.py` (parity target
`examples/scala-parallel-classification/`):
  - the data source aggregates `$set` properties of `user` entities into
    labeled points: features attr0..attr2, label `plan`
    (`add-algorithm/src/main/scala/DataSource.scala`); custom property
    names via params (the `reading-custom-properties` variant);
    `read_eval` splits them into k folds (`e2.split_data`);
  - NaiveBayesAlgorithm (MLlib NB -> `ops.naive_bayes`)
    (`NaiveBayesAlgorithm.scala:35-56`);
  - RandomForestAlgorithm (MLlib RandomForest.trainClassifier ->
    `ops.forest`, the level-wise histogram forest)
    (`add-algorithm/src/main/scala/RandomForestAlgorithm.scala:41-72`);
  - LogisticRegressionAlgorithm (`ops.logreg`), beyond the reference's
    algorithm set;
  - query `{"attr0": 2, "attr1": 0, "attr2": 0}` -> `{"label": 1.0}`.

Every algorithm trains on the context's device (`ctx.device`, None =
cuda; raises without CUDA unless "cpu"; NB's transfer_s / solve_s and
the forest's bin_s / device_s go into `ctx.phase_timings`); its model
predicts there (a deploy moves it with `to`), the forest's small
batches by its host loop (`ForestModel.HOST_CROSSOVER_CELLS`). The mesh
forms (sharded samples with partial statistics) are not ported:
training runs on one device. Evaluation: Accuracy (the template's
PrecisionEvaluation analog).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              FirstServing,
                                              IdentityPreparator)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.evaluation import AverageMetric
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.ingest import (BiMap, LabeledPoints,
                                           labeled_points_from_properties)
from predictionio_tpu_torch.ops import forest as forest_ops
from predictionio_tpu_torch.ops import logreg as lr_ops
from predictionio_tpu_torch.ops import naive_bayes as nb_ops


@dataclass(frozen=True)
class Query(Params):
    attr0: Optional[float] = None
    attr1: Optional[float] = None
    attr2: Optional[float] = None
    features: Optional[Sequence[float]] = None

    def vector(self) -> List[float]:
        if self.features is not None:
            return [float(v) for v in self.features]
        vals = [self.attr0, self.attr1, self.attr2]
        if any(v is None for v in vals):
            raise ValueError(
                "query must provide attr0..attr2 or a features array")
        return [float(v) for v in vals]


@dataclass(frozen=True)
class PredictedResult:
    label: float


@dataclass(frozen=True)
class ActualResult:
    label: float


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None
    entity_type: str = "user"
    attrs: Sequence[str] = ("attr0", "attr1", "attr2")
    label: str = "plan"
    eval_k: Optional[int] = None   # k-fold readEval


class ClassificationDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> LabeledPoints:
        p = self.params
        props = store.aggregate_properties(
            ctx.registry, p.app_name, channel_name=p.channel,
            entity_type=p.entity_type)
        lp = labeled_points_from_properties(
            props, feature_attrs=list(p.attrs), label_attr=p.label)
        if lp.features.shape[0] == 0:
            raise ValueError(
                f"No '{p.entity_type}' entities with attributes "
                f"{list(p.attrs)} + '{p.label}' found "
                "(DataSource.scala readTraining require)")
        return lp

    def read_eval(self, ctx: RuntimeContext):
        p = self.params
        if not p.eval_k:
            raise ValueError("eval requires DataSourceParams.eval_k")
        from predictionio_tpu_torch.e2 import split_data
        lp = self.read_training(ctx)
        rows = [(lp.features[i], lp.label[i], lp.entities.inverse(i))
                for i in range(lp.features.shape[0])]

        def to_training(train_rows):
            feats = np.stack([r[0] for r in train_rows])
            labels = np.array([r[1] for r in train_rows], np.float32)
            return LabeledPoints(feats, labels,
                                 BiMap.from_keys(r[2] for r in train_rows))

        return split_data(
            p.eval_k, rows, to_training=to_training,
            to_qa=lambda r: (Query(features=tuple(map(float, r[0]))),
                             ActualResult(float(r[1]))))


def _features(queries) -> np.ndarray:
    return np.array([q.vector() for _, q in queries], np.float32)


def _results(queries, labels):
    return [(i, PredictedResult(float(y)))
            for (i, _), y in zip(queries, labels)]


@dataclass(frozen=True)
class NaiveBayesParams(Params):
    lambda_: float = 1.0


class NaiveBayesAlgorithm(Algorithm):
    params_class = NaiveBayesParams
    query_class = Query

    def train(self, ctx: RuntimeContext,
              pd: LabeledPoints) -> nb_ops.NaiveBayesModel:
        return nb_ops.nb_train(pd.features, pd.label, self.params.lambda_,
                               device=ctx.device, timings=ctx.phase_timings)

    def predict(self, model, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model, queries):
        return _results(queries, nb_ops.nb_predict(model, _features(queries)))


@dataclass(frozen=True)
class LogisticRegressionParams(Params):
    steps: int = 200
    lr: float = 0.1
    reg: float = 1e-4


class LogisticRegressionAlgorithm(Algorithm):
    params_class = LogisticRegressionParams
    query_class = Query

    def train(self, ctx: RuntimeContext,
              pd: LabeledPoints) -> lr_ops.LogRegModel:
        p = self.params
        return lr_ops.logreg_train(pd.features, pd.label, steps=p.steps,
                                   lr=p.lr, reg=p.reg, device=ctx.device)

    def predict(self, model, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model, queries):
        return _results(queries,
                        lr_ops.logreg_predict(model, _features(queries)))


@dataclass(frozen=True)
class RandomForestParams(Params):
    """(RandomForestAlgorithmParams, RandomForestAlgorithm.scala:30-38:
    numClasses is inferred from the labels rather than declared)."""
    num_trees: int = 10
    max_depth: int = 5
    max_bins: int = 32
    impurity: str = "gini"
    feature_subset_strategy: str = "auto"
    seed: int = 0


class RandomForestAlgorithm(Algorithm):
    params_class = RandomForestParams
    query_class = Query

    def train(self, ctx: RuntimeContext,
              pd: LabeledPoints) -> forest_ops.ForestModel:
        p = self.params
        return forest_ops.forest_train(
            pd.features, pd.label, n_trees=p.num_trees,
            max_depth=p.max_depth, max_bins=p.max_bins,
            impurity=p.impurity,
            feature_subset_strategy=p.feature_subset_strategy, seed=p.seed,
            device=ctx.device, timings=ctx.phase_timings)

    def predict(self, model, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model, queries):
        return _results(queries, model.predict(_features(queries)))


class Accuracy(AverageMetric):
    """Fraction of correct predictions (the template's Precision
    evaluation generalized to all classes), a fold scored as one array
    comparison."""

    def calculate_batch(self, qpa):
        n = len(qpa)
        pred = np.fromiter((p.label for _, p, _ in qpa), np.float64, n)
        act = np.fromiter((a.label for _, _, a in qpa), np.float64, n)
        return (pred == act).astype(np.float64)

    def calculate_one(self, q, p: PredictedResult, a: ActualResult) -> float:
        return 1.0 if p.label == a.label else 0.0


class ClassificationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source=ClassificationDataSource,
            preparator=IdentityPreparator,
            algorithms={"naive": NaiveBayesAlgorithm, "": NaiveBayesAlgorithm,
                        "forest": RandomForestAlgorithm,
                        "logreg": LogisticRegressionAlgorithm},
            serving=FirstServing,
        )


def engine() -> Engine:
    return ClassificationEngine.apply()


register_engine("classification", ClassificationEngine)
