"""Evaluation and hyperparameter tuning.

The port of `predictionio_tpu/core/evaluation.py`:
  - `Metric` and AverageMetric / OptionAverageMetric / StdevMetric /
    SumMetric / ZeroMetric (`core/.../controller/Metric.scala:39-268`);
  - `Evaluation`, binding an engine and its metrics
    (`controller/Evaluation.scala:34-125`), and `EngineParamsGenerator`,
    the candidates (`controller/EngineParamsGenerator.scala`);
  - `MetricEvaluator`, scoring every candidate and picking the best
    (`MetricEvaluator.scala:185-245`);
  - prefix memoization across candidates (`FastEvalEngine.scala:46-346`):
    a sweep re-reads, re-prepares and re-trains only the stages whose
    params changed;
  - `run_evaluation`, the EvaluationInstance lifecycle EVALINIT ->
    EVALRUNNING -> EVALCOMPLETED (`CoreWorkflow.scala:103-160`).

Training and prediction run where the context says (`ctx.device`, None
= cuda). The prefix cache keeps every trained model, on the card, until
the evaluation ends. Beyond the JAX package, the completed instance's
`runtime_conf` records the run's `phase_timings` (the read, and each
candidate's prepare, train and predict seconds per fold) and, on a
card, `peak_device_bytes`.
"""

from __future__ import annotations

import json
import math
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.base import Evaluator
from predictionio_tpu_torch.core.engine import Engine, bind_serving_context
from predictionio_tpu_torch.core.params import EngineParams, params_to_json
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import utcnow
from predictionio_tpu_torch.data.storage.base import (
    EvaluationInstance, EvaluationInstanceStatus)

# eval data set shape: [(eval_info, [(query, prediction, actual)])]
EvalDataSet = List[Tuple[Any, List[Tuple[Any, Any, Any]]]]


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

class Metric:
    """Score an EvalDataSet; higher is better unless `higher_is_better`
    is False (Metric.scala:39-78)."""

    higher_is_better: bool = True

    def header(self) -> str:
        return type(self).__name__

    def calculate(self, ctx: RuntimeContext, eval_data: EvalDataSet) -> float:
        raise NotImplementedError

    def compare(self, a: float, b: float) -> int:
        key = (a > b) - (a < b)
        return key if self.higher_is_better else -key


class _BatchableMetric(Metric):
    """The calculate_one family: a metric may override `calculate_batch`
    to score a whole fold's (Q, P, A) list at once; None falls back to
    `calculate_one` per tuple."""

    def calculate_batch(self, qpa: List[Tuple[Any, Any, Any]]):
        return None

    def _fold_scores(self, qpa) -> List:
        batch = self.calculate_batch(qpa)
        if batch is not None:
            return list(batch)
        return [self.calculate_one(q, p, a) for q, p, a in qpa]

    def calculate_one(self, q, p, a):
        raise NotImplementedError


class AverageMetric(_BatchableMetric):
    """Mean of calculate_one over every (Q, P, A) (Metric.scala:95-130)."""

    def calculate(self, ctx, eval_data):
        scores = [s for _, qpa in eval_data for s in self._fold_scores(qpa)]
        return float(sum(scores) / len(scores)) if scores else float("nan")


class OptionAverageMetric(_BatchableMetric):
    """Mean over the scores that are not None (Metric.scala:132-170)."""

    def calculate(self, ctx, eval_data):
        scores = [s for _, qpa in eval_data for s in self._fold_scores(qpa)
                  if s is not None]
        return float(sum(scores) / len(scores)) if scores else float("nan")


class SumMetric(_BatchableMetric):
    """Sum of calculate_one (Metric.scala:217-250)."""

    def calculate(self, ctx, eval_data):
        return float(sum(s for _, qpa in eval_data
                         for s in self._fold_scores(qpa)))


class StdevMetric(_BatchableMetric):
    """Population stdev of calculate_one (Metric.scala:172-215)."""

    def calculate(self, ctx, eval_data):
        scores = [s for _, qpa in eval_data for s in self._fold_scores(qpa)]
        if not scores:
            return float("nan")
        mean = sum(scores) / len(scores)
        return float(math.sqrt(sum((s - mean) ** 2
                                   for s in scores) / len(scores)))


class ZeroMetric(Metric):
    """Always 0: a placeholder auxiliary metric (Metric.scala:252-268)."""

    def calculate(self, ctx, eval_data):
        return 0.0


# ---------------------------------------------------------------------------
# Evaluation binding + candidate generation
# ---------------------------------------------------------------------------

@dataclass
class Evaluation:
    """Engine + metrics (+ an optional candidate generator)
    (controller/Evaluation.scala:34-125)."""
    engine: Engine
    metric: Metric
    other_metrics: Sequence[Metric] = ()
    engine_params_generator: Optional["EngineParamsGenerator"] = None


@dataclass
class EngineParamsGenerator:
    """A list of candidate EngineParams
    (controller/EngineParamsGenerator.scala)."""
    engine_params_list: Sequence[EngineParams]


# ---------------------------------------------------------------------------
# MetricEvaluator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MetricScores:
    score: float
    other_scores: Tuple[float, ...]
    engine_params: EngineParams


@dataclass(frozen=True)
class MetricEvaluatorResult:
    best_score: MetricScores
    best_index: int
    all_results: Tuple[MetricScores, ...]
    metric_header: str
    other_metric_headers: Tuple[str, ...]

    def one_liner(self) -> str:
        return (f"[{self.best_score.score:.4f}] "
                f"{self.metric_header} (best of "
                f"{len(self.all_results)} candidates)")

    def to_json(self) -> str:
        return json.dumps({
            "metricHeader": self.metric_header,
            "otherMetricHeaders": list(self.other_metric_headers),
            "bestIndex": self.best_index,
            "bestScore": self.best_score.score,
            "results": [
                {"score": r.score, "otherScores": list(r.other_scores)}
                for r in self.all_results],
        })

    def to_html(self) -> str:
        rows = "".join(
            f"<tr{' style=font-weight:bold' if i == self.best_index else ''}>"
            f"<td>{i}</td><td>{r.score}</td>"
            f"<td>{list(r.other_scores)}</td></tr>"
            for i, r in enumerate(self.all_results))
        return (f"<table><tr><th>#</th><th>{self.metric_header}</th>"
                f"<th>{list(self.other_metric_headers)}</th></tr>{rows}"
                "</table>")


class MetricEvaluator(Evaluator):
    """Evaluates every candidate EngineParams and returns the best
    (MetricEvaluator.scala:185-245). `output_path` gets the full result
    JSON. After `evaluate`, `timings` holds the run's phase seconds."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = (),
                 output_path: Optional[str] = None):
        super().__init__()
        self.metric = metric
        self.other_metrics = tuple(other_metrics)
        self.output_path = output_path
        self.timings: Dict[str, Any] = {}

    def evaluate(self, ctx: RuntimeContext, engine: Engine,
                 engine_params_list: Sequence[EngineParams],
                 eval_data_set=None) -> MetricEvaluatorResult:
        cache = _PrefixCache()
        results: List[MetricScores] = []
        for candidate, params in enumerate(engine_params_list):
            eval_data = _eval_with_cache(engine, ctx, params, cache,
                                         candidate=candidate)
            score = self.metric.calculate(ctx, eval_data)
            others = tuple(m.calculate(ctx, eval_data)
                           for m in self.other_metrics)
            results.append(MetricScores(score, others, params))
        self.timings = cache.timings
        best_index = 0
        for i, r in enumerate(results):
            if self.metric.compare(r.score,
                                   results[best_index].score) > 0:
                best_index = i
        result = MetricEvaluatorResult(
            best_score=results[best_index],
            best_index=best_index,
            all_results=tuple(results),
            metric_header=self.metric.header(),
            other_metric_headers=tuple(m.header()
                                       for m in self.other_metrics),
        )
        if self.output_path:
            with open(self.output_path, "w") as f:
                f.write(result.to_json())
        return result


# ---------------------------------------------------------------------------
# Prefix-memoized eval (the FastEvalEngine analog)
# ---------------------------------------------------------------------------

class _PrefixCache:
    """Per-stage prefixes keyed by the params JSON of each stage
    (FastEvalEngine.scala:88-230): folds by DataSource params, prepared
    data by (DataSource, Preparator) params, trained models by
    (DataSource, Preparator, Algorithm) params and fold. `timings` gets
    the read seconds and, per candidate and fold, the prepare, train
    and predict seconds (0 where the cache answered)."""

    def __init__(self):
        self.folds: Dict[str, Any] = {}
        self.prepared: Dict[str, Any] = {}
        self.models: Dict[str, Any] = {}
        self.timings: Dict[str, Any] = {"read_s": 0.0, "folds": []}

    @staticmethod
    def key(*parts) -> str:
        return "|".join(
            f"{name}:{params_to_json(p)}" for name, p in parts)


def _sync(ctx: RuntimeContext) -> None:
    """Wait for the card, so that a phase's seconds include its device
    work."""
    import torch
    dev = torch.device(ctx.device or "cuda")
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def _eval_with_cache(engine: Engine, ctx: RuntimeContext,
                     engine_params: EngineParams,
                     cache: _PrefixCache, candidate: int = 0
                     ) -> EvalDataSet:
    ds, prep, algos, serving = engine.make_components(engine_params)
    bind_serving_context(algos, ctx)
    tm = cache.timings
    ds_key = _PrefixCache.key(engine_params.data_source_params)
    if ds_key not in cache.folds:
        t0 = time.perf_counter()
        cache.folds[ds_key] = ds.read_eval(ctx)
        tm["read_s"] += time.perf_counter() - t0
    folds = cache.folds[ds_key]

    prep_key = ds_key + "||" + _PrefixCache.key(
        engine_params.preparator_params)
    prepare_s = [0.0] * len(folds)
    if prep_key not in cache.prepared:
        prepared = []
        for f, (td, _, _) in enumerate(folds):
            t0 = time.perf_counter()
            prepared.append(prep.prepare(ctx, td))
            prepare_s[f] = time.perf_counter() - t0
        cache.prepared[prep_key] = prepared
    prepared = cache.prepared[prep_key]

    out: EvalDataSet = []
    for fold_ix, ((td, eval_info, qa_pairs), pd) in enumerate(
            zip(folds, prepared)):
        t0 = time.perf_counter()
        models = []
        for algo, ap in zip(algos, engine_params.algorithm_params_list):
            m_key = (prep_key + f"||fold{fold_ix}||"
                     + _PrefixCache.key(ap))
            if m_key not in cache.models:
                cache.models[m_key] = algo.train(ctx, pd)
            models.append(cache.models[m_key])
        _sync(ctx)
        t1 = time.perf_counter()
        queries = [(i, serving.supplement(q))
                   for i, (q, _) in enumerate(qa_pairs)]
        per_algo = [dict(a.batch_predict(m, queries))
                    for a, m in zip(algos, models)]
        qpa = [(q, serving.serve(q, [pa[i] for pa in per_algo]), a)
               for i, (q, a) in enumerate(qa_pairs)]
        tm["folds"].append({"candidate": candidate, "fold": fold_ix,
                            "queries": len(qa_pairs),
                            "prepare_s": prepare_s[fold_ix],
                            "train_s": t1 - t0,
                            "predict_s": time.perf_counter() - t1})
        out.append((eval_info, qpa))
    return out


# ---------------------------------------------------------------------------
# Evaluation workflow (CoreWorkflow.runEvaluation)
# ---------------------------------------------------------------------------

def _peak_device_bytes(ctx: RuntimeContext, reset: bool = False
                       ) -> Optional[int]:
    import torch
    dev = torch.device(ctx.device or "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def run_evaluation(evaluation: Evaluation, ctx: RuntimeContext, *,
                   evaluation_class: str = "",
                   engine_params_list: Optional[Sequence[EngineParams]] = None,
                   evaluator: Optional[MetricEvaluator] = None,
                   ) -> Tuple[EvaluationInstance, MetricEvaluatorResult]:
    """Run an evaluation end to end, recording an EvaluationInstance
    (CoreWorkflow.scala:103-160): EVALINIT, EVALRUNNING, then
    EVALCOMPLETED with the results, the phase timings and the card's
    peak bytes; a failure keeps the row EVALRUNNING with its end time
    and re-raises."""
    instances = ctx.registry.get_meta_data_evaluation_instances()
    row = EvaluationInstance(
        id="", status=EvaluationInstanceStatus.INIT,
        start_time=utcnow(), end_time=utcnow(),
        evaluation_class=evaluation_class,
        batch=ctx.workflow_params.batch,
        runtime_conf=dict(ctx.workflow_params.runtime_conf),
    )
    iid = instances.insert(row)
    row = row.with_(id=iid, status=EvaluationInstanceStatus.RUNNING)
    instances.update(row)
    try:
        if engine_params_list is None:
            gen = evaluation.engine_params_generator
            if gen is None:
                raise ValueError(
                    "No engine params: pass engine_params_list or set "
                    "Evaluation.engine_params_generator")
            engine_params_list = gen.engine_params_list
        evaluator = evaluator or MetricEvaluator(
            evaluation.metric, evaluation.other_metrics)
        _peak_device_bytes(ctx, reset=True)
        result = evaluator.evaluate(ctx, evaluation.engine,
                                    engine_params_list)
        conf = {**row.runtime_conf,
                "phase_timings": getattr(evaluator, "timings", {})}
        peak = _peak_device_bytes(ctx)
        if peak is not None:
            conf["peak_device_bytes"] = peak
        row = row.with_(
            status=EvaluationInstanceStatus.COMPLETED,
            end_time=utcnow(), runtime_conf=conf,
            evaluator_results=result.one_liner(),
            evaluator_results_html=result.to_html(),
            evaluator_results_json=result.to_json(),
        )
        instances.update(row)
        return row, result
    except Exception:
        traceback.print_exc()
        instances.update(row.with_(end_time=utcnow()))
        raise
