"""The port's eval (`core/evaluation.py`, `Engine.eval`, the
recommendation template's `read_eval` and `PrecisionAtK`, evaluation
instances, `cli eval`) against the JAX package, on the CPU:

  - the metrics of `tests/test_evaluation.py`, on the same data;
  - `MetricEvaluator`'s sweep and `_PrefixCache` over counting sample
    components: the best candidate, every score, and how often each
    stage read, prepared and trained, equal to the JAX package's;
  - `read_eval` over one store: folds, eval infos and (query, actual)
    lists identical to the JAX package's, in the same order;
  - `MetricEvaluator` with `PrecisionAtK` over the same MEM data at rank
    2 and 4 (the Cholesky path), both packages started from the JAX
    package's initial factors: scores within 1e-6, query by query;
  - an evaluation instance that either package writes into a shared
    SQLITE store reads back in the other; `run_evaluation`'s lifecycle;
    `cli eval` in a subprocess.
"""

import json
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.core import MetricEvaluator as JMetricEvaluator
from predictionio_tpu.core import RuntimeContext as JRuntimeContext
from predictionio_tpu.core import evaluation as jev
from predictionio_tpu.data import DataMap as JDataMap
from predictionio_tpu.data import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.data.storage.base import (
    EvaluationInstance as JEvaluationInstance)
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.core import evaluation as pev
from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              Preparator, Serving)
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.evaluation import (
    AverageMetric, EngineParamsGenerator, Evaluation, MetricEvaluator,
    OptionAverageMetric, StdevMetric, SumMetric, ZeroMetric, _PrefixCache,
    _eval_with_cache, run_evaluation)
from predictionio_tpu_torch.core.params import EngineParams, Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (App,
                                                 EvaluationInstanceStatus,
                                                 StorageRegistry)
from predictionio_tpu_torch.data.storage.base import EvaluationInstance
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.ops import als as pals

import sample_engine as se
from test_core_engine import ep as jep

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
DATA = [(None, [(1, 2, 3), (2, 4, 6), (3, 6, 9)])]


# -- metrics -------------------------------------------------------------------

def _metric(pkg, base, fn, **attrs):
    return type("M", (base,), {"calculate_one": lambda self, q, p, a:
                               fn(q, p, a), **attrs})()


METRICS = {
    "average": ("AverageMetric", lambda q, p, a: p, {}),
    "option_average_skips_none": (
        "OptionAverageMetric", lambda q, p, a: p if q > 1 else None, {}),
    "sum": ("SumMetric", lambda q, p, a: q, {}),
    "stdev": ("StdevMetric", lambda q, p, a: q, {}),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_equal_the_jax_metrics(name):
    base, fn, attrs = METRICS[name]
    ours = _metric(pev, getattr(pev, base), fn, **attrs)
    theirs = _metric(jev, getattr(jev, base), fn, **attrs)
    assert ours.calculate(None, DATA) == theirs.calculate(None, DATA)
    empty, jempty = ours.calculate(None, []), theirs.calculate(None, [])
    assert empty == jempty or (np.isnan(empty) and np.isnan(jempty))


def test_metric_values_and_comparator():
    assert _metric(pev, AverageMetric, lambda q, p, a: p).calculate(
        None, DATA) == 4.0
    assert _metric(pev, OptionAverageMetric,
                   lambda q, p, a: p if q > 1 else None).calculate(
        None, DATA) == 5.0
    assert _metric(pev, SumMetric, lambda q, p, a: q).calculate(
        None, DATA) == 6.0
    assert abs(_metric(pev, StdevMetric, lambda q, p, a: q).calculate(
        None, DATA) - np.std([1, 2, 3])) < 1e-9
    assert ZeroMetric().calculate(None, DATA) == 0.0
    err = _metric(pev, AverageMetric, lambda q, p, a: p,
                  higher_is_better=False)
    assert err.compare(1.0, 2.0) > 0 and AverageMetric().compare(
        2.0, 1.0) > 0


# -- the sweep over counting sample components ------------------------------------

COUNTS = {"read": 0, "prepare": 0, "train": 0}


@dataclass(frozen=True)
class SDSParams(Params):
    id: int = 0


@dataclass(frozen=True)
class SPrepParams(Params):
    id: int = 1


@dataclass(frozen=True)
class SAlgoParams(Params):
    id: int = 2
    value: int = 0


@dataclass(frozen=True)
class SQuery:
    q: int = 0


class CountingDS(DataSource):
    """`tests/sample_engine.py`'s SDataSource: two folds of three
    queries."""
    params_class = SDSParams

    def read_eval(self, ctx):
        COUNTS["read"] += 1
        return [((self.params.id + f,), f"ei{f}",
                 [(SQuery(f * 10 + i), f * 10 + i) for i in range(3)])
                for f in range(2)]


class CountingPrep(Preparator):
    params_class = SPrepParams

    def prepare(self, ctx, td):
        COUNTS["prepare"] += 1
        return (self.params.id, td)


class CountingAlgo(Algorithm):
    params_class = SAlgoParams
    query_class = SQuery

    def train(self, ctx, pd):
        COUNTS["train"] += 1
        return {"value": self.params.value, "pd": pd}

    def predict(self, model, query):
        return {"model": model, "q": query.q}


class FirstServing(Serving):
    def serve(self, query, predictions):
        return predictions[0]


class ModelValue(AverageMetric):
    def calculate_one(self, q, p, a):
        return p["model"]["value"]


# the JAX metric under the same name, so that the headers agree
JModelValue = type("ModelValue", (jev.AverageMetric,), {
    "calculate_one": lambda self, q, p, a: p.model.params_value})


class JCounting:
    """The JAX package's counting components (tests/test_evaluation.py)."""
    COUNTS = {"read": 0, "prepare": 0, "train": 0}

    class DS(se.SDataSource):
        def read_eval(self, ctx):
            JCounting.COUNTS["read"] += 1
            return super().read_eval(ctx)

    class Prep(se.SPreparator):
        def prepare(self, ctx, td):
            JCounting.COUNTS["prepare"] += 1
            return super().prepare(ctx, td)

    class Algo(se.SAlgo):
        def train(self, ctx, pd):
            JCounting.COUNTS["train"] += 1
            return super().train(ctx, pd)


def _engine():
    COUNTS.update(read=0, prepare=0, train=0)
    return Engine(data_source=CountingDS, preparator=CountingPrep,
                  algorithms={"algo": CountingAlgo}, serving=FirstServing)


def _ep(value, ds_id=7):
    return EngineParams(
        data_source_params=("", SDSParams(id=ds_id)),
        preparator_params=("", SPrepParams(id=8)),
        algorithm_params_list=(("algo", SAlgoParams(id=1, value=value)),))


SWEEPS = {"three_values": (3, 9, 5), "repeated_value": (4, 4, 2),
          "one_candidate": (2,)}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_and_memo_counts_equal_the_jax_package(sweep):
    from predictionio_tpu.core import Engine as JEngine
    values = SWEEPS[sweep]
    result = MetricEvaluator(ModelValue()).evaluate(
        RuntimeContext(device="cpu"), _engine(), [_ep(v) for v in values])
    JCounting.COUNTS.update(read=0, prepare=0, train=0)
    jengine = JEngine(data_source=JCounting.DS, preparator=JCounting.Prep,
                      algorithms={"algo": JCounting.Algo},
                      serving=se.SServing)
    jresult = JMetricEvaluator(JModelValue()).evaluate(
        JRuntimeContext(registry=JRegistry(dict(MEM))), jengine,
        [jep(("algo", se.SAlgoParams(id=1, value=v))) for v in values])
    assert result.best_index == jresult.best_index
    assert [r.score for r in result.all_results] == [
        r.score for r in jresult.all_results] == [float(v) for v in values]
    assert COUNTS == JCounting.COUNTS
    assert COUNTS["read"] == 1 and COUNTS["prepare"] == 2
    assert COUNTS["train"] == 2 * len(set(values))
    assert result.one_liner() == jresult.one_liner()
    assert json.loads(result.to_json()) == json.loads(jresult.to_json())
    assert result.to_html() == jresult.to_html()


def test_identical_params_are_fully_cached_and_timed():
    engine, cache = _engine(), _PrefixCache()
    ctx = RuntimeContext(device="cpu")
    first = _eval_with_cache(engine, ctx, _ep(7), cache)
    trains = COUNTS["train"]
    again = _eval_with_cache(engine, ctx, _ep(7), cache, candidate=1)
    assert COUNTS["train"] == trains and again == first
    folds = cache.timings["folds"]
    assert [(f["candidate"], f["fold"], f["queries"]) for f in folds] == [
        (0, 0, 3), (0, 1, 3), (1, 0, 3), (1, 1, 3)]
    assert all(f["prepare_s"] == 0.0 for f in folds[2:])


def test_output_path_and_engine_eval(tmp_path):
    out = tmp_path / "result.json"
    MetricEvaluator(ModelValue(), output_path=str(out)).evaluate(
        RuntimeContext(device="cpu"), _engine(), [_ep(2)])
    assert json.loads(out.read_text())["bestScore"] == 2.0
    folds = _engine().eval(RuntimeContext(device="cpu"), _ep(5, ds_id=3))
    assert [info for info, _ in folds] == ["ei0", "ei1"]
    assert [(q.q, p["q"], p["model"]["pd"], a) for q, p, a in folds[1][1]] \
        == [(10 + i, 10 + i, (8, (4,)), 10 + i) for i in range(3)]


def test_run_evaluation_lifecycle():
    registry = StorageRegistry(dict(MEM))
    evaluation = Evaluation(
        engine=_engine(), metric=ModelValue(), other_metrics=[ZeroMetric()],
        engine_params_generator=EngineParamsGenerator([_ep(2), _ep(8)]))
    row, result = run_evaluation(
        evaluation, RuntimeContext(registry=registry, device="cpu"),
        evaluation_class="TestEval")
    assert row.status == EvaluationInstanceStatus.COMPLETED
    assert result.best_score.score == 8.0 and result.best_index == 1
    assert "8.0" in row.evaluator_results_json
    assert "<table>" in row.evaluator_results_html
    stored = registry.get_meta_data_evaluation_instances()
    assert stored.get_completed()[0].id == row.id
    assert len(row.runtime_conf["phase_timings"]["folds"]) == 4
    assert "peak_device_bytes" not in row.runtime_conf   # no card
    with pytest.raises(ValueError, match="No engine params"):
        run_evaluation(Evaluation(engine=_engine(), metric=ModelValue()),
                       RuntimeContext(registry=registry, device="cpu"))
    failed = [i for i in stored.get_all() if i.id != row.id]
    assert [i.status for i in failed] == [EvaluationInstanceStatus.RUNNING]


# -- evaluation instances in a shared SQLITE store -------------------------------

def _sqlite(tmp_path):
    return {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db")}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_evaluation_instances_round_trip_a_shared_sqlite_store(tmp_path,
                                                               writer):
    from datetime import datetime, timezone
    fields = dict(
        status="EVALCOMPLETED",
        start_time=datetime(2021, 5, 1, 12, 0, 0, 123000, timezone.utc),
        end_time=datetime(2021, 5, 1, 12, 3, 0, 456000, timezone.utc),
        evaluation_class="my.Eval", engine_params_generator_class="my.Gen",
        batch="b1", env={"K": "v"}, runtime_conf={"phase_timings": {
            "read_s": 1.5}}, evaluator_results="[0.5] P@K",
        evaluator_results_html="<table></table>",
        evaluator_results_json='{"bestScore": 0.5}')
    mine = StorageRegistry(_sqlite(tmp_path))
    theirs = JRegistry(_sqlite(tmp_path))
    src, dst = (mine, theirs) if writer == "port" else (theirs, mine)
    cls = EvaluationInstance if writer == "port" else JEvaluationInstance
    dao = src.get_meta_data_evaluation_instances()
    iid = dao.insert(cls(**fields))
    dao.insert(cls(**{**fields, "status": "EVALRUNNING"}))
    got = dst.get_meta_data_evaluation_instances().get(iid)
    assert {k: getattr(got, k) for k in fields} == fields
    assert [i.id for i in dst.get_meta_data_evaluation_instances()
            .get_completed()] == [iid]
    dao.update(dao.get(iid).with_(status="EVALRUNNING"))
    assert dst.get_meta_data_evaluation_instances().get_completed() == []
    dst.get_meta_data_evaluation_instances().delete(iid)
    assert dao.get(iid) is None
    mine.close()
    theirs.close()


# -- the recommendation template's eval half --------------------------------------

def _rate(pkg, u, i, r):
    """A rating stamped by its (user, item), so that both stores hold
    the same event times."""
    from datetime import datetime, timedelta, timezone
    E, D = (Event, DataMap) if pkg == "port" else (JEvent, JDataMap)
    return E(event="rate", entity_type="user", entity_id=f"u{u}",
             target_entity_type="item", target_entity_id=f"i{i}",
             properties=D({"rating": r}), event_time=datetime(
                 2021, 1, 1, tzinfo=timezone.utc) + timedelta(
                     seconds=1000 * u + i))


def _eval_store(pkg, n_users=25, n_items=20, seed=0):
    """tests/test_evaluation.py's block-structured ratings, in one
    package's MEM store."""
    reg = (StorageRegistry if pkg == "port" else JRegistry)(dict(MEM))
    app_id = reg.get_meta_data_apps().insert(
        (App if pkg == "port" else JApp)(0, "evalapp"))
    events = reg.get_events()
    events.init(app_id)
    rng = np.random.RandomState(seed)
    for u in range(n_users):
        for i in range(n_items):
            if rng.rand() > 0.8:
                continue
            events.insert(_rate(pkg, u, i, 5.0 if i % 4 == u % 4 else 1.0),
                          app_id)
    return reg


def _ds(pkg, k_fold=2, query_num=5):
    m = rec if pkg == "port" else jrec
    return ("", m.DataSourceParams(app_name="evalapp", eval_params=(
        m.EvalParams(k_fold=k_fold, query_num=query_num))))


@pytest.mark.parametrize("k_fold,seed", [(2, 0), (3, 1), (5, 2)])
def test_read_eval_equals_the_jax_read_eval(k_fold, seed):
    ours = rec.RecommendationDataSource(_ds("port", k_fold)[1]).read_eval(
        RuntimeContext(registry=_eval_store("port", seed=seed),
                       device="cpu"))
    theirs = jrec.RecommendationDataSource(_ds("jax", k_fold)[1]).read_eval(
        JRuntimeContext(registry=_eval_store("jax", seed=seed)))
    assert len(ours) == len(theirs) == k_fold
    for (td, info, qa), (jtd, jinfo, jqa) in zip(ours, theirs):
        assert info == jinfo
        for col in ("user_ix", "item_ix", "rating", "t_millis"):
            np.testing.assert_array_equal(getattr(td, col),
                                          getattr(jtd, col))
        assert td.users.to_dict() == jtd.users.to_dict()
        assert td.items.to_dict() == jtd.items.to_dict()
        assert [(q.user, q.num, tuple(a.ratings)) for q, a in qa] == [
            (q.user, q.num, tuple(a.ratings)) for q, a in jqa]


def test_read_eval_needs_eval_params():
    ds = rec.RecommendationDataSource(rec.DataSourceParams(
        app_name="evalapp"))
    with pytest.raises(ValueError, match="eval_params"):
        ds.read_eval(RuntimeContext(registry=_eval_store("port"),
                                    device="cpu"))


def _candidates(pkg):
    m = rec if pkg == "port" else jrec
    cls = EngineParams if pkg == "port" else JEngineParams
    return [cls(data_source_params=_ds(pkg), algorithm_params_list=(
        ("als", m.ALSAlgorithmParams(rank=r, num_iterations=5, lambda_=0.1,
                                     seed=1)),)) for r in (2, 4)]


def test_precision_at_k_sweep_equals_the_jax_sweep(monkeypatch):
    """Both packages start from the JAX package's initial factors (the
    port draws splitmix64 normals, the JAX package threefry ones)."""
    monkeypatch.setattr(pals, "init_factors", jals.init_factors)
    metric, jmetric = (rec.PrecisionAtK(k=5, rating_threshold=4.0),
                       jrec.PrecisionAtK(k=5, rating_threshold=4.0))
    ctx = RuntimeContext(registry=_eval_store("port"), device="cpu")
    jctx = JRuntimeContext(registry=_eval_store("jax"))
    cache, jcache = _PrefixCache(), jev._PrefixCache()
    scores = []
    for ep, jep_ in zip(_candidates("port"), _candidates("jax")):
        data = _eval_with_cache(rec.RecommendationEngine.apply(), ctx, ep,
                                cache)
        jdata = jev._eval_with_cache(jrec.engine(), jctx, jep_, jcache)
        flips = [(info, q.user) for (info, qpa), (_, jqpa)
                 in zip(data, jdata) for (q, p, a), (_, jp, _) in
                 zip(qpa, jqpa)
                 if metric.calculate_one(q, p, a)
                 != jmetric.calculate_one(q, jp, a)]
        assert not flips, f"a top-k tie flipped a hit for {flips}"
        score = metric.calculate(ctx, data)
        assert abs(score - jmetric.calculate(jctx, jdata)) <= 1e-6
        scores.append(score)
    result = MetricEvaluator(metric).evaluate(
        ctx, rec.RecommendationEngine.apply(), _candidates("port"))
    assert [r.score for r in result.all_results] == scores
    assert max(scores) > 0.2      # the block structure is recovered


def test_precision_metric_semantics():
    m = rec.PrecisionAtK(k=2, rating_threshold=4.0)
    q = rec.Query(user="u", num=2)
    p = rec.PredictedResult((rec.ItemScore("a", 1.0),
                             rec.ItemScore("b", 0.5)))
    assert m.calculate_one(q, p, rec.ActualResult(
        (("a", 5.0), ("c", 5.0)))) == 0.5
    assert m.calculate_one(q, p, rec.ActualResult((("a", 1.0),))) is None
    assert m.calculate_one(q, rec.PredictedResult(()), rec.ActualResult(
        (("a", 5.0),))) == 0.0
    assert m.header() == jrec.PrecisionAtK(k=2, rating_threshold=4.0
                                           ).header()


EVAL_MODULE = '''
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.models import recommendation as rec

DS = ("", rec.DataSourceParams(app_name="evalapp", eval_params=(
    rec.EvalParams(k_fold=2, query_num=5))))


def _ep(rank):
    return EngineParams(data_source_params=DS, algorithm_params_list=(
        ("als", rec.ALSAlgorithmParams(rank=rank, num_iterations=4,
                                       lambda_=0.1, seed=1)),))


MyEvaluation = Evaluation(engine=rec.RecommendationEngine.apply(),
                          metric=rec.PrecisionAtK(k=5, rating_threshold=4.0),
                          engine_params_generator=EngineParamsGenerator(
                              [_ep(2)]))
MyGenerator = EngineParamsGenerator([_ep(2), _ep(3)])
'''


def test_cli_eval_records_a_completed_instance(tmp_path):
    reg = StorageRegistry(_sqlite(tmp_path))
    app_id = reg.get_meta_data_apps().insert(App(0, "evalapp"))
    rng = np.random.RandomState(0)
    reg.get_events().insert_batch(
        [_rate("port", u, i, 5.0 if i % 4 == u % 4 else 1.0)
         for u in range(12) for i in range(10) if rng.rand() < 0.8], app_id)
    reg.close()
    (tmp_path / "my_eval.py").write_text(EVAL_MODULE)
    env = {**os.environ, "PYTHONPATH": str(REPO), **_sqlite(tmp_path)}
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "eval",
         "my_eval.MyEvaluation", "my_eval.MyGenerator", "--output-path",
         "result.json", "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    printed = json.loads(out.stdout)
    assert set(printed) == {"evaluationInstanceId", "result", "bestScore"}
    result = json.loads((tmp_path / "result.json").read_text())
    assert len(result["results"]) == 2
    assert printed["bestScore"] == result["bestScore"]
    jreg = JRegistry(_sqlite(tmp_path))
    row = jreg.get_meta_data_evaluation_instances().get(
        printed["evaluationInstanceId"])
    jreg.close()
    assert row.status == "EVALCOMPLETED"
    assert row.evaluation_class == "my_eval.MyEvaluation"
    assert row.evaluator_results == printed["result"]
    assert len(row.runtime_conf["phase_timings"]["folds"]) == 4
