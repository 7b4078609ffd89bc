"""The port's classification template (`predictionio_tpu_torch.models.
classification`, with `ops.naive_bayes`, `ops.logreg` and
`ingest.arrays.LabeledPoints`) against the JAX package's, on the CPU.

Tolerances: labeled points equal exactly; NB's pi and theta within 1e-6
of the JAX fit at each upload dtype (the class sums are exact, only the
logs may differ in an ulp), predictions equal, probabilities within
1e-6; logistic regression's logits within LOGREG_TOL times the largest
|logit| of optax's (fp32 summation order through 150-300 Adam steps),
predictions equal. The template runs through `run_train`,
`prepare_deploy` and `MetricEvaluator` on the JAX fixture's 120 users in
both packages' MEM stores: NB and logistic regression answer as the JAX
template's, NB's k-fold accuracy equals the JAX one, and the forest (the
port's own draws, by design not threefry's) holds the JAX tests' bars.
The forest op itself is held in `tests/test_torch_forest.py`."""

import numpy as np
import pytest
import torch

from predictionio_tpu.core import CoreWorkflow as JWorkflow
from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.core import MetricEvaluator as JMetricEvaluator
from predictionio_tpu.core import RuntimeContext as JContext
from predictionio_tpu.core import persistence as jpers
from predictionio_tpu.core import resolve_engine as jresolve
from predictionio_tpu.data import event as jev
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.ingest import arrays as jarrays
from predictionio_tpu.models import classification as jclf
from predictionio_tpu.ops import forest as jfo
from predictionio_tpu.ops import logreg as jlr
from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu_torch.core import persistence as pers
from predictionio_tpu_torch.core.evaluation import MetricEvaluator
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.ingest import arrays as parrays
from predictionio_tpu_torch.models import classification as clf
from predictionio_tpu_torch.ops import logreg as plr
from predictionio_tpu_torch.ops import naive_bayes as pnb

pytestmark = pytest.mark.torch

LOGREG_TOL = 1e-4
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


def _props(mod, numeric: bool):
    """entityId -> PropertyMap of `mod` (either package's event module):
    four complete users, one missing attr1, one with a text attr0, one
    without a label; the plans as names or (`numeric`) as numbers."""
    code = {"basic": 0.0, "pro": 1.0, "gold": 2.0}
    rows = {"u0": {"attr0": 1, "attr1": 2, "attr2": 3, "plan": "basic"},
            "u1": {"attr0": 0, "attr1": 5.5, "attr2": 1, "plan": "pro"},
            "u2": {"attr0": 4, "attr2": 1, "plan": "pro"},
            "u3": {"attr0": "x", "attr1": 1, "attr2": 1, "plan": "basic"},
            "u4": {"attr0": 2, "attr1": 2, "attr2": 2},
            "u5": {"attr0": 7, "attr1": 0, "attr2": 9, "plan": "gold"},
            "u6": {"attr0": 3, "attr1": 3, "attr2": 0, "plan": "basic"}}
    t = jev.utcnow()
    return {k: mod.PropertyMap(mod.DataMap(
        {a: (code[v] if a == "plan" and numeric else v)
         for a, v in r.items()}), t, t) for k, r in rows.items()}


@pytest.mark.parametrize("label_map", [None, {"basic": 0.0, "pro": 1.0}])
def test_labeled_points_match_the_jax_ones(label_map):
    """Entities missing an attribute, with a value that is no number, or
    (with `label_map`) with a label the map lacks, are skipped alike."""
    kw = dict(feature_attrs=["attr0", "attr1", "attr2"], label_attr="plan",
              label_map=label_map)
    numeric = label_map is None
    want = jarrays.labeled_points_from_properties(_props(jev, numeric),
                                                  **kw)
    got = parrays.labeled_points_from_properties(_props(pev, numeric), **kw)
    assert got.n == want.n == (4 if numeric else 3)
    assert got.features.dtype == want.features.dtype == np.float32
    assert np.array_equal(got.features, want.features)
    assert np.array_equal(got.label, want.label)
    assert list(got.entities.keys()) == list(want.entities.keys())
    empty = parrays.labeled_points_from_properties({}, **kw)
    assert empty.features.shape == (0, 3) and empty.n == 0


def _nb_data(kind):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 5, (200, 3)).astype(np.float32)
    y = (x[:, 0] > 2).astype(np.float32) + (x[:, 2] > 3)
    if kind == "uint16":
        x *= 300
    elif kind == "float32":
        x *= 0.37
    return x, y


@pytest.mark.parametrize("kind", ["uint8", "uint16", "float32"])
def test_naive_bayes_matches_the_jax_fit_at_each_upload_dtype(kind):
    x, y = _nb_data(kind)
    assert pnb.narrow_features(x).dtype == np.dtype(kind)
    jm = jnb.nb_train(x, y, 1.0)
    tm = {}
    pm = pnb.nb_train(x, y, 1.0, device="cpu", timings=tm)
    assert set(tm) == {"transfer_s", "solve_s"}
    assert np.array_equal(pm.labels, jm.labels)
    np.testing.assert_allclose(pm.pi, jm.pi, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pm.theta, jm.theta, rtol=0, atol=1e-6)
    pm.sanity_check()
    assert np.array_equal(pnb.nb_predict(pm, x), jnb.nb_predict(jm, x))
    proba = pnb.nb_predict_proba(pm, x)
    np.testing.assert_allclose(proba, jnb.nb_predict_proba(jm, x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(proba.sum(1), 1.0, rtol=1e-5)


def test_naive_bayes_refuses_what_the_jax_one_refuses():
    with pytest.raises(ValueError, match="nonnegative"):
        pnb.nb_train(np.array([[-1.0]]), np.array([0.0]), device="cpu")
    with pytest.raises(ValueError, match="no training points"):
        pnb.nb_train(np.zeros((0, 2)), np.zeros(0), device="cpu")
    assert pnb._integer_valued(np.array([[1.0, 2.0]])) and \
        not pnb._integer_valued(np.array([[1.5]]))


def _logreg_cases():
    """The JAX tests' three data sets (tests/test_classification.py)."""
    rng = np.random.RandomState(0)
    x = rng.randn(300, 2).astype(np.float32)
    yield x, (x[:, 0] + 2 * x[:, 1] > 0).astype(np.float32), 300
    rng = np.random.RandomState(3)
    centers = np.array([[0, 5], [5, 0], [-5, -5]], np.float32)
    y = rng.randint(0, 3, 300)
    x = centers[y] + rng.randn(300, 2).astype(np.float32)
    yield x, np.array([10.0, 20.0, 30.0])[y], 300
    rng = np.random.RandomState(1)
    x = rng.randn(205, 6).astype(np.float32)
    yield x, (x[:, 0] + x[:, 1] > 0).astype(np.float32), 50


@pytest.mark.parametrize("case", range(3))
def test_logistic_regression_matches_optax(case):
    x, y, steps = list(_logreg_cases())[case]
    jm = jlr.logreg_train(x, y, steps=steps)
    pm = plr.logreg_train(x, y, steps=steps, device="cpu")
    want, got = x @ jm.w + jm.b, x @ pm.w + pm.b
    np.testing.assert_allclose(
        got, want, rtol=0, atol=LOGREG_TOL * max(1.0, np.abs(want).max()))
    assert np.array_equal(pm.labels, jm.labels)
    assert np.array_equal(plr.logreg_predict(pm, x),
                          jlr.logreg_predict(jm, x))
    assert (plr.logreg_predict(pm, x) == y).mean() > 0.95


def _fixture_events(mod):
    """The JAX test fixture's 120 users (tests/test_classification.py:
    87-103): plan 0 has attr0 high, plan 1 attr2 high."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(120):
        plan = i % 2
        a0 = rng.poisson(7) if plan == 0 else rng.poisson(1)
        a2 = rng.poisson(7) if plan == 1 else rng.poisson(1)
        out.append(mod.Event(
            event="$set", entity_type="user", entity_id=f"u{i}",
            properties=mod.DataMap({"attr0": int(a0),
                                    "attr1": int(rng.poisson(2)),
                                    "attr2": int(a2),
                                    "plan": float(plan)})))
    return out


@pytest.fixture()
def stores():
    jreg = JRegistry(MEM)
    japp = jreg.get_meta_data_apps().insert(JApp(0, "clfapp"))
    preg = StorageRegistry(MEM)
    papp = preg.get_meta_data_apps().insert(App(0, "clfapp"))
    for reg, app, mod in ((jreg, japp, jev), (preg, papp, pev)):
        reg.get_events().init(app)
        for e in _fixture_events(mod):
            reg.get_events().insert(e, app)
    return (JContext(registry=jreg),
            RuntimeContext(registry=preg, device="cpu"))


def _queries():
    rng = np.random.RandomState(11)
    qs = [dict(attr0=8.0, attr1=2.0, attr2=0.0),
          dict(attr0=0.0, attr1=2.0, attr2=8.0)]
    qs += [dict(attr0=float(a), attr1=float(b), attr2=float(c))
           for a, b, c in rng.poisson(3, (40, 3))]
    return qs


def test_template_answers_as_the_jax_template(stores):
    """run_train -> prepare_deploy in both packages: NB and logistic
    regression answer every query as the JAX algorithms do; the forest
    (8 trees, its own draws) gets the JAX test's two queries right; the
    models round-trip through the port's blob."""
    jctx, pctx = stores
    algos = (("naive", dict(lambda_=1.0)), ("logreg", dict(steps=150)),
             ("forest", dict(num_trees=8, max_depth=4)))
    jparams = JEngineParams(
        data_source_params=("", jclf.DataSourceParams(app_name="clfapp")),
        algorithm_params_list=tuple(
            (n, {"naive": jclf.NaiveBayesParams,
                 "logreg": jclf.LogisticRegressionParams,
                 "forest": jclf.RandomForestParams}[n](**p))
            for n, p in algos[:2]))
    jengine = jresolve("classification")
    jrow = JWorkflow.run_train(jengine, jparams, jctx)
    jalgos, jmodels, _ = JWorkflow.prepare_deploy(jengine, jrow, jctx)
    engine = resolve_engine("classification")
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "clfapp"}},
        "algorithms": [{"name": n, "params": p} for n, p in algos]})
    row = CoreWorkflow.run_train(engine, params, pctx)
    assert row.status == "COMPLETED"
    tm = row.runtime_conf["phase_timings"]
    assert {"transfer_s", "solve_s", "bin_s", "device_s"} <= set(tm)
    palgos, pmodels, serving = CoreWorkflow.prepare_deploy(
        engine, row, pctx, warm_batch_max=64)
    assert [m.device for m in pmodels] == ["cpu"] * 3
    assert [type(m) for m in pmodels] == [pnb.NaiveBayesModel,
                                          plr.LogRegModel,
                                          clf.forest_ops.ForestModel]
    qs = _queries()
    for name, ja, jm, pa, pm in zip(("naive", "logreg"), jalgos, jmodels,
                                    palgos, pmodels):
        want = [ja.predict(jm, jclf.Query(**q)).label for q in qs]
        got = [p.label for _, p in pa.batch_predict(
            pm, [(i, clf.Query(**q)) for i, q in enumerate(qs)])]
        assert got == want, name
        assert [pa.predict(pm, clf.Query(**q)).label for q in qs] == got
    forest = palgos[2]
    assert forest.predict(pmodels[2], clf.Query(**qs[0])).label == 0.0
    assert forest.predict(pmodels[2], clf.Query(**qs[1])).label == 1.0
    first = serving.serve(qs[0], [forest.predict(pmodels[2],
                                                 clf.Query(**qs[0]))])
    assert first == clf.PredictedResult(0.0)


def test_eval_accuracy_matches_the_jax_eval(stores):
    """k = 3 folds: NB's accuracy equals the JAX evaluation's (one
    model, one split); the forest's is at least NB's - 0.05, the JAX
    tests' parity bar."""
    jctx, pctx = stores
    jp = JEngineParams(
        data_source_params=("", jclf.DataSourceParams(app_name="clfapp",
                                                      eval_k=3)),
        algorithm_params_list=(("naive", jclf.NaiveBayesParams()),))
    jscore = JMetricEvaluator(jclf.Accuracy()).evaluate(
        jctx, jresolve("classification"), [jp]).best_score.score
    engine = resolve_engine("classification")
    ds = ("", clf.DataSourceParams(app_name="clfapp", eval_k=3))
    nb = EngineParams(data_source_params=ds, algorithm_params_list=(
        ("naive", clf.NaiveBayesParams()),))
    rf = EngineParams(data_source_params=ds, algorithm_params_list=(
        ("forest", clf.RandomForestParams(num_trees=8, max_depth=4)),))
    result = MetricEvaluator(clf.Accuracy()).evaluate(pctx, engine, [nb, rf])
    nb_score, rf_score = (r.score for r in result.all_results)
    assert nb_score == jscore and nb_score > 0.85
    assert rf_score > nb_score - 0.05, (rf_score, nb_score)
    with pytest.raises(ValueError, match="eval_k"):
        clf.ClassificationDataSource(clf.DataSourceParams(
            app_name="clfapp")).read_eval(pctx)


def test_custom_attrs_missing_data_and_query_vector():
    reg = StorageRegistry(MEM)
    app = reg.get_meta_data_apps().insert(App(0, "custom"))
    reg.get_meta_data_apps().insert(App(0, "emptyclf"))
    reg.get_events().init(app)
    for i in range(20):
        reg.get_events().insert(pev.Event(
            event="$set", entity_type="point", entity_id=f"p{i}",
            properties=pev.DataMap({"fa": i % 4, "fb": (i + 1) % 4,
                                    "cls": float(i % 2)})), app)
    ctx = RuntimeContext(registry=reg, device="cpu")
    lp = clf.ClassificationDataSource(clf.DataSourceParams(
        app_name="custom", entity_type="point", attrs=("fa", "fb"),
        label="cls")).read_training(ctx)
    assert lp.features.shape == (20, 2)
    assert np.array_equal(lp.features[:, 0], np.arange(20) % 4)
    with pytest.raises(ValueError, match="No 'user' entities"):
        clf.ClassificationDataSource(clf.DataSourceParams(
            app_name="emptyclf")).read_training(ctx)
    with pytest.raises(ValueError, match="attr0..attr2"):
        clf.Query(attr0=1.0).vector()
    assert clf.Query(features=(1, 2)).vector() == [1.0, 2.0]
    assert clf.Query(attr0=1, attr1=2, attr2=3).vector() == [1.0, 2.0, 3.0]
    assert clf.Accuracy().calculate_one(
        None, clf.PredictedResult(1.0), clf.ActualResult(1.0)) == 1.0


def test_blobs_round_trip_and_refuse_the_jax_models():
    """The three models through the port's blob and restricted
    unpickler; the JAX package's classification models are refused."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 5, (60, 3)).astype(np.float32)
    y = (x[:, 0] > 2).astype(np.float32)
    models = [pnb.nb_train(x, y, device="cpu"),
              plr.logreg_train(x, y, steps=5, device="cpu"),
              clf.forest_ops.forest_train(x, y, n_trees=2, max_depth=2,
                                          device="cpu")]
    algos = [clf.NaiveBayesAlgorithm(), clf.LogisticRegressionAlgorithm(),
             clf.RandomForestAlgorithm()]
    blob = pers.serialize_models("iid", algos, models, None)
    back = pers.deserialize_models(blob, "iid", algos, None, None)
    for m, b in zip(models, back):
        assert type(b) is type(m) and b.device == "cpu"
        for k, v in vars(m).items():
            assert np.array_equal(getattr(b, k), v), k
    jmodels = [jnb.NaiveBayesModel(models[0].pi, models[0].theta,
                                   models[0].labels),
               jlr.LogRegModel(models[1].w, models[1].b, models[1].labels),
               jfo.ForestModel(models[2].bin_edges, models[2].split_feature,
                               models[2].split_bin, models[2].leaf_class,
                               models[2].classes, models[2].max_depth)]
    for jm in jmodels:
        jblob = jpers.serialize_models("iid", [object()], [jm], None)
        with pytest.raises(pers.ForeignModelError, match="JAX package"):
            pers.deserialize_models(jblob, "iid", [object()], None, None)


def test_entry_points_refuse_to_carry_on_on_the_cpu(monkeypatch):
    """Without CUDA, training and predicting on the default device raise;
    `device="cpu"` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = np.ones((4, 2), np.float32), np.array([0.0, 1.0, 0.0, 1.0])
    for train in (pnb.nb_train, plr.logreg_train):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(x, y)
    nb = pnb.nb_train(x, y, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nb.to()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pnb.nb_predict(pnb.NaiveBayesModel(nb.pi, nb.theta, nb.labels), x)
    lr = plr.logreg_train(x, y, steps=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plr.logreg_predict(plr.LogRegModel(lr.w, lr.b, lr.labels), x)
    lp = parrays.LabeledPoints(x, y.astype(np.float32),
                               parrays.BiMap.from_keys("abcd"))
    for algo in (clf.NaiveBayesAlgorithm(), clf.RandomForestAlgorithm(),
                 clf.LogisticRegressionAlgorithm()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            algo.train(RuntimeContext(registry=None), lp)
