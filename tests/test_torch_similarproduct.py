"""The port's similar-product template (`predictionio_tpu_torch.models.
similarproduct`, the multi-events-multi-algos engine) against the JAX
package's, on the CPU.

The same events (explicit, increasing times) go into both packages' MEM
stores. The 5 engine cases of `tests/test_similarproduct.py` run on the
port (its 3 cooccurrence-op cases are in `tests/test_torch_cooccur.py`):
each case's own assertion holds, and every answer equals the JAX
template's on the port-trained models: item lists equal, scores to
rtol 1e-5 / atol 1e-6 (fp32 summation order of the cosine products);
cooccurrence answers exactly (host numpy on equal counts). Training is
held against the JAX template from the JAX package's init at rank 6
(the exact path): factors within 1e-3, the cooccurrence lists equal.
Then the multi-algorithm average (`ScoreAverageServing`), the warmed
cosine plan against the unwarmed path, and the three folds (views, likes
with the latest of a pair winning, the cooccurrence count merge)
against the JAX ones on one PEVLOG directory: factors within 1e-4, the
merged lists equal."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.core import CoreWorkflow as JWorkflow
from predictionio_tpu.core import RuntimeContext as JContext
from predictionio_tpu.core import resolve_engine as jresolve
from predictionio_tpu.data import event as jev
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.ingest.bimap import BiMap as JBiMap
from predictionio_tpu.models import similarproduct as jsp
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import cooccur as jco
from predictionio_tpu.streaming import scan_delta as jscan_delta
from predictionio_tpu.streaming.updaters import FoldContext as JFoldContext
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import (CoreWorkflow,
                                                  resolve_engine)
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.models import similarproduct as sp
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops.topk import BucketedSimilar
from predictionio_tpu_torch.streaming import scan_delta
from predictionio_tpu_torch.streaming.updaters import FoldContext

pytestmark = pytest.mark.torch

N_USERS, N_ITEMS = 24, 18
T0 = datetime(2023, 1, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
ALS = dict(rank=6, num_iterations=8, alpha=20.0, seed=1)
LIKE = dict(rank=6, num_iterations=6, alpha=20.0, seed=2)


def _seed_events(mod, t0=0):
    """The JAX test's fixture: categories by parity; each user views the
    items of its block (i % 3 == u % 3) and likes (4:1) or dislikes
    each of them."""
    rng = np.random.RandomState(0)
    clock = iter(range(t0 + 1, 10 ** 9))

    def at():
        return T0 + timedelta(seconds=next(clock))
    out = []
    for i in range(N_ITEMS):
        out.append(mod.Event(
            event="$set", entity_type="item", entity_id=f"i{i}",
            properties=mod.DataMap({"categories": [
                "even" if i % 2 == 0 else "odd"]}), event_time=at()))
    for u in range(N_USERS):
        for i in range(N_ITEMS):
            if i % 3 == u % 3 and rng.rand() < 0.9:
                out.append(_ev(mod, "view", f"u{u}", f"i{i}", at()))
                out.append(_ev(mod, "like" if rng.rand() < 0.8
                               else "dislike", f"u{u}", f"i{i}", at()))
    return out


def _ev(mod, name, user, item, t):
    return mod.Event(event=name, entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     event_time=t)


@pytest.fixture()
def stores():
    jreg = JRegistry(MEM)
    japp = jreg.get_meta_data_apps().insert(JApp(0, "spapp"))
    preg = StorageRegistry(MEM)
    papp = preg.get_meta_data_apps().insert(App(0, "spapp"))
    for reg, app, mod in ((jreg, japp, jev), (preg, papp, pev)):
        reg.get_events().init(app)
        reg.get_events().insert_batch(_seed_events(mod), app)
    return (JContext(registry=jreg),
            RuntimeContext(registry=preg, device="cpu"))


def _variant(*algos):
    return {"id": "default", "engineFactory": "similarproduct",
            "datasource": {"params": {"app_name": "spapp"}},
            "algorithms": [{"name": n, "params": p} for n, p in algos]}


def deploy(pctx, *algos, warm=None):
    engine = resolve_engine("similarproduct")
    row = CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(_variant(*algos)), pctx)
    assert row.status == "COMPLETED"
    return CoreWorkflow.prepare_deploy(engine, row, pctx,
                                       warm_batch_max=warm)


def jax_model(model):
    """A port model as the JAX template's model class."""
    if isinstance(model, sp.CoocModel):
        return jsp.CoocModel(jco.CooccurrenceModel(model.top.top_items,
                                                   model.top.top_counts),
                             JBiMap.from_keys(model.items.keys()),
                             model.item_categories)
    return jsp.SimilarModel(
        model.item_factors.numpy(), JBiMap.from_keys(model.items.keys()),
        model.item_categories, user_factors=model.user_factors.numpy(),
        users=JBiMap.from_keys(model.users.keys()))


JALGO = {sp.ALSAlgorithm: (jsp.ALSAlgorithm, jsp.ALSParams),
         sp.LikeAlgorithm: (jsp.LikeAlgorithm, jsp.ALSParams),
         sp.CooccurrenceAlgorithm: (jsp.CooccurrenceAlgorithm,
                                    jsp.CooccurrenceParams)}


def jax_algo(algo):
    cls, pcls = JALGO[type(algo)]
    return cls(pcls(**algo.params.__dict__))


def same(pres, jres):
    assert [s.item for s in pres.itemScores] == [
        s.item for s in jres.itemScores]
    np.testing.assert_allclose([s.score for s in pres.itemScores],
                               [s.score for s in jres.itemScores],
                               rtol=1e-5, atol=1e-6)


def predict_both(algo, model, query):
    pres = algo.predict(model, sp.Query(**query))
    same(pres, jax_algo(algo).predict(jax_model(model), jsp.Query(**query)))
    return pres


# -- the JAX package's engine cases ----------------------------------------------

def test_als_similarity_respects_blocks(stores):
    _, pctx = stores
    algos, models, serving = deploy(pctx, ("als", ALS))
    q = dict(items=["i0"], num=4)   # block 0
    res = serving.serve(sp.Query(**q),
                        [predict_both(algos[0], models[0], q)])
    assert len(res.itemScores) == 4
    assert "i0" not in [s.item for s in res.itemScores]
    assert np.mean([int(s.item[1:]) % 3 == 0
                    for s in res.itemScores]) >= 0.75, res.itemScores


def test_category_whitelist_blacklist(stores):
    _, pctx = stores
    algos, models, _ = deploy(pctx, ("als", dict(rank=6, num_iterations=6,
                                                 seed=1)))
    algo, model = algos[0], models[0]
    res = predict_both(algo, model, dict(items=["i0"], num=5,
                                         categories=["even"]))
    assert all(int(s.item[1:]) % 2 == 0 for s in res.itemScores)
    res = predict_both(algo, model, dict(items=["i0"], num=3,
                                         whiteList=["i3", "i6"]))
    assert {s.item for s in res.itemScores} <= {"i3", "i6"}
    res = predict_both(algo, model, dict(items=["i0"], num=5,
                                         blackList=["i3"]))
    assert "i3" not in [s.item for s in res.itemScores]


def test_unknown_query_items_empty(stores):
    _, pctx = stores
    algos, models, _ = deploy(pctx, ("als", dict(rank=4, num_iterations=3,
                                                 seed=1)))
    res = predict_both(algos[0], models[0], dict(items=["ghost"], num=3))
    assert res.itemScores == ()


def _multi(pctx, warm=None):
    return deploy(pctx, ("als", ALS), ("likealgo", LIKE),
                  ("cooccurrence", dict(n=10)), warm=warm)


MULTI_QUERIES = [dict(items=["i0", "i3"], num=5),
                 dict(items=["i1"], num=4, categories=["odd"]),
                 dict(items=["i2", "ghost"], num=6, blackList=["i5"]),
                 dict(items=["i4"], num=3, whiteList=["i7", "i10", "i13"]),
                 dict(items=["ghost"], num=3), dict(items=["i6"], num=30)]


def test_multi_algo_serving_averages(stores):
    _, pctx = stores
    algos, models, serving = _multi(pctx)
    jserving = jsp.ScoreAverageServing()
    for query in MULTI_QUERIES:
        q = sp.Query(**query)
        preds = [predict_both(a, m, query) for a, m in zip(algos, models)]
        res = serving.serve(q, preds)
        jpreds = [jax_algo(a).predict(jax_model(m), jsp.Query(**query))
                  for a, m in zip(algos, models)]
        same(res, jserving.serve(jsp.Query(**query), jpreds))
        assert len(res.itemScores) <= q.num
        scores = [s.score for s in res.itemScores]
        assert scores == sorted(scores, reverse=True)
        assert {s.item for s in res.itemScores} <= {
            s.item for p in preds for s in p.itemScores}
    q = sp.Query(items=["i0", "i3"], num=5)
    assert 0 < len(serving.serve(q, [a.predict(m, q) for a, m in zip(
        algos, models)]).itemScores) <= 5


def test_cooccurrence_predict(stores):
    _, pctx = stores
    algos, models, _ = deploy(pctx, ("cooccurrence", dict(n=10)))
    res = predict_both(algos[0], models[0], dict(items=["i0"], num=4))
    assert res.itemScores
    assert all(int(s.item[1:]) % 3 == 0 for s in res.itemScores)


# -- beyond them ----------------------------------------------------------------

def test_training_matches_the_jax_template(stores, monkeypatch):
    monkeypatch.setattr(pals, "init_factors", jals.init_factors)
    jctx, pctx = stores
    _, models, _ = _multi(pctx)
    jengine = jresolve("similarproduct")
    jrow = JWorkflow.run_train(jengine, jengine.engine_params_from_variant(
        _variant(("als", ALS), ("likealgo", LIKE),
                 ("cooccurrence", dict(n=10)))), jctx)
    _, jmodels, _ = JWorkflow.prepare_deploy(jengine, jrow, jctx)
    for m, jm in zip(models[:2], jmodels[:2]):
        assert m.items.keys() == jm.items.keys()
        assert m.users.keys() == jm.users.keys()
        np.testing.assert_allclose(m.item_factors.numpy(), jm.item_factors,
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(m.user_factors.numpy(), jm.user_factors,
                                   rtol=1e-3, atol=1e-3)
        assert m.item_categories == jm.item_categories
    assert np.array_equal(models[2].top.top_items, jmodels[2].top.top_items)
    assert np.array_equal(models[2].top.top_counts,
                          jmodels[2].top.top_counts)


def test_warmed_plans_answer_as_the_unwarmed_path(stores):
    """A deploy warms one `BucketedSimilar` per factor algorithm and none
    for the cooccurrence; batches through the plans equal the unwarmed
    `topk_similar` path, bit for bit."""
    _, pctx = stores
    algos, models, serving = _multi(pctx, warm=4)
    plans = [a._serve_plan for a in algos[:2]]
    assert all(isinstance(p, BucketedSimilar) for p in plans)
    assert [p.buckets for p in plans] == [(1, 2, 4)] * 2
    assert not hasattr(algos[2], "_serve_plan")
    queries = [(n, sp.Query(**q)) for n, q in enumerate(MULTI_QUERIES)]
    for algo, model, plan in zip(algos, models, plans):
        calls = plan.calls
        warm = dict(algo.batch_predict(model, queries[:5]))
        assert plan.calls == calls + 1    # 4 live queries: bucket 4
        # num 30 (k 18) is past the plan's k: the whole batch goes
        # through `topk_similar`, as in the JAX package
        past = dict(algo.batch_predict(model, queries))
        assert plan.calls == calls + 1
        algo._serve_plan = None
        assert dict(algo.batch_predict(model, queries[:5])) == warm
        assert dict(algo.batch_predict(model, queries)) == past


# -- the folds ------------------------------------------------------------------

def _pev_config(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    }


def test_three_folds_agree_with_the_jax_template(tmp_path):
    """One PEVLOG directory, the port-trained models, one drip: views of
    known users (a new pair, a repeat), a new user's views, a like that
    turns into a dislike. Each factor fold's rows agree with the JAX
    fold within 1e-4 and its untouched item rows stay bit for bit; the
    cooccurrence merge equals the JAX one exactly."""
    reg = StorageRegistry(_pev_config(tmp_path))
    app = reg.get_meta_data_apps().insert(App(0, "spapp"))
    events = reg.get_events()
    events.init(app)
    events.insert_batch(_seed_events(pev), app)
    ctx = RuntimeContext(registry=reg, device="cpu")
    engine = resolve_engine("similarproduct")
    params = engine.engine_params_from_variant(_variant(
        ("als", ALS), ("likealgo", LIKE), ("cooccurrence", dict(n=10))))
    ds, prep, algos, _ = engine.make_components(params)
    pd = prep.prepare(ctx, ds.read_training(ctx))
    models = [a.train(ctx, pd) for a in algos]
    wm1 = events.ingest_watermark(app)
    t = T0 + timedelta(days=1)
    drip = [_ev(pev, "view", "u0", "i1", t),
            _ev(pev, "view", "u0", "i3", t + timedelta(seconds=1)),
            _ev(pev, "view", "newbie", "i2", t + timedelta(seconds=2)),
            _ev(pev, "view", "newbie", "i5", t + timedelta(seconds=3)),
            _ev(pev, "like", "u1", "i1", t + timedelta(seconds=4)),
            _ev(pev, "dislike", "u1", "i1", t + timedelta(seconds=5))]
    events.insert_batch(drip, app)
    wm2 = events.ingest_watermark(app)
    delta = scan_delta(events, app, None, wm1, wm2)
    folded = [a.fold_in(m, delta, FoldContext(
        store=events, app_id=app, channel_id=None, since=wm1, upto=wm2))
        for a, m in zip(algos, models)]
    jreg = JRegistry(_pev_config(tmp_path))
    jevents = jreg.get_events()
    jdelta = jscan_delta(jevents, app, None, wm1, wm2)
    jfolded = [jax_algo(a).fold_in(jax_model(m), jdelta, JFoldContext(
        store=jevents, app_id=app, channel_id=None, since=wm1, upto=wm2))
        for a, m in zip(algos, models)]
    touched = {"als": {"i1", "i3", "i2", "i5"}, "like": {"i1"}}
    for (name, items), f, jf, m in zip(touched.items(), folded, jfolded,
                                       models):
        assert f.users.keys() == jf.users.keys(), name
        np.testing.assert_allclose(f.user_factors.numpy(), jf.user_factors,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f.item_factors.numpy(), jf.item_factors,
                                   rtol=1e-4, atol=1e-4)
        keep = [r for r in range(len(m.items))
                if m.items.inverse(r) not in items]
        assert torch.equal(f.item_factors[keep], m.item_factors[keep])
    assert "newbie" in folded[0].users.keys()
    assert np.array_equal(folded[2].top.top_items, jfolded[2].top.top_items)
    assert np.array_equal(folded[2].top.top_counts,
                          jfolded[2].top.top_counts)
    assert not np.array_equal(folded[2].top.top_counts,
                              models[2].top.top_counts)
    # a delta with no event of an algorithm folds nothing for it
    assert all(a.fold_in(m, None, FoldContext(
        store=events, app_id=app, channel_id=None, since=wm2, upto=wm2))
        is None for a, m in zip(algos, folded))
    jreg.close()
    reg.close()


def test_fold_without_user_factors_needs_a_rebuild():
    from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
    from predictionio_tpu_torch.ingest.bimap import BiMap
    model = sp.SimilarModel(torch.zeros((2, 3)), BiMap.from_keys(["a", "b"]),
                            {})
    with pytest.raises(DeltaInvalidated, match="full rebuild"):
        sp.ALSAlgorithm().fold_in(model, None, None)


# -- the model blobs --------------------------------------------------------------

def test_blobs_load_the_ports_classes_and_refuse_the_jax_templates(stores):
    """The restricted unpickler loads the port's `SimilarModel`,
    `CoocModel` and `CooccurrenceModel` (and, in the e-commerce tests,
    `ECommModel`), and refuses a blob of the JAX package's same
    templates with `ForeignModelError`."""
    from predictionio_tpu.core import persistence as jpers
    from predictionio_tpu.models import ecommerce as jec
    from predictionio_tpu_torch.core import persistence as pers
    _, pctx = stores
    algos, models, _ = _multi(pctx)
    back = pers.loads(pers.dumps(models))
    assert [type(m) for m in back] == [sp.SimilarModel, sp.SimilarModel,
                                       sp.CoocModel]
    assert isinstance(back[2].top, sp.CooccurrenceModel)
    assert torch.equal(back[0].item_factors, models[0].item_factors)
    assert np.array_equal(back[2].top.top_counts, models[2].top.top_counts)
    jmodels = [jax_model(m) for m in models]
    jmodels.append(jec.ECommModel(
        np.ones((2, 3), np.float32), np.ones((4, 3), np.float32),
        JBiMap.from_keys(["a", "b"]), JBiMap.from_keys(["w", "x", "y", "z"]),
        np.zeros(4, np.float32), {}))
    for jm in jmodels:
        blob = jpers.serialize_models("iid", [object()], [jm], None)
        with pytest.raises(pers.ForeignModelError, match="JAX package"):
            pers.deserialize_models(blob, "iid", [object()], None, None)
