"""The port's e-commerce template (`predictionio_tpu_torch.models.
ecommerce`) against the JAX package's, on the CPU.

The same events (explicit, increasing times) go into both packages' MEM
stores. The 6 cases of `tests/test_ecommerce.py` run on the port: each
case's own assertion holds, and every answer equals the JAX template's
on the port-trained factors (the JAX algorithm bound to the JAX store,
so its serving-time reads are its own): the same item lists, scores to
rtol 1e-5 / atol 1e-6 (fp32 summation order). Training itself is held
against the JAX template from the JAX package's init at rank 6 (the
exact path): factors within 1e-3, popularity equal. Then `batch_predict`
equals `predict` per query, the warmed plan path equals the generic
path, `fold_in` agrees with the JAX one on one PEVLOG directory (1e-4,
Cholesky; popularity equal), and `cli build/train/deploy` of an
e-commerce `engine.json` serves the model from a subprocess on the
CPU."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from datetime import datetime, timedelta, timezone
from pathlib import Path

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
from predictionio_tpu.models import ecommerce as jec
from predictionio_tpu.ops import als as jals
from predictionio_tpu.streaming import scan_delta as jscan_delta
from predictionio_tpu.streaming.updaters import FoldContext as JFoldContext
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import (CoreWorkflow,
                                                  resolve_engine)
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.models import ecommerce as ec
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops.topk import BucketedTopK
from predictionio_tpu_torch.streaming import scan_delta
from predictionio_tpu_torch.streaming.updaters import FoldContext

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 20, 15
T0 = datetime(2023, 1, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
ALGO = dict(app_name="ecapp", rank=6, num_iterations=8, alpha=20.0, seed=1)


class _Clock:
    """Increasing event times, one second apart, so that find order and
    the latest-first reads are the same in both stores."""

    def __init__(self, start=0):
        self.t = start

    def __call__(self):
        self.t += 1
        return T0 + timedelta(seconds=self.t)


def _seed_events(mod, clock):
    """The JAX test's fixture: categories by parity, views in each user's
    block (i % 3 == u % 3), i1 bought by 12 users."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_ITEMS):
        out.append(mod.Event(
            event="$set", entity_type="item", entity_id=f"i{i}",
            properties=mod.DataMap({"categories": [
                "even" if i % 2 == 0 else "odd"]}), event_time=clock()))
    for u in range(N_USERS):
        for i in range(N_ITEMS):
            if i % 3 == u % 3 and rng.rand() < 0.9:
                out.append(_view(mod, f"u{u}", f"i{i}", clock()))
    for u in range(12):
        out.append(mod.Event(
            event="buy", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id="i1",
            event_time=clock()))
    return out


def _view(mod, user, item, t):
    return mod.Event(event="view", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     event_time=t)


class _Stores:
    """The same events in a JAX and a port MEM store; `insert` writes an
    event to both."""

    def __init__(self):
        self.clock = _Clock()
        self.jreg = JRegistry(MEM)
        self.japp = self.jreg.get_meta_data_apps().insert(JApp(0, "ecapp"))
        self.preg = StorageRegistry(MEM)
        self.papp = self.preg.get_meta_data_apps().insert(App(0, "ecapp"))
        clock = _Clock()
        for reg, app, mod in ((self.jreg, self.japp, jev),
                              (self.preg, self.papp, pev)):
            reg.get_events().init(app)
            clock.t = 0
            reg.get_events().insert_batch(_seed_events(mod, clock), app)
        self.clock.t = clock.t
        self.jctx = JContext(registry=self.jreg)
        self.pctx = RuntimeContext(registry=self.preg, device="cpu")

    def insert(self, make):
        """`make(mod, time)` -> an Event of that package, into both."""
        t = self.clock()
        self.jreg.get_events().insert(make(jev, t), self.japp)
        self.preg.get_events().insert(make(pev, t), self.papp)


@pytest.fixture()
def stores():
    return _Stores()


def _variant(**algo):
    return {"id": "default", "engineFactory": "ecommerce",
            "datasource": {"params": {"app_name": "ecapp"}},
            "algorithms": [{"name": "ecomm", "params": {**ALGO, **algo}}]}


def train(st, warm=None, **algo):
    """The port template trained and deployed through the workflow on
    the CPU; returns (algorithm, model)."""
    engine = resolve_engine("ecommerce")
    params = engine.engine_params_from_variant(_variant(**algo))
    row = CoreWorkflow.run_train(engine, params, st.pctx)
    assert row.status == "COMPLETED"
    algos, models, _ = CoreWorkflow.prepare_deploy(
        engine, row, st.pctx, warm_batch_max=warm)
    return algos[0], models[0]


def jax_twin(st, model, **algo):
    """The JAX template on the port-trained model, reading the JAX store."""
    jmodel = jec.ECommModel(
        model.user_factors.numpy(), model.item_factors.numpy(),
        JBiMap.from_keys(model.users.keys()),
        JBiMap.from_keys(model.items.keys()), model.popularity.numpy(),
        model.item_categories)
    jalgo = jec.ECommAlgorithm(jec.ECommParams(**{**ALGO, **algo}))
    if st is not None:
        jalgo.with_serving_context(st.jctx)
    return jalgo, jmodel


def same(pres, jres):
    assert [s.item for s in pres.itemScores] == [
        s.item for s in jres.itemScores]
    np.testing.assert_allclose([s.score for s in pres.itemScores],
                               [s.score for s in jres.itemScores],
                               rtol=1e-5, atol=1e-6)


def both(st, algo, model, query, **params):
    jalgo, jmodel = jax_twin(st, model, **params)
    pres = algo.predict(model, ec.Query(**query))
    same(pres, jalgo.predict(jmodel, jec.Query(**query)))
    return pres


# -- the JAX package's cases ---------------------------------------------------

def test_known_user_unseen_filtering(stores):
    algo, model = train(stores)
    res = both(stores, algo, model, dict(user="u0", num=5))
    assert res.itemScores
    seen = {e.target_entity_id for e in stores.preg.get_events().find(
        stores.papp, entity_type="user", entity_id="u0",
        event_names=["view", "buy"])}
    assert not ({s.item for s in res.itemScores} & seen)


def test_seen_included_when_unseen_only_false(stores):
    algo, model = train(stores, unseen_only=False)
    res = both(stores, algo, model, dict(user="u0", num=5),
               unseen_only=False)
    block = [s for s in res.itemScores if int(s.item[1:]) % 3 == 0]
    assert len(block) >= 3, res.itemScores


def test_unavailable_constraint_event(stores):
    algo, model = train(stores, unseen_only=False)
    q = dict(user="u0", num=3)
    base = both(stores, algo, model, q, unseen_only=False)
    banned = base.itemScores[0].item

    def constraint(items):
        return lambda mod, t: mod.Event(
            event="$set", entity_type="constraint",
            entity_id="unavailableItems",
            properties=mod.DataMap({"items": items}), event_time=t)
    stores.insert(constraint([banned]))
    res = both(stores, algo, model, q, unseen_only=False)
    assert banned not in [s.item for s in res.itemScores]
    stores.insert(constraint([]))     # lifted by a newer $set
    res = both(stores, algo, model, q, unseen_only=False)
    assert banned in [s.item for s in res.itemScores]


def test_unknown_user_recent_similarity(stores):
    algo, model = train(stores)
    for it in ("i0", "i3"):
        stores.insert(lambda mod, t, it=it: _view(mod, "newbie", it, t))
    res = both(stores, algo, model, dict(user="newbie", num=4))
    assert res.itemScores
    assert np.mean([int(s.item[1:]) % 3 == 0
                    for s in res.itemScores]) >= 0.5, res.itemScores


def test_cold_user_popularity_fallback(stores):
    algo, model = train(stores)
    res = both(stores, algo, model, dict(user="total-stranger", num=3))
    assert res.itemScores and res.itemScores[0].item == "i1"


def test_category_filter(stores):
    algo, model = train(stores, unseen_only=False)
    res = both(stores, algo, model,
               dict(user="u0", num=5, categories=["even"]),
               unseen_only=False)
    assert res.itemScores
    assert all(int(s.item[1:]) % 2 == 0 for s in res.itemScores)


# -- beyond them ----------------------------------------------------------------

def test_training_matches_the_jax_template(stores, monkeypatch):
    """From the JAX package's init, the port's implicit ALS at rank 6 (the
    exact path) gives the JAX template's factors within 1e-3; the
    popularity, id maps and categories are equal, and the residual is
    in the phase report."""
    monkeypatch.setattr(pals, "init_factors", jals.init_factors)
    _, model = train(stores)
    jengine = jresolve("ecommerce")
    jrow = JWorkflow.run_train(jengine, jengine.engine_params_from_variant(
        _variant()), stores.jctx)
    _, (jmodel,), _ = JWorkflow.prepare_deploy(jengine, jrow, stores.jctx)
    assert model.users.keys() == jmodel.users.keys()
    assert model.items.keys() == jmodel.items.keys()
    np.testing.assert_allclose(model.user_factors.numpy(),
                               jmodel.user_factors, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(model.item_factors.numpy(),
                               jmodel.item_factors, rtol=1e-3, atol=1e-3)
    assert np.array_equal(model.popularity.numpy(), jmodel.popularity)
    assert model.item_categories == jmodel.item_categories
    assert stores.pctx.phase_timings["solver_residual"] == 0.0


QUERIES = [dict(user="u0", num=5), dict(user="u1", num=4, blackList=["i4"]),
           dict(user="u2", num=10, blackList=["i2", "i5", "nope"]),
           dict(user="u3", num=3, categories=["odd"]),
           dict(user="u4", num=4, whiteList=["i1", "i2", "i3", "i9"]),
           dict(user="total-stranger", num=3),
           dict(user="u5", num=20), dict(user="u6", num=2)]


@pytest.mark.parametrize("warm", [None, 8], ids=["generic", "plan"])
def test_batch_predict_equals_predict_and_jax(stores, warm):
    algo, model = train(stores, warm=warm)
    assert (algo._serve_plan is not None) == (warm is not None)
    queries = [(n, ec.Query(**q)) for n, q in enumerate(QUERIES)]
    batch = dict(algo.batch_predict(model, queries))
    jalgo, jmodel = jax_twin(stores, model)
    jbatch = dict(jalgo.batch_predict(
        jmodel, [(n, jec.Query(**q)) for n, q in enumerate(QUERIES)]))
    for n, q in queries:
        same(batch[n], algo.predict(model, q))
        same(batch[n], jbatch[n])
    paths = algo.serve_paths
    if warm:   # u0-u2, u5 (num 20 > the plan's k: generic), u6
        assert (paths["plan"], paths["generic"]) == (4, 1)
    else:
        assert (paths["plan"], paths["generic"]) == (0, 5)
    assert paths["store_reads"] > len(QUERIES)


def test_plan_path_equals_generic_path(stores):
    """Known-user batches through the warmed plan (the kernel's plain
    version on the CPU) equal the generic `topk_scores_filtered`, bit
    for bit; the plan's banned width covers the unavailable items."""
    stores.insert(lambda mod, t: mod.Event(
        event="$set", entity_type="constraint", entity_id="unavailableItems",
        properties=mod.DataMap({"items": [f"i{n}" for n in range(0, 15, 4)]}),
        event_time=t))
    algo, model = train(stores, warm=8)
    assert isinstance(algo._serve_plan, BucketedTopK)
    assert algo._serve_plan.banned_width == 256
    queries = [(n, ec.Query(user=f"u{n}", num=1 + n % 10,
                            blackList=[f"i{(n * 7) % 15}"]))
               for n in range(N_USERS)]
    calls = algo._serve_plan.calls
    via_plan = dict(algo.batch_predict(model, queries))
    assert algo._serve_plan.calls == calls + 3   # 20 queries: 8 + 8 + 4
    algo._serve_plan = None
    generic = dict(algo.batch_predict(model, queries))
    for n, _ in queries:
        assert via_plan[n] == generic[n]
        assert not {s.item for s in via_plan[n].itemScores} & {
            f"i{m}" for m in range(0, 15, 4)}


def test_bans_past_the_plan_go_generic_alone(stores, monkeypatch):
    """A query whose bans outgrow the plan's width goes through the
    generic path alone; the rest of its batch keeps the plan."""
    algo, model = train(stores, warm=8, unseen_only=False)
    monkeypatch.setattr(algo._serve_plan, "banned_width", 2)
    queries = [(0, ec.Query(user="u0", num=3, blackList=["i0", "i1", "i2"])),
               (1, ec.Query(user="u1", num=3, blackList=["i0"]))]
    out = dict(algo.batch_predict(model, queries))
    assert (algo.serve_paths["plan"], algo.serve_paths["generic"]) == (1, 1)
    jalgo, jmodel = jax_twin(stores, model, unseen_only=False)
    for n, q in queries:
        same(out[n], jalgo.predict(jmodel, jec.Query(**q.__dict__)))


def test_model_round_trip_and_devices(stores, monkeypatch):
    """The blob holds the port's classes (CPU tensors); deploy places
    them; without CUDA the default device raises."""
    algo, model = train(stores)
    assert model.device.type == "cpu" and model.popularity.dtype == \
        torch.float32
    instances = stores.preg.get_meta_data_engine_instances()
    inst = instances.get_latest_completed("default", "default", "default")
    back, = deserialize_models(
        stores.preg.get_model_data_models().get(inst.id).models, inst.id,
        [algo], stores.pctx, retrain=None)
    assert isinstance(back, ec.ECommModel)
    assert torch.equal(back.item_factors, model.item_factors)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        back.to()


def test_predict_needs_a_serving_context():
    with pytest.raises(RuntimeError, match="serving context"):
        ec.ECommAlgorithm().predict(None, ec.Query(user="u"))


# -- the fold -------------------------------------------------------------------

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


def test_fold_in_agrees_with_the_jax_template(tmp_path):
    """One PEVLOG directory, the port-trained model, one drip of views
    (new user, touched items) and buys (one of a never-viewed id): the
    touched rows of both folds agree within 1e-4, the untouched rows
    stay the trained ones bit for bit, the popularity is merged equal."""
    reg = StorageRegistry(_pev_config(tmp_path))
    app = reg.get_meta_data_apps().insert(App(0, "ecapp"))
    events = reg.get_events()
    events.init(app)
    clock = _Clock()
    events.insert_batch(_seed_events(pev, clock), app)
    ctx = RuntimeContext(registry=reg, device="cpu")
    engine = resolve_engine("ecommerce")
    params = engine.engine_params_from_variant(_variant())
    ds, prep, (algo,), _ = engine.make_components(params)
    model = algo.train(ctx, prep.prepare(ctx, ds.read_training(ctx)))
    wm1 = events.ingest_watermark(app)
    drip = [_view(pev, "u1", "i4", clock()), _view(pev, "u2", "i2", clock()),
            _view(pev, "newbie", "i3", clock()),
            pev.Event(event="buy", entity_type="user", entity_id="u3",
                      target_entity_type="item", target_entity_id="i7",
                      event_time=clock()),
            pev.Event(event="buy", entity_type="user", entity_id="u3",
                      target_entity_type="item", target_entity_id="ghost",
                      event_time=clock())]
    events.insert_batch(drip, app)
    wm2 = events.ingest_watermark(app)
    folded = algo.fold_in(model, scan_delta(events, app, None, wm1, wm2),
                          FoldContext(store=events, app_id=app,
                                      channel_id=None, since=wm1, upto=wm2))
    jreg = JRegistry(_pev_config(tmp_path))
    jevents = jreg.get_events()
    jalgo, jmodel = jax_twin(None, model)
    jfolded = jalgo.fold_in(jmodel, jscan_delta(jevents, app, None, wm1, wm2),
                            JFoldContext(store=jevents, app_id=app,
                                         channel_id=None, since=wm1,
                                         upto=wm2))
    assert folded.users.keys() == jfolded.users.keys()
    np.testing.assert_allclose(folded.user_factors.numpy(),
                               jfolded.user_factors, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(folded.item_factors.numpy(),
                               jfolded.item_factors, rtol=1e-4, atol=1e-4)
    assert np.array_equal(folded.popularity.numpy(), jfolded.popularity)
    assert folded.popularity[model.items.get("i7")] == \
        model.popularity[model.items.get("i7")] + 1
    touched_u = {model.users.get(u) for u in ("u1", "u2")}
    keep = [r for r in range(len(model.users)) if r not in touched_u]
    assert torch.equal(folded.user_factors[keep], model.user_factors[keep])
    touched_i = {model.items.get(i) for i in ("i4", "i2", "i3")}
    keep = [r for r in range(len(model.items)) if r not in touched_i]
    assert torch.equal(folded.item_factors[keep], model.item_factors[keep])
    # buys alone fold the popularity only; nothing at all folds nothing
    wm3 = events.ingest_watermark(app)
    events.insert(drip[3], app)
    wm4 = events.ingest_watermark(app)
    only_buy = algo.fold_in(folded, None, FoldContext(
        store=events, app_id=app, channel_id=None, since=wm3, upto=wm4))
    assert only_buy.user_factors is folded.user_factors
    assert algo.fold_in(folded, None, FoldContext(
        store=events, app_id=app, channel_id=None, since=wm4,
        upto=wm4)) is None
    jreg.close()
    reg.close()


# -- the command line -----------------------------------------------------------

def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_cli_build_train_deploy_serves_the_template(tmp_path):
    """`cli import`, `build`, `train --device cpu` and `deploy --device
    cpu` of an e-commerce engine.json in subprocesses over one sqlite
    file: the instance COMPLETED, its answers the JAX template's on the
    stored factors, the plan's calls on `GET /`."""
    env = {**os.environ, "PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db"),
           "PYTHONPATH": str(REPO)}
    with open(tmp_path / "events.jsonl", "w") as f:
        for e in _seed_events(pev, _Clock()):
            f.write(json.dumps(e.to_api_json()) + "\n")
        f.write(json.dumps(pev.Event(
            event="$set", entity_type="constraint",
            entity_id="unavailableItems",
            properties=pev.DataMap({"items": ["i5"]}),
            event_time=T0 + timedelta(days=1)).to_api_json()) + "\n")
    (tmp_path / "engine.json").write_text(json.dumps(_variant()))

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout)

    app = cli("app", "new", "ecapp")
    cli("import", "--appid", str(app["id"]), "--input", "events.jsonl")
    assert cli("build")["engineFactory"] == "ecommerce"
    report = cli("train", "--device", "cpu")
    assert report["status"] == "COMPLETED"
    assert report["phaseTimings"]["solver_residual"] == 0.0
    registry = StorageRegistry(env)
    iid = report["engineInstanceId"]
    model, = deserialize_models(
        registry.get_model_data_models().get(iid).models, iid, [None],
        None, retrain=None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--port", "0", "--device", "cpu", "--batch-max", "4"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    queries = [dict(user="u3", num=4, blackList=["i0"]),
               dict(user="stranger", num=2),
               dict(user="u1", num=3, categories=["even"])]
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving engine instance {iid} "), \
            proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        answers = [_post(port, q) for q in queries]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            status = json.loads(resp.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0
    assert status["plans"] == ["BucketedTopK"]
    assert status["plan_calls"] == 3 + 1     # buckets 1, 2, 4; u3's query
    assert status["serve_paths"][0]["plan"] == 1
    assert status["serve_paths"][0]["per_query"] == 2
    jreg = JRegistry({"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
                      "PIO_STORAGE_SOURCES_PIO_PATH":
                      str(tmp_path / "pio.db")})
    jalgo, jmodel = jax_twin(None, model)
    jalgo.with_serving_context(JContext(registry=jreg))
    for q, (code, body) in zip(queries, answers):
        assert code == 200
        want = jalgo.predict(jmodel, jec.Query(**q))
        assert [s["item"] for s in body["itemScores"]] == [
            s.item for s in want.itemScores]
        np.testing.assert_allclose(
            [s["score"] for s in body["itemScores"]],
            [s.score for s in want.itemScores], rtol=1e-5, atol=1e-6)
    assert "i5" not in [s["item"] for _, b in answers
                        for s in b["itemScores"]]
    assert fused_topk.LAUNCHES == 0   # no card here: nothing launched
