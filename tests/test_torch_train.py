"""The port's training slice end to end on the CPU: `Engine.train` with
the recommendation template (`ALSAlgorithm.train` over
`ops.als.als_train`) on the ratings of an
app in the event store, engine.json variants parsed as the JAX engine
parses them, and `cli train` -> engine instance -> `cli deploy --device
cpu` -> `/queries.json`. A model the port trained answers
`batch_predict` as the JAX template does on the same factors (the same
item lists; scores to rtol 1e-5, the fp32 summation order of the two
matmuls being the only difference)."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import ops as cli_ops
from predictionio_tpu_torch.core.params import EmptyParams, ParamsError
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core import workflow as pwf
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import Event, DataMap, from_millis
from predictionio_tpu_torch.data.storage import StorageRegistry
from predictionio_tpu_torch.data.store import AppNotFoundError
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.ops import als as pals

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS = 50, 80
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _columns(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS - 2, n).astype(np.int32)  # 2 unrated users
    i = rng.integers(0, N_ITEMS, n).astype(np.int32)
    r = rng.integers(1, 6, n).astype(np.float32)
    return RatingColumns(u, i, r, np.arange(n, dtype=np.int64),
                         BiMap.from_keys(USERS), BiMap.from_keys(ITEMS))


def _mem_registry():
    return StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})


def _store(cols, registry=None, app="MyApp"):
    """`cols` as `rate` events of app `app` (the event time of row n is
    n ms, so the store gives the rows back in this order); returns the
    registry."""
    registry = registry or _mem_registry()
    info = cli_ops.app_new(registry, app)
    registry.get_events().insert_batch([
        Event(event="rate", entity_type="user",
              entity_id=cols.users.inverse(int(u)),
              target_entity_type="item",
              target_entity_id=cols.items.inverse(int(i)),
              properties=DataMap({"rating": float(r)}),
              event_time=from_millis(int(t)))
        for u, i, r, t in zip(cols.user_ix, cols.item_ix, cols.rating,
                              cols.t_millis)], info["id"])
    return registry


def _events_file(cols, path):
    """`cols` as API-JSON `rate` lines, distinct event times."""
    path.write_text("\n".join(json.dumps({
        "event": "rate", "entityType": "user",
        "entityId": cols.users.inverse(int(u)),
        "targetEntityType": "item",
        "targetEntityId": cols.items.inverse(int(i)),
        "properties": {"rating": float(r)}, "eventTime": int(t)})
        for u, i, r, t in zip(cols.user_ix, cols.item_ix, cols.rating,
                              cols.t_millis)))


def _variant(rank=24, iters=3, reg=0.05, seed=1):
    return {"id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": "MyApp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": rank, "num_iterations": iters, "lambda_": reg,
                "seed": seed}}]}


def test_variant_parses_as_the_jax_engine_does():
    variant = _variant()
    jp = jrec.RecommendationEngine.apply().engine_params_from_variant(
        variant)
    pp = prec.RecommendationEngine.apply().engine_params_from_variant(
        json.dumps(variant))
    (jname, jparams), = jp.algorithm_params_list
    (pname, pparams), = pp.algorithm_params_list
    assert pname == jname == "als"
    assert (pparams.rank, pparams.num_iterations, pparams.lambda_,
            pparams.seed) == (jparams.rank, jparams.num_iterations,
                              jparams.lambda_, jparams.seed)
    assert pp.data_source_params[1].app_name == "MyApp"
    assert pp.preparator_params == ("", EmptyParams())
    for bad in ({"algorithms": [{"name": "nope"}]},
                {"algorithms": [{"name": "als", "params": {"rnk": 3}}]},
                {"version": 1}):
        with pytest.raises(ParamsError):
            prec.RecommendationEngine.apply().engine_params_from_variant(bad)
        with pytest.raises(Exception):
            jrec.RecommendationEngine.apply().engine_params_from_variant(bad)


def test_engine_train_runs_the_template_on_the_cpu():
    """The template reads the app's events from the store: users and
    items that rated nothing are not in its id maps; a rating pair that
    repeats keeps its last rating."""
    engine = prec.RecommendationEngine.apply()
    cols = _columns()
    ctx = RuntimeContext(registry=_store(cols), device="cpu")
    model, = engine.train(ctx, engine.engine_params_from_variant(
        _variant()))
    assert isinstance(model, pals.ALSModel)
    n_users = len(np.unique(cols.user_ix))
    n_items = len(np.unique(cols.item_ix))
    assert n_users == N_USERS - 2
    assert model.user_factors.shape == (n_users, 24)
    assert model.item_factors.shape == (n_items, 24)
    assert model.device.type == "cpu"
    assert "u48" not in model.users and "u0" in model.users
    tm = ctx.phase_timings
    assert {"read_s", "ingest_scan_s", "ingest_build_s", "prepare_s",
            "train_algo0_s", "pack_s", "transfer_s", "solve_s", "fetch_s",
            "solver_residual"} <= set(tm)
    assert tm["solver_residual"] < 1e-2


def test_engine_train_checks():
    engine = prec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant(_variant())
    with pytest.raises(AppNotFoundError, match="MyApp"):
        engine.train(RuntimeContext(registry=_mem_registry(),
                                    device="cpu"), params)
    empty = _store(_columns(n=0))
    with pytest.raises(ValueError, match="No rating events"):
        engine.train(RuntimeContext(registry=empty, device="cpu"), params)


def test_train_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = prec.RecommendationEngine.apply()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.train(RuntimeContext(registry=_store(_columns())),
                     engine.engine_params_from_variant(_variant()))


@pytest.mark.parametrize("rank", [8, 24])
def test_trained_model_predicts_as_the_jax_template(rank):
    """Trained by the port (exact path at rank 8, bf16 CG at 24), the
    model's answers equal the JAX template's on the same factors."""
    cols = _columns()
    algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams(
        rank=rank, num_iterations=4, lambda_=0.05, seed=3))
    model = algo.train(RuntimeContext(device="cpu"), cols)
    model.sanity_check()
    x, y = model.user_factors.numpy(), model.item_factors.numpy()
    jmodel = jals.ALSModel(x, y, JBiMap.from_keys(USERS),
                           JBiMap.from_keys(ITEMS))
    jalgo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
    jalgo.warm_serving(jmodel, [1, 2, 4, 8])
    assert algo.warm_serving(model, [1, 2, 4, 8]) == 4
    queries = [dict(user="u1", num=4, blackList=["i0", "i3"]),
               dict(user="u2", num=10), dict(user="u49", num=3),
               dict(user="ghost", num=2),
               dict(user="u5", num=5, whiteList=ITEMS[10:40]),
               dict(user="u7", num=15)]
    jout = dict(jalgo.batch_predict(
        jmodel, [(n, jrec.Query(**q)) for n, q in enumerate(queries)]))
    pout = dict(algo.batch_predict(
        model, [(n, prec.Query(**q)) for n, q in enumerate(queries)]))
    assert jout.keys() == pout.keys()
    for n in jout:
        j = [(s.item, s.score) for s in jout[n].itemScores]
        p = [(s.item, s.score) for s in pout[n].itemScores]
        assert [it for it, _ in p] == [it for it, _ in j]
        np.testing.assert_allclose([s for _, s in p], [s for _, s in j],
                                   rtol=1e-5, atol=1e-6)
    assert pout[2].itemScores[0].score == 0.0   # u49 rated nothing


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_cli_train_then_deploy_serves_the_model(tmp_path):
    """`cli train` records an engine instance in the sqlite store;
    `cli deploy` on the CPU serves it, and the answer is the JAX
    template's on its factors."""
    cols = _columns()
    env = {**os.environ, "PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db")}
    _events_file(cols, tmp_path / "events.jsonl")
    (tmp_path / "engine.json").write_text(json.dumps(_variant()))

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp_path, env={**env, "PYTHONPATH": str(REPO)},
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout)

    app = cli("app", "new", "MyApp")
    assert cli("import", "--appid", str(app["id"]), "--input",
               "events.jsonl")["imported"] == cols.n
    report = cli("train", "--device", "cpu")
    assert report["status"] == "COMPLETED"
    assert report["phaseTimings"]["solver_residual"] < 1e-2
    registry = StorageRegistry(env)
    inst = registry.get_meta_data_engine_instances().get(
        report["engineInstanceId"])
    model, = deserialize_models(
        registry.get_model_data_models().get(inst.id).models, inst.id,
        [None], None, retrain=None)
    assert model.user_factors.shape == (N_USERS - 2, 24)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--port", "0", "--device", "cpu", "--batch-max", "4"],
        cwd=tmp_path, env={**env, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving engine instance {inst.id} "), \
            proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        q = {"user": "u3", "num": 5, "blackList": ["i1", "i2"]}
        status, body = _post(port, q)
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0 and status == 200
    jmodel = jals.ALSModel(model.user_factors.numpy(),
                           model.item_factors.numpy(),
                           JBiMap.from_keys(model.users.keys()),
                           JBiMap.from_keys(model.items.keys()))
    (_, want), = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams()).batch_predict(
        jmodel, [(0, jrec.Query(**q))])
    assert [s["item"] for s in body["itemScores"]] == [
        s.item for s in want.itemScores]
    np.testing.assert_allclose([s["score"] for s in body["itemScores"]],
                               [s.score for s in want.itemScores],
                               rtol=1e-5, atol=1e-6)


def test_cli_train_function_writes_the_model(tmp_path):
    """`ops.train` (what `cli train` runs) stores the trained model: the
    blob read back equals the factors, on the CPU, with the id maps."""
    registry = _store(_columns())
    (tmp_path / "engine.json").write_text(json.dumps(
        {"engineFactory": "recommendation",
         "datasource": {"params": {"app_name": "MyApp"}}}))
    report = cli_ops.train(registry, engine_json=str(tmp_path / "engine.json"),
                           device="cpu")
    timings = report["phaseTimings"]
    assert timings["solver_residual"] == 0.0            # exact path
    assert timings["blob_bytes"] > 0
    iid = report["engineInstanceId"]
    model, = deserialize_models(
        registry.get_model_data_models().get(iid).models, iid, [None],
        None, retrain=None)
    assert model.user_factors.shape == (N_USERS - 2, 10)  # template defaults
    assert model.device.type == "cpu"
    engine, inst = cli_ops.deploy_target(
        registry, engine_json=str(tmp_path / "engine.json"))
    assert inst.id == iid
    _, (back,), _ = pwf.CoreWorkflow.prepare_deploy(
        engine, inst, RuntimeContext(registry=registry, device="cpu"))
    assert torch.equal(back.user_factors, model.user_factors)
    assert back.users == model.users and back.items == model.items
