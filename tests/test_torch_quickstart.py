"""The quickstart of `tests/test_cli.py` (`TestQuickstartSubprocess`)
through the port's CLI on the CPU: `app new` -> `import` -> `build` ->
`train --device cpu` -> `deploy --device cpu` -> `/queries.json`, in
subprocesses over one sqlite store.

Held against the JAX package on the same file: the rating columns the
port trained on equal the JAX read, and the served answers equal the
JAX template's `batch_predict` on the factors the port stored. Then the
JAX package trains on the same store: the port's `batch_predict` on
those factors (carried over with `als_model_from_numpy`) equals the JAX
one, and the port's deploy refuses the JAX instance, now the newest,
with a clear error instead of importing the JAX package."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.core import RuntimeContext as JRuntimeContext
from predictionio_tpu.core import workflow as jwf
from predictionio_tpu.core.persistence import loads as jloads
from predictionio_tpu.data import store as jstore
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import ops as pops
from predictionio_tpu_torch.core import workflow as pwf
from predictionio_tpu_torch.core.persistence import (ForeignModelError,
                                                     deserialize_models)
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data import store as pstore
from predictionio_tpu_torch.data.storage import StorageRegistry
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.ops.als import als_model_from_numpy

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
TEMPLATE = dict(event_names=["rate", "buy"],
                value_spec={"rate": ("prop", "rating"), "buy": 4.0},
                dedup_last_wins=True)
QUERIES = [{"user": "u1", "num": 3}, {"user": "u4", "num": 5,
                                      "blackList": ["i0", "i3"]},
           {"user": "u19", "num": 10}, {"user": "nobody", "num": 2},
           {"user": "u7", "num": 4, "whiteList": ["i1", "i2", "i5", "i9"]}]


def _events_lines():
    """`TestQuickstartSubprocess`'s MovieLens-style events."""
    rng = np.random.RandomState(0)
    lines = []
    for u in range(20):
        for i in range(15):
            if rng.rand() < 0.5:
                lines.append(json.dumps({
                    "event": "rate", "entityType": "user",
                    "entityId": f"u{u}",
                    "targetEntityType": "item", "targetEntityId": f"i{i}",
                    "properties": {
                        "rating": 5.0 if i % 3 == u % 3 else 1.0},
                    "eventTime": "2020-01-01T00:00:00.000Z"}))
    return lines


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _jax_answers(user_factors, item_factors, users, items):
    jmodel = jals.ALSModel(np.asarray(user_factors, np.float32),
                           np.asarray(item_factors, np.float32),
                           JBiMap.from_keys(users), JBiMap.from_keys(items))
    out = dict(jrec.ALSAlgorithm(jrec.ALSAlgorithmParams()).batch_predict(
        jmodel, [(n, jrec.Query(**q)) for n, q in enumerate(QUERIES)]))
    return [[{"item": s.item, "score": s.score} for s in out[n].itemScores]
            for n in range(len(QUERIES))]


def _same_answers(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [s["item"] for s in g] == [s["item"] for s in w]
        np.testing.assert_allclose([s["score"] for s in g],
                                   [s["score"] for s in w],
                                   rtol=1e-5, atol=1e-6)


def test_quickstart_through_the_port_cli(tmp_path):
    config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db"),
              "PIO_INGEST_CACHE": "off"}
    env = {**os.environ, **config, "PYTHONPATH": str(REPO)}

    def cli(*args):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout)

    app = cli("app", "new", "quickstart")
    assert app["accessKey"] and cli("app", "list")[0]["id"] == app["id"]
    lines = _events_lines()
    (tmp_path / "events.jsonl").write_text("\n".join(lines))
    assert cli("import", "--appid", str(app["id"]), "--input",
               "events.jsonl")["imported"] == len(lines)
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "quickstart"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 4, "seed": 7}}]}))
    assert cli("build")["engineFactory"] == "recommendation"
    report = cli("train", "--device", "cpu")
    assert report["status"] == "COMPLETED"
    iid = report["engineInstanceId"]

    # what the port trained on is what the JAX package reads
    registry = StorageRegistry(config)
    rc = pstore.rating_columns(registry, "quickstart", **TEMPLATE)
    jrc = jstore.rating_columns(JRegistry(config), "quickstart", **TEMPLATE)
    for f in ("user_ix", "item_ix", "rating", "t_millis"):
        assert np.array_equal(getattr(rc, f), getattr(jrc, f)), f
    assert rc.users.keys() == jrc.users.keys()
    model, = deserialize_models(
        registry.get_model_data_models().get(iid).models, iid, [None],
        None, retrain=None)
    assert model.users.keys() == rc.users.keys()
    assert model.items.keys() == rc.items.keys()

    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--ip", "127.0.0.1", "--port", "0", "--device", "cpu",
         "--batch-max", "8"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"serving engine instance {iid} on "), \
            proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        got = [_post(port, q)["itemScores"] for q in QUERIES]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as resp:
            status = json.loads(resp.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0
    assert status["engineInstanceId"] == iid
    assert status["plans"] == ["BucketedTopK"] and status["devices"] == ["cpu"]
    assert status["plan_buckets"] == [[1, 2, 4, 8]]   # --batch-max 8
    assert [len(a) for a in got] == [3, 5, 10, 0, 4]
    _same_answers(got, _jax_answers(model.user_factors.numpy(),
                                    model.item_factors.numpy(),
                                    model.users.keys(), model.items.keys()))

    # the JAX package trains on the same store; its factors answer alike
    # through the port's template
    jregistry = JRegistry(config)
    jengine = jrec.RecommendationEngine.apply()
    variant = pops.load_variant(str(tmp_path / "engine.json"))
    jrow = jwf.CoreWorkflow.run_train(
        jengine, jengine.engine_params_from_variant(variant),
        JRuntimeContext(registry=jregistry),
        engine_factory="recommendation", engine_variant="default")
    jmodel, = jloads(jregistry.get_model_data_models().get(jrow.id).models)
    carried = als_model_from_numpy(
        np.asarray(jmodel.user_factors), np.asarray(jmodel.item_factors),
        jmodel.users.keys(), jmodel.items.keys(), device="cpu")
    algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams())
    algo.warm_serving(carried, [1, 2, 4, 8])
    out = dict(algo.batch_predict(
        carried, [(n, prec.Query(**q)) for n, q in enumerate(QUERIES)]))
    _same_answers([[{"item": s.item, "score": s.score}
                    for s in out[n].itemScores] for n in range(len(QUERIES))],
                  _jax_answers(jmodel.user_factors, jmodel.item_factors,
                               jmodel.users.keys(), jmodel.items.keys()))

    # the shared-store caveat: the newest COMPLETED instance of the
    # variant is now the JAX package's, and the port refuses its blob
    registry = StorageRegistry(config)
    engine, inst = pops.deploy_target(
        registry, engine_json=str(tmp_path / "engine.json"))
    assert inst.id == jrow.id
    with pytest.raises(ForeignModelError, match="JAX package"):
        pwf.CoreWorkflow.prepare_deploy(
            engine, inst, RuntimeContext(registry=registry, device="cpu"))
    # the port's own instance still deploys by id
    engine, inst = pops.deploy_target(registry, engine_instance_id=iid)
    _, (again,), _ = pwf.CoreWorkflow.prepare_deploy(
        engine, inst, RuntimeContext(registry=registry, device="cpu"))
    assert np.array_equal(again.user_factors.numpy(),
                          model.user_factors.numpy())
