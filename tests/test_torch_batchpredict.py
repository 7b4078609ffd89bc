"""The port's `pio batchpredict` (`core/batchpredict.py`, `cli
batchpredict`) against the JAX package's, on the CPU:

  - `batch_predict_lines` on factors carried across from a JAX-trained
    instance (`als_model_from_numpy`, recorded as a port instance) gives
    the JAX package's item ids in the same order, with scores within
    1e-5, for blackList, whiteList, `num` > 10 and unknown-user queries,
    whatever the chunk size; the warmed plan answers the blackList
    chunks (one plan call per chunk, split at the largest bucket);
  - `tests/test_cli.py::TestTrainBatchPredict` through the port's CLI:
    `train` then `batchpredict` in a subprocess, the output in the
    input's order.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.core import RuntimeContext as JRuntimeContext
from predictionio_tpu.core import workflow as jwf
from predictionio_tpu.core.batchpredict import (
    batch_predict_lines as jbatch_predict_lines)
from predictionio_tpu.core.persistence import loads as jloads
from predictionio_tpu.data import DataMap as JDataMap
from predictionio_tpu.data import Event as JEvent
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu_torch.cli import ops as pops
from predictionio_tpu_torch.core.batchpredict import (batch_predict_lines,
                                                      load_deployment,
                                                      predict_lines,
                                                      run_batch_predict)
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.ops.als import als_model_from_numpy

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
VARIANT = {"datasource": {"params": {"app_name": "bp"}},
           "algorithms": [{"name": "als", "params": {
               "rank": 4, "num_iterations": 3, "seed": 1}}]}


def _ratings(n_users=15, n_items=12, seed=0):
    rng = np.random.RandomState(seed)
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6)))
            for u in range(n_users) for i in range(n_items)
            if rng.rand() < 0.6]


def _store(pkg, ratings):
    E, D, A, R = ((Event, DataMap, App, StorageRegistry) if pkg == "port"
                  else (JEvent, JDataMap, JApp, JRegistry))
    reg = R(dict(MEM))
    app_id = reg.get_meta_data_apps().insert(A(0, "bp"))
    reg.get_events().init(app_id)
    reg.get_events().insert_batch(
        [E(event="rate", entity_type="user", entity_id=u,
           target_entity_type="item", target_entity_id=i,
           properties=D({"rating": r})) for u, i, r in ratings], app_id)
    return reg


def _queries(n=40, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for n_ in range(n):
        q = {"user": f"u{rng.randint(0, 17)}", "num": int(rng.randint(1, 8))}
        kind = n_ % 5
        if kind == 1:
            q["blackList"] = [f"i{x}" for x in rng.choice(12, 3, False)]
        elif kind == 2:
            q["whiteList"] = [f"i{x}" for x in rng.choice(12, 5, False)]
        elif kind == 3:
            q["num"] = 11
        out.append(json.dumps(q))
    return out + [json.dumps({"user": "nobody", "num": 3})]


@pytest.fixture(scope="module")
def both():
    """A JAX-trained instance, and a port instance that carries its
    factors, each in its package's MEM store."""
    ratings = _ratings()
    jreg = _store("jax", ratings)
    jengine = jrec.engine()
    jrow = jwf.CoreWorkflow.run_train(
        jengine, jengine.engine_params_from_variant(VARIANT),
        JRuntimeContext(registry=jreg))
    jmodel, = jloads(jreg.get_model_data_models().get(jrow.id).models)
    carried = als_model_from_numpy(
        np.asarray(jmodel.user_factors), np.asarray(jmodel.item_factors),
        jmodel.users.keys(), jmodel.items.keys(), device="cpu")
    preg = _store("port", ratings)
    engine = rec.RecommendationEngine.apply()
    train = rec.ALSAlgorithm.train
    rec.ALSAlgorithm.train = lambda self, ctx, pd: carried
    try:
        prow = CoreWorkflow.run_train(
            engine, engine.engine_params_from_variant(VARIANT),
            RuntimeContext(registry=preg, device="cpu"))
    finally:
        rec.ALSAlgorithm.train = train
    return (jengine, jrow, jreg), (engine, prow, preg)


@pytest.mark.parametrize("chunk_size", [1, 7, 1024])
def test_lines_equal_the_jax_batch_predict(both, chunk_size):
    (jengine, jrow, jreg), (engine, prow, preg) = both
    lines = _queries()
    theirs = [json.loads(s) for s in jbatch_predict_lines(
        jengine, jrow, JRuntimeContext(registry=jreg), lines)]
    ours = [json.loads(s) for s in batch_predict_lines(
        engine, prow, RuntimeContext(registry=preg, device="cpu"),
        lines + ["", "  "], chunk_size=chunk_size)]
    assert len(ours) == len(theirs) == len(lines)
    for n, (a, b) in enumerate(zip(ours, theirs)):
        assert a["query"] == b["query"] == json.loads(lines[n])
        ia = [x["item"] for x in a["prediction"]["itemScores"]]
        ib = [x["item"] for x in b["prediction"]["itemScores"]]
        assert ia == ib, f"query {n}: {a['query']}"
        np.testing.assert_allclose(
            [x["score"] for x in a["prediction"]["itemScores"]],
            [x["score"] for x in b["prediction"]["itemScores"]],
            rtol=1e-5, atol=1e-5)
    assert any(o["prediction"]["itemScores"] == [] for o in ours)


def test_blacklist_chunks_go_through_the_warmed_plan(both):
    _, (engine, prow, preg) = both
    dep = load_deployment(engine, prow, RuntimeContext(registry=preg,
                                                       device="cpu"))
    plan = dep.algos[0]._serve_plan
    warm_calls = plan.calls
    assert warm_calls == len(plan.buckets) and max(plan.buckets) == 64
    known = [json.dumps({"user": f"u{n % 15}", "num": 3, "blackList":
                         ["i0"]}) for n in range(150)]
    out = list(predict_lines(dep, known, chunk_size=100))
    assert len(out) == 150
    # chunks of 100 and 50; 100 splits at bucket 64 into 2 plan calls
    assert plan.calls - warm_calls == 2 + 1


def test_run_batch_predict_writes_one_line_per_query(both, tmp_path):
    _, (engine, prow, preg) = both
    lines = _queries(12, seed=3)
    (tmp_path / "q.jsonl").write_text("\n".join(lines) + "\n\n")
    n = run_batch_predict(engine, prow, RuntimeContext(registry=preg,
                                                       device="cpu"),
                          input_path=str(tmp_path / "q.jsonl"),
                          output_path=str(tmp_path / "out.jsonl"),
                          chunk_size=5)
    rows = [json.loads(s) for s in
            (tmp_path / "out.jsonl").read_text().splitlines()]
    assert n == len(rows) == len(lines) == 13
    assert [r["query"] for r in rows] == [json.loads(s) for s in lines]


def test_cli_train_then_batchpredict(tmp_path):
    """tests/test_cli.py::TestTrainBatchPredict through the port."""
    config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db")}
    reg = StorageRegistry(config)
    info = pops.app_new(reg, "bp")
    reg.get_events().insert_batch(
        [Event(event="rate", entity_type="user", entity_id=u,
               target_entity_type="item", target_entity_id=i,
               properties=DataMap({"rating": r}))
         for u, i, r in _ratings(10, 8)], info["id"])
    (tmp_path / "engine.json").write_text(json.dumps(
        {"id": "default", "engineFactory": "recommendation", **VARIANT}))
    result = pops.train(reg, engine_json=str(tmp_path / "engine.json"),
                        device="cpu")
    assert result["status"] == "COMPLETED"
    reg.close()
    (tmp_path / "queries.jsonl").write_text("\n".join(
        json.dumps({"user": f"u{u}", "num": 3}) for u in range(5)))
    env = {**os.environ, "PYTHONPATH": str(REPO), **config}
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "batchpredict",
         "--input", "queries.jsonl", "--output", "out.jsonl",
         "--query-partitions", "2", "--device", "cpu"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {
        "engineInstanceId": result["engineInstanceId"], "predictions": 5,
        "output": "out.jsonl"}
    rows = [json.loads(s) for s in
            (tmp_path / "out.jsonl").read_text().splitlines()]
    assert [r["query"]["user"] for r in rows] == [f"u{u}" for u in range(5)]
    assert all(len(r["prediction"]["itemScores"]) == 3 for r in rows)
