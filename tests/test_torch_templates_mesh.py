"""One `runtime_conf["mesh"]` trains every template of the port: `cli
train --mesh data=2,model=2` (and `data=2,sp=2` for seqrec) over four
CPU shards (`PIO_CPU_DEVICE_COUNT=4`), recorded on the instance, then
deployed and queried on the CPU, against the same variant trained on
one device (`--mesh data=1`) or on the "data" axis alone:

- recommendation and similar product over data=2,model=2, e-commerce
  over data=2,sp=2: ALS answers exactly as over data=2 (its factors are
  bit-equal);
- classification: the forest and NB answer exactly as on one device,
  logistic regression within its 5e-3 bar (every label equal here);
- two-tower over data=2,model=2 and seqrec over data=2,sp=2: the same
  items as one device, scores within 1e-4 (the towers within 1e-5).

A deploy of an instance whose recorded mesh has several axes serves
as the JAX package's does: the catalog sharded over every local card,
forced (`serve_mesh_from_conf`, held against the JAX function).
"""

import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk_sharded as jtopk
from predictionio_tpu_torch.cli import ops as cli_ops
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, resolve_engine
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.ops import topk_sharded

pytestmark = pytest.mark.torch

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


def _store(kind):
    reg = StorageRegistry(MEM)
    app = reg.get_meta_data_apps().insert(App(0, "app"))
    events = reg.get_events()
    events.init(app)
    rng = np.random.RandomState(0)
    batch = []
    if kind == "classification":
        for i in range(120):
            plan = i % 2
            batch.append(Event(
                event="$set", entity_type="user", entity_id=f"u{i}",
                properties=DataMap({
                    "attr0": int(rng.poisson(7 if plan == 0 else 1)),
                    "attr1": int(rng.poisson(2)),
                    "attr2": int(rng.poisson(7 if plan else 1)),
                    "plan": float(plan)})))
    else:
        name = "rate" if kind == "recommendation" else "view"
        for u in range(24):
            for i in range(18):
                if i % 3 != u % 3 and rng.rand() < 0.8:
                    continue
                props = ({"rating": float(1 + (u * 7 + i) % 5)}
                         if name == "rate" else {})
                batch.append(Event(
                    event=name, entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap(props),
                    event_time=T0 + timedelta(seconds=len(batch))))
                if kind == "ecommerce" and i < 3:
                    batch.append(Event(
                        event="buy", entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        properties=DataMap({}),
                        event_time=T0 + timedelta(seconds=len(batch))))
    for s in range(0, len(batch), 50):
        events.insert_batch(batch[s:s + 50], app)
    return reg


CASES = {
    "recommendation": ([("als", {"rank": 4, "num_iterations": 3,
                                 "seed": 1})], "data=2,model=2", "data=2"),
    "ecommerce": ([("ecomm", {"app_name": "app", "rank": 4,
                              "num_iterations": 3, "seed": 1})],
                  "data=2,sp=2", "data=2"),
    "similarproduct": ([("als", {"rank": 4, "num_iterations": 3,
                                 "seed": 1})], "data=2,model=2", "data=2"),
    "classification": ([("forest", {"num_trees": 4, "max_depth": 3,
                                    "seed": 1}),
                        ("naive", {}),
                        ("logreg", {"steps": 50})],
                       "data=2,model=2", "data=1"),
    "twotower": ([("twotower", {"emb_dim": 8, "hidden": 8, "out_dim": 8,
                                "batch_size": 16, "epochs": 2,
                                "seed": 1})], "data=2,model=2", "data=1"),
    "seqrec": ([("seqrec", {"app_name": "app", "seq_len": 4, "dim": 8,
                            "n_heads": 2, "n_layers": 1, "batch_size": 8,
                            "epochs": 2, "seed": 1})],
               "data=2,sp=2", "data=1"),
}


def _queries(factory):
    if factory == "classification":
        return [{"attr0": a, "attr1": b, "attr2": c}
                for a, b, c in ((8, 2, 0), (0, 2, 8), (3, 1, 3), (1, 0, 6))]
    if factory == "similarproduct":
        return [{"items": [f"i{i}"], "num": 4} for i in range(0, 18, 3)]
    return [{"user": f"u{u}", "num": 4} for u in range(0, 24, 3)]


def _answers(reg, tmp_path, factory, algo, params, mesh):
    variant = {"id": "default", "engineFactory": factory,
               "datasource": {"params": {"app_name": "app"}},
               "algorithms": [{"name": algo, "params": params}]}
    path = tmp_path / f"{factory}-{algo}.json"
    path.write_text(json.dumps(variant))
    report = cli_ops.train(reg, engine_json=str(path), device="cpu",
                           mesh=mesh)
    assert report["status"] == "COMPLETED"
    row = reg.get_meta_data_engine_instances().get(
        report["engineInstanceId"])
    assert row.runtime_conf["mesh"] == mesh
    engine = resolve_engine(factory)
    algos, models, serving = CoreWorkflow.prepare_deploy(
        engine, row, RuntimeContext(registry=reg, device="cpu"),
        warm_batch_max=4)
    qc = algos[0].query_class
    out = algos[0].batch_predict(models[0], [
        (k, qc(**q)) for k, q in enumerate(_queries(factory))])
    return [p for _, p in sorted(out, key=lambda t: t[0])]


@pytest.mark.parametrize("factory", sorted(CASES))
def test_cli_train_mesh_trains_and_deploys_every_template(
        factory, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_CPU_DEVICE_COUNT", "4")
    reg = _store(factory)
    algos, mesh, baseline = CASES[factory]
    for algo, params in algos:
        got = _answers(reg, tmp_path, factory, algo, params, mesh)
        want = _answers(reg, tmp_path, factory, algo, params, baseline)
        if factory == "classification":
            assert [p.label for p in got] == [p.label for p in want], algo
            continue
        assert all(p.itemScores for p in got)
        for g, w in zip(got, want):
            assert [s.item for s in g.itemScores] == \
                [s.item for s in w.itemScores]
            tol = 1e-4 if factory in ("twotower", "seqrec") else 0
            np.testing.assert_allclose([s.score for s in g.itemScores],
                                       [s.score for s in w.itemScores],
                                       atol=tol, rtol=0)


def test_a_multi_axis_recorded_mesh_serves_as_the_jax_package(monkeypatch):
    """An instance trained on data=2,model=2 deploys over every local
    card, forced, as the JAX `serve_mesh_from_conf` answers for as many
    devices (PIO_SERVE_SHARDS=4 of its 8 virtual CPU devices); with
    PIO_SERVE_SHARD=off neither shards."""
    monkeypatch.delenv("PIO_SERVE_SHARD", raising=False)
    monkeypatch.setenv("PIO_SERVE_SHARDS", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for conf in ({"mesh": "data=2,model=2"}, {"mesh": "data=2,sp=2"},
                 {"mesh": "data=4"}):
        got = topk_sharded.serve_mesh_from_conf(conf)
        want = jtopk.serve_mesh_from_conf(conf)
        assert (got.n_shards, got.forced) == (want.n_shards, want.forced) \
            == (4, True)
        assert got.devices == tuple(torch.device("cuda", c)
                                    for c in range(4))
    monkeypatch.setenv("PIO_SERVE_SHARD", "off")
    assert topk_sharded.serve_mesh_from_conf(
        {"mesh": "data=2,model=2"}) is None
    assert jtopk.serve_mesh_from_conf({"mesh": "data=2,model=2"}) is None
