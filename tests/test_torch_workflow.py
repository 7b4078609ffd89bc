"""The port's train/deploy workflow (`core/workflow.py`): an engine
instance goes INIT -> TRAINING -> COMPLETED with its blob stored, or
FAILED on an error, after which deploy refuses it; the stop-after flags
and the skipped sanity checks; the heartbeat; `engine_params_from_
instance` equals the variant; engine factories by name; a
`RetrainMarker` retrains at deploy; deploy makes its components once
and binds the serving context, so the algorithms that load the models
serve them, as in the JAX package. On the CPU, with MEM stores."""

import json
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.core import workflow as jwf
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.cli import ops
from predictionio_tpu_torch.core import base
from predictionio_tpu_torch.core import workflow as pwf
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.runtime import RuntimeContext, WorkflowParams
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (EngineInstanceStatus,
                                                 StorageRegistry, set_default)
from predictionio_tpu_torch.models import recommendation as prec

pytestmark = pytest.mark.torch

S = EngineInstanceStatus
VARIANT = {"id": "default", "engineFactory": "recommendation",
           "datasource": {"params": {"app_name": "shop", "buy_rating": 3.5}},
           "algorithms": [{"name": "als", "params": {
               "rank": 4, "num_iterations": 2, "lambda_": 0.1, "seed": 5}}]}


def _registry(n_events=300, **config):
    r = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM", **config})
    app = ops.app_new(r, "shop")["id"]
    rng = np.random.default_rng(0)
    r.get_events().insert_batch([
        Event("rate", "user", f"u{rng.integers(0, 20)}", "item",
              f"i{rng.integers(0, 25)}",
              DataMap({"rating": float(rng.integers(1, 6))}))
        for _ in range(n_events)], app)
    return r


def _spy_statuses(registry):
    dao = registry.get_meta_data_engine_instances()
    seen = []
    for name in ("insert", "update"):
        orig = getattr(dao, name)

        def spy(row, _orig=orig):
            seen.append(row.status)
            return _orig(row)
        setattr(dao, name, spy)
    return seen


def _train(registry, variant=VARIANT, **wp):
    engine = prec.RecommendationEngine.apply()
    ctx = RuntimeContext(registry=registry, device="cpu",
                         workflow_params=WorkflowParams(**wp))
    row = pwf.CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(variant), ctx,
        engine_factory="recommendation", engine_variant="default")
    return engine, ctx, row


def test_instance_goes_init_training_completed():
    registry = _registry()
    seen = _spy_statuses(registry)
    engine, ctx, row = _train(registry)
    assert seen == [S.INIT, S.TRAINING, S.COMPLETED]
    stored = registry.get_meta_data_engine_instances().get(row.id)
    assert stored.status == S.COMPLETED and stored.end_time >= stored.start_time
    tm = stored.runtime_conf["phase_timings"]
    assert {"read_s", "ingest_scan_s", "ingest_build_s", "prepare_s",
            "train_algo0_s", "solve_s", "store_s", "blob_bytes"} <= set(tm)
    assert tm["blob_bytes"] == len(
        registry.get_model_data_models().get(row.id).models)
    assert ops.latest_completed(registry, "default").id == row.id
    algos, (model,), serving = pwf.CoreWorkflow.prepare_deploy(
        engine, stored, ctx, warm_batch_max=4)
    assert model.device.type == "cpu" and algos[0]._serve_plan is not None
    (_, pred), = algos[0].batch_predict(model, [(0, prec.Query(user="u1"))])
    assert len(pred.itemScores) == 10


def test_failure_marks_the_instance_failed_and_deploy_refuses():
    registry = _registry(n_events=0)
    seen = _spy_statuses(registry)
    with pytest.raises(ValueError, match="No rating events"):
        _train(registry)
    assert seen == [S.INIT, S.TRAINING, S.FAILED]
    row, = registry.get_meta_data_engine_instances().get_all()
    assert row.status == S.FAILED
    assert registry.get_model_data_models().get(row.id) is None
    with pytest.raises(ValueError, match="No valid engine instance found "
                                         "for this engine"):
        ops.latest_completed(registry, "default")
    with pytest.raises(ValueError, match="not COMPLETED"):
        pwf.CoreWorkflow.prepare_deploy(
            prec.RecommendationEngine.apply(), row,
            RuntimeContext(registry=registry, device="cpu"))


@pytest.mark.parametrize("flag,exc,last", [
    ("stop_after_read", base.StopAfterReadInterruption, "ingest_build_s"),
    ("stop_after_prepare", base.StopAfterPrepareInterruption, "prepare_s"),
])
def test_stop_after_flags(flag, exc, last):
    registry = _registry()
    seen = _spy_statuses(registry)
    engine = prec.RecommendationEngine.apply()
    ctx = RuntimeContext(registry=registry, device="cpu",
                         workflow_params=WorkflowParams(**{flag: True}))
    with pytest.raises(exc):
        pwf.CoreWorkflow.run_train(
            engine, engine.engine_params_from_variant(VARIANT), ctx)
    assert seen[-1] == S.FAILED and list(ctx.phase_timings)[-1] == last
    assert "train_algo0_s" not in ctx.phase_timings


def test_cli_train_stop_after_read_ends_normally(tmp_path, capsys):
    registry = _registry()
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    set_default(registry)
    try:
        assert cli_main.main(["train", "--engine-json",
                              str(tmp_path / "engine.json"),
                              "--stop-after-read", "--device", "cpu"]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "interrupted": "StopAfterReadInterruption"}
        assert cli_main.main(["deploy", "--engine-json",
                              str(tmp_path / "engine.json"),
                              "--device", "cpu"]) == 1
        assert "No valid engine instance" in capsys.readouterr().err
    finally:
        set_default(None)


class _Fussy:
    """Training data whose sanity check always fails."""

    def sanity_check(self):
        raise AssertionError("sanity check ran")


class _FussySource(base.DataSource):
    def read_training(self, ctx):
        return _Fussy()


class _Constant(base.Algorithm):
    persist_model = False

    def train(self, ctx, pd):
        ctx.phase_timings.setdefault("trained", 0)
        ctx.phase_timings["trained"] += 1
        time.sleep(0.3)
        return {"constant": 1}


def _fussy_engine():
    return Engine(_FussySource, base.IdentityPreparator, _Constant,
                  base.FirstServing)


def test_skip_sanity_check_heartbeat_and_retrain_marker():
    registry = StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM",
                                "PIO_TRAIN_HEARTBEAT_S": "0.05"})
    engine = _fussy_engine()
    params = engine.engine_params_from_variant({})
    with pytest.raises(AssertionError, match="sanity check ran"):
        pwf.CoreWorkflow.run_train(engine, params, RuntimeContext(
            registry=registry, device="cpu"))
    beats = []
    dao = registry.get_meta_data_engine_instances()
    orig = dao.record_heartbeat
    dao.record_heartbeat = lambda iid, ts=None: (beats.append(iid),
                                                 orig(iid, ts))
    ctx = RuntimeContext(registry=registry, device="cpu",
                         workflow_params=WorkflowParams(
                             skip_sanity_check=True))
    row = pwf.CoreWorkflow.run_train(engine, params, ctx)
    assert row.status == S.COMPLETED and beats and set(beats) == {row.id}
    n = len(beats)
    time.sleep(0.2)
    assert len(beats) == n            # the beat stopped with the train
    # the algorithm stored a RetrainMarker: deploy trains it again
    _, models, _ = pwf.CoreWorkflow.prepare_deploy(engine, row, ctx)
    assert models == [{"constant": 1}] and ctx.phase_timings["trained"] == 2


def test_engine_params_from_instance_equal_the_variant():
    registry = _registry()
    engine, _, row = _train(registry)
    want = engine.engine_params_from_variant(VARIANT)
    assert pwf.engine_params_from_instance(engine, row) == want
    # the JAX package records and reads back the same params JSON
    jengine_ = jrec.RecommendationEngine.apply()
    jrow = jwf.EngineInstance(
        data_source_params=row.data_source_params,
        preparator_params=row.preparator_params,
        algorithms_params=row.algorithms_params,
        serving_params=row.serving_params)
    jp = jwf.engine_params_from_instance(jengine_, jrow)
    assert jp.data_source_params[1].buy_rating == 3.5
    assert jp.algorithm_params_list[0][1].rank == 4
    assert row.algorithms_params == jwf._algo_params_json(
        jengine_.engine_params_from_variant(VARIANT))


def test_deploy_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    registry = _registry()
    engine, _, row = _train(registry)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pwf.CoreWorkflow.prepare_deploy(engine, row,
                                        RuntimeContext(registry=registry))
    # the command line too: neither train nor deploy runs on the CPU
    # unless asked to
    variant = str(tmp_path / "engine.json")
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    set_default(registry)
    try:
        for argv in (["train", "--engine-json", variant],
                     ["deploy", "--engine-json", variant, "--port", "0"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli_main.main(argv)
    finally:
        set_default(None)
    assert [r.status for r in registry.get_meta_data_engine_instances()
            .get_all()].count(S.FAILED) == 1


def test_resolve_engine():
    assert isinstance(pwf.resolve_engine("recommendation"), Engine)
    assert isinstance(pwf.resolve_engine(
        "predictionio_tpu_torch.models.recommendation.RecommendationEngine"),
        Engine)
    pwf.register_engine("fussy", _fussy_engine)
    assert pwf.resolve_engine("fussy").data_source_classes == {
        "": _FussySource}
    with pytest.raises(ValueError, match="Unknown engine factory"):
        pwf.resolve_engine("no_such_template")
    with pytest.raises(TypeError, match="did not produce an Engine"):
        pwf.resolve_engine("json.JSONDecoder")
    with pytest.raises(ValueError, match="JAX package"):
        pwf.resolve_engine("predictionio_tpu.no_such_module.Factory")


class _Contextual(prec.ALSAlgorithm):
    """The recommendation algorithm with a serve-time context hook that
    records what it was bound to."""
    bound: list = []

    def with_serving_context(self, ctx):
        self.ctx = ctx
        _Contextual.bound.append((self, ctx))


def _contextual_engine():
    return Engine(prec.RecommendationDataSource, base.IdentityPreparator,
                  {"als": _Contextual}, base.FirstServing)


def test_prepare_deploy_makes_components_once_and_serves_the_loaders(
        monkeypatch):
    """The algorithms `deserialize_models` loads the models through are
    the ones `prepare_deploy` returns to serve, and the engine makes its
    components once."""
    registry = _registry()
    engine, ctx, row = _train(registry)
    made, loaders = [], []
    make = engine.make_components

    def counting(params):
        made.append(params)
        return make(params)

    deserialize = pwf.deserialize_models

    def recording(blob, iid, algos, ctx_, retrain):
        loaders.append(list(algos))
        return deserialize(blob, iid, algos, ctx_, retrain)

    monkeypatch.setattr(engine, "make_components", counting)
    monkeypatch.setattr(pwf, "deserialize_models", recording)
    algos, models, _ = pwf.CoreWorkflow.prepare_deploy(
        engine, row, ctx, warm_batch_max=2)
    assert len(made) == 1 and len(loaders) == 1
    assert [id(a) for a in algos] == [id(a) for a in loaders[0]]
    assert algos[0]._serve_plan is not None      # warmed by the loader
    assert models[0].users.get("u3") is not None


def test_with_serving_context_sees_the_deploys_and_the_trains_context(
        monkeypatch):
    """`Engine.train` and `prepare_deploy` bind the run's context to
    every algorithm with a `with_serving_context` hook: the serving
    algorithm holds the deploy's context."""
    monkeypatch.setattr(_Contextual, "bound", [])
    registry = _registry()
    engine = _contextual_engine()
    params = engine.engine_params_from_variant(VARIANT)
    train_ctx = RuntimeContext(registry=registry, device="cpu")
    row = pwf.CoreWorkflow.run_train(engine, params, train_ctx)
    assert [c for _, c in _Contextual.bound] == [train_ctx]
    deploy_ctx = RuntimeContext(registry=registry, device="cpu")
    algos, _, _ = pwf.CoreWorkflow.prepare_deploy(
        engine, row, deploy_ctx, warm_batch_max=1)
    assert _Contextual.bound[-1] == (algos[0], deploy_ctx)
    assert algos[0].ctx is deploy_ctx and len(_Contextual.bound) == 2
    server = cli_main.deploy_instance(engine, row, deploy_ctx, port=0,
                                      batch_max=1)
    try:
        dep = server.deployment
        assert dep.engine is engine and dep.instance.id == row.id
        assert dep.algos[0].ctx is deploy_ctx and server.ctx is deploy_ctx
    finally:
        server.stop()
