"""Command implementations of the port's CLI.

The port of the lifecycle commands of `predictionio_tpu/cli/ops.py`
(commands/{App,AccessKey,Engine,Import,Management}.scala): `app new|
list|show|delete`, `accesskey new|list`, `import` of API-JSON event
lines, the engine.json plumbing of `build`, `train` and `deploy`,
`eval`, `batchpredict`, `status`, the running server's `undeploy`
(POST /stop) and `reload_server` (POST /reload, `redeploy`'s second
half), and the `template new` scaffold (commands/Template.scala). Every
function but the scaffold and the two server calls takes the storage
registry it works on.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, format_time
from predictionio_tpu_torch.data.storage import AccessKey, App

IMPORT_BATCH = 500


def app_new(registry, name: str, *, description: Optional[str] = None,
            access_key: str = "") -> Dict[str, Any]:
    """A new app, its default event table and its default access key."""
    apps = registry.get_meta_data_apps()
    if apps.get_by_name(name) is not None:
        raise ValueError(f"App {name} already exists. Aborting.")
    app_id = apps.insert(App(0, name, description))
    registry.get_events().init(app_id)
    key = registry.get_meta_data_access_keys().insert(
        AccessKey(access_key, app_id, ()))
    return {"name": name, "id": app_id, "accessKey": key}


def _require_app(registry, name: str) -> App:
    app = registry.get_meta_data_apps().get_by_name(name)
    if app is None:
        raise ValueError(f"App {name} does not exist. Aborting.")
    return app


def app_list(registry) -> List[Dict[str, Any]]:
    keys = registry.get_meta_data_access_keys()
    return [{"name": app.name, "id": app.id,
             "accessKeys": [k.key for k in keys.get_by_appid(app.id)]}
            for app in sorted(registry.get_meta_data_apps().get_all(),
                              key=lambda a: a.name)]


def app_show(registry, name: str) -> Dict[str, Any]:
    app = _require_app(registry, name)
    keys = registry.get_meta_data_access_keys().get_by_appid(app.id)
    channels = registry.get_meta_data_channels().get_by_appid(app.id)
    return {
        "name": app.name, "id": app.id, "description": app.description,
        "accessKeys": [{"key": k.key, "events": list(k.events) or "(all)"}
                       for k in keys],
        "channels": [{"id": c.id, "name": c.name} for c in channels],
    }


def app_delete(registry, name: str, *, force: bool = False) -> None:
    """Delete an app with its channels, events and access keys."""
    app = _require_app(registry, name)
    if not force:
        raise ValueError("Pass force=True (CLI: --force) to delete")
    events = registry.get_events()
    channels = registry.get_meta_data_channels()
    for ch in channels.get_by_appid(app.id):
        events.remove(app.id, ch.id)
        channels.delete(ch.id)
    events.remove(app.id)
    keys = registry.get_meta_data_access_keys()
    for k in keys.get_by_appid(app.id):
        keys.delete(k.key)
    registry.get_meta_data_apps().delete(app.id)


def accesskey_new(registry, app_name: str, *, key: str = "",
                  events: Sequence[str] = ()) -> Dict[str, Any]:
    app = _require_app(registry, app_name)
    new_key = registry.get_meta_data_access_keys().insert(
        AccessKey(key, app.id, tuple(events)))
    return {"accessKey": new_key, "app": app_name, "events": list(events)}


def accesskey_list(registry, app_name: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
    dao = registry.get_meta_data_access_keys()
    keys = (dao.get_by_appid(_require_app(registry, app_name).id)
            if app_name is not None else dao.get_all())
    return [{"accessKey": k.key, "appid": k.appid, "events": list(k.events)}
            for k in keys]


def import_events(registry, *, app_id: int, input_path: str,
                  channel_id: Optional[int] = None) -> Dict[str, Any]:
    """One API-JSON event per line -> the event store, in batches of
    `IMPORT_BATCH` (imprt/FileToEvents.scala:40-106); returns the count
    and the seconds it took."""
    t0 = time.perf_counter()
    store = registry.get_events()
    store.init(app_id, channel_id)
    n = 0
    batch: List[Event] = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            batch.append(Event.from_api_json(json.loads(line)))
            if len(batch) >= IMPORT_BATCH:
                store.insert_batch(batch, app_id, channel_id)
                n += len(batch)
                batch = []
    if batch:
        store.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    return {"imported": n, "seconds": time.perf_counter() - t0}


def load_variant(path: str) -> Dict[str, Any]:
    p = Path(path)
    if not p.is_file():
        raise ValueError(f"Engine variant file {path} not found")
    return json.loads(p.read_text())


def resolve_factory_name(variant: Dict[str, Any],
                         engine_factory: Optional[str],
                         engine_json: str) -> str:
    factory = engine_factory or variant.get("engineFactory")
    if not factory:
        raise ValueError(f"No engineFactory in {engine_json} and none "
                         "given (--engine-factory)")
    return factory


def build(engine_json: str = "engine.json") -> Dict[str, Any]:
    """Check that engine.json names a known engine and parses into its
    params."""
    from predictionio_tpu_torch.core.workflow import resolve_engine
    variant = load_variant(engine_json)
    factory = resolve_factory_name(variant, None, engine_json)
    resolve_engine(factory).engine_params_from_variant(variant)
    return {"message": "Engine variant is valid", "engineFactory": factory}


def train(registry, *, engine_json: str = "engine.json",
          engine_factory: Optional[str] = None, batch: str = "",
          skip_sanity_check: bool = False, stop_after_read: bool = False,
          stop_after_prepare: bool = False, device=None) -> Dict[str, Any]:
    """pio train (commands/Engine.scala:177-188): the engine.json
    variant trained through `CoreWorkflow.run_train` on `device` (None
    = cuda), recorded as an engine instance with its model blob."""
    from predictionio_tpu_torch.core.runtime import (RuntimeContext,
                                                     WorkflowParams)
    from predictionio_tpu_torch.core.workflow import (CoreWorkflow,
                                                      resolve_engine)
    variant = load_variant(engine_json)
    factory = resolve_factory_name(variant, engine_factory, engine_json)
    engine = resolve_engine(factory)
    ctx = RuntimeContext(
        registry=registry, device=device,
        workflow_params=WorkflowParams(
            batch=batch, skip_sanity_check=skip_sanity_check,
            stop_after_read=stop_after_read,
            stop_after_prepare=stop_after_prepare))
    row = CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(variant), ctx,
        engine_factory=factory, engine_variant=variant.get("id", "default"))
    return {"engineInstanceId": row.id, "status": row.status,
            "startTime": format_time(row.start_time),
            "endTime": format_time(row.end_time),
            "phaseTimings": dict(ctx.phase_timings)}


def latest_completed(registry, variant_id: str):
    """The instance `deploy` serves: the newest COMPLETED one of the
    variant (commands/Engine.scala:235-236)."""
    inst = registry.get_meta_data_engine_instances().get_latest_completed(
        "default", "default", variant_id)
    if inst is None:
        raise ValueError(
            "No valid engine instance found for this engine. Try running "
            "'train' before 'deploy' (commands/Engine.scala:235-236)")
    return inst


def deploy_target(registry, *, engine_instance_id: Optional[str] = None,
                  engine_json: str = "engine.json",
                  engine_factory: Optional[str] = None):
    """(engine, instance) that `deploy` serves: the instance named by
    id, else the latest COMPLETED instance of engine.json's variant."""
    from predictionio_tpu_torch.core.workflow import resolve_engine
    if engine_instance_id:
        inst = registry.get_meta_data_engine_instances().get(
            engine_instance_id)
        if inst is None:
            raise ValueError(
                f"Engine instance {engine_instance_id} does not exist")
        factory = engine_factory or inst.engine_factory
    else:
        variant = load_variant(engine_json)
        factory = resolve_factory_name(variant, engine_factory, engine_json)
        inst = latest_completed(registry, variant.get("id", "default"))
    return resolve_engine(factory), inst


def _resolve_dotted(dotted: str):
    """The object at 'package.module.attr', called when it is a
    callable without an `engine` (a factory of the Evaluation or the
    generator)."""
    import importlib
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"{dotted!r} is not a dotted path module.attr")
    obj = getattr(importlib.import_module(module_name), attr)
    return obj() if callable(obj) and not hasattr(obj, "engine") else obj


def run_eval(registry, evaluation_path: str,
             params_generator_path: Optional[str] = None,
             output_path: Optional[str] = None, *,
             device=None) -> Dict[str, Any]:
    """pio eval <Evaluation> [<EngineParamsGenerator>] (Console.scala's
    eval command) on `device` (None = cuda): every candidate of the
    generator (else the Evaluation's own) trained and scored per fold,
    recorded as an evaluation instance."""
    from predictionio_tpu_torch.core.evaluation import (MetricEvaluator,
                                                        run_evaluation)
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    evaluation = _resolve_dotted(evaluation_path)
    engine_params_list = None
    if params_generator_path:
        engine_params_list = _resolve_dotted(
            params_generator_path).engine_params_list
    evaluator = MetricEvaluator(evaluation.metric, evaluation.other_metrics,
                                output_path=output_path)
    row, result = run_evaluation(
        evaluation, RuntimeContext(registry=registry, device=device),
        evaluation_class=evaluation_path,
        engine_params_list=engine_params_list, evaluator=evaluator)
    return {"evaluationInstanceId": row.id, "result": result.one_liner(),
            "bestScore": result.best_score.score}


def batchpredict(registry, *, engine_json: str = "engine.json",
                 engine_factory: Optional[str] = None,
                 input_path: str = "batchpredict-input.json",
                 output_path: str = "batchpredict-output.json",
                 chunk_size: int = 1024, device=None) -> Dict[str, Any]:
    """pio batchpredict (commands/Engine.scala:279-314) with the latest
    COMPLETED instance of engine.json's variant on `device`."""
    from predictionio_tpu_torch.core.batchpredict import run_batch_predict
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    engine, instance = deploy_target(registry, engine_json=engine_json,
                                     engine_factory=engine_factory)
    n = run_batch_predict(engine, instance,
                          RuntimeContext(registry=registry, device=device),
                          input_path=input_path, output_path=output_path,
                          chunk_size=chunk_size)
    return {"engineInstanceId": instance.id, "predictions": n,
            "output": output_path}


def status(registry, variant: str = "default") -> Dict[str, Any]:
    """pio status (commands/Management.scala:99-181): the version, the
    storage sources and repositories and whether their DAOs open, the
    torch devices, and the latest COMPLETED instance of `variant` with
    its phase timings."""
    import torch

    import predictionio_tpu_torch
    info: Dict[str, Any] = {
        "version": predictionio_tpu_torch.__version__,
        "storageSources": {name: cfg.get("TYPE")
                           for name, cfg in registry.sources.items()},
        "repositories": {repo: cfg.get("SOURCE")
                         for repo, cfg in registry.repositories.items()},
    }
    try:
        registry.get_meta_data_apps().get_all()
        registry.get_meta_data_engine_instances()
        registry.get_model_data_models()
        registry.get_events()
        info["storage"] = "ok"
    except Exception as e:  # noqa: BLE001 — reported, not raised
        info["storage"] = f"error: {e}"
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(d)
                           for d in range(torch.cuda.device_count())]
        info["platform"] = "cuda"
    else:
        info["devices"], info["platform"] = [], "cpu"
    info["torch"] = torch.__version__
    info["status"] = ("(sleeping)" if info["storage"] == "ok"
                      else "storage check failed")
    try:
        latest = registry.get_meta_data_engine_instances() \
            .get_latest_completed("default", "default", variant)
    except Exception:  # noqa: BLE001 — status never fails on metadata
        latest = None
    if latest is not None:
        info["latestTrainedInstance"] = {
            "id": latest.id,
            "startTime": format_time(latest.start_time),
            "endTime": format_time(latest.end_time),
            "phaseTimings": latest.runtime_conf.get("phase_timings", {})}
    return info


def _post_server(ip: str, port: int, endpoint: str, access_key: str,
                 timeout: float) -> bool:
    """POST a lifecycle endpoint of a running prediction server. The
    server key travels as the Basic-auth username (never in the URL, so
    not in access logs). 401 raises ValueError; an unreachable server or
    another status returns False."""
    import base64
    import urllib.error
    import urllib.request
    headers = {}
    if access_key:
        headers["Authorization"] = "Basic " + base64.b64encode(
            f"{access_key}:".encode()).decode()
    req = urllib.request.Request(f"http://{ip}:{port}{endpoint}",
                                 data=b"", method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status == 200
    except urllib.error.HTTPError as e:
        if e.code == 401:
            raise ValueError(
                f"Unauthorized: the server's {endpoint} is key-protected; "
                "pass --accesskey with the server key") from e
        return False
    except OSError:
        return False


def reload_server(ip: str = "127.0.0.1", port: int = 8000,
                  access_key: str = "", timeout: float = 300.0) -> bool:
    """POST /reload: the running server loads, warms and publishes the
    latest COMPLETED instance (train + reload is the reference's cron
    redeploy recipe, examples/redeploy-script/redeploy.sh)."""
    return _post_server(ip, port, "/reload", access_key, timeout=timeout)


def undeploy(ip: str = "127.0.0.1", port: int = 8000,
             access_key: str = "") -> bool:
    """POST /stop to a running prediction server (Console undeploy)."""
    return _post_server(ip, port, "/stop", access_key, timeout=30)


# -- template scaffold (commands/Template.scala) ------------------------------

_SCAFFOLD_ENGINE = '''\
"""Custom engine scaffold. Wire your DASE components into `engine()` and
reference this module from engine.json's engineFactory
("my_engine.engine")."""

from predictionio_tpu_torch.core.base import FirstServing, IdentityPreparator
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.models.{base} import (
    {ds_class} as DataSource,
    {algo_class} as Algorithm,
)


def engine() -> Engine:
    return Engine(
        data_source=DataSource,
        preparator=IdentityPreparator,
        algorithms={{"": Algorithm}},
        serving=FirstServing,
    )
'''

SCAFFOLD_BASES = {
    "recommendation": ("RecommendationDataSource", "ALSAlgorithm"),
    "similarproduct": ("SimilarProductDataSource", "ALSAlgorithm"),
    "classification": ("ClassificationDataSource", "NaiveBayesAlgorithm"),
    "ecommerce": ("ECommDataSource", "ECommAlgorithm"),
    "twotower": ("TwoTowerDataSource", "TwoTowerAlgorithm"),
    "seqrec": ("SeqRecDataSource", "SeqRecAlgorithm"),
}


def template_new(directory: str, *, base: str = "recommendation") -> str:
    """pio template new: an engine directory with an engine.json and a
    `my_engine.py` whose `engine()` wires the base template's data
    source and algorithm; `cli build`, `train` and `deploy` run in it."""
    if base not in SCAFFOLD_BASES:
        raise ValueError(
            f"Unknown base template {base!r}; known: "
            f"{sorted(SCAFFOLD_BASES)}")
    target = Path(directory)
    if target.exists() and any(target.iterdir()):
        raise ValueError(f"Directory {directory} exists and is not empty")
    target.mkdir(parents=True, exist_ok=True)
    ds_class, algo_class = SCAFFOLD_BASES[base]
    (target / "my_engine.py").write_text(_SCAFFOLD_ENGINE.format(
        base=base, ds_class=ds_class, algo_class=algo_class))
    # the bases whose algorithm reads the event store at serve time carry
    # app_name in their algorithm params too: without it the reads would
    # target the 'default' app and answer empty
    algo_params = ({"app_name": "myapp"}
                   if base in ("ecommerce", "seqrec") else {})
    (target / "engine.json").write_text(json.dumps({
        "id": "default",
        "description": f"scaffold based on the {base} template",
        "engineFactory": "my_engine.engine",
        "datasource": {"params": {"app_name": "myapp"}},
        "algorithms": [{"name": "", "params": algo_params}],
    }, indent=2) + "\n")
    return str(target)
