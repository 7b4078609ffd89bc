"""Command implementations of the port's CLI.

The port of the lifecycle commands of `predictionio_tpu/cli/ops.py`
(commands/{App,AccessKey,Engine,Import,Export,Management}.scala): `app
new|list|show|delete|data-delete|channel-new|channel-delete`, the
serving tenancy's `app quota-set|quota-show|quota-delete`, `accesskey
new|list|delete`, `import` and `export` of events (API-JSON lines, or
parquet through pyarrow, imported when asked for), the engine.json
plumbing of `build`, `train` and `deploy`, `eval`, `batchpredict`,
`status`, `doctor` (`data/fsck.py`), the running server's `undeploy`
(POST /stop) and `reload_server` (POST /reload, `redeploy`'s second
half), and the `template new` scaffold (commands/Template.scala). Every
function but the scaffold and the two server calls takes the storage
registry it works on.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, format_time
from predictionio_tpu_torch.data.storage import (AccessKey, App, Channel,
                                                 TenantQuota)
from predictionio_tpu_torch.data.view import (require_pyarrow,
                                              write_events_parquet)

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


_QUOTA_FIELDS = ("rate", "burst", "concurrency", "queue_max", "weight")


def app_quota_set(registry, name: str, **fields) -> Dict[str, Any]:
    """Store the app's admission override: the fields given (`rate`,
    `burst`, `concurrency`, `queue_max`, `weight`) replace the stored
    ones, the rest keep theirs or inherit the PIO_TENANT_* defaults.
    Running servers read it within their admission TTL."""
    app = _require_app(registry, name)
    quotas = registry.get_meta_data_tenant_quotas()
    existing = quotas.get(app.id)
    row = {k: fields.get(k) for k in _QUOTA_FIELDS}
    if existing is not None:
        row = {k: v if v is not None else getattr(existing, k)
               for k, v in row.items()}
    quotas.upsert(TenantQuota(appid=app.id, **row))
    return app_quota_show(registry, name)


def app_quota_show(registry, name: str) -> Dict[str, Any]:
    """The app's stored override (null fields inherit the defaults)."""
    app = _require_app(registry, name)
    quota = registry.get_meta_data_tenant_quotas().get(app.id)
    return {"name": app.name, "id": app.id,
            "quota": {k: getattr(quota, k) if quota is not None else None
                      for k in _QUOTA_FIELDS},
            "note": "null fields inherit the PIO_TENANT_* defaults"}


def app_quota_delete(registry, name: str) -> None:
    """Drop the app's override; the defaults apply again."""
    app = _require_app(registry, name)
    registry.get_meta_data_tenant_quotas().delete(app.id)


def app_data_delete(registry, name: str, *,
                    channel: Optional[str] = None,
                    all_channels: bool = False,
                    force: bool = False) -> None:
    """Empty the app's default event table (or the named channel's; with
    `all_channels` every channel's too), keeping the app."""
    app = _require_app(registry, name)
    if not force:
        raise ValueError("Pass force=True (CLI: --force) to delete data")
    events = registry.get_events()
    channels = registry.get_meta_data_channels().get_by_appid(app.id)
    if channel is not None:
        match = [c for c in channels if c.name == channel]
        if not match:
            raise ValueError(f"Channel {channel} does not exist. Aborting.")
        events.remove(app.id, match[0].id)
        events.init(app.id, match[0].id)
        return
    events.remove(app.id)
    events.init(app.id)
    if all_channels:
        for c in channels:
            events.remove(app.id, c.id)
            events.init(app.id, c.id)


def channel_new(registry, app_name: str,
                channel_name: str) -> Dict[str, Any]:
    """A new channel of the app, with its event table."""
    app = _require_app(registry, app_name)
    channels = registry.get_meta_data_channels()
    if any(c.name == channel_name for c in channels.get_by_appid(app.id)):
        raise ValueError(f"Channel {channel_name} already exists. Aborting.")
    channel_id = channels.insert(Channel(0, channel_name, app.id))
    registry.get_events().init(app.id, channel_id)
    return {"app": app_name, "channel": channel_name, "id": channel_id}


def channel_delete(registry, app_name: str, channel_name: str, *,
                   force: bool = False) -> None:
    """Delete a channel with its events."""
    app = _require_app(registry, app_name)
    if not force:
        raise ValueError("Pass force=True (CLI: --force) to delete")
    channels = registry.get_meta_data_channels()
    match = [c for c in channels.get_by_appid(app.id)
             if c.name == channel_name]
    if not match:
        raise ValueError(f"Channel {channel_name} does not exist. Aborting.")
    registry.get_events().remove(app.id, match[0].id)
    channels.delete(match[0].id)


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


def accesskey_delete(registry, key: str) -> None:
    dao = registry.get_meta_data_access_keys()
    if dao.get(key) is None:
        raise ValueError(f"Access key {key} does not exist. Aborting.")
    dao.delete(key)


def import_events(registry, *, app_id: int, input_path: str,
                  channel_id: Optional[int] = None,
                  format: str = "json") -> Dict[str, Any]:
    """An events file -> the event store, in batches of `IMPORT_BATCH`
    (imprt/FileToEvents.scala:40-106): one API-JSON event per line, or
    parquet as `export_events` writes it. Returns the count and the
    seconds it took."""
    if format not in ("json", "parquet"):
        raise ValueError(f"Unknown import format {format!r} "
                         "(expected 'json' or 'parquet')")
    t0 = time.perf_counter()
    store = registry.get_events()
    store.init(app_id, channel_id)
    n = 0
    batch: List[Event] = []

    def add(e: Event) -> None:
        nonlocal n, batch
        batch.append(e)
        if len(batch) >= IMPORT_BATCH:
            store.insert_batch(batch, app_id, channel_id)
            n += len(batch)
            batch = []

    if format == "parquet":
        pa = require_pyarrow()
        for rb in pa.parquet.ParquetFile(input_path).iter_batches(
                batch_size=IMPORT_BATCH):
            for row in rb.to_pylist():
                obj = {k: v for k, v in row.items() if v is not None}
                if "properties" in obj:
                    obj["properties"] = json.loads(obj["properties"])
                add(Event.from_api_json(obj))
    else:
        with open(input_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    add(Event.from_api_json(json.loads(line)))
    if batch:
        store.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    return {"imported": n, "seconds": time.perf_counter() - t0}


def export_events(registry, *, app_id: int, output_path: str,
                  channel_id: Optional[int] = None,
                  format: str = "json") -> Dict[str, Any]:
    """The event store -> a file (export/EventsToFile.scala:40-108): one
    API-JSON event per line, or parquet with the API-JSON fields as
    columns. Returns the count and the seconds it took."""
    if format not in ("json", "parquet"):
        raise ValueError(f"Unknown export format {format!r} "
                         "(expected 'json' or 'parquet')")
    t0 = time.perf_counter()
    events = registry.get_events().find(app_id, channel_id)
    n = 0
    if format == "parquet":
        n = write_events_parquet(events, output_path)
    else:
        with open(output_path, "w") as f:
            for e in events:
                f.write(json.dumps(e.to_api_json()) + "\n")
                n += 1
    return {"exported": n, "seconds": time.perf_counter() - t0}


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
          stop_after_prepare: bool = False, device=None,
          profile_dir: Optional[str] = None, mesh: Optional[str] = None,
          coordinator: Optional[str] = None,
          num_processes: Optional[int] = None,
          process_id: Optional[int] = None) -> Dict[str, Any]:
    """pio train (commands/Engine.scala:177-188): the engine.json
    variant trained through `CoreWorkflow.run_train` on `device` (None
    = cuda), recorded as an engine instance with its model blob.

    `mesh` ("data=4", "data=2,model=2", "data=2,sp=2") goes into the
    instance's `runtime_conf`: every template trains over that mesh of
    `device`'s kind (each over the axes it shards, replicated over the
    others), and a deploy of the instance serves through the sharded
    plan. Multi-process:
    `coordinator` host:port with `num_processes` and `process_id` (or
    the PIO_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID env vars)
    join a `torch.distributed` group before the mesh is built; every
    process trains, only process 0 writes the instance and the blob
    (the env-forwarding spark-submit analog, Runner.scala:213-215,
    298-305); the report's `distributed` and `persisted` say which.

    `profile_dir` (or PIO_TPU_PROFILE_DIR) wraps the whole run in
    `torch.profiler.profile` with CPU activity, and CUDA activity where
    CUDA is available, and writes its Chrome trace into that directory
    as `pio-train-<pid>-<ms>.pt.trace.json` (the JAX package's
    `jax.profiler.trace`). The report's `kernelBuilds` counts this run's
    nvcc builds (`obs.kernelprobe`), where the JAX report has
    `jaxCompiles`."""
    import contextlib

    from predictionio_tpu_torch.core.runtime import (RuntimeContext,
                                                     WorkflowParams)
    from predictionio_tpu_torch.core.workflow import (CoreWorkflow,
                                                      resolve_engine)
    from predictionio_tpu_torch.obs import build_count, install_kernel_probe
    from predictionio_tpu_torch.parallel import initialize_distributed
    # flags override env inside initialize_distributed; nothing is
    # written back to os.environ
    distributed = initialize_distributed(
        coordinator=coordinator, num_processes=num_processes,
        process_id=process_id, device=device)
    persist = True
    if distributed:
        import torch.distributed as dist
        persist = dist.get_rank() == 0
    variant = load_variant(engine_json)
    factory = resolve_factory_name(variant, engine_factory, engine_json)
    engine = resolve_engine(factory)
    ctx = RuntimeContext(
        registry=registry, device=device,
        workflow_params=WorkflowParams(
            batch=batch, skip_sanity_check=skip_sanity_check,
            stop_after_read=stop_after_read,
            stop_after_prepare=stop_after_prepare,
            runtime_conf={"mesh": mesh} if mesh else {}))
    profile_dir = profile_dir or os.environ.get("PIO_TPU_PROFILE_DIR")
    prof = None
    if profile_dir:
        import torch
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    # this run's builds, not the process's
    install_kernel_probe()
    builds_before = build_count()
    with (prof if prof is not None else contextlib.nullcontext()):
        row = CoreWorkflow.run_train(
            engine, engine.engine_params_from_variant(variant), ctx,
            engine_factory=factory,
            engine_variant=variant.get("id", "default"), persist=persist)
    if prof is not None:
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(
            out / f"pio-train-{os.getpid()}-{int(time.time() * 1000)}"
                  ".pt.trace.json"))
    return {"engineInstanceId": row.id, "status": row.status,
            "startTime": format_time(row.start_time),
            "endTime": format_time(row.end_time),
            "phaseTimings": dict(ctx.phase_timings),
            "kernelBuilds": int(build_count() - builds_before),
            "distributed": distributed, "persisted": persist}


def latest_completed(registry, variant_id: str):
    """The instance `deploy` serves: the newest COMPLETED one of the
    variant (commands/Engine.scala:235-236). An instance whose blob
    `doctor --repair` quarantined is still the newest, as in the JAX
    package: its deploy fails, and the operator names an intact one
    with `--engine-instance-id`."""
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


def doctor(registry, *, repair: bool = False,
           stale_after_s: Optional[float] = None) -> Dict[str, Any]:
    """`pio doctor`: the store-wide fsck, the stale-instance janitor and
    the breakers' states; with `repair` it quarantines, truncates,
    rebuilds and fails what it finds."""
    from predictionio_tpu_torch.data import fsck
    return fsck.doctor(
        registry, repair=repair,
        stale_after_s=(stale_after_s if stale_after_s is not None
                       else fsck.DEFAULT_STALE_S))


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
