"""Command line of the port: PredictionIO's lifecycle.

    python -m predictionio_tpu_torch.cli app new MyApp
    python -m predictionio_tpu_torch.cli import --appid 1 --input events.jsonl
    python -m predictionio_tpu_torch.cli build [--engine-json engine.json]
    python -m predictionio_tpu_torch.cli train [--engine-json engine.json] \
        [--stop-after-read | --stop-after-prepare] [--skip-sanity-check] \
        [--device cpu]
    python -m predictionio_tpu_torch.cli deploy [--engine-instance-id ID] \
        [--port 8000] [--batch-max 64] [--batch-window-ms 2] \
        [--items-on-host] [--device cpu] [--refresh-interval SECONDS] \
        [--server-key KEY] [--feedback --accesskey KEY \
        [--event-server-ip localhost] [--event-server-port 7070]]
    python -m predictionio_tpu_torch.cli undeploy [--ip 127.0.0.1] \
        [--port 8000] [--accesskey SERVER_KEY]
    python -m predictionio_tpu_torch.cli redeploy [--engine-json engine.json] \
        [--ip 127.0.0.1] [--port 8000] [--accesskey SERVER_KEY] [--device cpu]
    python -m predictionio_tpu_torch.cli status
    python -m predictionio_tpu_torch.cli version
    python -m predictionio_tpu_torch.cli eventserver [--ip 0.0.0.0] \
        [--port 7070] [--stats]
    python -m predictionio_tpu_torch.cli eval my.module.MyEvaluation \
        [my.module.MyEngineParamsGenerator] [--output-path result.json] \
        [--device cpu]
    python -m predictionio_tpu_torch.cli batchpredict [--input queries.json] \
        [--output predictions.json] [--query-partitions 1024] [--device cpu]
    python -m predictionio_tpu_torch.cli template new DIR \
        [--base recommendation|similarproduct|classification|ecommerce|
                twotower|seqrec]

Storage comes from `PIO_STORAGE_*` (or a `pio-env` file); without any,
one sqlite file at `./.pio_store/pio.db`, the JAX package's default.
`train` reads the app's events, trains the engine.json variant and
records an engine instance with its model blob; it prints the instance
id, status, times and phase timings as JSON on stdout. `deploy` serves
the latest COMPLETED instance of the variant (or the one named) on
`/queries.json`; `GET /` shows the instance id and the kernel's launch
counts. `deploy --model m.npz` serves a model file
(`ops.als.ALSModel.save_npz`) instead. `train` and `deploy` run on CUDA
unless `--device cpu` is given, and refuse to start without CUDA
otherwise. `--items-on-host` keeps the item master in host RAM, so that
a catalog past the card's budget tiers (or, over two or more cards,
shards) instead of being loaded whole onto one card.
`--refresh-interval` (seconds, default 0 = off) keeps a deployed
instance fresh: a refresher thread folds the events appended since the
last tick into the served model (a delta-capable event store, PEVLOG,
is needed; SQLITE retrains in full on a change) and swaps the new item
factors into the warmed plan. `--feedback` posts every served
prediction back to the event server (`--event-server-ip`,
`--event-server-port`, `--accesskey`) as a `predict` event.
`--server-key` (else `PIO_SERVER_ACCESS_KEY` of the storage config, the
JAX name) guards the server's `/reload` and `/stop`; the JAX deploy's
`--accesskey` is the feedback key here too, so the server key has a
flag of its own. `--batch-window-ms` is the micro-batcher's window.
`PIO_SERVER_SSL_CERT` and `PIO_SERVER_SSL_KEY` serve TLS (on the
threaded wire); `PIO_SERVE_WIRE=threaded` picks that wire without TLS.
The deploy process exits 0 on SIGTERM or after `/stop`.

`undeploy` POSTs `/stop` to a running server (the server key as
`--accesskey`); `redeploy` trains engine.json's variant, then POSTs
`/reload` (the reference's cron recipe); `status` prints the version,
the storage and the devices; `version` the port's version.

`eventserver` serves the REST event API (`/events.json`,
`/batch/events.json`, webhooks, `/stats.json` with `--stats`) over the
configured event store until SIGTERM. `eval` runs an `Evaluation` over
its candidates (or those of the `EngineParamsGenerator` named) on the
card, records an evaluation instance, and prints its id, the result line
and the best score. `batchpredict` answers a file of JSON queries, one
per line, with the latest COMPLETED instance of engine.json's variant,
through the warmed serving plan, into one JSON line per query.
`template new` scaffolds an engine directory (engine.json and a
`my_engine.py` over one of the six bundled templates) to run `build`,
`train` and `deploy` in.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
from typing import Optional, Sequence

from predictionio_tpu_torch.cli import ops
from predictionio_tpu_torch.core.base import TrainingInterrupted
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow, prepare_deploy
from predictionio_tpu_torch.models.recommendation import RecommendationEngine
from predictionio_tpu_torch.obs import train_report
from predictionio_tpu_torch.ops.als import ALSModel, load_npz
from predictionio_tpu_torch.serving.server import (FeedbackConfig,
                                                   PredictionServer,
                                                   _Deployment,
                                                   install_signal_handlers)
from predictionio_tpu_torch.utils.security import ssl_context_from_config


def _emit(obj) -> None:
    print(json.dumps(obj, indent=2, default=str), flush=True)


def deploy(model: ALSModel, *, host: str = "127.0.0.1", port: int = 8000,
           batch_max: int = 64, window_s: float = 0.002,
           mesh=None, feedback: Optional[FeedbackConfig] = None,
           **server_kw) -> PredictionServer:
    """Warm `model` for serving (kernel built, every bucket up to
    `batch_max` launched once) and start a `PredictionServer` on it in a
    background thread; returns the running server. `mesh`, an
    `ops.topk_sharded.ServeMesh`, shards the catalog over its devices
    (`ServeMesh((torch.device("cuda", 0),) * 3, forced=True)` serves
    three shards from one card); None shards only over two or more
    local cards, as `serve_mesh_from_conf` decides. A sharded or tiered
    plan takes the device state: `model.item_factors` is moved to host
    RAM (`ALSAlgorithm.warm_serving`). `feedback` posts every served
    prediction to an event server; `server_kw` go to `PredictionServer`
    (`server_key`, `max_inflight`, `wire`, `plugins`, `metrics`, ...)."""
    algos, models, serving = prepare_deploy(
        RecommendationEngine.apply(), [model], warm_batch_max=batch_max,
        mesh=mesh)
    return _start(_Deployment(algos, models, serving), host, port,
                  batch_max, window_s, feedback=feedback, **server_kw)


def deploy_instance(engine, instance, ctx: RuntimeContext, *,
                    host: str = "127.0.0.1", port: int = 8000,
                    batch_max: int = 64, window_s: float = 0.002,
                    items_device=None, refresh_interval_s: float = 0.0,
                    feedback: Optional[FeedbackConfig] = None,
                    **server_kw) -> PredictionServer:
    """Serve an engine instance: its models read back from the model
    store (`CoreWorkflow.prepare_deploy`) onto `ctx.device`, warmed as
    `deploy` warms a model, behind a started `PredictionServer`, whose
    `GET /` shows the instance id and the deploy's load, place and warm
    seconds. `refresh_interval_s` > 0 runs the streaming refresher;
    `feedback` posts every served prediction to an event server;
    `server_kw` go to `PredictionServer`. Its `/reload` loads the
    variant's latest COMPLETED instance the same way."""
    timings: dict = {}
    algos, models, serving = CoreWorkflow.prepare_deploy(
        engine, instance, ctx, warm_batch_max=batch_max,
        items_device=items_device, timings=timings)
    return _start(_Deployment(algos, models, serving, engine=engine,
                              instance=instance, timings=timings),
                  host, port, batch_max, window_s, ctx=ctx,
                  refresh_interval_s=refresh_interval_s, feedback=feedback,
                  items_device=items_device, **server_kw)


def _start(dep: _Deployment, host: str, port: int, batch_max: int,
           window_s: float, **kw) -> PredictionServer:
    server = PredictionServer(dep, host=host, port=port, batch_max=batch_max,
                              window_s=window_s, **kw)
    server.start()
    return server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="predictionio_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    app = sub.add_parser("app", help="manage apps").add_subparsers(
        dest="app_command", required=True)
    x = app.add_parser("new")
    x.add_argument("name")
    x.add_argument("--description")
    x.add_argument("--access-key", default="")
    app.add_parser("list")
    x = app.add_parser("show")
    x.add_argument("name")
    x = app.add_parser("delete")
    x.add_argument("name")
    x.add_argument("--force", "-f", action="store_true")
    ak = sub.add_parser("accesskey", help="manage access keys"
                        ).add_subparsers(dest="ak_command", required=True)
    x = ak.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("--key", default="")
    x.add_argument("--events", nargs="*", default=[])
    x = ak.add_parser("list")
    x.add_argument("app_name", nargs="?")
    x = sub.add_parser("import", help="import API-JSON event lines")
    x.add_argument("--appid", type=int, required=True)
    x.add_argument("--channel", type=int, default=None)
    x.add_argument("--input", required=True)
    x = sub.add_parser("build", help="validate the engine variant")
    x.add_argument("--engine-json", default="engine.json")
    x = sub.add_parser("train", help="train and record an engine instance")
    x.add_argument("--engine-json", default="engine.json")
    x.add_argument("--engine-factory")
    x.add_argument("--batch", default="")
    x.add_argument("--skip-sanity-check", action="store_true")
    x.add_argument("--stop-after-read", action="store_true")
    x.add_argument("--stop-after-prepare", action="store_true")
    x.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    x = sub.add_parser("deploy", help="serve /queries.json")
    x.add_argument("--engine-instance-id")
    x.add_argument("--engine-json", default="engine.json")
    x.add_argument("--engine-factory")
    x.add_argument("--model", help="serve this model .npz file instead of "
                                   "an engine instance")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    x.add_argument("--batch-max", type=int, default=64)
    x.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="the micro-batcher's window")
    x.add_argument("--server-key", default=None,
                   help="key guarding /reload and /stop (default: "
                        "PIO_SERVER_ACCESS_KEY)")
    x.add_argument("--items-on-host", action="store_true",
                   help="keep the item factors in host RAM; the serving "
                        "plan places what it needs on the device")
    x.add_argument("--refresh-interval", type=float, default=0.0,
                   help="seconds between streaming fold-in ticks "
                        "(0 = off)")
    x.add_argument("--feedback", action="store_true",
                   help="post every served prediction to the event "
                        "server as a predict event")
    x.add_argument("--event-server-ip", default="localhost")
    x.add_argument("--event-server-port", type=int, default=7070)
    x.add_argument("--accesskey", default="")
    x = sub.add_parser("undeploy", help="POST /stop to a running server")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--accesskey", default="",
                   help="the server key when /stop is key-protected")
    x = sub.add_parser("redeploy", help="train, then POST /reload to the "
                                        "running server")
    x.add_argument("--engine-json", default="engine.json")
    x.add_argument("--engine-factory")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--accesskey", default="",
                   help="the server key when /reload is key-protected")
    x.add_argument("--device", default=None,
                   help="torch device of the train (default cuda)")
    x = sub.add_parser("status", help="version, storage and devices")
    x.add_argument("--engine-json", default="engine.json")
    sub.add_parser("version", help="the port's version")
    x = sub.add_parser("eventserver", help="serve the REST event API")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=7070)
    x.add_argument("--stats", action="store_true")
    x = sub.add_parser("eval", help="evaluate and tune engine params")
    x.add_argument("evaluation", help="dotted path to an Evaluation")
    x.add_argument("params_generator", nargs="?",
                   help="dotted path to an EngineParamsGenerator")
    x.add_argument("--output-path")
    x.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    x = sub.add_parser("batchpredict", help="answer a file of queries")
    x.add_argument("--engine-json", default="engine.json")
    x.add_argument("--engine-factory")
    x.add_argument("--input", default="batchpredict-input.json")
    x.add_argument("--output", default="batchpredict-output.json")
    x.add_argument("--query-partitions", type=int, default=1024,
                   help="queries per device batch chunk")
    x.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    x = sub.add_parser("template", help="scaffold a new engine directory")
    x.add_argument("template_command", choices=["new"])
    x.add_argument("directory")
    x.add_argument("--base", default="recommendation",
                   choices=sorted(ops.SCAFFOLD_BASES),
                   help="bundled template the scaffold is based on")
    return p


def _registry():
    from predictionio_tpu_torch.data.storage import storage
    return storage()


def _app(args) -> None:
    registry = _registry()
    c = args.app_command
    if c == "new":
        _emit(ops.app_new(registry, args.name, description=args.description,
                          access_key=args.access_key))
    elif c == "list":
        _emit(ops.app_list(registry))
    elif c == "show":
        _emit(ops.app_show(registry, args.name))
    else:
        ops.app_delete(registry, args.name, force=args.force)
        _emit({"message": f"App {args.name} deleted"})


def _wait_for_sigterm() -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()


def _deploy(args) -> int:
    items_device = "cpu" if args.items_on_host else None
    feedback = FeedbackConfig(
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey) if args.feedback else None
    registry = _registry()
    server_kw = dict(
        window_s=args.batch_window_ms / 1000.0, feedback=feedback,
        server_key=(args.server_key if args.server_key is not None else
                    registry.config.get("PIO_SERVER_ACCESS_KEY", "")),
        ssl_context=ssl_context_from_config(registry.config))
    if args.model:
        model = load_npz(args.model, device=args.device,
                         items_device=items_device)
        server = deploy(model, host=args.ip, port=args.port,
                        batch_max=args.batch_max, **server_kw)
        what, dev = args.model, model.device
    else:
        engine, inst = ops.deploy_target(
            registry, engine_instance_id=args.engine_instance_id,
            engine_json=args.engine_json, engine_factory=args.engine_factory)
        server = deploy_instance(
            engine, inst, RuntimeContext(registry=registry,
                                         device=args.device),
            host=args.ip, port=args.port, batch_max=args.batch_max,
            items_device=items_device,
            refresh_interval_s=args.refresh_interval, **server_kw)
        what = f"engine instance {inst.id}"
        dev = ", ".join(sorted({str(m.device)
                                for m in server.deployment.models
                                if hasattr(m, "device")}))
    print(f"serving {what} on http://{args.ip}:{server.port} ({dev})",
          flush=True)
    # SIGTERM, SIGINT and POST /stop all end in the graceful stop()
    install_signal_handlers(server)
    server.stopped.wait()
    return 0


def _eventserver(args) -> int:
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    server = EventServer(EventServerConfig(ip=args.ip, port=args.port,
                                           stats=args.stats), _registry())
    port = server.start()
    print(f"Event server started on {args.ip}:{port}", flush=True)
    _wait_for_sigterm()
    server.shutdown()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cmd = args.command
    try:
        if cmd == "app":
            _app(args)
        elif cmd == "accesskey":
            if args.ak_command == "new":
                _emit(ops.accesskey_new(_registry(), args.app_name,
                                        key=args.key, events=args.events))
            else:
                _emit(ops.accesskey_list(_registry(), args.app_name))
        elif cmd == "import":
            _emit(ops.import_events(_registry(), app_id=args.appid,
                                    input_path=args.input,
                                    channel_id=args.channel))
        elif cmd == "build":
            _emit(ops.build(args.engine_json))
        elif cmd == "eval":
            _emit(ops.run_eval(_registry(), args.evaluation,
                               args.params_generator, args.output_path,
                               device=args.device))
        elif cmd == "batchpredict":
            _emit(ops.batchpredict(
                _registry(), engine_json=args.engine_json,
                engine_factory=args.engine_factory, input_path=args.input,
                output_path=args.output, chunk_size=args.query_partitions,
                device=args.device))
        elif cmd == "eventserver":
            return _eventserver(args)
        elif cmd == "undeploy":
            ok = ops.undeploy(args.ip, args.port, access_key=args.accesskey)
            print("Undeployed" if ok else "No server responded", flush=True)
            return 0 if ok else 1
        elif cmd == "redeploy":
            _emit(ops.train(_registry(), engine_json=args.engine_json,
                            engine_factory=args.engine_factory,
                            device=args.device))
            ok = ops.reload_server(args.ip, args.port,
                                   access_key=args.accesskey)
            print("Reloaded" if ok
                  else "Trained, but no server responded to /reload",
                  flush=True)
            return 0 if ok else 1
        elif cmd == "status":
            variant = "default"
            try:
                variant = ops.load_variant(args.engine_json).get(
                    "id", "default")
            except ValueError:
                pass
            _emit(ops.status(_registry(), variant))
        elif cmd == "version":
            import predictionio_tpu_torch
            print(predictionio_tpu_torch.__version__)
        elif cmd == "template":
            path = ops.template_new(args.directory, base=args.base)
            _emit({"message": f"Engine scaffold created at {path}",
                   "next": "edit engine.json, then: build && train"})
        elif cmd == "train":
            try:
                _emit(ops.train(
                    _registry(), engine_json=args.engine_json,
                    engine_factory=args.engine_factory, batch=args.batch,
                    skip_sanity_check=args.skip_sanity_check,
                    stop_after_read=args.stop_after_read,
                    stop_after_prepare=args.stop_after_prepare,
                    device=args.device))
            except TrainingInterrupted as e:
                # the reference ends a stop-after run normally; the
                # instance stays FAILED, so deploy never serves it
                _emit({"interrupted": type(e).__name__})
            else:
                print(train_report(), file=sys.stderr, flush=True)
        else:
            return _deploy(args)
        return 0
    except (ValueError, OSError) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
