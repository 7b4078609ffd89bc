"""Command line of the port: PredictionIO's lifecycle.

    python -m predictionio_tpu_torch.cli app new MyApp
    python -m predictionio_tpu_torch.cli app quota-set MyApp [--rate R] \
        [--burst B] [--concurrency C] [--queue-max Q] [--weight W]
    python -m predictionio_tpu_torch.cli app quota-show|quota-delete MyApp
    python -m predictionio_tpu_torch.cli app data-delete MyApp \
        [--channel NAME] [--all] --force
    python -m predictionio_tpu_torch.cli app channel-new MyApp NAME
    python -m predictionio_tpu_torch.cli app channel-delete MyApp NAME --force
    python -m predictionio_tpu_torch.cli accesskey delete KEY
    python -m predictionio_tpu_torch.cli import --appid 1 [--channel ID] \
        --input events.jsonl [--format json|parquet]
    python -m predictionio_tpu_torch.cli export --appid 1 [--channel ID] \
        --output events.jsonl [--format json|parquet]
    python -m predictionio_tpu_torch.cli doctor [--repair] \
        [--stale-after SECONDS]
    python -m predictionio_tpu_torch.cli build [--engine-json engine.json]
    python -m predictionio_tpu_torch.cli train [--engine-json engine.json] \
        [--stop-after-read | --stop-after-prepare] [--skip-sanity-check] \
        [--device cpu] [--profile-dir DIR]
    python -m predictionio_tpu_torch.cli deploy [--engine-instance-id ID] \
        [--port 8000] [--batch-max 64] [--batch-window-ms 2] \
        [--items-on-host] [--device cpu] [--refresh-interval SECONDS] \
        [--server-key KEY] [--feedback --accesskey KEY \
        [--event-server-ip localhost] [--event-server-port 7070]] \
        [--replicas N | --supervised N | --standby | --join URL[,URL]] \
        [--advertise HOST:PORT] [--member-name NAME] \
        [--autoscale on|off] [--autoscale-min N] [--autoscale-max N] \
        [--mesh items=N@fleet[:i]] [--tenancy on|off] [--tenant-rate R] \
        [--tenant-burst B] [--tenant-concurrency C] [--tenant-queue-max Q] \
        [--quality on|off] [--attribution-s S] [--canary-sample N] \
        [--canary-min-overlap F]
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
    python -m predictionio_tpu_torch.cli ingestd [--ip 0.0.0.0] \
        [--port 7200] [--block-rows 65536] [--workers N] \
        [--join URL[,URL]] [--advertise HOST:PORT]
    python -m predictionio_tpu_torch.cli run my.module.function
    python -m predictionio_tpu_torch.cli shell
    python -m predictionio_tpu_torch.cli loadsim -- --scenario NAME|FILE \
        --port P [--port P2] [--key KEY] [--seed S] [--scale F] \
        [--dry-run] [--timeout S] [--samples FILE]
    python -m predictionio_tpu_torch.cli chaos list
    python -m predictionio_tpu_torch.cli chaos run NAME|all [--json] \
        [--device cpu]
    python -m predictionio_tpu_torch.cli dashboard [--ip 127.0.0.1] \
        [--port 9000]
    python -m predictionio_tpu_torch.cli adminserver [--ip 127.0.0.1] \
        [--port 7071]
    python -m predictionio_tpu_torch.cli top [--host 127.0.0.1] \
        [--port 8000] [--watch SECONDS]
    python -m predictionio_tpu_torch.cli start-all [--ip 127.0.0.1] \
        [--event-server-port 7070] [--dashboard-port 9000] \
        [--admin-port 7071] [--pid-dir DIR] [--log-dir DIR]
    python -m predictionio_tpu_torch.cli stop-all [--pid-dir DIR]
    python -m predictionio_tpu_torch.cli daemon --name NAME [--pid-dir DIR] \
        [--log-dir DIR] -- SUBCOMMAND [ARGS]

Storage comes from `PIO_STORAGE_*` (or a `pio-env` file); without any,
one sqlite file at `./.pio_store/pio.db`, the JAX package's default.
`train` reads the app's events, trains the engine.json variant and
records an engine instance with its model blob; it prints the instance
id, status, times, phase timings and the run's kernel builds
(`kernelBuilds`) as JSON on stdout; `--profile-dir DIR` (or
`PIO_TPU_PROFILE_DIR`) also writes a `torch.profiler` Chrome trace of
the run into DIR. `deploy` serves
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
`--replicas N` (N > 1, or 0 for a router fed by `--join` members) serves
through a fleet router (`serving/fleet.py`) in front of N in-process
replicas; `--supervised N` runs the N replicas as child processes of a
router (`serving/supervisor.py`), each a `deploy --join` of this CLI;
`--standby` starts a router with no replicas that takes the leader lease
when the leader's expires; `--join URL[,URL]` starts a replica that
registers with those routers and heartbeats (`--advertise`, the address
they reach it at; `--member-name`, its name). `--mesh items=N@fleet` on
a router merges N catalog slices, served by in-process replica i (or
supervised child i) as slice i % N; `--mesh items=N@fleet:i` makes a
`--join` member serve slice i. `PIO_FLEET_LEASE_TTL_S`,
`PIO_FLEET_HEARTBEAT_S` and `PIO_FLEET_SUSPECT_N` tune the fleet.
`--autoscale on` (default `PIO_AUTOSCALE`, off) with `--supervised N`
lets the router grow and retire child processes off its own tsdb ring
(`serving/autoscaler.py`) within [`--autoscale-min`, `--autoscale-max`]
(`PIO_AUTOSCALE_MIN`, `PIO_AUTOSCALE_MAX`; thresholds and damping from
the other `PIO_AUTOSCALE_*`); a grown child is named `scale<n>`.
`loadsim -- ...` replays a scenario open loop against servers
(`tools/loadsim.py`; `-- --help` lists its flags).
`--tenancy on` authenticates `/queries.json` with the app access keys and
enforces per-app quotas (429 with Retry-After) and weighted-fair
batching; `--tenant-*` set the defaults (`PIO_TENANT_*`), `app quota-set`
an app's own override, which servers read within 10 s.
`--quality on|off` (default `PIO_QUALITY`, on) keeps score sketches and
drift per app on the serve path (`/quality.json`), joins `--feedback`'s
events back to their predictions within `--attribution-s` (default
`PIO_ATTRIBUTION_S`, 300), and runs the reload canary: `--canary-sample`
kept traces (default `PIO_CANARY_SAMPLE`, 16; 0 turns it off) replayed
through the old and the new model, and a reload refused below
`--canary-min-overlap` (default `PIO_CANARY_MIN_OVERLAP`, 0: report
only).
`--server-key` (else `PIO_SERVER_ACCESS_KEY` of the storage config, the
JAX name) guards the server's `/reload` and `/stop` (on a fleet, its
membership routes too) and signs a router's tenant header and the
`X-PIO-Trace` headers of traced requests; the JAX deploy's
`--accesskey` is the feedback key here too, so the server key has a
flag of its own. `--batch-window-ms` is the micro-batcher's window.
`PIO_TRACE_SAMPLE` (a fraction; 0, the default, is off) traces requests
into each server's `/traces.json`; every server also answers
`/tsdb.json` (`PIO_TSDB_INTERVAL_S`, default 5 s) and `/profile.json`,
`/profile.txt` (`PIO_PROF_HZ`, default 19). `PIO_SERVER_SSL_CERT` and
`PIO_SERVER_SSL_KEY` serve TLS (on the
threaded wire); `PIO_SERVE_WIRE=threaded` picks that wire without TLS.
The deploy process exits 0 on SIGTERM or after `/stop`.

`doctor` runs the store-wide fsck (corrupt model blobs, torn journal
tails, stale sidecars, diverging replicas) and the stale-instance
janitor and prints the report with the breakers' states; `--repair`
quarantines, truncates, rebuilds and fails what it finds, and
`--stale-after` (default 900 s) is how old an INIT or TRAINING row's
heartbeat may grow. `export` writes an app's (or channel's) events to a
file, `import --format parquet` and `export --format parquet` need
pyarrow.

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

`ingestd` serves the configured event store's columnar scans as
CRC-framed column blocks (`ingest/service.py`) until SIGTERM; it is a
host service and takes no device. A `train`, `deploy --refresh-interval`
or `run` given `PIO_INGEST_SERVICE=host:port[,host:port]` scans through
it and falls back to its own scan if none answers, unless
`PIO_INGEST_FALLBACK=off`. `--block-rows` sizes its blocks, `--workers`
its PEVLOG scan pool; `--join` registers it with fleet routers as a
member of role `ingest`, which beats and is never routed queries.
`chaos list` prints the chaos drills (`resilience/scenarios.py`) and
`chaos run NAME|all` runs them against loopback servers of a tiny model
trained on the card (`--device cpu` trains and serves on the CPU); a
report per drill (`--json`: one JSON list), exit 1 on any violated
invariant, 2 on an unknown name. `dashboard` serves the completed
evaluations, `/metrics.html` and `/traces.html` (`tools/dashboard.py`);
`adminserver` the app CRUD API on `/cmd/app` (`tools/admin.py`); `top`
prints a running server's vitals from its `/tsdb.json`, `/profile.json`
and `/quality.json` (`--watch N` redraws every N seconds). `start-all`
starts the event server, the dashboard and the admin server as daemons
of this CLI with pidfiles (`cli/service.py`; default run and log
directories `~/.pio_store/run` and `~/.pio_store/log`), `daemon` any
subcommand so, and `stop-all` stops every pidfile's daemon whose
command line names this package. These are host services and take no
device.
`run` calls a function by its dotted path (the working directory is on
the import path) with the storage configured and prints what it returns
as JSON; `shell` is an interactive Python with `registry`, `events` (the
event store) and the port's `core`, `data`, `models` and `ops`
preloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import sys
import threading
from typing import TYPE_CHECKING, Optional, Sequence

from predictionio_tpu_torch.cli import ops
from predictionio_tpu_torch.core.base import TrainingInterrupted
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.obs import trace, train_report
from predictionio_tpu_torch.serving.server import (FeedbackConfig,
                                                   PredictionServer,
                                                   _Deployment,
                                                   install_signal_handlers)
from predictionio_tpu_torch.tenancy import TenancyConfig
from predictionio_tpu_torch.utils.security import ssl_context_from_config

if TYPE_CHECKING:    # torch loads with the commands that need it
    from predictionio_tpu_torch.ops.als import ALSModel


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
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.models.recommendation import \
        RecommendationEngine
    algos, models, serving = prepare_deploy(
        RecommendationEngine.apply(), [model], warm_batch_max=batch_max,
        mesh=mesh)
    return _start(_Deployment(algos, models, serving), host, port,
                  batch_max, window_s, feedback=feedback, mesh=mesh,
                  **server_kw)


def deploy_instance(engine, instance, ctx: RuntimeContext, *,
                    host: str = "127.0.0.1", port: int = 8000,
                    batch_max: int = 64, window_s: float = 0.002,
                    items_device=None, refresh_interval_s: float = 0.0,
                    feedback: Optional[FeedbackConfig] = None, mesh=None,
                    **server_kw) -> PredictionServer:
    """Serve an engine instance: its models read back from the model
    store (`CoreWorkflow.prepare_deploy`) onto `ctx.device`, warmed as
    `deploy` warms a model, behind a started `PredictionServer`, whose
    `GET /` shows the instance id and the deploy's load, place and warm
    seconds. `refresh_interval_s` > 0 runs the streaming refresher;
    `feedback` posts every served prediction to an event server;
    `mesh`, a `ShardSlice(n, i)`, serves catalog slice i of n (a fleet
    member) or, a `ServeMesh`, shards it; `server_kw` go to
    `PredictionServer`. Its `/reload` loads the variant's latest
    COMPLETED instance the same way, over the same `mesh`."""
    timings: dict = {}
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    algos, models, serving = CoreWorkflow.prepare_deploy(
        engine, instance, ctx, warm_batch_max=batch_max,
        items_device=items_device, timings=timings, mesh=mesh)
    return _start(_Deployment(algos, models, serving, engine=engine,
                              instance=instance, timings=timings),
                  host, port, batch_max, window_s, ctx=ctx,
                  refresh_interval_s=refresh_interval_s, feedback=feedback,
                  items_device=items_device, mesh=mesh, **server_kw)


def fleet_replica_factory(engine, instance, ctx: RuntimeContext,
                          **deploy_kw):
    """A `FleetServer` replica factory over `deploy_instance`: replica i
    loads `instance` from `ctx`'s store, warms its plan over its `mesh`
    (a `ShardSlice`, or None for the whole catalog) and serves on a
    loopback ephemeral port with the router's replica `tenancy`.
    `deploy_kw` go to `deploy_instance` (batch_max, window_s,
    items_device, server_key, metrics, ...)."""
    def make(index: int, *, mesh=None, tenancy=None) -> PredictionServer:
        return deploy_instance(engine, instance, ctx, host="127.0.0.1",
                               port=0, mesh=mesh, tenancy=tenancy,
                               startup_check=False, **deploy_kw)
    return make


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
    x = app.add_parser("quota-set", help="store an app's serving "
                       "admission override; unset fields inherit the "
                       "PIO_TENANT_* defaults")
    x.add_argument("name")
    x.add_argument("--rate", type=float,
                   help="token-bucket refill, requests/second")
    x.add_argument("--burst", type=float,
                   help="token-bucket capacity, requests")
    x.add_argument("--concurrency", type=int,
                   help="in-flight cap (0 = unlimited)")
    x.add_argument("--queue-max", type=int,
                   help="per-app micro-batch lane cap")
    x.add_argument("--weight", type=float,
                   help="weighted-fair drain weight (default 1.0)")
    for cmd in ("quota-show", "quota-delete"):
        app.add_parser(cmd).add_argument("name")
    x = app.add_parser("data-delete", help="delete an app's events")
    x.add_argument("name")
    x.add_argument("--channel")
    x.add_argument("--all", action="store_true")
    x.add_argument("--force", "-f", action="store_true")
    x = app.add_parser("channel-new")
    x.add_argument("app_name")
    x.add_argument("channel_name")
    x = app.add_parser("channel-delete")
    x.add_argument("app_name")
    x.add_argument("channel_name")
    x.add_argument("--force", "-f", action="store_true")
    ak = sub.add_parser("accesskey", help="manage access keys"
                        ).add_subparsers(dest="ak_command", required=True)
    x = ak.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("--key", default="")
    x.add_argument("--events", nargs="*", default=[])
    x = ak.add_parser("list")
    x.add_argument("app_name", nargs="?")
    ak.add_parser("delete").add_argument("key")
    x = sub.add_parser("import", help="import an events file")
    x.add_argument("--appid", type=int, required=True)
    x.add_argument("--channel", type=int, default=None)
    x.add_argument("--input", required=True)
    x.add_argument("--format", choices=["json", "parquet"], default="json")
    x = sub.add_parser("export", help="export an app's events to a file")
    x.add_argument("--appid", type=int, required=True)
    x.add_argument("--channel", type=int, default=None)
    x.add_argument("--output", required=True)
    x.add_argument("--format", choices=["json", "parquet"], default="json")
    x = sub.add_parser("doctor", help="fsck every bound store and fail "
                       "stale instances; --repair to act")
    x.add_argument("--repair", action="store_true",
                   help="quarantine, truncate, rebuild and fail instead "
                        "of only reporting")
    x.add_argument("--stale-after", type=float, default=None,
                   help="seconds before an INIT/TRAINING instance with no "
                        "heartbeat counts as dead (default 900)")
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
    x.add_argument("--profile-dir",
                   help="write a torch.profiler trace of the run here (a "
                        "Chrome trace, CPU and CUDA activity); or set "
                        "PIO_TPU_PROFILE_DIR")
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
    x.add_argument("--replicas", type=int, default=1,
                   help="replicas behind a fleet router (> 1; 0 = a "
                        "router fed by --join members)")
    x.add_argument("--supervised", type=int, default=0, metavar="N",
                   help="run N replicas as supervised child processes "
                        "of a fleet router")
    x.add_argument("--standby", action="store_true",
                   help="a standby router: no replicas, takes the "
                        "leader lease when the leader's expires")
    x.add_argument("--join",
                   help="comma-separated router URLs this replica "
                        "registers with and heartbeats")
    x.add_argument("--advertise",
                   help="host:port other hosts reach this process at "
                        "(default 127.0.0.1:<port>)")
    x.add_argument("--member-name",
                   help="with --join: the member's name in heartbeats")
    x.add_argument("--autoscale", choices=["on", "off"],
                   help="with --supervised: grow and retire child "
                        "processes off the router's tsdb ring "
                        "(default: PIO_AUTOSCALE, off)")
    x.add_argument("--autoscale-min", type=int,
                   help="the autoscaler's floor on children "
                        "(PIO_AUTOSCALE_MIN, default 1)")
    x.add_argument("--autoscale-max", type=int,
                   help="the autoscaler's ceiling on children "
                        "(PIO_AUTOSCALE_MAX, default 4)")
    x.add_argument("--mesh",
                   help="items=N@fleet on a router: merge N catalog "
                        "slices; items=N@fleet:i on a --join member: "
                        "serve slice i")
    x.add_argument("--tenancy", choices=["on", "off"],
                   help="per-app auth, quotas (429 + Retry-After) and "
                        "weighted-fair batching on /queries.json "
                        "(default: PIO_TENANCY, off)")
    x.add_argument("--tenant-rate", type=float,
                   help="default per-app rate, requests/second "
                        "(PIO_TENANT_RATE)")
    x.add_argument("--tenant-burst", type=float,
                   help="default per-app burst (PIO_TENANT_BURST)")
    x.add_argument("--tenant-concurrency", type=int,
                   help="default per-app in-flight cap, 0 = unlimited "
                        "(PIO_TENANT_CONCURRENCY)")
    x.add_argument("--tenant-queue-max", type=int,
                   help="default per-app micro-batch lane cap "
                        "(PIO_TENANT_QUEUE_MAX)")
    x.add_argument("--quality", choices=["on", "off"],
                   help="score sketches and drift on the serve path, the "
                        "feedback join (with --feedback) and the reload "
                        "canary (default: PIO_QUALITY, on)")
    x.add_argument("--attribution-s", type=float, default=0.0,
                   help="the feedback join's window, seconds "
                        "(PIO_ATTRIBUTION_S, default 300)")
    x.add_argument("--canary-sample", type=int, default=-1,
                   help="kept traces replayed through the old and the new "
                        "model per reload (PIO_CANARY_SAMPLE, default 16; "
                        "0 turns the canary off)")
    x.add_argument("--canary-min-overlap", type=float, default=-1.0,
                   help="refuse a reload whose replayed top-k overlap is "
                        "below this (PIO_CANARY_MIN_OVERLAP, default 0: "
                        "report only)")
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
    x = sub.add_parser("ingestd", help="the remote ingest service: owns "
                       "the columnar scan and streams CRC-framed column "
                       "blocks to trainers and refreshers")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=7200)
    x.add_argument("--block-rows", type=int, default=0,
                   help="rows per streamed block (default 65536)")
    x.add_argument("--workers", type=int, default=None,
                   help="scan worker pool width (default "
                        "PIO_INGEST_WORKERS)")
    x.add_argument("--join", default="",
                   help="comma-separated router URLs to register with as "
                        "a fleet member of role ingest")
    x.add_argument("--advertise", default="",
                   help="host:port other hosts reach this service at")
    x = sub.add_parser("loadsim", help="open-loop traffic from a "
                                       "scenario (tools/loadsim.py)")
    x.add_argument("loadsim_argv", nargs=argparse.REMAINDER,
                   help="the simulator's arguments after --, e.g. -- "
                        "--scenario flash-crowd --port 8000 --scale 0.2")
    x = sub.add_parser(
        "chaos",
        help="self-healing drills: timed fault scenarios (thread "
             "stall/death, lease failover, memory pressure, replica "
             "SIGKILL) against a real loopback topology, gated on "
             "invariants; non-zero exit on any violation")
    chaos = x.add_subparsers(dest="chaos_command", required=True)
    chaos.add_parser("list", help="list scenarios")
    y = chaos.add_parser("run", help="run one scenario (or 'all')")
    y.add_argument("scenario", help="scenario name, or 'all'")
    y.add_argument("--json", action="store_true",
                   help="machine-readable reports on stdout")
    y.add_argument("--device", default=None,
                   help="torch device of the drills' model (default cuda)")
    x = sub.add_parser("dashboard", help="completed evaluations, live "
                                         "metrics and traces over HTTP")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=9000)
    x = sub.add_parser("adminserver", help="app CRUD over REST")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=7071)
    x = sub.add_parser("top", help="terminal observatory view of a running "
                       "server (qps, p50/p99, shed, burn, RSS, top frames "
                       "from /tsdb.json + /profile.json)")
    x.add_argument("--host", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                   help="redraw every N seconds (0 = one-shot)")
    x = sub.add_parser("start-all", help="start event server + dashboard + "
                                         "admin server as daemons")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--event-server-port", type=int, default=7070)
    x.add_argument("--dashboard-port", type=int, default=9000)
    x.add_argument("--admin-port", type=int, default=7071)
    x.add_argument("--pid-dir")
    x.add_argument("--log-dir")
    x = sub.add_parser("stop-all", help="stop all pidfile-tracked services")
    x.add_argument("--pid-dir")
    x = sub.add_parser("daemon", help="run a subcommand of this CLI "
                                      "detached with a pidfile")
    x.add_argument("--name", required=True)
    x.add_argument("--pid-dir")
    x.add_argument("--log-dir")
    x.add_argument("daemon_argv", nargs=argparse.REMAINDER,
                   help="subcommand to run, e.g. -- eventserver --port 7070")
    x = sub.add_parser("run", help="run a function by its dotted path with "
                                   "the storage configured")
    x.add_argument("target", help="module.function")
    sub.add_parser("shell", help="interactive Python with the storage "
                                 "registry and the port's modules loaded")
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
    elif c == "quota-set":
        _emit(ops.app_quota_set(
            registry, args.name, rate=args.rate, burst=args.burst,
            concurrency=args.concurrency, queue_max=args.queue_max,
            weight=args.weight))
    elif c == "quota-show":
        _emit(ops.app_quota_show(registry, args.name))
    elif c == "quota-delete":
        ops.app_quota_delete(registry, args.name)
        _emit({"message": f"Quota override for {args.name} deleted"})
    elif c == "data-delete":
        ops.app_data_delete(registry, args.name, channel=args.channel,
                            all_channels=args.all, force=args.force)
        _emit({"message": f"Data of app {args.name} deleted"})
    elif c == "channel-new":
        _emit(ops.channel_new(registry, args.app_name, args.channel_name))
    elif c == "channel-delete":
        ops.channel_delete(registry, args.app_name, args.channel_name,
                           force=args.force)
        _emit({"message": f"Channel {args.channel_name} deleted"})
    else:
        ops.app_delete(registry, args.name, force=args.force)
        _emit({"message": f"App {args.name} deleted"})


def _sigterm_event() -> threading.Event:
    """An event SIGINT and SIGTERM set, installed before the caller
    announces itself (a signal sent at once must not kill the process)."""
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    return stop


def _tenancy(args, registry, server_key: str) -> TenancyConfig:
    """The deploy's TenancyConfig: PIO_TENANCY and PIO_TENANT_* of the
    storage config, the flags over them; the server key signs a router's
    tenant header."""
    over = {k: v for k, v in (
        ("rate", args.tenant_rate), ("burst", args.tenant_burst),
        ("concurrency", args.tenant_concurrency),
        ("queue_max", args.tenant_queue_max)) if v is not None}
    if args.tenancy:
        over["enabled"] = args.tenancy == "on"
    if server_key:
        over["header_key"] = server_key
    return TenancyConfig.from_env(registry.config, **over)


def _fleet_mesh(spec: Optional[str]):
    """`--mesh`: (shards, index or None), or None without one."""
    if not spec:
        return None
    from predictionio_tpu_torch.ops.topk_sharded import parse_fleet_mesh
    parsed = parse_fleet_mesh(spec)
    if parsed is None:
        raise ValueError(f"--mesh {spec!r}: the port's deploy takes "
                         "items=N@fleet[:i] (a local mesh comes from "
                         "PIO_SERVE_SHARD)")
    return parsed


def _autoscale_on(args, registry) -> bool:
    """`--autoscale`, else PIO_AUTOSCALE of the storage config."""
    return (args.autoscale == "on" if args.autoscale else
            registry.config.get("PIO_AUTOSCALE", "") in ("1", "true", "on"))


def _autoscaler(args, registry, sup, server, spec_factory):
    """An Autoscaler over the supervisor and the router when
    `_autoscale_on`, its thresholds from PIO_AUTOSCALE_*,
    `--autoscale-min`/`--autoscale-max` over theirs; None when off."""
    if not _autoscale_on(args, registry):
        return None
    from predictionio_tpu_torch.serving.autoscaler import (AutoscaleConfig,
                                                           Autoscaler)
    cfg = AutoscaleConfig.from_env()
    cfg = dataclasses.replace(
        cfg, enabled=True,
        min_children=(args.autoscale_min if args.autoscale_min is not None
                      else cfg.min_children),
        max_children=(args.autoscale_max if args.autoscale_max is not None
                      else cfg.max_children))
    return Autoscaler(cfg, supervisor=sup, fleet=server,
                      spec_factory=spec_factory)


def _deploy(args, argv: Sequence[str]) -> int:
    from predictionio_tpu_torch.ops.topk_sharded import ShardSlice
    from predictionio_tpu_torch.serving.fleet import (FleetServer,
                                                      ReplicaAgent,
                                                      fleet_config_from_env)
    items_device = "cpu" if args.items_on_host else None
    feedback = FeedbackConfig(
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey) if args.feedback else None
    registry = _registry()
    server_key = (args.server_key if args.server_key is not None else
                  registry.config.get("PIO_SERVER_ACCESS_KEY", ""))
    if server_key and trace.get_recorder().key != server_key:
        # trace headers are signed and verified with the server key
        trace.configure(key=server_key)
    tenancy = _tenancy(args, registry, server_key)
    mesh = _fleet_mesh(args.mesh)
    router = args.supervised > 0 or args.standby or args.replicas != 1
    if args.join and router:
        raise ValueError("--join starts one replica: no --replicas, "
                         "--supervised or --standby with it")
    if mesh is not None and (mesh[1] is None) != router:
        raise ValueError(f"--mesh {args.mesh}: items=N@fleet goes with a "
                         "router (--replicas, --supervised), "
                         "items=N@fleet:i with a single or --join replica")
    if mesh is not None and args.supervised and _autoscale_on(args, registry):
        # a grown child would serve no slice, and the mesh routes only to
        # members that declare one
        raise ValueError(f"--mesh {args.mesh}: the autoscaler grows "
                         "whole-catalog children; no --autoscale on (or "
                         "PIO_AUTOSCALE) with --mesh")
    server_kw = dict(
        window_s=args.batch_window_ms / 1000.0, server_key=server_key,
        ssl_context=ssl_context_from_config(registry.config),
        quality=(args.quality == "on" if args.quality else None),
        attribution_s=args.attribution_s,
        canary_sample=args.canary_sample,
        canary_min_overlap=args.canary_min_overlap)
    if router:
        if args.model:
            raise ValueError("a fleet serves engine instances, not --model")
        fleet_cfg = fleet_config_from_env(
            registry.config,
            replicas=0 if args.standby or args.supervised else args.replicas,
            advertise=args.advertise or "")
        factory = None
        if fleet_cfg.replicas:
            engine, inst = ops.deploy_target(
                registry, engine_instance_id=args.engine_instance_id,
                engine_json=args.engine_json,
                engine_factory=args.engine_factory)
            factory = fleet_replica_factory(
                engine, inst, RuntimeContext(registry=registry,
                                             device=args.device),
                batch_max=args.batch_max, items_device=items_device,
                refresh_interval_s=args.refresh_interval,
                feedback=feedback, **server_kw)
        server = FleetServer(
            factory, fleet=fleet_cfg, host=args.ip, port=args.port,
            registry=registry, mesh=args.mesh or "",
            server_key=server_key, tenancy=tenancy)
        port = server.start()
        what = (f"{args.supervised} supervised replica processes"
                if args.supervised else
                f"{fleet_cfg.replicas} local replicas")
        sup = asc = None
        if args.supervised:
            from predictionio_tpu_torch.serving.supervisor import (
                ChildSpec, Supervisor, child_argv_from_parent)
            router_url = f"http://127.0.0.1:{port}"

            def _child_spec(name: str, i: Optional[int] = None) -> ChildSpec:
                # a grown child has no index (no mesh with the autoscaler)
                extra = ["--member-name", name]
                if mesh is not None and i is not None:
                    extra += ["--mesh", f"items={mesh[0]}@fleet:{i % mesh[0]}"]
                return ChildSpec(name, child_argv_from_parent(
                    argv, router_url, extra=extra))

            sup = Supervisor([_child_spec(f"replica{i}", i)
                              for i in range(args.supervised)])
            asc = _autoscaler(args, registry, sup, server, _child_spec)
            if asc is not None:
                cfg = asc.config
                what += (f", autoscale [{cfg.min_children}, "
                         f"{cfg.max_children}]")
        print(f"Fleet {'standby router' if args.standby else 'control plane'}"
              f" started on {args.ip}:{port} ({what})", flush=True)
        if sup is not None:
            # the kernel library, built once before the children load it
            if args.device != "cpu":
                from predictionio_tpu_torch.ops import fused_topk
                fused_topk.build_library()
            sup.start()
            # the router's tsdb tick drives it from now on
            server.autoscaler = asc
        install_signal_handlers(server)
        try:
            server.stopped.wait()
        finally:
            if sup is not None:
                sup.stop()
        return 0
    if args.model:
        from predictionio_tpu_torch.ops.als import load_npz
        model = load_npz(args.model, device=args.device,
                         items_device=items_device)
        server = deploy(model, host=args.ip, port=args.port,
                        batch_max=args.batch_max, feedback=feedback,
                        tenancy=tenancy, **server_kw)
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
            refresh_interval_s=args.refresh_interval, feedback=feedback,
            mesh=ShardSlice(*mesh) if mesh is not None else None,
            tenancy=(tenancy.replica_variant() if args.join else tenancy),
            startup_check=not args.join, **server_kw)
        what = f"engine instance {inst.id}"
        dev = ", ".join(sorted({str(m.device)
                                for m in server.deployment.models
                                if hasattr(m, "device")}))
    agent = None
    if args.join:
        agent = ReplicaAgent(
            server, args.join.split(","), advertise=args.advertise or "",
            server_key=server_key,
            heartbeat_s=fleet_config_from_env(registry.config).heartbeat_s,
            member_name=args.member_name or "")
        agent.start()
    print(f"serving {what} on http://{args.ip}:{server.port} ({dev})"
          + (f", joined {args.join}" if args.join else ""), flush=True)
    # SIGTERM, SIGINT and POST /stop all end in the graceful stop()
    install_signal_handlers(server)
    server.stopped.wait()
    if agent is not None:
        agent.stop()
    return 0


def _eventserver(args) -> int:
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    server = EventServer(EventServerConfig(ip=args.ip, port=args.port,
                                           stats=args.stats), _registry())
    port = server.start()
    stop = _sigterm_event()
    print(f"Event server started on {args.ip}:{port}", flush=True)
    stop.wait()
    server.shutdown()
    return 0


def _ingestd(args) -> int:
    """The ingest service until SIGINT or SIGTERM; with `--join` a fleet
    member of role ingest."""
    from predictionio_tpu_torch.ingest.service import (IngestConfig,
                                                       IngestService)
    server = IngestService(
        IngestConfig(ip=args.ip, port=args.port, block_rows=args.block_rows,
                     workers=args.workers), _registry())
    port = server.start()
    stop = _sigterm_event()
    print(f"Ingest service started on {args.ip}:{port}", flush=True)
    agent = None
    if args.join:
        from predictionio_tpu_torch.serving.fleet import ReplicaAgent
        agent = ReplicaAgent(
            server, args.join.split(","),
            advertise=args.advertise or f"{args.ip}:{port}", role="ingest")
        agent.start()
    try:
        stop.wait()
    finally:
        if agent is not None:
            agent.stop()
        server.shutdown()
    return 0


def _host_service(server, what: str, ip: str) -> int:
    """Start a host service (dashboard, admin server), announce it and
    serve until SIGINT or SIGTERM."""
    port = server.start()
    stop = _sigterm_event()
    print(f"{what} started on {ip}:{port}", flush=True)
    stop.wait()
    server.shutdown()
    return 0


def _chaos(args) -> int:
    """`cli chaos list|run`: the JAX CLI's output; an unknown scenario
    exits 2, a violated invariant 1."""
    from predictionio_tpu_torch.resilience import scenarios
    if args.chaos_command == "list":
        _emit([{"name": n, "description": scenarios.get(n).description}
               for n in scenarios.names()])
        return 0
    wanted = (scenarios.names() if args.scenario == "all"
              else [args.scenario])
    unknown = [n for n in wanted if n not in scenarios.names()]
    if unknown:
        print(f"[ERROR] unknown scenario(s): {', '.join(unknown)}; have: "
              f"{', '.join(scenarios.names())}", file=sys.stderr)
        return 2
    trained = scenarios.train_tiny(device=args.device)
    rc = 0
    reports = []
    for n in wanted:
        report = scenarios.run(n, trained=trained, device=args.device)
        reports.append(report.to_json())
        if not report.ok:
            rc = 1
        if not args.json:
            print(scenarios.format_report(report), flush=True)
    if args.json:
        _emit(reports)
    return rc


def _service(args) -> None:
    """`cli start-all|stop-all|daemon` (`cli/service.py`)."""
    from predictionio_tpu_torch.cli import service
    if args.command == "start-all":
        _emit(service.start_all(
            ip=args.ip, event_server_port=args.event_server_port,
            dashboard_port=args.dashboard_port, admin_port=args.admin_port,
            pid_dir=args.pid_dir, log_dir=args.log_dir))
    elif args.command == "stop-all":
        _emit(service.stop_all(pid_dir=args.pid_dir))
    else:
        rest = list(args.daemon_argv)
        if rest and rest[0] == "--":
            rest = rest[1:]
        if not rest:
            raise ValueError("daemon needs a subcommand after --")
        _emit(service.daemonize(rest, name=args.name, pid_dir=args.pid_dir,
                                log_dir=args.log_dir))


def _run(target: str) -> None:
    """`cli run`: call `module.function()` and print what it returns."""
    import importlib
    module_name, _, attr = target.rpartition(".")
    result = getattr(importlib.import_module(module_name), attr)()
    if result is not None:
        _emit(result)


def _shell() -> None:
    """`cli shell` (bin/pio-shell): a REPL with the storage registry, the
    event store and the port's modules in scope."""
    import code

    import predictionio_tpu_torch
    from predictionio_tpu_torch import core, data, models
    from predictionio_tpu_torch import ops as tops
    registry = _registry()
    ns = {"predictionio_tpu_torch": predictionio_tpu_torch, "core": core,
          "data": data, "models": models, "ops": tops,
          "registry": registry, "events": registry.get_events()}
    code.interact(banner="predictionio_tpu_torch shell - preloaded: "
                         "registry (storage registry), events (event "
                         "store), core, data, models, ops", local=ns)


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
            elif args.ak_command == "delete":
                ops.accesskey_delete(_registry(), args.key)
                _emit({"message": f"Access key {args.key} deleted"})
            else:
                _emit(ops.accesskey_list(_registry(), args.app_name))
        elif cmd == "import":
            _emit(ops.import_events(_registry(), app_id=args.appid,
                                    input_path=args.input,
                                    channel_id=args.channel,
                                    format=args.format))
        elif cmd == "export":
            _emit(ops.export_events(_registry(), app_id=args.appid,
                                    output_path=args.output,
                                    channel_id=args.channel,
                                    format=args.format))
        elif cmd == "doctor":
            report = ops.doctor(_registry(), repair=args.repair,
                                stale_after_s=args.stale_after)
            _emit(report)
            return 0 if report["unrepaired"] == 0 else 1
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
        elif cmd == "ingestd":
            return _ingestd(args)
        elif cmd == "loadsim":
            from predictionio_tpu_torch.tools import loadsim
            sim_argv = list(args.loadsim_argv)
            if sim_argv and sim_argv[0] == "--":
                sim_argv = sim_argv[1:]
            return loadsim.main(sim_argv)
        elif cmd == "chaos":
            return _chaos(args)
        elif cmd == "dashboard":
            from predictionio_tpu_torch.tools.dashboard import (
                Dashboard, DashboardConfig)
            return _host_service(
                Dashboard(DashboardConfig(ip=args.ip, port=args.port),
                          _registry()), "Dashboard", args.ip)
        elif cmd == "adminserver":
            from predictionio_tpu_torch.tools.admin import (AdminConfig,
                                                            AdminServer)
            return _host_service(
                AdminServer(AdminConfig(ip=args.ip, port=args.port),
                            _registry()), "Admin server", args.ip)
        elif cmd == "top":
            from predictionio_tpu_torch.tools.admin import run_top
            return run_top(args.host, args.port, watch_s=args.watch)
        elif cmd in ("start-all", "stop-all", "daemon"):
            _service(args)
        elif cmd == "run":
            _run(args.target)
        elif cmd == "shell":
            _shell()
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
                    device=args.device, profile_dir=args.profile_dir))
            except TrainingInterrupted as e:
                # the reference ends a stop-after run normally; the
                # instance stays FAILED, so deploy never serves it
                _emit({"interrupted": type(e).__name__})
            else:
                print(train_report(), file=sys.stderr, flush=True)
        else:
            return _deploy(args, list(argv) if argv is not None
                           else sys.argv[1:])
        return 0
    except (ValueError, OSError) as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
