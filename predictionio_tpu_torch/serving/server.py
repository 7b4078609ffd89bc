"""Prediction server: the serve plane of one server process.

The port of `predictionio_tpu/serving/server.py` (CreateServer.scala): a
deployment (`_Deployment.predict_batch`), the micro-batcher that
coalesces concurrent requests into device batches (`_MicroBatcher`), and
`PredictionServer`, an `utils.http.HTTPServerBase` on the selector wire
(`utils/wire.py`) or the threaded one, with

  POST /queries.json   {"user", "num", "blackList"?, "whiteList"?}
                       -> {"itemScores": [{"item", "score"}]}; also a
                       binary frame (`application/x-pio-bin`, {"user",
                       "num"} only)
  GET  /               the port's status JSON: the engine instance, the
                       fused kernel's launch counts, the serving plans'
                       kinds, calls, buckets and banned widths, the
                       drained batch sizes, each algorithm's
                       `serve_paths`, the refresher and the feedback loop
  GET  /status.json    the JAX keys (status, engineInstanceId,
                       engineVariant, startTime, requestCount,
                       avgServingSec, lastServingSec) plus the same
                       counters as GET /
  POST /reload         load the variant's latest COMPLETED instance, warm
                       it beside the serving one and publish it; a
                       failed load answers 500 and the previous
                       deployment keeps serving
  POST /stop           drain accepted requests and close, on a thread of
                       its own
  POST /shard/queries.json   a fleet member's candidates, with GLOBAL item
                       ids: its catalog slice on a `ShardSlice` member,
                       else the whole catalog (`serving/fleet.py` merges)
  GET  /plugins.json, GET /plugins/<name>[/<args>]   engine-server plugins
  GET  /metrics, /health, /ready   (the HTTP base; /ready is false while
                       a storage circuit breaker is open, named in
                       `storageBreakers`, and carries the SLO burn as
                       detail)

`/reload` and `/stop` take the server key (`server_key`, the JAX
`PIO_SERVER_ACCESS_KEY`) as `?accessKey=` or the Basic username; a wrong
or missing key answers 401.

On the selector wire `/queries.json` has a fast route: a body that is
exactly {"user": <str>, "num": <int>} (or its binary frame) is parsed by
one regular expression, submitted to the batcher, and answered with the
body the drainer pre-serialized for the whole batch
(`_encode_scores_batch`), with no Request object and no per-request
json.dumps. Anything else (bans, white lists, other fields, a query
class of another shape, feedback or plugins on) takes the generic
route, whose json.loads is the fallback parser. Both answer the same
bytes: the encoder prints each score as `json.dumps` prints the float.

Tenancy (`tenancy=TenancyConfig(enabled=True)`, or `PIO_TENANCY=on`): on
both routes a request authenticates with its app's access key
(`?accessKey=`, the Basic username, or on a fleet replica the router's
signed `X-PIO-App`), is charged its app's rate and concurrency quotas
(`QuotaExceeded`, 429 with `Retry-After`), and queues in its app's DRR
lane of the micro-batcher (`tenancy/drr.py`), capped at the app's
`queue_max`. Every request lands in the per-app `SLOTracker`
(`obs/slo.py`).

Deadlines and shedding: `X-PIO-Deadline-Ms` bounds a request's wait in
the batcher; a budget below one window plus the drain estimate is
refused at once (504, `pio_shed_total{surface=deadline_batch}`), one
that expires while queued answers 504; a full queue or lane, a
predicted queue delay past the budget, or `max_inflight` requests in
flight answer 503 with `Retry-After`.

A server given a `ctx` sweeps its stores when it starts
(`data.fsck.startup_check`: fsck reporting only, the stale-instance
janitor acting) unless `startup_check` is False (a fleet member: its
router sweeps once). A storage call under an open breaker
(`CircuitOpenError`) answers 503 with `Retry-After` on both routes.

A deployment whose plan is tiered gets a `serving.paging.PageManager`
thread. With `refresh_interval_s` > 0 a `streaming.Refresher` thread
folds new events into the models and publishes a new deployment under
`_dep_lock` (`publish`); a request holds the deployment it started with.
With a `FeedbackConfig` every served query becomes a `predict` event
POSTed to the event server by one worker thread, retried with backoff
and then dropped; a full queue drops instead of stalling the serve path.

Metrics (the JAX names): `pio_http_requests_total`,
`pio_http_request_duration_seconds`, `pio_serve_stage_seconds{stage}`
(extract, supplement, predict, serve, feedback),
`pio_serve_algo_predict_seconds{algo}`, `pio_serve_batch_size`,
`pio_serve_batch_queue_depth`, `pio_queue_delay_seconds`,
`pio_shed_total{surface,app}`, `pio_deadline_expired_total`,
`pio_algo_errors_total`, `pio_reload_total{outcome}`,
`pio_feedback_events_total{outcome,app}`,
`pio_feedback_dropped_total{reason,app}`, `pio_tenant_admitted_total
{app}`, `pio_tenant_serve_seconds{app}`, `pio_tenant_active`,
`pio_slo_burn_rate{app,window}`, and `pio_serve_seconds{app}`, the
end-to-end serve latency, observed by the flight recorder at the wire
write when tracing is on (`obs/trace.py`, with kept trace ids as
exemplars) and here when it is off.

Traces (`PIO_TRACE_SAMPLE` > 0, on the selector wire): the fast route
stamps its handler entry, admission and answer; the micro-batcher
stamps the enqueue, the drain, the execution (`S_EXEC`, once the
batch's answers are on the host: K1's launch is asynchronous, so the
stamp follows the device-to-host copy inside `predict_batch`) and the
splice; the generic route tags its entry `kind="serve"`. The tsdb
scrape adds `pio_plan_resident_bytes{device,bucket}` (`_obs_collectors`).

Prediction quality (`obs/quality.py`, on unless `quality=False` or
`PIO_QUALITY=off`): every answered request, on the fast route, the
generic route and the fleet's shard route, is observed into per-app
score sketches (`observe_result`, one list append), whose reference is
frozen after each successful reload; `GET /quality.json` serves them,
the feedback joiner's reward view (with `feedback`) and the last canary
report. The reload canary replays up to `PIO_CANARY_SAMPLE` kept serve
traces through the serving and the new deployment before the publish
(each replay one `predict_batch`, so K1 through both plans); below
`PIO_CANARY_MIN_OVERLAP` it raises `CanaryVeto`, a load failure that
keeps the old deployment.

Memory pressure (`resilience/pressure.py`): the server's `MemoryGuard`,
checked on the watchdog's sweep, trims the tsdb rings, the trace ring,
the quality accumulators, the tenant key cache and the prepared-ingest
cache past its soft watermark and sheds new requests with 503, Retry-
After and `pio_shed_total{surface="memory"}` on every route while over
it; past the hard one `/ready` fails and the graceful `stop()` starts
once. `/status.json` and GET / carry `memPressure`; `/ready` carries it
when it fails, and `degradedLoops`, the roles of this server's loops
(drainer, refresher, feedback, joiner, page thread, scraper) that the
watchdog gave up on.
"""

from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import os
import queue
import random
import re
import string
import threading
import time
import typing
from json.encoder import encode_basestring_ascii as _json_str
from typing import Any, Callable, Dict, List, Optional, Sequence
from urllib.parse import unquote_plus

import numpy as np

from predictionio_tpu_torch.core.params import extract_params
from predictionio_tpu_torch.data.event import format_time, utcnow
from predictionio_tpu_torch.obs import MetricsRegistry, get_logger, trace
from predictionio_tpu_torch.obs.quality import (CanaryGate, QualityStats,
                                                quality_enabled)
from predictionio_tpu_torch.obs.slo import SLOTracker, dao_overrides_loader
from predictionio_tpu_torch.resilience import (DEADLINE_HEADER,
                                               CircuitOpenError, Deadline,
                                               DeadlineExceeded,
                                               OverloadedError,
                                               RetryPolicy, call_with_retry,
                                               current_deadline,
                                               deadline_from_header, faults)
from predictionio_tpu_torch.resilience.pressure import MemoryGuard
from predictionio_tpu_torch.resilience.watchdog import watchdog
from predictionio_tpu_torch.serving.plugins import (
    EngineServerPluginContext, QueryInfo)
from predictionio_tpu_torch.tenancy import (DEFAULT_TENANT, TENANT_HEADER,
                                            AdmissionController, DRRQueue,
                                            TenancyConfig, TenantIdentity)
from predictionio_tpu_torch.utils.http import (HTTPError, HTTPServerBase,
                                               Request, Response,
                                               retry_after_header)
from predictionio_tpu_torch.utils.wire import (BIN_CONTENT_TYPE,
                                               RawRequest, build_response,
                                               decode_bin_query)

__all__ = ["DeadlineExceeded", "FeedbackConfig", "OverloadedError",
           "PredictionServer", "install_signal_handlers", "to_jsonable"]

BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                      256.0, 512.0)

_log = get_logger("serving")


class _ServeInstruments:
    """The serve chain's metric families, shared by the server, its
    deployments, the micro-batcher and the feedback loop."""

    def __init__(self, metrics: MetricsRegistry):
        self.stage = metrics.histogram(
            "pio_serve_stage_seconds",
            "Serve-chain stage wall time (extract/supplement/predict/"
            "serve/feedback)", labels=("stage",))
        self.algo = metrics.histogram(
            "pio_serve_algo_predict_seconds",
            "Per-algorithm batch_predict wall time", labels=("algo",))
        self.batch_size = metrics.histogram(
            "pio_serve_batch_size",
            "Coalesced device batch size per drain",
            buckets=BATCH_SIZE_BUCKETS)
        self.queue_depth = metrics.gauge(
            "pio_serve_batch_queue_depth",
            "Requests waiting in the micro-batcher")
        self.queue_delay = metrics.histogram(
            "pio_queue_delay_seconds",
            "Micro-batch enqueue->drain latency (feeds the adaptive "
            "shed decision)")
        self.feedback = metrics.counter(
            "pio_feedback_events_total",
            "Feedback events by outcome (sent/failed/dropped)",
            labels=("outcome", "app"))
        self.feedback_dropped = metrics.counter(
            "pio_feedback_dropped_total",
            "Feedback events dropped (queue full / send retries "
            "exhausted)", labels=("reason", "app"))
        self.shed = metrics.counter(
            "pio_shed_total", "Requests shed by surface at admission",
            labels=("surface", "app"))
        self.tenant_serve = metrics.histogram(
            "pio_tenant_serve_seconds",
            "End-to-end serve latency per authenticated app",
            labels=("app",))
        self.algo_errors = metrics.counter(
            "pio_algo_errors_total",
            "Per-algorithm predict failures isolated by graceful "
            "degradation", labels=("algo",))
        self.reloads = metrics.counter(
            "pio_reload_total",
            "Deployment (re)loads by outcome (ok/failed)",
            labels=("outcome",))


def to_jsonable(obj: Any) -> Any:
    """Prediction/query dataclasses -> JSON-ready structures."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# -- the fast route -----------------------------------------------------------
# The compiled query shape: exactly {"user": "<str>", "num": <int>} with
# JSON's optional whitespace. Anything else (more fields, escapes in the
# user id, a numeric user) falls through to the generic route.
_FAST_QUERY_RE = re.compile(
    rb'\A[ \t\r\n]*\{[ \t\r\n]*"user"[ \t\r\n]*:[ \t\r\n]*'
    rb'"([^"\\\x00-\x1f]{0,512})"[ \t\r\n]*,[ \t\r\n]*'
    rb'"num"[ \t\r\n]*:[ \t\r\n]*(-?(?:0|[1-9]\d{0,8}))[ \t\r\n]*\}'
    rb'[ \t\r\n]*\Z')

_EMPTY_SCORES = b'{"itemScores": []}'

_ACCESS_KEY_RE = re.compile(r"(?:^|&)accessKey=([^&]*)")
_CHANNEL_RE = re.compile(r"(?:^|&)channel=([^&]*)")


def _scan_query(qs: str, name: str, regex: re.Pattern) -> Optional[str]:
    """`parse_qs`'s value of one parameter of a raw query string (the
    fast route reads only `accessKey` and `channel`)."""
    if name not in qs:
        return None
    m = regex.search(qs)
    if m is None:
        return None
    v = m.group(1)
    return unquote_plus(v) if "%" in v or "+" in v else v


def _derive_fast_ctor(qc) -> Optional[Callable[[str, int], Any]]:
    """A (user, num) -> Query constructor when the query class has a
    str `user` and an int `num` and every other field a default; else
    None, and the fast route stays dark for the deployment."""
    if qc is None or not dataclasses.is_dataclass(qc):
        return None
    try:
        hints = typing.get_type_hints(qc)
    except Exception:  # noqa: BLE001 — an unresolvable class: no fast route
        return None
    if hints.get("user") is not str or hints.get("num") is not int:
        return None
    for f in dataclasses.fields(qc):
        if f.name in ("user", "num"):
            continue
        if f.default is dataclasses.MISSING \
                and f.default_factory is dataclasses.MISSING:
            return None
    try:
        qc(user="", num=1)
    except Exception:  # noqa: BLE001 — the class refuses the shape
        return None
    return lambda u, n: qc(user=u, num=n)


# result type -> a dataclass whose only field is itemScores?
_WIRE_RESULT_TYPES: Dict[type, bool] = {}


def _wire_encodable(t: type) -> bool:
    ok = _WIRE_RESULT_TYPES.get(t)
    if ok is None:
        ok = (dataclasses.is_dataclass(t)
              and [f.name for f in dataclasses.fields(t)] == ["itemScores"])
        _WIRE_RESULT_TYPES[t] = ok
    return ok


def _score_text(s: float) -> bytes:
    """A score as `json.dumps` prints it: the shortest text that parses
    back to the same float. (The JAX encoder prints `%.12g`, equal to
    the float32 score but not always to the float64 its generic route
    prints.)"""
    if s != s or s in (float("inf"), float("-inf")):
        return json.dumps(s).encode("ascii")
    return float.__repr__(s).encode("ascii")


def _encode_scores_batch(dep, results: Sequence[Any]
                         ) -> Optional[List[bytes]]:
    """Pre-serialized bodies for one drained batch, byte for byte what
    `json.dumps(to_jsonable(result))` gives: item ids through the C
    JSON string escaper, scores as `_score_text`. None when any result
    is not a bare itemScores record (the batch is then served through
    json.dumps)."""
    out: List[bytes] = []
    for r in results:
        if not _wire_encodable(type(r)):
            return None
        frags = []
        for s in r.itemScores:
            it = getattr(s, "item", None)
            sc = getattr(s, "score", None)
            if type(it) is not str or type(sc) is not float:
                return None
            frags.append(b'{"item": ' + _json_str(it).encode("ascii")
                         + b', "score": ' + _score_text(sc) + b'}')
        out.append(b'{"itemScores": [' + b", ".join(frags) + b']}'
                   if frags else _EMPTY_SCORES)
    return out


class _Deployment:
    """One loaded (algorithms, models, serving) set with the engine and
    the engine instance it came from (None for a model in hand: the
    refresher's full rebuild and /reload need both) and the deploy's
    timings."""

    def __init__(self, algos, models, serving, *, engine=None,
                 instance=None, timings: Optional[Dict[str, float]] = None,
                 obs: Optional[_ServeInstruments] = None):
        self.engine = engine
        self.instance = instance
        self.instance_id = instance.id if instance is not None else None
        self.engine_variant = (instance.engine_variant
                               if instance is not None else "default")
        self.timings = dict(timings or {})
        self.algos = list(algos)
        self.models = list(models)
        self.serving = serving
        self.obs = obs
        self.query_class = next(
            (a.query_class for a in self.algos if a.query_class is not None),
            None)
        # the fast route's (user, num) constructor, derived once
        self.fast_ctor = _derive_fast_ctor(self.query_class)
        # user maps for the quality accumulators' unknown-entity ratio
        self.user_maps = tuple(
            um for um in (getattr(m, "users", None) for m in self.models)
            if um is not None and hasattr(um, "get"))
        # item name -> global id, for /shard/queries.json's candidates
        self.item_maps = tuple(
            im for im in (getattr(m, "items", None) for m in self.models)
            if im is not None and hasattr(im, "get"))

    def predict_batch(self, queries: Sequence[Any]) -> List[Any]:
        """supplement -> per-algo batch_predict -> serve, for a batch.

        A failing algorithm is dropped from the ensemble for this batch,
        logged and counted (`pio_algo_errors_total`); only when every
        algorithm fails does the batch error."""
        obs = self.obs
        t0 = time.perf_counter()
        supplemented = [self.serving.supplement(q) for q in queries]
        indexed = list(enumerate(supplemented))
        t1 = time.perf_counter()
        alive, errors = [], []
        for i, (algo, model) in enumerate(zip(self.algos, self.models)):
            label = f"{i}:{type(algo).__name__}"
            ta = time.perf_counter()
            try:
                faults().check(f"serve.predict.{label}")
                alive.append(dict(algo.batch_predict(model, indexed)))
            except Exception as e:  # noqa: BLE001 — isolated per algorithm
                errors.append(e)
                if obs is not None:
                    obs.algo_errors.labels(algo=label).inc()
                _log.warning("algo_predict_failed", algo=label,
                             error=f"{type(e).__name__}: {e}",
                             degraded=len(self.algos) > 1)
                continue
            if obs is not None:
                obs.algo.labels(algo=label).observe(time.perf_counter() - ta)
        if not alive:
            raise errors[0]
        t2 = time.perf_counter()
        out = [self.serving.serve(q, [pa[i] for pa in alive])
               for i, q in enumerate(queries)]
        if obs is not None:
            obs.stage.labels(stage="supplement").observe(t1 - t0)
            obs.stage.labels(stage="predict").observe(t2 - t1)
            obs.stage.labels(stage="serve").observe(time.perf_counter() - t2)
        return out

    def plans(self) -> List[Any]:
        return [getattr(a, "_serve_plan", None) for a in self.algos]


class _MicroBatcher:
    """Coalesces concurrent requests into device batches.

    One drainer at a time: a submit either becomes the drainer (none is
    active) or just queues. The drainer waits out the batching window,
    or less when a full batch forms, takes up to `batch_max` pending
    items, processes them outside the lock, and loops while more work
    queued meanwhile; an empty window retires it. A drainer that dies
    fails every waiter and clears the flag for the next submit.

    The pending store is a `tenancy.DRRQueue` of per-tenant lanes: each
    lane is capped by its tenant's own `tenant_queue_max`, the drainer
    composes batches weighted-fair across lanes, and with tenancy off
    every item lands in the one default lane, which is exactly FIFO.

    Admission: a closed batcher, a full queue (`queue_max`) or a full
    lane refuses with OverloadedError (503); every submit waits at most
    its deadline's budget, else `submit_timeout_s`, then raises
    DeadlineExceeded (504) so that a wedged drainer never strands a
    handler thread. Each drained item's enqueue->drain delay feeds an
    EWMA, the batcher's and its lane's: while work is pending, a submit
    whose budget is below its lane's EWMA (the global one for the
    default lane) is shed 503 (`queue_delay`), so the tenant causing a
    backlog sheds first; a deadline budget below one window plus the
    EWMA of the drain's own time is refused 504 at the door
    (`deadline_batch`; that estimate ages toward zero while no batch
    drains, so one stall cannot lock deadlined traffic out).

    After each batch the drainer runs `encoder(dep, results)` once (the
    fast route's pre-serialized bodies) and `drain_hook()` (the wire's
    flush hint)."""

    DELAY_ALPHA = 0.2    # EWMA smoothing of the queue and drain delays

    def __init__(self, window_s: float, batch_max: int,
                 queue_max: int = 256, submit_timeout_s: float = 30.0,
                 obs: Optional[_ServeInstruments] = None):
        self.window_s = window_s
        self.batch_max = batch_max
        self.queue_max = queue_max
        self.submit_timeout_s = submit_timeout_s
        self.obs = obs
        self.encoder: Optional[Callable[[Any, Sequence[Any]],
                                        Optional[List[bytes]]]] = None
        self.drain_hook: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        self._full = threading.Condition(self._lock)
        # per-tenant lanes; items: (deployment, query, done event,
        # result slot, enqueue t, tenant label, pending trace or None)
        self._queue = DRRQueue()
        self._batch_seq = itertools.count(1)
        self._draining = False
        self._closed = False
        self._delay_ewma = 0.0
        self._drain_ewma = 0.0
        self._drain_t = time.perf_counter()
        # drained batch size -> count
        self._sizes: Dict[int, int] = {}
        # the live drainer's watchdog beat (None while none runs)
        self._drain_beat = None

    def batch_sizes(self) -> Dict[int, int]:
        """Drained batch sizes -> how many batches had that size."""
        with self._lock:
            return dict(self._sizes)

    def _drain_estimate_locked(self) -> float:
        """The drain EWMA, halved per grace interval without a drain."""
        if self._drain_ewma <= 0.0:
            return self._drain_ewma
        grace = max(4.0 * (self.window_s + self._drain_ewma), 1.0)
        idle = time.perf_counter() - self._drain_t
        if idle <= grace:
            return self._drain_ewma
        return self._drain_ewma * 0.5 ** ((idle - grace) / grace)

    def _shed(self, surface: str, tenant: str) -> None:
        if self.obs is not None:
            self.obs.shed.labels(surface=surface, app=tenant).inc()

    def _depth_locked(self) -> None:
        if self.obs is not None:
            self.obs.queue_depth.set(float(len(self._queue)))

    def submit(self, deployment: _Deployment, query: Any,
               deadline: Optional[Deadline] = None,
               tenant: str = DEFAULT_TENANT, weight: float = 1.0,
               tenant_queue_max: int = 0, pending=None) -> Any:
        return self.submit_slot(deployment, query, deadline, tenant,
                                weight, tenant_queue_max, pending)["result"]

    def submit_slot(self, deployment: _Deployment, query: Any,
                    deadline: Optional[Deadline] = None,
                    tenant: str = DEFAULT_TENANT, weight: float = 1.0,
                    tenant_queue_max: int = 0,
                    pending=None) -> Dict[str, Any]:
        """submit(), returning the drained slot: "result" and, when the
        batch encoder ran, the pre-serialized "wire" body. `tenant`,
        `weight` and `tenant_queue_max` place the item in its DRR lane
        (`AdmissionController.batch_params`). `pending` is the request's
        trace stamps (`obs.trace.PendingTrace`) or None; the batcher
        stamps its enqueue, drain, execution and splice on it."""
        done = threading.Event()
        slot: Dict[str, Any] = {}
        item = (deployment, query, done, slot, time.perf_counter(), tenant,
                pending)
        with self._lock:
            if self._closed:
                self._shed("queries", tenant)
                raise OverloadedError("server draining for shutdown")
            if self.queue_max > 0 and len(self._queue) >= self.queue_max:
                self._shed("queries", tenant)
                raise OverloadedError("micro-batch queue full",
                                      retry_after=max(self.window_s, 0.05))
            budget = self.submit_timeout_s
            if deadline is not None:
                budget = min(budget, deadline.remaining())
                drain_est = self._drain_estimate_locked()
                if drain_est > 0.0 and budget < self.window_s + drain_est:
                    self._shed("deadline_batch", tenant)
                    raise DeadlineExceeded(
                        f"deadline budget {budget * 1e3:.0f}ms below "
                        f"batch window + drain estimate "
                        f"{(self.window_s + drain_est) * 1e3:.0f}ms")
            ewma = (self._delay_ewma if tenant == DEFAULT_TENANT
                    else self._queue.delay_ewma(tenant))
            if len(self._queue) and ewma > budget:
                self._shed("queue_delay", tenant)
                raise OverloadedError(
                    f"predicted queue delay {ewma * 1e3:.0f}ms"
                    f" exceeds request budget {budget * 1e3:.0f}ms",
                    retry_after=ewma)
            if not self._queue.push(tenant, item, weight=weight,
                                    queue_max=tenant_queue_max):
                # this tenant's own lane is full: only it sheds
                self._shed("queries", tenant)
                raise OverloadedError(
                    f"per-tenant micro-batch queue full "
                    f"({tenant_queue_max} pending)",
                    retry_after=max(self.window_s, 0.05))
            trace.mark(pending, trace.S_ENQ)
            self._depth_locked()
            if len(self._queue) >= self.batch_max:
                self._full.notify()
            drain = not self._draining
            self._draining = True
        if drain:
            threading.Thread(target=self._drain_loop, daemon=True,
                             name="pio-torch-batch-drain").start()
        if not done.wait(budget):
            with self._lock:
                if self._queue.remove(tenant, item):
                    self._depth_locked()
            raise DeadlineExceeded(
                "request deadline expired in micro-batch queue"
                if deadline is not None else
                f"micro-batch submit timed out after "
                f"{self.submit_timeout_s:.1f}s")
        if "error" in slot:
            raise slot["error"]
        return slot

    def _drain_loop(self) -> None:
        batch: List[tuple] = []
        # registered for one busy burst: while a drainer lives, a stall
        # past the submit timeout means its waiters are timing out
        beat = watchdog().register("drainer",
                                   budget_s=self.submit_timeout_s)
        beat.attach()
        self._drain_beat = beat
        try:
            while True:
                beat.tick()
                with self._lock:
                    self._full.wait_for(
                        lambda: len(self._queue) >= self.batch_max,
                        timeout=self.window_s)
                    batch = self._queue.take(self.batch_max)
                    self._depth_locked()
                    if not batch:
                        # retire under the lock every submit checks, so
                        # the next arrival starts a fresh drainer
                        self._draining = False
                        self._full.notify_all()
                        return
                    n = len(batch)
                    self._sizes[n] = self._sizes.get(n, 0) + 1
                    now = time.perf_counter()
                    for item in batch:
                        delay = max(now - item[4], 0.0)
                        if self.obs is not None:
                            self.obs.queue_delay.observe(delay)
                        self._delay_ewma += self.DELAY_ALPHA * (
                            delay - self._delay_ewma)
                        self._queue.observe_delay(item[5], delay)
                        trace.mark(item[6], trace.S_DRAIN)
                t0 = time.perf_counter()
                self._process(batch)
                dt = time.perf_counter() - t0
                with self._lock:
                    base = self._drain_estimate_locked()
                    self._drain_ewma = base + self.DELAY_ALPHA * (dt - base)
                    self._drain_t = time.perf_counter()
                batch = []
        except BaseException as e:
            with self._lock:
                stranded = batch + self._queue.drain_all()
                self._depth_locked()
                self._draining = False
                self._full.notify_all()
            for _, _, done, slot, _, _, _ in stranded:
                slot["error"] = e
                done.set()
            from predictionio_tpu_torch.resilience.watchdog import _deaths
            _deaths().labels(role="drainer").inc()
            _log.error("batch_drainer_crashed",
                       error=f"{type(e).__name__}: {e}",
                       stranded=len(stranded))
            raise
        finally:
            beat.close()
            if self._drain_beat is beat:
                self._drain_beat = None

    def _process(self, pending: List[tuple]) -> None:
        if self.obs is not None:
            self.obs.batch_size.observe(float(len(pending)))
        # one predict_batch call per deployment among the drained items
        # (a reload or a fold may publish while requests queue)
        by_dep: Dict[int, List[tuple]] = {}
        for item in pending:
            by_dep.setdefault(id(item[0]), []).append(item)
        from predictionio_tpu_torch.ops.topk import last_dispatch
        for items in by_dep.values():
            dep = items[0][0]
            try:
                # the answers are host objects when this returns: the
                # kernel's scores and ids were copied off the card
                results = dep.predict_batch([item[1] for item in items])
            except Exception as e:  # noqa: BLE001 — reported per request
                for _, _, done, slot, _, _, p in items:
                    slot["error"] = e
                    trace.annotate_pending(p, error=type(e).__name__)
                    done.set()
                continue
            disp = last_dispatch()
            bid = next(self._batch_seq)
            for item in items:
                p = item[6]
                if p is not None:
                    trace.mark(p, trace.S_EXEC)
                    p.batch_id = bid
                    p.batch_size = len(items)
                    if disp:
                        p.dispatch = disp
            wires = None
            if self.encoder is not None:
                try:
                    wires = self.encoder(dep, results)
                except Exception:  # noqa: BLE001 — json.dumps serves it
                    wires = None
            for i, ((_, _, done, slot, _, _, p), r) in enumerate(
                    zip(items, results)):
                slot["result"] = r
                if wires is not None:
                    slot["wire"] = wires[i]
                trace.mark(p, trace.S_SPLICE)
                done.set()
        hook = self.drain_hook
        if hook is not None:
            try:
                hook()
            except Exception:  # noqa: BLE001 — a wire nudge is best effort
                pass

    def close(self, timeout: float = 30.0) -> bool:
        """Stop admitting (new submits shed 503) and wait for accepted
        requests to drain; True when they did."""
        with self._lock:
            self._closed = True
            return self._full.wait_for(
                lambda: not len(self._queue) and not self._draining,
                timeout=timeout)


@dataclasses.dataclass(frozen=True)
class FeedbackConfig:
    """Where served predictions go back as `predict` events (`cli deploy
    --feedback --event-server-ip --event-server-port --accesskey`)."""
    event_server_ip: str = "localhost"
    event_server_port: int = 7070
    access_key: str = ""


def _gen_pr_id() -> str:
    return "".join(random.choices(string.ascii_letters + string.digits,
                                  k=64))


class _Feedback:
    """The feedback loop: a bounded queue of `predict` events and one
    daemon worker that POSTs them over one kept-alive connection,
    retrying each send with backoff and dropping it when the attempts
    run out; every outcome lands in `pio_feedback_events_total` and
    every drop in `pio_feedback_dropped_total`."""

    QUEUE_MAX = 1024    # the JAX ServerConfig's feedback_queue_max
    RETRIES = 3         # and feedback_retries: send attempts per event

    def __init__(self, config: FeedbackConfig, obs: _ServeInstruments):
        self.config = config
        self.obs = obs
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._lock = threading.Lock()
        self.sent = 0
        self.dropped: Dict[str, int] = {"queue_full": 0, "send_failed": 0}
        self._conn = None   # the worker's connection to the event server
        self._policy = RetryPolicy(attempts=self.RETRIES,
                                   base_delay=0.1, max_delay=2.0,
                                   retryable=(OSError,))
        # a blocking get has no cadence to budget against: no stall
        # verdict, the beat counts deaths and respawns
        self.beat = watchdog().register("feedback", budget_s=float("inf"),
                                        restart=self._spawn)
        self._spawn()

    def _spawn(self) -> None:
        threading.Thread(target=self._run, daemon=True,
                         name="pio-torch-feedback").start()

    def _run(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._drain)
        else:
            self._drain()

    def close(self) -> None:
        """Retire the worker's beat (the daemon thread stays parked)."""
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()

    def post(self, dep: _Deployment, query: Any, prediction: Any,
             pr_id: str, trace_id: str = "") -> None:
        props = {"engineInstanceId": dep.instance_id, "prId": pr_id,
                 "query": to_jsonable(query),
                 "prediction": to_jsonable(prediction)}
        if trace_id:
            # the served request's trace, so that the event joins it
            props["traceId"] = trace_id
        data = {"event": "predict", "eventTime": format_time(utcnow()),
                "entityType": "pio_pr", "entityId": pr_id,
                "properties": props}
        try:
            self._queue.put_nowait(data)
        except queue.Full:
            self._count_drop("queue_full")
            self.obs.feedback.labels(outcome="dropped", app="").inc()
            _log.warning("feedback_dropped", reason="queue_full")

    def _count_drop(self, reason: str) -> None:
        with self._lock:
            self.dropped[reason] += 1
        self.obs.feedback_dropped.labels(reason=reason, app="").inc()

    def _send(self, data: Dict[str, Any]) -> None:
        """One POST over the worker's kept-alive connection (a new one
        after any failure); a reply other than 201 raises OSError, so
        that the retry policy treats a refusing event server as
        transient."""
        c = self.config
        try:
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    c.event_server_ip, c.event_server_port, timeout=5)
            self._conn.request(
                "POST", f"/events.json?accessKey={c.access_key}",
                json.dumps(data).encode(),
                {"Content-Type": "application/json"})
            resp = self._conn.getresponse()
            resp.read()
        except (OSError, http.client.HTTPException) as e:
            if self._conn is not None:
                self._conn.close()
            self._conn = None
            raise ConnectionError(f"{type(e).__name__}: {e}") from e
        if resp.status != 201:
            raise OSError(f"event server replied {resp.status}")

    def _drain(self) -> None:
        beat = self.beat
        while True:
            data = self._queue.get()
            if beat is not None:
                beat.tick()
            try:
                call_with_retry(self._send, data, policy=self._policy)
                with self._lock:
                    self.sent += 1
                self.obs.feedback.labels(outcome="sent", app="").inc()
            except Exception as e:  # noqa: BLE001 — best effort: drop
                self._count_drop("send_failed")
                self.obs.feedback.labels(outcome="failed", app="").inc()
                _log.warning("feedback_dropped", reason="send_failed",
                             error=f"{type(e).__name__}: {e}")
            finally:
                self._queue.task_done()

    def flush(self, timeout_s: float) -> bool:
        """Wait up to `timeout_s` for the queue to drain; True if it
        did."""
        end = time.perf_counter() + timeout_s
        while self._queue.unfinished_tasks and time.perf_counter() < end:
            time.sleep(0.02)
        left = self._queue.unfinished_tasks
        if left:
            _log.warning("stop_feedback_unflushed", remaining=left)
        return not left

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"sent": self.sent,
                    "dropped": sum(self.dropped.values()),
                    "dropped_by_reason": dict(self.dropped),
                    "queued": self._queue.unfinished_tasks}


class PredictionServer(HTTPServerBase):
    """`/queries.json` over one deployment (CreateServer.scala's
    MasterActor + ServerActor). `port=0` binds an ephemeral port. `ctx`
    (the deploy's `RuntimeContext`: registry and device) serves the
    refresher and /reload; `items_device` is where /reload puts a new
    model's item master, as the deploy did. `feedback`, a
    `FeedbackConfig`, posts every served prediction back to an event
    server; `plugins` are engine-server plugins; `server_key` guards
    /reload and /stop; `max_inflight` caps the requests in flight (503
    past it); `wire` picks "selector" or "threaded" (default:
    `PIO_SERVE_WIRE`, else the selector wire; TLS takes the threaded
    one). `tenancy`, a `TenancyConfig` (default: `PIO_TENANCY` and
    `PIO_TENANT_*`), turns on per-app admission; `mesh`, an
    `ops.topk_sharded.ShardSlice`, marks a fleet member that serves one
    catalog slice (`shard_spec`), which /reload rebuilds.
    `startup_check` runs the store sweep of a server given a `ctx`.
    `quality` (default: `PIO_QUALITY`, on) turns the quality
    accumulators and the reload canary on; `attribution_s` is the
    feedback joiner's window (default `PIO_ATTRIBUTION_S`),
    `canary_sample` and `canary_min_overlap` the canary's (defaults
    `PIO_CANARY_SAMPLE`, `PIO_CANARY_MIN_OVERLAP`)."""

    def __init__(self, deployment: _Deployment, *, host: str = "127.0.0.1",
                 port: int = 8000, batch_max: int = 64,
                 window_s: float = 0.002, ctx=None,
                 refresh_interval_s: float = 0.0,
                 feedback: Optional[FeedbackConfig] = None,
                 max_inflight: int = 0, server_key: str = "",
                 plugins: Sequence[Any] = (), items_device=None,
                 ssl_context=None, metrics: Optional[MetricsRegistry] = None,
                 wire: Optional[str] = None,
                 tenancy: Optional[TenancyConfig] = None, mesh=None,
                 startup_check: bool = True,
                 quality: Optional[bool] = None, attribution_s: float = 0.0,
                 canary_sample: int = -1, canary_min_overlap: float = -1.0):
        super().__init__(host=host, port=port, ssl_context=ssl_context,
                         metrics=metrics, max_inflight=max_inflight,
                         wire=wire)
        from predictionio_tpu_torch.core.runtime import RuntimeContext
        from predictionio_tpu_torch.utils.security import KeyAuthentication
        self._serve_obs = _ServeInstruments(self.metrics)
        deployment.obs = self._serve_obs
        self.deployment = deployment
        self._dep_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self.ctx = ctx if ctx is not None else RuntimeContext()
        self._items_device = items_device
        self.mesh = mesh
        tcfg = tenancy if tenancy is not None else TenancyConfig.from_env()
        # the metadata store, where a deploy named one or tenancy needs
        # it (a model in hand with tenancy off opens none)
        registry = self.ctx.registry if ctx is not None or tcfg.enabled \
            else None
        self._store = registry
        if ctx is not None and startup_check:
            from predictionio_tpu_torch.data.fsck import startup_check as sweep
            t0 = time.perf_counter()
            sweep(registry, log=_log.warning)
            deployment.timings["sweep_s"] = time.perf_counter() - t0
        self.admission = AdmissionController(tcfg, registry=registry,
                                             metrics=self.metrics)
        self._slo = SLOTracker(metrics=self.metrics,
                               loader=dao_overrides_loader(registry))
        self.auth = KeyAuthentication(server_key or None)
        self.plugin_context = EngineServerPluginContext(plugins)
        self._refresher = None
        if refresh_interval_s > 0:
            from predictionio_tpu_torch.streaming import Refresher
            self._refresher = Refresher(self, refresh_interval_s)
        self.batcher = _MicroBatcher(window_s, batch_max,
                                     obs=self._serve_obs)
        self.batcher.encoder = _encode_scores_batch
        self._feedback = (_Feedback(feedback, self._serve_obs)
                          if feedback is not None else None)
        self._stats_lock = threading.Lock()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self.start_time = utcnow()
        self._stopping = False
        self.stopped = threading.Event()
        self._pager = None
        # the fast route's metric children, resolved once
        self._fq_ok = self._req_counter.labels(
            route="/queries.json", method="POST", status="200")
        self._fq_hist = self._req_hist.labels(route="/queries.json")
        # end-to-end serve latency: with tracing on the recorder observes
        # it at the wire write (with trace-id exemplars); these children
        # observe it when tracing is off, so the family exists either way
        self._serve_seconds = self.metrics.histogram(
            "pio_serve_seconds",
            "End-to-end serve latency (wire read to wire write)",
            labels=("app",), buckets=trace.SERVE_BUCKETS)
        self._ss0 = self._serve_seconds.labels(app="")
        self._serve_obs.reloads.labels(outcome="ok").inc()
        # prediction quality: the serve path's accumulators and the
        # reload canary; the joiner reads the feedback this server posts
        q_on = quality if quality is not None else quality_enabled()
        self._quality = (QualityStats(metrics=self.metrics)
                         if q_on else None)
        self._canary = (CanaryGate(sample=canary_sample,
                                   min_overlap=canary_min_overlap,
                                   metrics=self.metrics)
                        if q_on else None)
        self._joiner = None
        if feedback is not None and q_on:
            from predictionio_tpu_torch.obs.quality import QualityJoiner
            self._joiner = QualityJoiner(self, attribution_s=attribution_s,
                                         metrics=self.metrics)
        # memory pressure: trims and sheds past the soft watermark,
        # drains past the hard one; checked on the watchdog's sweep
        from predictionio_tpu_torch.ingest.pipeline import (
            trim_prepared_cache)
        self._pressure = MemoryGuard()
        self._pressure.add_trim("tsdb", self.tsdb.trim)
        self._pressure.add_trim("trace",
                                lambda: trace.get_recorder().trim())
        if self._quality is not None:
            self._pressure.add_trim("quality", self._quality.trim)
        self._pressure.add_trim("tenant_keys", self.admission.trim_key_cache)
        self._pressure.add_trim("ingest_cache", trim_prepared_cache)
        self._pressure.on_hard(self._drain_on_pressure)
        self._routes()

    # -- lifecycle ----------------------------------------------------------
    def start(self, background: bool = True) -> int:
        """Page tiered plans, start the refresher, then bind and serve
        (in a background thread unless `background` is False); returns
        the bound port."""
        self._sync_pager(self.deployment)
        if self._refresher is not None:
            # the recorder exists before the first tick, so that the
            # baseline tick is traced too
            trace.get_recorder()
            self._refresher.start()
        if self._joiner is not None:
            self._joiner.start()
        port = super().start(background)
        wd = watchdog()
        wd.attach_guard(self._pressure)
        wd.ensure_started()
        return port

    def _on_bound(self) -> None:
        # a drained batch nudges the selector wire to flush deferred
        # pipelined responses (the threaded wire has no hint)
        self.batcher.drain_hook = getattr(self._httpd, "flush_hint", None)

    # -- the observatory ----------------------------------------------------
    def _obs_collectors(self):
        """The serve plane's tsdb tick also samples its plans' device
        residency."""
        return super()._obs_collectors() + [self._sample_plan_bytes]

    def _sample_plan_bytes(self) -> None:
        """The live plans' resident bytes into `pio_plan_resident_bytes
        {device,bucket}`: bucket="factors" is the pinned item table's
        exact bytes; numbered buckets estimate one launch's query block
        and its top-k scores and ids, so a reload to a bigger catalog or
        bucket ladder shows in the ring."""
        import torch
        gauge = self.metrics.gauge(
            "pio_plan_resident_bytes",
            "Device-resident bytes of live serving plans by bucket",
            labels=("device", "bucket"))
        for plan in self.deployment.plans():
            factors = getattr(plan, "factors", None)
            if not isinstance(factors, torch.Tensor):
                continue
            dev = factors.device
            device = f"{dev.type}:{dev.index or 0}"
            gauge.labels(device=device, bucket="factors").set(
                float(factors.numel() * factors.element_size()))
            rank = int(getattr(plan, "rank", 0) or 0)
            k = int(getattr(plan, "k", 0) or 0)
            for b in getattr(plan, "buckets", ()) or ():
                gauge.labels(device=device, bucket=str(b)).set(
                    float(b * (rank * 4 + k * 8)))

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop the refresher, drain accepted
        requests (new ones shed 503), flush the feedback queue within
        what is left of `timeout`, then close the wire and stop the
        page thread. Idempotent; sets `stopped` when done."""
        with self._stats_lock:
            if self._stopping:
                return
            self._stopping = True
        t0 = time.perf_counter()
        watchdog().detach_guard(self._pressure)
        try:
            if self._refresher is not None:
                self._refresher.stop()
            if self._joiner is not None:
                self._joiner.stop()
            if not self.batcher.close(timeout):
                _log.warning("stop_drain_incomplete",
                             waited_s=round(time.perf_counter() - t0, 3))
            if self._feedback is not None:
                self._feedback.flush(max(0.0, timeout
                                         - (time.perf_counter() - t0)))
                self._feedback.close()
            self.shutdown()
            if self._pager is not None:
                self._pager.stop()
                self._pager = None
        finally:
            self.stopped.set()

    def shutdown(self) -> None:
        # every way out (stop() ends here; tests call shutdown()) drops
        # the guard from the process's watchdog, so that a dead server's
        # guard is not swept
        watchdog().detach_guard(self._pressure)
        super().shutdown()

    def _drain_on_pressure(self) -> None:
        """The hard watermark: the graceful stop() on a thread of its
        own (the watchdog's sweep must go on); /ready already fails."""
        _log.error("mem_hard_watermark_draining",
                   detail=self._pressure.detail())
        threading.Thread(target=self.stop, daemon=True,
                         name="pio-torch-mem-drain").start()

    def publish(self, dep: _Deployment,
                expected: Optional[_Deployment] = None) -> bool:
        """Install `dep` as the deployment new requests go to; with
        `expected`, only if that one still serves (a fold computed from
        a deployment that a reload has since replaced is dropped).
        Returns whether it was installed."""
        dep.obs = self._serve_obs
        with self._dep_lock:
            if expected is not None and self.deployment is not expected:
                return False
            self.deployment = dep
        return True

    def _refresh_deployment(self, dep: _Deployment,
                            new_models: Sequence[Any]) -> _Deployment:
        """A fold's publish step: the same engine, instance, algorithms
        and serving with new models. The refresher swaps the device
        factors first and publishes this after."""
        return _Deployment(dep.algos, list(new_models), dep.serving,
                           engine=dep.engine, instance=dep.instance,
                           timings=dep.timings, obs=self._serve_obs)

    def _sync_pager(self, dep: _Deployment) -> None:
        """Bind the page thread to the deployment's tiered plans:
        started on first sight, rebound across /reload, retired when a
        reload drops tiering."""
        plans = _tiered_plans(dep)
        if plans:
            if self._pager is None:
                from predictionio_tpu_torch.serving.paging import (
                    PageManager)
                self._pager = PageManager(metrics=self.metrics)
            self._pager.bind(plans)
            self._pager.start()
        elif self._pager is not None:
            pager, self._pager = self._pager, None
            pager.stop()

    def reload(self) -> _Deployment:
        """Load the latest COMPLETED instance of the serving variant
        (CreateServer.scala:316-342), warm its plan on the card beside
        the serving one, then publish it. Any failure raises before the
        publish, so the previous deployment keeps serving."""
        from predictionio_tpu_torch.core.workflow import (CoreWorkflow,
                                                          resolve_engine)
        with self._reload_lock:
            prev = self.deployment
            try:
                if prev.instance is None:
                    raise ValueError("the deployment serves a model file, "
                                     "not an engine instance")
                faults().check("deploy.prepare")
                inst = self.ctx.registry.get_meta_data_engine_instances() \
                    .get_latest_completed("default", "default",
                                          prev.engine_variant)
                if inst is None:
                    raise ValueError(
                        f"No COMPLETED engine instance of variant "
                        f"{prev.engine_variant}")
                engine = (resolve_engine(inst.engine_factory)
                          if inst.engine_factory else prev.engine)
                timings: Dict[str, float] = {}
                algos, models, serving = CoreWorkflow.prepare_deploy(
                    engine, inst, self.ctx,
                    warm_batch_max=self.batcher.batch_max,
                    items_device=self._items_device, timings=timings,
                    mesh=self.mesh)
                new = _Deployment(algos, models, serving, engine=engine,
                                  instance=inst, timings=timings,
                                  obs=self._serve_obs)
                # the canary: kept serve traces replayed through both
                # deployments before the publish; a veto is a load
                # failure, so the old deployment keeps serving
                if self._canary is not None:
                    self._canary.check(prev, new, self._canary_replay)
            except Exception:
                self._serve_obs.reloads.labels(outcome="failed").inc()
                raise
            self.publish(new)
            self._serve_obs.reloads.labels(outcome="ok").inc()
            self._sync_pager(new)
            if self._refresher is not None:
                self._refresher.rebase()
            # the new model's own scores are the new drift reference
            if self._quality is not None:
                self._quality.freeze_reference()
            return new

    def _canary_replay(self, dep: _Deployment,
                       qdicts: List[Dict]) -> List[Any]:
        """The canary's replay: the traced query dicts parsed as the
        deployment parses them, predicted as one batch."""
        if dep.query_class is not None:
            queries = [extract_params(dep.query_class, qd) for qd in qdicts]
        else:
            queries = list(qdicts)
        return dep.predict_batch(queries)

    # -- serving ------------------------------------------------------------
    def _count_request(self, dt: float) -> None:
        with self._stats_lock:
            self.request_count += 1
            self.last_serving_sec = dt
            self.avg_serving_sec += (
                (dt - self.avg_serving_sec) / self.request_count)

    def serve_query(self, payload: Any,
                    tenant: Optional[TenantIdentity] = None) -> Any:
        """The generic route's serve chain: extract the typed query,
        batch it in the tenant's lane, post feedback, run the output
        blockers and sniffers; returns the JSON-ready answer."""
        t0 = time.perf_counter()
        app = tenant.label if tenant is not None else ""
        # the pending trace that _handle_raw made current: a serve entry,
        # so that the recorder observes it in pio_serve_seconds
        p = trace.current()
        trace.annotate_pending(
            p, kind="serve", app=app,
            query=payload if isinstance(payload, dict) else None)
        dep = self.deployment
        obs = self._serve_obs
        query = (extract_params(dep.query_class, payload)
                 if dep.query_class is not None else payload)
        obs.stage.labels(stage="extract").observe(time.perf_counter() - t0)
        label, weight, tqmax = self.admission.batch_params(tenant)
        prediction = self.batcher.submit(dep, query, current_deadline(),
                                         label, weight, tqmax, pending=p)
        if self._quality is not None:
            self._quality.observe_result(app, prediction,
                                         getattr(query, "user", None),
                                         dep.user_maps)
        extra = {}
        if self._feedback is not None:
            tf = time.perf_counter()
            pr_id = getattr(prediction, "prId", None) or _gen_pr_id()
            if p is not None:
                trace.ensure_ids(p)
            self._feedback.post(dep, query, prediction, pr_id,
                                trace_id=p.trace_id if p is not None else "")
            if hasattr(prediction, "prId"):
                extra["prId"] = pr_id
            obs.stage.labels(stage="feedback").observe(
                time.perf_counter() - tf)
        prediction = self.plugin_context.run_blockers(
            QueryInfo(dep.engine_variant, query, prediction))
        self.plugin_context.notify_sniffers(
            QueryInfo(dep.engine_variant, query, prediction))
        dt = time.perf_counter() - t0
        self._count_request(dt)
        if tenant is not None:
            obs.tenant_serve.labels(app=tenant.label).observe(dt)
        if p is None:
            # tracing off (or the threaded wire): observed here; with
            # tracing on the recorder observes at the wire write
            (self._ss0 if not app
             else self._serve_seconds.labels(app=app)).observe(dt)
        out = to_jsonable(prediction)
        if isinstance(out, dict):
            out.update(extra)
        return out

    def _fast_queries(self, raw: RawRequest) -> Optional[bytes]:
        """/queries.json off the raw frame: the compiled query shape (or
        its binary frame), deadline, in-flight and tenant admission
        (the access key, `X-PIO-App` and Basic auth scanned from the
        raw head), the batch submit in the tenant's lane, and the body
        the drainer pre-serialized. None hands the request to the
        generic route: no fast constructor, feedback or plugins on, or
        a body of another shape."""
        dep = self.deployment
        if dep.fast_ctor is None or self._feedback is not None \
                or self.plugin_context.output_blockers \
                or self.plugin_context.output_sniffers:
            return None
        t0 = time.perf_counter()
        rid = raw.header("X-Request-ID") or ""
        keep = raw.keep_alive
        m = _FAST_QUERY_RE.match(raw.body)
        if m is not None:
            try:
                user = m.group(1).decode("utf-8")
            except UnicodeDecodeError:
                return None
            num = int(m.group(2))
        else:
            ct = raw.header("Content-Type")
            if ct is None or not ct.startswith(BIN_CONTENT_TYPE):
                return None
            decoded = decode_bin_query(raw.body)
            if decoded is None:
                # a terminal 400: the generic fallback speaks JSON only
                return self._fast_finish(400, "malformed binary query "
                                         "frame", rid, keep, t0, raw=raw)
            user, num = decoded
        if raw.trace is not None:
            trace.begin_raw(raw, raw.header(trace.TRACE_HEADER),
                            kind="serve")
        admitted = False
        tenant: Optional[TenantIdentity] = None
        try:
            deadline = deadline_from_header(raw.header(DEADLINE_HEADER))
            if deadline is not None and deadline.expired:
                return self._fast_finish(
                    504, "deadline expired before processing", rid, keep,
                    t0, raw=raw)
            if self._pressure.shedding():
                self._shed_counter.labels(surface="memory", app="").inc()
                return self._fast_finish(
                    503, "memory pressure: shedding new work", rid, keep,
                    t0, retry_after=1.0, raw=raw)
            if self.admission.enabled:
                qs = raw.query_string
                tenant = self.admission.resolve_raw(
                    _scan_query(qs, "accessKey", _ACCESS_KEY_RE),
                    raw.header(TENANT_HEADER), raw.header("Authorization"),
                    channel=_scan_query(qs, "channel", _CHANNEL_RE))
            with self._limiter:
                admitted = True
                with self.admission.admit(tenant):
                    trace.stamp(raw, trace.S_AUTH)
                    label, weight, tqmax = \
                        self.admission.batch_params(tenant)
                    slot = self.batcher.submit_slot(
                        dep, dep.fast_ctor(user, num), deadline, label,
                        weight, tqmax, pending=raw.trace)
        except HTTPError as e:
            return self._fast_finish(e.status, e.message, rid, keep, t0,
                                     tenant=tenant, extra=e.headers,
                                     raw=raw)
        except DeadlineExceeded as e:
            return self._fast_finish(504, str(e), rid, keep, t0,
                                     tenant=tenant, raw=raw)
        except OverloadedError as e:
            if not admitted:
                self._shed_counter.labels(surface=self._limiter.surface,
                                          app="").inc()
            return self._fast_finish(e.status, e.message, rid, keep, t0,
                                     retry_after=e.retry_after,
                                     tenant=tenant, raw=raw)
        except CircuitOpenError as e:
            return self._fast_finish(503, str(e), rid, keep, t0,
                                     retry_after=e.retry_after,
                                     tenant=tenant, raw=raw)
        except ValueError as e:
            return self._fast_finish(400, str(e), rid, keep, t0,
                                     tenant=tenant, raw=raw)
        except Exception as e:  # noqa: BLE001 — request boundary
            _log.exception("unhandled_error", request_id=rid,
                           method="POST", path="/queries.json",
                           error=f"{type(e).__name__}: {e}")
            return self._fast_finish(500, str(e), rid, keep, t0,
                                     tenant=tenant, raw=raw)
        wire = slot.get("wire")
        if wire is None:
            wire = json.dumps(to_jsonable(slot["result"])).encode("utf-8")
        dt = time.perf_counter() - t0
        self._count_request(dt)
        self._fq_ok.inc()
        self._fq_hist.observe(dt)
        app = tenant.label if tenant is not None else ""
        if tenant is not None:
            self._serve_obs.tenant_serve.labels(app=app).observe(dt)
        self._slo.record(app, dt, ok=True)
        if self._quality is not None:
            self._quality.observe_result(app, slot["result"], user,
                                         dep.user_maps)
        trace.annotate(raw, status=200, app=app, route="/queries.json",
                       query=(user, num))
        trace.stamp(raw, trace.S_DONE)
        if raw.trace is None:
            # tracing off: observed here (the recorder observes at the
            # wire write when tracing is on)
            (self._ss0 if not app
             else self._serve_seconds.labels(app=app)).observe(dt)
        return build_response(200, "application/json", wire, rid,
                              keep_alive=keep)

    def _fast_finish(self, status: int, message: str, rid: str,
                     keep: bool, t0: float,
                     retry_after: Optional[float] = None,
                     tenant: Optional[TenantIdentity] = None,
                     extra: Optional[Dict[str, str]] = None,
                     raw: Optional[RawRequest] = None) -> bytes:
        """A fast-route answer other than 200: the metrics the generic
        middleware records, the same JSON error body."""
        extra = dict(extra or {})
        if retry_after is not None:
            extra.update(retry_after_header(retry_after))
        dt = time.perf_counter() - t0
        app = tenant.label if tenant is not None else ""
        if status == 504:
            self._deadline_counter.labels(route="/queries.json").inc()
        self._req_counter.labels(route="/queries.json", method="POST",
                                 status=str(status)).inc()
        self._fq_hist.observe(dt)
        self._slo.record(app, dt, ok=status < 500)
        if raw is not None:
            trace.annotate(raw, status=status, app=app,
                           route="/queries.json", error=message)
            trace.stamp(raw, trace.S_DONE)
        if raw is None or raw.trace is None:
            (self._ss0 if not app
             else self._serve_seconds.labels(app=app)).observe(dt)
        body = b'{"message": ' + _json_str(message).encode("ascii") + b'}'
        return build_response(status, "application/json", body, rid,
                              extra or None, keep_alive=keep)

    @staticmethod
    def _query_payload(req: Request) -> Any:
        """The query of a generic-route request: its JSON body, or its
        binary frame (the threaded wire, feedback or plugins on, or a
        fleet router's proxy)."""
        if (req.header("Content-Type") or "").startswith(BIN_CONTENT_TYPE):
            decoded = decode_bin_query(req.body)
            if decoded is None:
                raise HTTPError(400, "malformed binary query frame")
            return {"user": decoded[0], "num": decoded[1]}
        try:
            return json.loads(req.body or b"{}")
        except ValueError as e:
            raise HTTPError(400, f"malformed JSON body: {e}")

    # -- fleet membership ---------------------------------------------------
    def shard_spec(self) -> str:
        """"i/n" on a fleet member that serves catalog slice i of n
        (`mesh=ShardSlice(n, i)`), else "": what the replica agent's
        heartbeats and /shard/queries.json report."""
        m = self.mesh
        if m is None or not hasattr(m, "index"):
            return ""
        return f"{m.index}/{m.n_shards}"

    def current_instance_id(self) -> str:
        """The serving engine instance's id ("" for a model file): a
        replica agent's heartbeats carry it."""
        return self.deployment.instance_id or ""

    def readiness(self):
        """/ready: serving, not stopping, and no storage breaker open;
        the SLO burn is detail only (a page, not a reason to leave
        rotation)."""
        states = (self._store.breaker_states()
                  if self._store is not None else {})
        detail: Dict[str, Any] = {"modelLoaded": True,
                                  "storageBreakers": states}
        slo = self._slo.snapshot()
        if slo:
            detail["slo"] = slo
            detail["sloDegraded"] = self._slo.degraded()
        degraded = [b.role for b in self._own_beats() if b.degraded]
        if degraded:
            detail["degradedLoops"] = degraded
        if not self._pressure.ready():
            detail["memPressure"] = self._pressure.detail()
            return (False, detail)
        open_breakers = [n for n, st in states.items() if st == "open"]
        return (not self._stopping and not open_breakers and not degraded,
                detail)

    def _own_beats(self) -> List[Any]:
        """The watchdog beats whose degradation fails THIS server's
        /ready (the process may run several servers)."""
        beats = [getattr(self._refresher, "beat", None),
                 getattr(self._joiner, "beat", None),
                 self.batcher._drain_beat,
                 getattr(self._pager, "beat", None),
                 getattr(self._feedback, "beat", None),
                 getattr(self._scraper, "_beat", None)]
        return [b for b in beats if b is not None]

    # -- status -------------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """GET /: the engine instance, the kernel's launches, the plans'
        calls and shapes, batches, serve paths, refresher, feedback."""
        from predictionio_tpu_torch.ops import fused_topk, topk
        dep = self.deployment
        devices = sorted({str(m.device) for m in dep.models
                          if hasattr(m, "device")})
        with self._stats_lock:
            stats = {"requests": self.request_count,
                     "avg_serving_sec": self.avg_serving_sec,
                     "last_serving_sec": self.last_serving_sec}
        plans = dep.plans()
        return {"status": "alive",
                "engineInstanceId": dep.instance_id,
                "pid": os.getpid(),
                "deploy_timings": dep.timings,
                "algorithms": [type(a).__name__ for a in dep.algos],
                "plans": [type(p).__name__ for p in plans],
                "plan_calls": sum(getattr(p, "calls", 0) for p in plans),
                "process_plan_calls": topk.PLAN_CALLS,
                "plan_buckets": [list(getattr(p, "buckets", ()))
                                 for p in plans],
                "plan_banned_widths": [getattr(p, "banned_width", None)
                                       for p in plans],
                "serve_paths": [dict(getattr(a, "serve_paths", {}))
                                for a in dep.algos],
                "devices": devices,
                "wire": self.wire,
                "shard": self.shard_spec(),
                "tenancy": self.admission.enabled,
                "kernel_launches": {
                    "fused_topk": fused_topk.LAUNCHES,
                    "shard_local_candidates": fused_topk.SHARD_LAUNCHES},
                "batch_sizes": {str(k): v for k, v in
                                sorted(self.batcher.batch_sizes().items())},
                "refresh": (self._refresher.status()
                            if self._refresher is not None else None),
                "feedback": (self._feedback.status()
                             if self._feedback is not None else None),
                "quality": self._quality is not None,
                "memPressure": self._pressure.detail(),
                **stats}

    def status_json(self) -> Dict[str, Any]:
        """/status.json: the JAX keys under the JAX names, then the
        port's counters of GET /."""
        dep = self.deployment
        with self._stats_lock:
            head = {"status": "alive",
                    "engineInstanceId": dep.instance_id,
                    "engineVariant": dep.engine_variant,
                    "startTime": format_time(self.start_time),
                    "requestCount": self.request_count,
                    "avgServingSec": self.avg_serving_sec,
                    "lastServingSec": self.last_serving_sec}
        return {**self.status(), **head}

    def quality_snapshot(self) -> Dict[str, Any]:
        """`/quality.json`: the per-app accumulators, the feedback
        joiner's reward view and the last canary report."""
        out: Dict[str, Any] = {
            "enabled": self._quality is not None,
            "apps": (self._quality.snapshot()
                     if self._quality is not None else {})}
        if self._joiner is not None:
            out["joiner"] = self._joiner.snapshot()
        if self._canary is not None:
            out["canary"] = self._canary.last
        return out

    def _shed_on_pressure(self, app: str) -> None:
        """503 with Retry-After while the memory guard sheds."""
        if self._pressure.shedding():
            self._shed_counter.labels(surface="memory", app=app).inc()
            raise OverloadedError("memory pressure: shedding new work",
                                  retry_after=1.0)

    # -- routes -------------------------------------------------------------
    def _routes(self) -> None:
        r = self.router

        @r.post("/queries.json")
        def queries(req: Request) -> Response:
            # tenancy on: authenticate the app key, then charge the
            # app's quotas (429 with Retry-After past them)
            tenant = self.admission.resolve(req)
            app = tenant.label if tenant is not None else ""
            self._shed_on_pressure(app)
            t0 = time.perf_counter()
            try:
                with self.admission.admit(tenant):
                    resp = Response.json(self.serve_query(
                        self._query_payload(req), tenant))
            except Exception as e:
                self._slo.record(app, time.perf_counter() - t0,
                                 ok=getattr(e, "status", 500) < 500)
                raise
            self._slo.record(app, time.perf_counter() - t0, ok=True)
            return resp

        @r.post("/shard/queries.json")
        def shard_queries(req: Request) -> Response:
            """The fleet member's surface: this member's candidates
            (its catalog slice, or the whole catalog on a member with
            none) with GLOBAL item ids, which the router merges by
            (-score, id)."""
            tenant = self.admission.resolve(req)
            self._shed_on_pressure(tenant.label if tenant is not None
                                   else "")
            with self.admission.admit(tenant):
                dep = self.deployment
                payload = self._query_payload(req)
                query = (extract_params(dep.query_class, payload)
                         if dep.query_class is not None else payload)
                label, weight, tqmax = self.admission.batch_params(tenant)
                prediction = self.batcher.submit(
                    dep, query, current_deadline(), label, weight, tqmax)
            if self._quality is not None:
                self._quality.observe_result(
                    tenant.label if tenant is not None else "", prediction,
                    getattr(query, "user", None), dep.user_maps)
            out = to_jsonable(prediction)
            scores = (out.get("itemScores") or ()) \
                if isinstance(out, dict) else ()
            cands = []
            for sc in scores:
                name = sc.get("item")
                gid = next((g for g in (im.get(name)
                                        for im in dep.item_maps)
                            if g is not None), None)
                cands.append([-1 if gid is None else int(gid),
                              sc.get("score", 0.0), name])
            num = (query.get("num") if isinstance(query, dict)
                   else getattr(query, "num", None))
            return Response.json({"shard": self.shard_spec(),
                                  "num": int(num) if num else len(cands),
                                  "cands": cands})

        @r.get("/")
        def index(req: Request) -> Response:
            return Response.json(self.status())

        @r.get("/status.json")
        def status_json(req: Request) -> Response:
            return Response.json(self.status_json())

        @r.post("/reload")
        def reload(req: Request) -> Response:
            self.auth.check(req)
            prev = self.deployment
            try:
                self.reload()
            except Exception as e:  # noqa: BLE001 — rolled back
                _log.error("reload_failed_rolled_back",
                           error=f"{type(e).__name__}: {e}",
                           serving_instance=prev.instance_id)
                raise HTTPError(
                    500, f"Reload failed ({type(e).__name__}: {e}); "
                         "previous deployment still serving")
            return Response.json({"message": "Reloaded"})

        @r.post("/stop")
        def stop(req: Request) -> Response:
            self.auth.check(req)
            # drain on a thread of its own: this worker must answer
            threading.Thread(target=self.stop, daemon=True,
                             name="pio-torch-server-stop").start()
            return Response.json({"message": "Shutting down"})

        @r.get("/quality.json")
        def quality_json(req: Request) -> Response:
            return Response.json(self.quality_snapshot())

        @r.get("/plugins.json")
        def plugins_json(req: Request) -> Response:
            return Response.json(self.plugin_context.describe())

        def plugin_rest(req: Request) -> Response:
            pname = req.params["pname"]
            args = [a for a in req.params.get("args", "").split("/") if a]
            table = {**self.plugin_context.output_blockers,
                     **self.plugin_context.output_sniffers}
            if pname not in table:
                raise HTTPError(404, f"Unknown plugin {pname}")
            return Response.json(table[pname].handle_rest(args))

        r.get("/plugins/<pname>")(plugin_rest)
        r.get("/plugins/<pname>/<args:path>")(plugin_rest)
        # selector wire only; what it declines takes the route above
        self.fast_route("POST", "/queries.json", self._fast_queries)


def install_signal_handlers(server, on_stopped=None) -> None:
    """Route SIGTERM and SIGINT through the server's graceful `stop()`
    (or `shutdown()`, for servers without one) on a thread of its own,
    then call `on_stopped`. Main thread only (the signal module's
    rule); never installed by `start()`."""
    import signal

    def _drain_and_exit():
        try:
            stop = getattr(server, "stop", None)
            (stop if callable(stop) else server.shutdown)()
        finally:
            if on_stopped is not None:
                on_stopped()

    def _handle(signum, frame):
        _log.warning("signal_graceful_stop",
                     signal=signal.Signals(signum).name)
        threading.Thread(target=_drain_and_exit, daemon=True,
                         name="pio-torch-signal-stop").start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _handle)


def _tiered_plans(dep: _Deployment) -> List[Any]:
    """The deployment's tiered (demand-paged) serving plans, unwrapping
    one fleet-slice layer, where a giant slice tiers itself."""
    out: List[Any] = []
    for algo in dep.algos:
        plan = getattr(algo, "_serve_plan", None)
        plan = getattr(plan, "_inner", plan)
        if hasattr(plan, "fold_accesses") and plan not in out:
            out.append(plan)
    return out
