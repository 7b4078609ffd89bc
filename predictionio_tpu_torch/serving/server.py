"""Prediction server: `/queries.json` over a micro-batcher.

The port of the core of `predictionio_tpu/serving/server.py`
(CreateServer.scala): a deployment (`_Deployment.predict_batch`), the
micro-batcher that coalesces concurrent requests into device batches
(`_MicroBatcher`), and an HTTP front end on the standard library's
`ThreadingHTTPServer` that answers

  POST /queries.json   {"user", "num", "blackList"?, "whiteList"?}
                       -> {"itemScores": [{"item", "score"}]}
  GET  /               status JSON: the engine instance served, the
                       fused kernel's launch counts, the serving plans'
                       kinds and their calls, the refresher's ticks,
                       the feedback loop's sent and dropped counts

A deployment whose plan is tiered (`ops/topk_tiered.TieredTopK`, bare
or inside a fleet slice) gets a `serving.paging.PageManager` thread for
the server's lifetime. With `refresh_interval_s` > 0 a
`streaming.Refresher` thread keeps the deployment fresh: it folds new
events into the models and publishes a new deployment under
`_dep_lock` (`publish`); a request holds the deployment it started with.

With a `FeedbackConfig` (`cli deploy --feedback`) every served query
becomes a `predict` event (entityType `pio_pr`, entityId a fresh prId,
properties engineInstanceId, prId, query and prediction) on a bounded
queue that one worker thread POSTs to the event server's `/events.json`
(CreateServer.scala:506-576): each send retries with backoff and is then
dropped, and a full queue drops the event instead of stalling the serve
path. The response carries `prId` only where the prediction has such a
field.

Tenancy, fleet, tracing, SLO and quality accounting, the feedback
metrics and watchdog beat, the selector wire and the binary frame are
not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import queue
import random
import string
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.core.params import ParamsError, extract_params
from predictionio_tpu_torch.data.event import format_time, utcnow
from predictionio_tpu_torch.resilience import RetryPolicy, call_with_retry

_log = logging.getLogger("pio.torch.server")


class OverloadedError(RuntimeError):
    """Work refused for capacity: HTTP 503 with Retry-After."""

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceeded(TimeoutError):
    """A queued request outlived its wait: HTTP 504."""


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


class _Deployment:
    """One loaded (algorithms, models, serving) set with the engine and
    the engine instance it came from (None for a model in hand: the
    refresher's full rebuild needs both) and the deploy's timings."""

    def __init__(self, algos, models, serving, *, engine=None,
                 instance=None, timings: Optional[Dict[str, float]] = None):
        self.engine = engine
        self.instance = instance
        self.instance_id = instance.id if instance is not None else None
        self.timings = dict(timings or {})
        self.algos = list(algos)
        self.models = list(models)
        self.serving = serving
        self.query_class = next(
            (a.query_class for a in self.algos if a.query_class is not None),
            None)

    def predict_batch(self, queries: Sequence[Any]) -> List[Any]:
        """supplement -> per-algo batch_predict -> serve, for a batch.

        A failing algorithm is dropped from the ensemble for this batch
        and logged; only when every algorithm fails does the batch
        error."""
        supplemented = [self.serving.supplement(q) for q in queries]
        indexed = list(enumerate(supplemented))
        alive, errors = [], []
        for i, (algo, model) in enumerate(zip(self.algos, self.models)):
            try:
                alive.append(dict(algo.batch_predict(model, indexed)))
            except Exception as e:  # noqa: BLE001 — isolated per algorithm
                errors.append(e)
                _log.warning("algo_predict_failed algo=%d:%s error=%s: %s",
                             i, type(algo).__name__, type(e).__name__, e)
        if not alive:
            raise errors[0]
        return [self.serving.serve(q, [pa[i] for pa in alive])
                for i, q in enumerate(queries)]


class _MicroBatcher:
    """Coalesces concurrent requests into device batches.

    One drainer at a time: a submit either becomes the drainer (none is
    active) or just queues. The drainer waits out the batching window,
    or less when a full batch forms, takes up to `batch_max` pending
    items, processes them outside the lock, and loops while more work
    queued meanwhile; an empty window retires it. The queue is bounded
    (`queue_max`; a full queue raises OverloadedError) and every submit
    waits at most `submit_timeout_s` (then DeadlineExceeded), so a
    wedged drainer never strands a handler thread. A drainer that dies
    fails every waiter and clears the flag for the next submit."""

    def __init__(self, window_s: float, batch_max: int,
                 queue_max: int = 256, submit_timeout_s: float = 30.0):
        self.window_s = window_s
        self.batch_max = batch_max
        self.queue_max = queue_max
        self.submit_timeout_s = submit_timeout_s
        self._lock = threading.Lock()
        self._full = threading.Condition(self._lock)
        # items: (deployment, query, done event, result slot)
        self._queue: deque = deque()
        self._draining = False
        self._closed = False
        # drained batch size -> count
        self._sizes: Dict[int, int] = {}

    def batch_sizes(self) -> Dict[int, int]:
        """Drained batch sizes -> how many batches had that size."""
        with self._lock:
            return dict(self._sizes)

    def submit(self, deployment: _Deployment, query: Any) -> Any:
        done = threading.Event()
        slot: Dict[str, Any] = {}
        item = (deployment, query, done, slot)
        with self._lock:
            if self._closed:
                raise OverloadedError("server draining for shutdown")
            if self.queue_max > 0 and len(self._queue) >= self.queue_max:
                raise OverloadedError("micro-batch queue full",
                                      retry_after=max(self.window_s, 0.05))
            self._queue.append(item)
            if len(self._queue) >= self.batch_max:
                self._full.notify()
            drain = not self._draining
            self._draining = True
        if drain:
            threading.Thread(target=self._drain_loop, daemon=True,
                             name="pio-torch-batch-drain").start()
        if not done.wait(self.submit_timeout_s):
            with self._lock:
                try:
                    self._queue.remove(item)
                except ValueError:
                    pass   # already taken by the drainer
            raise DeadlineExceeded(
                f"micro-batch submit timed out after "
                f"{self.submit_timeout_s:.1f}s")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _drain_loop(self) -> None:
        batch: List[tuple] = []
        try:
            while True:
                with self._lock:
                    self._full.wait_for(
                        lambda: len(self._queue) >= self.batch_max,
                        timeout=self.window_s)
                    n = min(len(self._queue), self.batch_max)
                    batch = [self._queue.popleft() for _ in range(n)]
                    if not batch:
                        # retire under the lock every submit checks, so
                        # the next arrival starts a fresh drainer
                        self._draining = False
                        self._full.notify_all()
                        return
                    self._sizes[n] = self._sizes.get(n, 0) + 1
                self._process(batch)
                batch = []
        except BaseException as e:
            with self._lock:
                stranded = batch + list(self._queue)
                self._queue.clear()
                self._draining = False
                self._full.notify_all()
            for _, _, done, slot in stranded:
                slot["error"] = e
                done.set()
            _log.error("batch_drainer_crashed error=%s: %s stranded=%d",
                       type(e).__name__, e, len(stranded))
            raise

    def _process(self, pending: List[tuple]) -> None:
        # one predict_batch call per deployment among the drained items
        by_dep: Dict[int, List[tuple]] = {}
        for item in pending:
            by_dep.setdefault(id(item[0]), []).append(item)
        for items in by_dep.values():
            dep = items[0][0]
            try:
                results = dep.predict_batch([item[1] for item in items])
            except Exception as e:  # noqa: BLE001 — reported per request
                for _, _, done, slot in items:
                    slot["error"] = e
                    done.set()
                continue
            for (_, _, done, slot), r in zip(items, results):
                slot["result"] = r
                done.set()

    def close(self, timeout: float = 30.0) -> bool:
        """Stop admitting and wait for accepted requests to drain."""
        with self._lock:
            self._closed = True
            return self._full.wait_for(
                lambda: not self._queue and not self._draining,
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
    run out."""

    QUEUE_MAX = 1024    # the JAX ServerConfig's feedback_queue_max
    RETRIES = 3         # and feedback_retries: send attempts per event

    def __init__(self, config: FeedbackConfig):
        self.config = config
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._lock = threading.Lock()
        self.sent = 0
        self.dropped: Dict[str, int] = {"queue_full": 0, "send_failed": 0}
        self._conn = None   # the worker's connection to the event server
        self._policy = RetryPolicy(attempts=self.RETRIES,
                                   base_delay=0.1, max_delay=2.0,
                                   retryable=(OSError,))
        threading.Thread(target=self._drain, daemon=True,
                         name="pio-torch-feedback").start()

    def post(self, dep: "_Deployment", query: Any, prediction: Any,
             pr_id: str) -> None:
        data = {"event": "predict", "eventTime": format_time(utcnow()),
                "entityType": "pio_pr", "entityId": pr_id,
                "properties": {"engineInstanceId": dep.instance_id,
                               "prId": pr_id, "query": to_jsonable(query),
                               "prediction": to_jsonable(prediction)}}
        try:
            self._queue.put_nowait(data)
        except queue.Full:
            self._count_drop("queue_full")
            _log.warning("feedback_dropped reason=queue_full")

    def _count_drop(self, reason: str) -> None:
        with self._lock:
            self.dropped[reason] += 1

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
        while True:
            data = self._queue.get()
            try:
                call_with_retry(self._send, data, policy=self._policy)
                with self._lock:
                    self.sent += 1
            except Exception as e:  # noqa: BLE001 — best effort: drop
                self._count_drop("send_failed")
                _log.warning("feedback_dropped reason=send_failed "
                             "error=%s: %s", type(e).__name__, e)
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
            _log.warning("stop_feedback_unflushed remaining=%d", left)
        return not left

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"sent": self.sent,
                    "dropped": sum(self.dropped.values()),
                    "dropped_by_reason": dict(self.dropped),
                    "queued": self._queue.unfinished_tasks}


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # listen backlog: bursts of concurrent clients queue here instead of
    # being reset (the socketserver default is 5)
    request_queue_size = 1024


class PredictionServer:
    """`/queries.json` over one deployment (CreateServer.scala's
    MasterActor + ServerActor). `port=0` binds an ephemeral port. `ctx`
    (the deploy's `RuntimeContext`: registry and device) serves the
    refresher, which runs when `refresh_interval_s` > 0. `feedback`, a
    `FeedbackConfig`, posts every served prediction back to an event
    server."""

    def __init__(self, deployment: _Deployment, *, host: str = "127.0.0.1",
                 port: int = 8000, batch_max: int = 64,
                 window_s: float = 0.002, ctx=None,
                 refresh_interval_s: float = 0.0,
                 feedback: Optional[FeedbackConfig] = None):
        from predictionio_tpu_torch.core.runtime import RuntimeContext
        self.deployment = deployment
        self._dep_lock = threading.Lock()
        self.ctx = ctx if ctx is not None else RuntimeContext()
        self._refresher = None
        if refresh_interval_s > 0:
            from predictionio_tpu_torch.streaming import Refresher
            self._refresher = Refresher(self, refresh_interval_s)
        self.batcher = _MicroBatcher(window_s, batch_max)
        self._feedback = _Feedback(feedback) if feedback is not None \
            else None
        self._stats_lock = threading.Lock()
        self.request_count = 0
        self.avg_serving_sec = 0.0
        self.last_serving_sec = 0.0
        self._httpd = _HTTPServer((host, port), _handler_for(self))
        self._thread: Optional[threading.Thread] = None
        self._pager = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> int:
        """Serve in a background thread (page tiered plans and run the
        refresher in others); returns the bound port."""
        plans = _tiered_plans(self.deployment)
        if plans:
            from predictionio_tpu_torch.serving.paging import PageManager
            self._pager = PageManager()
            self._pager.bind(plans)
            self._pager.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pio-torch-http", daemon=True)
        self._thread.start()
        if self._refresher is not None:
            self._refresher.start()
        return self.port

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the refresher, drain accepted requests, flush the
        feedback queue within what is left of `timeout`, then close the
        socket and stop the page thread."""
        t0 = time.perf_counter()
        if self._refresher is not None:
            self._refresher.stop()
        self.batcher.close(timeout)
        if self._feedback is not None:
            self._feedback.flush(max(0.0, timeout
                                     - (time.perf_counter() - t0)))
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._pager is not None:
            self._pager.stop()
            self._pager = None

    def publish(self, dep: _Deployment) -> None:
        """Install `dep` as the deployment new requests go to."""
        with self._dep_lock:
            self.deployment = dep

    def _refresh_deployment(self, dep: _Deployment,
                            new_models: Sequence[Any]) -> _Deployment:
        """A fold's publish step: the same engine, instance, algorithms
        and serving with new models. The refresher swaps the device
        factors first and publishes this after."""
        return _Deployment(dep.algos, list(new_models), dep.serving,
                           engine=dep.engine, instance=dep.instance,
                           timings=dep.timings)

    def serve_query(self, payload: Any) -> Any:
        t0 = time.perf_counter()
        dep = self.deployment
        query = (extract_params(dep.query_class, payload)
                 if dep.query_class is not None else payload)
        prediction = self.batcher.submit(dep, query)
        extra = {}
        if self._feedback is not None:
            pr_id = getattr(prediction, "prId", None) or _gen_pr_id()
            self._feedback.post(dep, query, prediction, pr_id)
            if hasattr(prediction, "prId"):
                extra["prId"] = pr_id
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.request_count += 1
            self.last_serving_sec = dt
            self.avg_serving_sec += (
                (dt - self.avg_serving_sec) / self.request_count)
        out = to_jsonable(prediction)
        if isinstance(out, dict):
            out.update(extra)
        return out

    def status(self) -> Dict[str, Any]:
        from predictionio_tpu_torch.ops import fused_topk
        dep = self.deployment
        devices = sorted({str(m.device) for m in dep.models
                          if hasattr(m, "device")})
        with self._stats_lock:
            stats = {"requests": self.request_count,
                     "avg_serving_sec": self.avg_serving_sec,
                     "last_serving_sec": self.last_serving_sec}
        plans = [getattr(a, "_serve_plan", None) for a in dep.algos]
        return {"status": "alive",
                "engineInstanceId": dep.instance_id,
                "deploy_timings": dep.timings,
                "algorithms": [type(a).__name__ for a in dep.algos],
                "plans": [type(p).__name__ for p in plans],
                "plan_calls": sum(getattr(p, "calls", 0) for p in plans),
                "plan_buckets": [list(getattr(p, "buckets", ()))
                                 for p in plans],
                "devices": devices,
                "kernel_launches": {
                    "fused_topk": fused_topk.LAUNCHES,
                    "shard_local_candidates": fused_topk.SHARD_LAUNCHES},
                "batch_sizes": {str(k): v for k, v in
                                sorted(self.batcher.batch_sizes().items())},
                "refresh": (self._refresher.status()
                            if self._refresher is not None else None),
                "feedback": (self._feedback.status()
                             if self._feedback is not None else None),
                **stats}


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


def _handler_for(server: PredictionServer):
    class Handler(BaseHTTPRequestHandler):
        server_version = "pio-torch"

        def log_message(self, fmt, *args):   # no per-request stderr lines
            pass

        def _reply(self, status: int, body: Any,
                   headers: Optional[Dict[str, str]] = None) -> None:
            data = json.dumps(body).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.split("?", 1)[0] != "/":
                self._reply(404, {"message": f"no route {self.path}"})
                return
            self._reply(200, server.status())

        def do_POST(self):
            if self.path.split("?", 1)[0] != "/queries.json":
                self._reply(404, {"message": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:
                self._reply(400, {"message": f"malformed JSON body: {e}"})
                return
            try:
                self._reply(200, server.serve_query(payload))
            except ParamsError as e:
                self._reply(400, {"message": str(e)})
            except OverloadedError as e:
                self._reply(503, {"message": str(e)},
                            {"Retry-After": f"{e.retry_after:.3f}"})
            except DeadlineExceeded as e:
                self._reply(504, {"message": str(e)})
            except Exception as e:  # noqa: BLE001 — request boundary
                _log.exception("query_failed")
                self._reply(500, {"message": f"{type(e).__name__}: {e}"})

    return Handler
