"""HTTP framework of the port's REST planes, over one of two wires.

The port of `predictionio_tpu/utils/http.py` (the reference's spray/akka
REST planes, EventServer.scala, CreateServer.scala): `Request`,
`Response`, `HTTPError`, a `Router` with `<name>` (one path segment) and
`<name:path>` (across slashes) captures, and `HTTPServerBase`, which
serves a router over

  - `selector` (the default): the readiness loop of `utils/wire.py`,
    keep-alive connections multiplexed by reactor threads over a worker
    pool, with a `fast_route` hook that answers a hot route straight
    from the framed bytes (no header dict, no Request object);
  - `threaded`: the standard library's `ThreadingHTTPServer`, one thread
    per connection, chosen by `PIO_SERVE_WIRE=threaded` or `wire=
    "threaded"`, and always under TLS (the selector loop does not speak
    TLS).

Routing, middleware and handler contracts are the same on both wires.
Every server answers

  GET /metrics  the process-default registry (or the one passed) in the
                Prometheus text format, with the selector wire's
                `pio_wire_*` counters scraped in
  GET /health   liveness: {"status": "ok"}
  GET /ready    readiness: {"ready": ...} from the `readiness()` hook,
                503 when not ready

Middleware, per request: a request id (`X-Request-ID` in, else a fresh
one; always echoed), one structured JSON log line (method, path, route,
status, duration_ms, request_id), `pio_http_requests_total{route,
method,status}` and `pio_http_request_duration_seconds{route}`; the
`X-PIO-Deadline-Ms` header becomes a `Deadline` installed for the handler (expiry anywhere below
it answers 504, counted in `pio_deadline_expired_total`); past
`max_inflight` concurrent requests the plane sheds with 503 and
`Retry-After` (`pio_shed_total`).

Error bodies keep the JAX shape `{"message": ...}` with the JAX status
codes: an unknown path 404, a known path with another method 405, a
raised `HTTPError` its own status, `DeadlineExceeded` 504, an
`OverloadedError` its status with `Retry-After`, a `ValueError` (bad
JSON, an invalid event) 400, any other exception 500. Path captures are
matched on the raw (still percent-encoded) path and then decoded one by
one, so that an id holding `%2F` stays reachable.

Traces, the sampling profiler, the time-series ring and their endpoints
are not ported yet (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import base64
import errno
import json
import os
import re
import ssl as ssl_module
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from predictionio_tpu_torch.obs import (MetricsRegistry, get_logger,
                                        get_registry, new_request_id)
from predictionio_tpu_torch.resilience import (DEADLINE_HEADER, Deadline,
                                               DeadlineExceeded,
                                               InflightLimiter,
                                               OverloadedError,
                                               deadline_from_header,
                                               deadline_scope)
from predictionio_tpu_torch.utils.wire import (RawRequest, SelectorWire,
                                               ShardedWire, build_response,
                                               reactor_count)

_log = get_logger("http")


@dataclass
class Request:
    method: str
    path: str
    query: Mapping[str, str]
    headers: Mapping[str, str]
    body: bytes
    params: Mapping[str, str] = field(default_factory=dict)  # captures
    client: str = ""
    request_id: str = ""       # set by the middleware, never empty there
    route: str = ""            # the matched route pattern (metrics label)
    deadline: Optional[Deadline] = None   # X-PIO-Deadline-Ms / default

    def json(self) -> Any:
        if not self.body:
            raise ValueError("Empty request body")
        try:
            return json.loads(self.body.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise ValueError(f"Invalid JSON: {e}") from e

    def header(self, name: str, default: Optional[str] = None
               ) -> Optional[str]:
        """Case-insensitive header lookup (RFC 7230 names are
        case-insensitive, and clients disagree on their casing)."""
        v = self.headers.get(name)
        if v is not None:
            return v
        lname = name.lower()
        for k, val in self.headers.items():
            if k.lower() == lname:
                return val
        return default

    def query_get(self, name: str, default: Optional[str] = None
                  ) -> Optional[str]:
        return self.query.get(name, default)


@dataclass
class Response:
    status: int = 200
    body: Any = None              # JSON-serializable, or bytes, or str
    content_type: str = "application/json"
    headers: Mapping[str, str] = field(default_factory=dict)

    @staticmethod
    def json(obj: Any, status: int = 200, **headers) -> "Response":
        return Response(status=status, body=obj, headers=headers)

    @staticmethod
    def text(s: str, status: int = 200,
             content_type: str = "text/plain") -> "Response":
        return Response(status=status, body=s, content_type=content_type)

    def encode(self) -> bytes:
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


Handler = Callable[[Request], Response]


class HTTPError(Exception):
    """Raise from a handler to answer `{"message": message}` with
    `status`."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Mapping[str, str]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers: Dict[str, str] = dict(headers or {})


def retry_after_header(seconds: float) -> Dict[str, str]:
    """`Retry-After` in whole seconds, at least 1, as the JAX planes
    send it."""
    return {"Retry-After": str(max(1, round(seconds)))}


def _compile(pattern: str) -> re.Pattern:
    """`<name>` captures one segment; `<name:path>` captures across
    slashes."""
    parts = []
    for piece in re.split(r"(<[a-zA-Z_]+(?::path)?>)", pattern):
        if piece.startswith("<") and piece.endswith(">"):
            inner = piece[1:-1]
            if inner.endswith(":path"):
                parts.append(f"(?P<{inner[:-5]}>.+)")
            else:
                parts.append(f"(?P<{inner}>[^/]+)")
        else:
            parts.append(re.escape(piece))
    return re.compile("^" + "".join(parts) + "$")


class Router:
    def __init__(self):
        self.routes: List[Tuple[str, str, re.Pattern, Handler]] = []

    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self.routes.append(
                (method.upper(), pattern, _compile(pattern), fn))
            return fn
        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def delete(self, pattern: str):
        return self.route("DELETE", pattern)

    def dispatch(self, req: Request) -> Response:
        path_matched = False
        for method, pattern, regex, fn in self.routes:
            m = regex.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            # captures match the raw path and are decoded one by one:
            # decoding first would let %2F alter the routing
            req.route = pattern
            req.params = {k: unquote(v) for k, v in m.groupdict().items()}
            try:
                return fn(req)
            except HTTPError as e:
                return Response.json({"message": e.message}, e.status,
                                     **e.headers)
            except DeadlineExceeded as e:
                return Response.json({"message": str(e)}, 504)
            except OverloadedError as e:
                return Response.json({"message": e.message}, e.status,
                                     **retry_after_header(e.retry_after))
            except ValueError as e:
                return Response.json({"message": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — request boundary
                _log.exception("unhandled_error",
                               request_id=req.request_id,
                               method=req.method, path=req.path,
                               error=f"{type(e).__name__}: {e}")
                return Response.json({"message": f"{e}"}, 500)
        if path_matched:
            return Response.json({"message": "Method Not Allowed"}, 405)
        return Response.json({"message": "Not Found"}, 404)


class HTTPServerBase:
    """A router served over the selector or the threaded wire, with the
    `start()` / `shutdown()` lifecycle. Subclasses add routes to
    `self.router`, may register raw `fast_route`s, and may override
    `readiness()` and `_on_bound()`. `wire` ("selector" or "threaded")
    overrides `PIO_SERVE_WIRE`; TLS (`ssl_context`) always takes the
    threaded wire."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 ssl_context: Optional[ssl_module.SSLContext] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 max_inflight: int = 0,
                 wire: Optional[str] = None):
        self.host = host
        self.port = port
        self.router = Router()
        self._ssl_context = ssl_context
        self._wire_choice = wire
        # ThreadingHTTPServer, SelectorWire or ShardedWire: one lifecycle
        self._httpd: Optional[Any] = None
        self._thread: Optional[threading.Thread] = None
        self._lifecycle_lock = threading.Lock()
        # the process-default registry unless one is passed, so that one
        # /metrics scrape sees every server of the process
        self.metrics = metrics if metrics is not None else get_registry()
        self.obs_log = get_logger(type(self).__name__)
        self._req_counter = self.metrics.counter(
            "pio_http_requests_total", "HTTP requests served",
            labels=("route", "method", "status"))
        self._req_hist = self.metrics.histogram(
            "pio_http_request_duration_seconds",
            "HTTP request wall time by matched route", labels=("route",))
        self._limiter = InflightLimiter(max_inflight,
                                        surface=type(self).__name__)
        # `app` names the shedding tenant where one is known; the
        # in-flight shed happens before any auth, hence app=""
        self._shed_counter = self.metrics.counter(
            "pio_shed_total", "Requests shed by surface at admission",
            labels=("surface", "app"))
        self._deadline_counter = self.metrics.counter(
            "pio_deadline_expired_total",
            "Requests that exhausted their deadline", labels=("route",))
        self.router.get("/metrics")(self._metrics_endpoint)
        self.router.get("/health")(self._health_endpoint)
        self.router.get("/ready")(self._ready_endpoint)
        # the last absolute wire counters seen, so that the monotone
        # pio_wire_* counters advance by delta on each scrape
        self._wire_last: Dict[str, float] = {}
        # (method, path) -> a handler of the raw framed request that
        # returns a whole response, or None to fall through to the
        # router (selector wire only)
        self._fast_routes: Dict[Tuple[str, str],
                                Callable[[RawRequest], Optional[bytes]]] = {}
        self.wire = "unstarted"

    def fast_route(self, method: str, path: str,
                   fn: Callable[[RawRequest], Optional[bytes]]) -> None:
        """Register a raw-bytes handler for one exact (method, path). It
        returns a whole HTTP response as bytes, or None to hand the
        request to the router, where the same path must be a route."""
        self._fast_routes[(method.upper(), path)] = fn

    def _metrics_endpoint(self, req: Request) -> Response:
        self._sync_wire_metrics()
        return Response.text(
            self.metrics.render(),
            content_type="text/plain; version=0.0.4; charset=utf-8")

    def _sync_wire_metrics(self) -> None:
        """The selector wire's raw counters into `pio_wire_*` families
        (on each /metrics; the wire itself stays obs-free): monotone
        values advance their counter by the delta since the last scrape,
        instantaneous ones land in gauges, each with a `reactor` label
        ("0" for the single-reactor wire)."""
        snap_fn = getattr(self._httpd, "stats_snapshot", None)
        if snap_fn is None:
            return
        snap = snap_fn()
        shards = snap.get("reactors") or [snap]
        listen = f"{self.host}:{self.port}"
        m = self.metrics
        last = self._wire_last

        def _cdelta(name: str, help_text: str, key: str, value: float,
                    **extra) -> None:
            k = name + key + str(sorted(extra.items()))
            delta = value - last.get(k, 0.0)
            if delta > 0:
                m.counter(name, help_text,
                          labels=("listen",) + tuple(sorted(extra))
                          ).labels(listen=listen, **extra).inc(delta)
            last[k] = value

        for rs in shards:
            r = str(rs.get("reactor", 0))
            _cdelta("pio_wire_connections_accepted_total",
                    "Connections accepted by the selector wire",
                    f"accepted[{r}]", float(rs["accepted"]), reactor=r)
            _cdelta("pio_wire_requests_total",
                    "Requests framed off the selector wire",
                    f"requests[{r}]", float(rs["requests"]), reactor=r)
            _cdelta("pio_wire_responses_total",
                    "Responses fully written by the selector wire",
                    f"responses[{r}]", float(rs["responses"]), reactor=r)
            _cdelta("pio_wire_egress_flushes_total",
                    "Gathered egress syscalls (sendmsg batches); "
                    "responses/flushes is the writev coalescing ratio",
                    f"flushes[{r}]", float(rs.get("flushes", 0)),
                    reactor=r)
            _cdelta("pio_wire_send_failures_total",
                    "Response writes that failed or timed out",
                    f"send_failures[{r}]", float(rs["send_failures"]),
                    reactor=r)
            _cdelta("pio_wire_bytes_total", "Wire bytes by direction",
                    f"bytes_in[{r}]", float(rs["bytes_in"]),
                    dir="in", reactor=r)
            _cdelta("pio_wire_bytes_total", "Wire bytes by direction",
                    f"bytes_out[{r}]", float(rs["bytes_out"]),
                    dir="out", reactor=r)
            for status, count in dict(rs["errors"]).items():
                _cdelta("pio_wire_errors_total",
                        "Wire-level framing error responses by status",
                        f"err{status}[{r}]", float(count),
                        status=str(status), reactor=r)
            for name, help_text, value in (
                    ("pio_wire_connections_open",
                     "Connections currently registered with the reactor",
                     rs["open_conns"]),
                    ("pio_wire_queue_depth",
                     "Connections waiting for a wire worker",
                     rs["queue_depth"]),
                    ("pio_wire_workers_busy",
                     "Wire workers currently running a handler",
                     rs["busy_workers"]),
                    ("pio_wire_workers", "Wire worker pool size",
                     rs["workers"]),
                    ("pio_wire_pipeline_depth_hwm",
                     "High-water mark of framed-but-unserved pipelined "
                     "requests on one connection", rs["pipeline_hwm"]),
                    ("pio_wire_worker_utilization",
                     "Busy fraction of the wire worker pool "
                     "(busy_workers / workers)",
                     rs.get("utilization", 0.0))):
                m.gauge(name, help_text,
                        labels=("listen", "reactor")).labels(
                            listen=listen, reactor=r).set(float(value))
            reqs = float(rs["requests"])
            reuse = ((reqs - float(rs["accepted"])) / reqs
                     if reqs > 0 else 0.0)
            m.gauge("pio_wire_keepalive_reuse_ratio",
                    "Fraction of requests that reused a kept-alive "
                    "connection", labels=("listen", "reactor")).labels(
                        listen=listen, reactor=r).set(max(0.0, reuse))

    # -- health/readiness ---------------------------------------------------
    def readiness(self) -> Tuple[bool, Dict[str, Any]]:
        """Subclass hook: (ready?, detail). Default: serving = ready."""
        return True, {}

    def _health_endpoint(self, req: Request) -> Response:
        return Response.json({"status": "ok"})

    def _ready_endpoint(self, req: Request) -> Response:
        ok, detail = self.readiness()
        body = {"ready": ok}
        body.update(detail)
        return Response.json(body, 200 if ok else 503)

    # -- middleware ---------------------------------------------------------
    def _handle(self, req: Request) -> Response:
        """Deadline extraction and propagation, in-flight admission,
        then the router."""
        try:
            req.deadline = deadline_from_header(req.header(DEADLINE_HEADER))
        except ValueError as e:
            return Response.json({"message": str(e)}, 400)
        if req.deadline is not None and req.deadline.expired:
            return Response.json(
                {"message": "deadline expired before processing"}, 504)
        try:
            with self._limiter:
                with deadline_scope(req.deadline):
                    return self.router.dispatch(req)
        except OverloadedError as e:
            self._shed_counter.labels(surface=self._limiter.surface,
                                      app="").inc()
            return Response.json({"message": e.message}, e.status,
                                 **retry_after_header(e.retry_after))

    def _handle_raw(self, raw: RawRequest) -> Tuple[bytes, bool]:
        """The selector wire's one entry point: the fast-route table on
        the raw frame, else a whole Request through the same middleware
        and router the threaded wire runs. Returns (response bytes,
        close the connection?)."""
        fast = self._fast_routes.get((raw.method, raw.path))
        if fast is not None:
            out = fast(raw)
            if out is not None:
                return out, not raw.keep_alive
        rid = raw.header("X-Request-ID") or new_request_id()
        raw_q = parse_qs(raw.query_string, keep_blank_values=True)
        req = Request(method=raw.method, path=raw.path,
                      query={k: v[0] for k, v in raw_q.items()},
                      headers=dict(raw.header_items()), body=raw.body,
                      client=raw.client, request_id=rid)
        started = time.perf_counter()
        resp = self._handle(req)
        self._observe_request(req, resp, time.perf_counter() - started)
        out = build_response(
            resp.status, resp.content_type, resp.encode(), rid,
            dict(resp.headers) if resp.headers else None,
            keep_alive=raw.keep_alive, head_only=raw.method == "HEAD")
        return out, not raw.keep_alive

    def _observe_request(self, req: Request, resp: Response,
                         duration: float) -> None:
        route = req.route or "(unmatched)"
        if resp.status == 504:
            self._deadline_counter.labels(route=route).inc()
        self._req_counter.labels(
            route=route, method=req.method, status=str(resp.status)).inc()
        self._req_hist.labels(route=route).observe(duration)
        self.obs_log.info(
            "request", request_id=req.request_id, method=req.method,
            path=req.path, route=route, status=resp.status,
            duration_ms=round(duration * 1000.0, 3))

    # -- lifecycle ----------------------------------------------------------
    def _threaded_handler(self):
        server_ref = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 60    # an idle keep-alive connection's thread
            # TCP_NODELAY: the head and the body go out in two writes,
            # and on a kept-alive connection Nagle's algorithm would
            # hold the body for the client's delayed ACK (about 40 ms)
            disable_nagle_algorithm = True

            def _respond(self):
                parsed = urlparse(self.path)
                query = {k: v[0] for k, v in parse_qs(
                    parsed.query, keep_blank_values=True).items()}
                rid = self.headers.get("X-Request-ID") or new_request_id()
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    if length < 0:
                        raise ValueError("negative Content-Length")
                except ValueError:
                    # the body was never read: answer, then close
                    self.close_connection = True
                    self._reply(Response.json(
                        {"message": "Invalid Content-Length header"}, 400),
                        rid)
                    return
                body = self.rfile.read(length) if length else b""
                req = Request(method=self.command, path=parsed.path,
                              query=query,
                              headers=dict(self.headers.items()),
                              body=body, client=self.client_address[0],
                              request_id=rid)
                started = time.perf_counter()
                resp = server_ref._handle(req)
                server_ref._observe_request(
                    req, resp, time.perf_counter() - started)
                self._reply(resp, rid)

            def _reply(self, resp: Response, rid: str) -> None:
                data = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("X-Request-ID", rid)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_POST = do_DELETE = do_PUT = do_HEAD = _respond

            def log_message(self, fmt, *args):   # no per-request lines
                pass

        return _Handler

    def start(self, background: bool = True) -> int:
        """Bind (three attempts on EADDRINUSE, as CreateServer.scala:
        260-285 retries its bind) the chosen wire and serve, in a daemon
        thread unless `background` is False; returns the bound port."""
        want = (self._wire_choice
                or os.environ.get("PIO_SERVE_WIRE", "selector")).lower()
        if want not in ("selector", "threaded"):
            raise ValueError(f"unknown wire {want!r} "
                             "(selector or threaded)")
        use_selector = want == "selector" and self._ssl_context is None
        self.wire = "selector" if use_selector else "threaded"
        handler = self._threaded_handler()
        # a deep listen backlog: bursts of concurrent clients queue
        # instead of being reset (the socketserver default is 5)
        server_cls = type("_Server", (ThreadingHTTPServer,),
                          {"request_queue_size": 1024,
                           "daemon_threads": True})

        def _bind():
            if use_selector:
                n = reactor_count()
                if n > 1:
                    return ShardedWire((self.host, self.port),
                                       self._handle_raw, reactors=n)
                return SelectorWire((self.host, self.port),
                                    self._handle_raw)
            return server_cls((self.host, self.port), handler)

        for attempt in range(3):
            try:
                self._httpd = _bind()
                break
            except OSError as e:
                if attempt == 2 or e.errno != errno.EADDRINUSE:
                    raise
                time.sleep(0.5 * (attempt + 1))
        if self._ssl_context is not None:
            self._httpd.socket = self._ssl_context.wrap_socket(
                self._httpd.socket, server_side=True)
        self.port = self._httpd.server_address[1]
        self._on_bound()
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name=f"pio-torch-http-{self.port}")
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def _on_bound(self) -> None:
        """Subclass hook: runs once the wire is bound (`self._httpd`
        set, `self.port` final) and before it serves; the place to
        connect wire callbacks such as the micro-batcher's flush hint."""

    def shutdown(self) -> None:
        """Stop serving and close the sockets; idempotent and safe
        under a race (a /stop handler's thread against a caller)."""
        with self._lifecycle_lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5)

    def is_running(self) -> bool:
        return self._httpd is not None


def parse_basic_auth_value(auth: Optional[str]) -> Optional[str]:
    """The username of one raw `Authorization: Basic` value (the
    reference takes the access key as the Basic username,
    EventServer.scala:114-126); None without one or when it does not
    decode."""
    if not auth or not auth.startswith("Basic "):
        return None
    try:
        decoded = base64.b64decode(auth[len("Basic "):]).decode("utf-8")
    except Exception:  # noqa: BLE001 — a malformed header is no user
        return None
    return decoded.split(":")[0].strip() or None


def parse_basic_auth_user(headers: Mapping[str, str]) -> Optional[str]:
    """The username of a Basic `Authorization` header."""
    return parse_basic_auth_value(
        headers.get("Authorization") or headers.get("authorization"))
