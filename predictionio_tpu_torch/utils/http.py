"""Minimal HTTP framework of the port's REST planes: the threaded wire.

The port of the routing core of `predictionio_tpu/utils/http.py` (the
reference's spray/akka REST planes, EventServer.scala): `Request`,
`Response`, `HTTPError`, a `Router` with `<name>` (one path segment) and
`<name:path>` (across slashes) captures, `parse_basic_auth_user`, and
`HTTPServerBase` on the standard library's `ThreadingHTTPServer`, one
thread per connection, with

  GET /health   liveness: {"status": "ok"}
  GET /ready    readiness: {"ready": ...} from the `readiness()` hook,
                503 when not ready

Error bodies keep the JAX shape `{"message": ...}` with the JAX status
codes, as `Router.dispatch` sets them: an unknown path 404, a known path
with another method 405, a raised `HTTPError` its own status, a
`ValueError` (bad JSON, an invalid event) 400, any other exception 500.
Path captures are matched on the raw (still percent-encoded) path and
then decoded one by one, so that an id holding `%2F` stays reachable.

The selector wire, request metrics and `/metrics`, traces, the sampling
profiler, the time-series ring, deadlines and in-flight admission are
not ported yet (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import base64
import errno
import json
import logging
import re
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

_log = logging.getLogger("pio.torch.http")


@dataclass
class Request:
    method: str
    path: str
    query: Mapping[str, str]
    headers: Mapping[str, str]
    body: bytes
    params: Mapping[str, str] = field(default_factory=dict)  # captures
    client: str = ""
    route: str = ""            # the matched route pattern

    def json(self) -> Any:
        if not self.body:
            raise ValueError("Empty request body")
        try:
            return json.loads(self.body.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise ValueError(f"Invalid JSON: {e}") from e

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
            except ValueError as e:
                return Response.json({"message": str(e)}, 400)
            except Exception as e:  # noqa: BLE001 — request boundary
                _log.exception("unhandled_error method=%s path=%s",
                               req.method, req.path)
                return Response.json({"message": f"{e}"}, 500)
        if path_matched:
            return Response.json({"message": "Method Not Allowed"}, 405)
        return Response.json({"message": "Not Found"}, 404)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a deep listen backlog: bursts of concurrent clients queue instead
    # of being reset (the socketserver default is 5)
    request_queue_size = 1024


class HTTPServerBase:
    """A threaded HTTP server around a `Router`, with the `start()` /
    `shutdown()` lifecycle. Subclasses add routes to `self.router` and
    may override `readiness()`."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.host = host
        self.port = port
        self.router = Router()
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._lifecycle_lock = threading.Lock()
        self.router.get("/health")(self._health_endpoint)
        self.router.get("/ready")(self._ready_endpoint)

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

    # -- lifecycle ----------------------------------------------------------
    def start(self, background: bool = True) -> int:
        """Bind (three attempts on EADDRINUSE, as CreateServer.scala:
        260-285 retries its bind) and serve, in a daemon thread unless
        `background` is False; returns the bound port."""
        router = self.router

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
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    if length < 0:
                        raise ValueError("negative Content-Length")
                except ValueError:
                    # the body was never read: answer, then close
                    self.close_connection = True
                    self._reply(Response.json(
                        {"message": "Invalid Content-Length header"}, 400))
                    return
                body = self.rfile.read(length) if length else b""
                self._reply(router.dispatch(Request(
                    method=self.command, path=parsed.path, query=query,
                    headers=dict(self.headers.items()), body=body,
                    client=self.client_address[0])))

            def _reply(self, resp: Response) -> None:
                data = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(data)))
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_POST = do_DELETE = do_PUT = do_HEAD = _respond

            def log_message(self, fmt, *args):   # no per-request lines
                pass

        for attempt in range(3):
            try:
                self._httpd = _Server((self.host, self.port), _Handler)
                break
            except OSError as e:
                if attempt == 2 or e.errno != errno.EADDRINUSE:
                    raise
                time.sleep(0.5 * (attempt + 1))
        self.port = self._httpd.server_address[1]
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name=f"pio-torch-http-{self.port}")
            self._thread.start()
        else:
            self._httpd.serve_forever()
        return self.port

    def shutdown(self) -> None:
        """Stop serving and close the socket; idempotent."""
        with self._lifecycle_lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)


def parse_basic_auth_user(headers: Mapping[str, str]) -> Optional[str]:
    """The username of a Basic `Authorization` header (the reference
    takes the access key as the Basic username, EventServer.scala:
    114-126); None without one or when it does not decode."""
    auth = headers.get("Authorization") or headers.get("authorization")
    if not auth or not auth.startswith("Basic "):
        return None
    try:
        decoded = base64.b64decode(auth[len("Basic "):]).decode("utf-8")
    except Exception:  # noqa: BLE001 — a malformed header is no user
        return None
    return decoded.split(":")[0].strip() or None
