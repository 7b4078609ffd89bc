"""Selector readiness-loop HTTP/1.1 front end of the serve plane.

The port of `predictionio_tpu/utils/wire.py`. It replaces the standard
library's thread-per-connection `ThreadingHTTPServer` for the port's
servers:

  - a reactor thread multiplexes persistent keep-alive connections
    through a `selectors` readiness loop (accept, recv and incremental
    framing only, never a handler); `ShardedWire` runs N reactors
    (`PIO_WIRE_REACTORS`, default min(4, cpus)), each with its own
    `SO_REUSEPORT` listener on the same port, selector, connection
    table, idle sweep and slice of the worker pool. Where SO_REUSEPORT
    is unavailable, reactor 0 keeps the one listener and hands accepted
    sockets to its siblings round-robin (`SelectorWire.adopt`);
  - a fixed worker pool runs the handlers, so an idle keep-alive
    connection costs one selector registration, not one blocked thread;
  - framing is incremental: the header block stays one bytes slice,
    scanned in place for the few headers a route reads
    (`RawRequest.header`); frames past the limits are answered from a
    static 400/413/431/501 table and the connection closes;
  - egress is gathered: responses queue per connection and leave in one
    `socket.sendmsg`, deferred
    while pipelined requests of the same connection are pending, so a
    burst leaves in one syscall, in request order. When the
    micro-batcher completes a drain it calls `flush_hint()` and the
    reactors push the deferred responses without waiting for the owning
    worker;
  - a binary query frame for SDK clients (`Content-Type:
    application/x-pio-bin`): `decode_bin_query` reads a msgpack-subset
    map straight into the fast route's (user, num) pair.

The wire knows nothing of routes, JSON or metrics: it calls one
`handler(RawRequest) -> (response bytes, close?)` that
`utils/http.HTTPServerBase` supplies. `set_trace_hooks` keeps the JAX
package's two tracing callbacks; no recorder installs them yet, and the
JAX reactor's watchdog beat is not ported (ROADMAP.md, Queue 1 item 5).
`HTTPConnectionPool` is the client side: kept-alive upstream
connections, one stale-connection retry.
"""

from __future__ import annotations

import http.client
import os
import select
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

# Framing limits: a head that never completes under the cap is 431, a
# declared body over the cap is 413 (both close the connection — the
# stream position is unrecoverable).
MAX_HEADER_BYTES = 16 << 10
MAX_BODY_BYTES = 8 << 20
# idle keep-alive connections are swept after this long (mirrors the
# threaded wire's 60 s handler timeout)
KEEPALIVE_IDLE_S = 65.0
# framed-but-unserved requests a pipelining client may stack up before
# the reactor stops parsing its buffer (bounds memory per connection)
PIPELINE_MAX = 64
_RECV_CHUNK = 1 << 18
_SEND_TIMEOUT_S = 30.0
# gathered-egress cap: a deferred pipelined burst is flushed once this
# many responses are queued even if more requests are still pending
_FLUSH_MAX_IOV = 64

RawHandler = Callable[["RawRequest"], Tuple[bytes, bool]]

# Tracing hooks, installed by set_trace_hooks(). None = tracing off (the
# port has no recorder yet); the wire never imports obs.
_STAMP_NEW: Optional[Callable[[float], object]] = None
_ON_SENT: Optional[Callable[["RawRequest"], None]] = None


def set_trace_hooks(stamp_new: Optional[Callable[[float], object]],
                    on_sent: Optional[Callable[["RawRequest"], None]]
                    ) -> None:
    """Install (or clear, with Nones) the flight-recorder hooks:
    `stamp_new(t_first_read) -> trace-or-None` runs as a request is
    framed (a non-None result gets `.reactor` set to the framing
    reactor's index), `on_sent(raw)` after its response bytes are on
    the socket."""
    global _STAMP_NEW, _ON_SENT
    _STAMP_NEW = stamp_new
    _ON_SENT = on_sent


def reactor_count() -> int:
    """`PIO_WIRE_REACTORS`, default min(4, cpu count): reactors are
    readiness loops, more of them than cores only adds contention."""
    raw = os.environ.get("PIO_WIRE_REACTORS", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return max(1, min(4, os.cpu_count() or 1))


def _default_workers() -> int:
    # Workers BLOCK in the handler (device step, store reads), they are
    # not CPU-bound — size the pool to cover the admission layer's
    # concurrency, not the core count, or overload queues invisibly at
    # the wire instead of shedding 503 with Retry-After at the app
    # layer.
    return max(16, min(64, 4 * (os.cpu_count() or 4)))


def _bind_listener(server_address: Tuple[str, int],
                   reuse_port: bool = False) -> socket.socket:
    """Bind + listen a nonblocking listener. With reuse_port=True the
    SO_REUSEPORT option must exist and stick — any failure raises
    OSError so ShardedWire can fall back to fd handoff."""
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            opt = getattr(socket, "SO_REUSEPORT", None)
            if opt is None:
                raise OSError("SO_REUSEPORT unavailable")
            ls.setsockopt(socket.SOL_SOCKET, opt, 1)
        ls.bind(server_address)
    except OSError:
        ls.close()
        raise
    ls.listen(1024)
    ls.setblocking(False)
    return ls


_REASONS = http.client.responses
_STATUS_LINES: Dict[int, bytes] = {
    code: (f"HTTP/1.1 {code} {reason}\r\n".encode("ascii"))
    for code, reason in _REASONS.items()
}


def _status_line(code: int) -> bytes:
    line = _STATUS_LINES.get(code)
    if line is None:
        line = b"HTTP/1.1 %d Status\r\n" % code
    return line


class RawRequest:
    """One framed request: request-line fields plus the UNPARSED header
    block. Hot routes scan `header()` for the few names they need; the
    legacy path materializes a dict via `header_items()`."""

    __slots__ = ("method", "target", "path", "query_string", "head",
                 "body", "keep_alive", "client", "trace", "_lhead")

    def __init__(self, method: str, target: str, head: bytes,
                 client: str = ""):
        self.method = method
        self.target = target
        path, _, qs = target.partition("?")
        self.path = path
        self.query_string = qs
        self.head = head          # header block, no request line, no CRLFCRLF
        self.body = b""
        self.keep_alive = True
        self.client = client
        self.trace = None         # a tracing recorder's stamp slots
        self._lhead: Optional[bytes] = None

    def header(self, name: str) -> Optional[str]:
        """Case-insensitive single-header scan over the raw block — no
        dict, one lazy lowercase copy per request shared by every
        lookup."""
        lh = self._lhead
        if lh is None:
            lh = self._lhead = b"\r\n" + self.head.lower()
        key = b"\r\n" + name.lower().encode("ascii") + b":"
        i = lh.find(key)
        if i < 0:
            return None
        start = i + len(key)
        end = lh.find(b"\r\n", start)
        if end < 0:
            end = len(lh)
        return self.head[start - 2:end - 2].decode("latin-1").strip()

    def header_items(self) -> List[Tuple[str, str]]:
        """All headers as (name, value) pairs — the legacy-route path
        that builds a Request with a dict of headers."""
        out = []
        for line in self.head.split(b"\r\n"):
            name, sep, value = line.partition(b":")
            if sep:
                out.append((name.decode("latin-1").strip(),
                            value.decode("latin-1").strip()))
        return out


class WireError(Exception):
    """Malformed framing; answered from a static table and the
    connection closes (the stream position is unrecoverable)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def build_response(status: int, content_type: str, body: bytes,
                   rid: str = "", extra: Optional[Dict[str, str]] = None,
                   keep_alive: bool = True,
                   head_only: bool = False) -> bytes:
    """Assemble one HTTP/1.1 response as a single bytes object."""
    parts = [_status_line(status),
             b"Content-Type: ", content_type.encode("latin-1"), b"\r\n",
             b"Content-Length: %d\r\n" % len(body)]
    if rid:
        parts.append(b"X-Request-ID: " + rid.encode("latin-1") + b"\r\n")
    if extra:
        for k, v in extra.items():
            parts.append(k.encode("latin-1") + b": "
                         + v.encode("latin-1") + b"\r\n")
    if not keep_alive:
        parts.append(b"Connection: close\r\n")
    parts.append(b"\r\n")
    if not head_only:
        parts.append(body)
    return b"".join(parts)


def _error_bytes(e: WireError) -> bytes:
    # static messages only — no user input is ever echoed into this
    # JSON, so the manual quoting cannot be broken by it
    body = b'{"message": "%s"}' % e.message.encode("ascii", "replace")
    return build_response(e.status, "application/json", body,
                          keep_alive=False)


def frame_request(buf: bytearray, client: str = ""
                  ) -> Tuple[Optional[RawRequest], int]:
    """Try to frame one request at the head of `buf`.

    Returns (request, bytes_consumed) when a full request (head + body)
    is present, (None, 0) when more bytes are needed. Raises WireError
    on malformed input. Pure function of the buffer — the caller owns
    deleting the consumed prefix."""
    he = buf.find(b"\r\n\r\n")
    if he < 0:
        if len(buf) > MAX_HEADER_BYTES:
            raise WireError(431, "Request header block too large")
        return None, 0
    if he > MAX_HEADER_BYTES:
        raise WireError(431, "Request header block too large")
    head = bytes(buf[:he])
    eol = head.find(b"\r\n")
    line = head if eol < 0 else head[:eol]
    fields = line.split(b" ")
    if len(fields) != 3:
        raise WireError(400, "Malformed request line")
    method_b, target_b, version_b = fields
    if not version_b.startswith(b"HTTP/1."):
        raise WireError(400, "Unsupported HTTP version")
    raw = RawRequest(method_b.decode("latin-1"),
                     target_b.decode("latin-1"),
                     b"" if eol < 0 else head[eol + 2:], client)
    if raw.header("Transfer-Encoding") is not None:
        raise WireError(501, "Transfer-Encoding is not supported")
    length = 0
    cl = raw.header("Content-Length")
    if cl is not None:
        try:
            length = int(cl)
        except ValueError:
            raise WireError(400, "Invalid Content-Length header")
        if length < 0:
            raise WireError(400, "Invalid Content-Length header")
        if length > MAX_BODY_BYTES:
            raise WireError(413, "Request body over size limit")
    total = he + 4 + length
    if len(buf) < total:
        return None, 0
    if length:
        raw.body = bytes(memoryview(buf)[he + 4:total])
    conn_tok = raw.header("Connection")
    if version_b == b"HTTP/1.0":
        raw.keep_alive = (conn_tok is not None
                          and conn_tok.lower() == "keep-alive")
    else:
        raw.keep_alive = (conn_tok is None
                          or conn_tok.lower() != "close")
    return raw, total


# -- binary query framing ----------------------------------------------------
# The SDK fast lane: `Content-Type: application/x-pio-bin` carries the
# dominant serve query {"user": <str>, "num": <int>} as a msgpack-subset
# map, decoded by direct byte indexing straight into the same (user,
# num) pair the JSON fast-path regex produces. Strict by construction:
# exactly two fixstr keys in fixed order, nothing trailing, so the
# binary route accepts a SUBSET of what the JSON route serves
# (fuzz-gated accept containment in tests/test_wire.py). Responses are
# spliced from the same pre-serialized JSON fragments — only the
# request side changes representation.

BIN_CONTENT_TYPE = "application/x-pio-bin"
_BIN_PREFIX = b"\x82\xa4user"   # fixmap(2) + fixstr(4) "user"
_BIN_NUM_KEY = b"\xa3num"       # fixstr(3) "num"
_BIN_NUM_MAX = 999_999_999      # parity with the JSON fast-path regex


def encode_bin_query(user: str, num: int) -> bytes:
    """Encode the dominant serve query as the msgpack-subset frame
    `decode_bin_query` accepts (client/SDK side; the server only ever
    decodes). fixstr/str8/str16 user id, fixint/uint16/int32 num."""
    if num > _BIN_NUM_MAX or num < -_BIN_NUM_MAX:
        raise ValueError("num out of range for the binary query frame")
    ub = user.encode("utf-8")
    ul = len(ub)
    if ul <= 31:
        uhead = bytes((0xa0 | ul,))
    elif ul <= 0xff:
        uhead = b"\xd9" + bytes((ul,))
    elif ul <= 0xffff:
        uhead = b"\xda" + ul.to_bytes(2, "big")
    else:
        raise ValueError("user id too long for the binary query frame")
    if 0 <= num <= 0x7f:
        nb = bytes((num,))
    elif -32 <= num < 0:
        nb = bytes((num & 0xff,))
    elif 0 <= num <= 0xffff:
        nb = b"\xcd" + num.to_bytes(2, "big")
    else:
        nb = b"\xd2" + num.to_bytes(4, "big", signed=True)
    return b"".join((_BIN_PREFIX, uhead, ub, _BIN_NUM_KEY, nb))


def decode_bin_query(body: bytes) -> Optional[Tuple[str, int]]:
    """Decode one binary query frame to (user, num), or None when the
    body is not the exact shape `encode_bin_query` emits. Rejects
    trailing bytes, out-of-range nums, and invalid UTF-8 so every
    accepted frame maps onto a query the JSON route would also serve.

    The dominant shape (fixstr user <= 31 bytes, one-byte num) is
    decoded inline with the minimum of branches — it is ~95% of SDK
    traffic and the whole point of the frame; everything else takes
    `_decode_bin_slow`."""
    lb = len(body)
    if lb < 12 or body[:6] != _BIN_PREFIX:
        return None
    c = body[6]
    if 0xa0 <= c <= 0xbf:
        e = 7 + (c & 0x1f)
        p = e + 4
        if lb == p + 1 and body[e:p] == _BIN_NUM_KEY:
            c2 = body[p]
            if c2 <= 0x7f:
                try:
                    return body[7:e].decode("utf-8"), c2
                except UnicodeDecodeError:
                    return None
            if c2 >= 0xe0:
                try:
                    return body[7:e].decode("utf-8"), c2 - 256
                except UnicodeDecodeError:
                    return None
            return None      # one trailing byte that is no fixint
    return _decode_bin_slow(body, lb, c)


def _decode_bin_slow(body: bytes, lb: int, c: int
                     ) -> Optional[Tuple[str, int]]:
    # the off-dominant encodings: str8/str16 user ids, uint16/int32
    # nums, and every reject path the fast lane skipped
    if 0xa0 <= c <= 0xbf:
        s = 7
        e = s + (c & 0x1f)
    elif c == 0xd9:
        s = 8
        e = s + body[7]
    elif c == 0xda:
        s = 9
        e = s + ((body[7] << 8) | body[8])
    else:
        return None
    p = e + 4
    if lb <= p or body[e:p] != _BIN_NUM_KEY:
        return None
    c2 = body[p]
    if c2 <= 0x7f:
        num = c2
        q = p + 1
    elif c2 >= 0xe0:
        num = c2 - 256
        q = p + 1
    elif c2 == 0xcd:
        q = p + 3
        if lb < q:
            return None
        num = (body[p + 1] << 8) | body[p + 2]
    elif c2 == 0xd2:
        q = p + 5
        if lb < q:
            return None
        num = int.from_bytes(body[p + 1:q], "big", signed=True)
    else:
        return None
    if q != lb or num > _BIN_NUM_MAX or num < -_BIN_NUM_MAX:
        return None
    try:
        user = body[s:e].decode("utf-8")
    except UnicodeDecodeError:
        return None
    return user, num


class _Conn:
    __slots__ = ("sock", "fd", "client", "buf", "pending", "busy",
                 "closing", "last_active", "lock", "t_read", "outq",
                 "wlock")

    def __init__(self, sock: socket.socket, client: str):
        self.sock = sock
        self.fd = sock.fileno()
        self.client = client
        self.buf = bytearray()
        # entries: ("req", RawRequest) | ("err", response_bytes)
        self.pending: Deque[tuple] = deque()
        self.busy = False          # a worker currently owns this conn
        self.closing = False
        self.last_active = time.monotonic()
        self.lock = threading.Lock()
        self.t_read = 0.0          # first-read stamp for the next request
        # egress: (response bytes-or-memoryview, RawRequest-or-None),
        # appended under `lock`, drained under `wlock` (egress order)
        self.outq: Deque[tuple] = deque()
        self.wlock = threading.Lock()


class WireStats:
    """Raw wire activity counters: plain ints, no metrics objects, so
    the wire stays obs-free. Reactor-owned fields (accepted, requests,
    bytes_in, pipeline_hwm, errors) are written by the reactor thread
    only; `lock` guards the worker-side fields. `flushes` counts
    gathered egress syscalls — responses/flushes is the writev
    coalescing ratio the bench gates on."""

    __slots__ = ("accepted", "requests", "bytes_in", "pipeline_hwm",
                 "errors", "lock", "bytes_out", "responses",
                 "send_failures", "busy_workers", "flushes")

    def __init__(self):
        self.accepted = 0
        self.requests = 0
        self.bytes_in = 0
        self.pipeline_hwm = 0
        self.errors: Dict[int, int] = {}   # WireError status -> count
        self.lock = threading.Lock()
        self.bytes_out = 0
        self.responses = 0
        self.send_failures = 0
        self.busy_workers = 0
        self.flushes = 0


class SelectorWire:
    """One selector reactor. API mirrors ThreadingHTTPServer just
    enough (`server_address`, `serve_forever`, `shutdown`,
    `server_close`) that HTTPServerBase treats both wires uniformly.

    Sharding hooks (used by ShardedWire, inert standalone): `index`
    names the reactor in stats/traces; `listener` adopts a pre-bound
    socket (SO_REUSEPORT shard) instead of binding here; a reactor
    built with neither address nor listener accepts nothing and is fed
    via `adopt()` (the fd-handoff fallback)."""

    def __init__(self, server_address: Optional[Tuple[str, int]],
                 handler: RawHandler, workers: int = 0, *,
                 index: int = 0,
                 listener: Optional[socket.socket] = None):
        self._handler = handler
        self._stop = False
        self._done = threading.Event()
        self._lifecycle = threading.Lock()
        self._conns: Dict[int, _Conn] = {}
        self._to_close: Deque[_Conn] = deque()
        self._adoptq: Deque[Tuple[socket.socket, str]] = deque()
        self._flush_req = False
        self._dispatch: Optional[Callable[[socket.socket, str], bool]] \
            = None
        self.index = index
        self.stats = WireStats()
        if workers <= 0:
            workers = _default_workers()
        self._n_workers = max(1, workers)
        import queue as _queue
        self._workq: "_queue.Queue" = _queue.Queue()
        self._workers: List[threading.Thread] = []
        # bind in the constructor so the caller's EADDRINUSE retry loop
        # wraps construction, exactly as with ThreadingHTTPServer
        if listener is None and server_address is not None:
            listener = _bind_listener(server_address)
        self._listener = listener
        self.server_address = (listener.getsockname()
                               if listener is not None else ("", 0))
        # wake pipe: shutdown(), adopt() and worker close-requests
        # nudge select()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel = selectors.DefaultSelector()

    # -- reactor -------------------------------------------------------------
    def serve_forever(self) -> None:
        for i in range(self._n_workers):
            t = threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"wire-{self.index}-worker-{i}")
            t.start()
            self._workers.append(t)
        sel = self._sel
        if self._listener is not None:
            sel.register(self._listener, selectors.EVENT_READ, "accept")
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        last_sweep = time.monotonic()
        try:
            while not self._stop:
                for key, _ in sel.select(1.0):
                    data = key.data
                    if data == "accept":
                        self._accept()
                    elif data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._on_readable(data)
                if self._adoptq:
                    self._drain_adopted()
                if self._flush_req:
                    self._flush_req = False
                    self._flush_pass()
                self._drain_close_requests()
                now = time.monotonic()
                if now - last_sweep >= 5.0:
                    last_sweep = now
                    self._sweep_idle(now)
        finally:
            self._done.set()

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            client = addr[0] if addr else ""
            d = self._dispatch
            if d is not None and d(sock, client):
                continue               # handed to a sibling reactor
            self._register_conn(sock, client)

    def adopt(self, sock: socket.socket, client: str) -> None:
        """Hand an already-accepted socket to this reactor — the
        round-robin fallback path when SO_REUSEPORT cannot shard the
        accept stream at the kernel."""
        self._adoptq.append((sock, client))
        self._wake()

    def _drain_adopted(self) -> None:
        while self._adoptq:
            sock, client = self._adoptq.popleft()
            self._register_conn(sock, client)

    def _register_conn(self, sock: socket.socket, client: str) -> None:
        conn = _Conn(sock, client)
        self._conns[conn.fd] = conn
        self.stats.accepted += 1
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _on_readable(self, conn: _Conn) -> None:
        eof = False
        if not conn.buf and _STAMP_NEW is not None:
            # first bytes of the next request on this connection
            conn.t_read = time.perf_counter()
        n_in = 0
        try:
            while True:
                data = conn.sock.recv(_RECV_CHUNK)
                if not data:
                    eof = True
                    break
                conn.buf.extend(data)
                n_in += len(data)
                if len(data) < _RECV_CHUNK:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            eof = True
        self.stats.bytes_in += n_in
        conn.last_active = time.monotonic()
        if conn.buf:
            self._pump(conn)
        if eof:
            with conn.lock:
                busy_or_pending = conn.busy or bool(conn.pending)
                conn.closing = True
            self._unregister(conn)
            if not busy_or_pending:
                self._destroy(conn)

    def _pump(self, conn: _Conn) -> None:
        """Frame every complete request in the buffer (up to the
        pipeline cap) and hand the connection to a worker."""
        added = False
        st = self.stats
        while len(conn.pending) < PIPELINE_MAX:
            try:
                raw, consumed = frame_request(conn.buf, conn.client)
            except WireError as e:
                st.errors[e.status] = st.errors.get(e.status, 0) + 1
                with conn.lock:
                    conn.pending.append(("err", _error_bytes(e)))
                    conn.closing = True
                self._unregister(conn)
                added = True
                break
            if raw is None:
                break
            del conn.buf[:consumed]
            sn = _STAMP_NEW
            if sn is not None:
                raw.trace = sn(conn.t_read)
                if raw.trace is not None:
                    raw.trace.reactor = self.index
            st.requests += 1
            with conn.lock:
                conn.pending.append(("req", raw))
                depth = len(conn.pending)
            if depth > st.pipeline_hwm:
                st.pipeline_hwm = depth
            added = True
        if added:
            with conn.lock:
                if not conn.busy and conn.pending:
                    conn.busy = True
                    self._workq.put(conn)

    def _sweep_idle(self, now: float) -> None:
        for conn in list(self._conns.values()):
            with conn.lock:
                idle = (not conn.busy and not conn.pending
                        and not conn.buf and not conn.outq
                        and now - conn.last_active > KEEPALIVE_IDLE_S)
            if idle:
                self._unregister(conn)
                self._destroy(conn)

    def _drain_close_requests(self) -> None:
        while self._to_close:
            conn = self._to_close.popleft()
            self._unregister(conn)
            self._destroy(conn)

    def _unregister(self, conn: _Conn) -> None:
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass

    def _destroy(self, conn: _Conn) -> None:
        self._conns.pop(conn.fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def flush_hint(self) -> None:
        """Cross-wakeup from the micro-batcher: a batch just drained,
        so deferred pipelined responses are likely complete — nudge the
        reactor to push them without waiting for the owning worker."""
        self._flush_req = True
        self._wake()

    def _flush_pass(self) -> None:
        for conn in list(self._conns.values()):
            if conn.outq:
                self._flush_out(conn, wait=False)

    # -- workers -------------------------------------------------------------
    def _worker_loop(self) -> None:
        st = self.stats
        while True:
            conn = self._workq.get()
            if conn is None:
                return
            with st.lock:
                st.busy_workers += 1
            try:
                self._service(conn)
            finally:
                with st.lock:
                    st.busy_workers -= 1

    def _service(self, conn: _Conn) -> None:
        """Serve this connection's framed requests in order; the busy
        flag guarantees one worker per connection, so pipelined
        responses cannot interleave. Responses land on conn.outq; the
        flush is deferred while more pipelined requests are pending so
        a whole burst leaves in one gathered sendmsg."""
        while True:
            with conn.lock:
                if not conn.pending:
                    conn.busy = False
                    close_now = conn.closing
                    break
                kind, item = conn.pending.popleft()
            if kind == "err":
                with conn.lock:
                    conn.outq.append((item, None))
                self._flush_out(conn)
                self._request_close(conn)
                return
            try:
                data, close = self._handler(item)
            except Exception:
                data, close = build_response(
                    500, "application/json",
                    b'{"message": "internal wire error"}',
                    keep_alive=False), True
            with conn.lock:
                conn.outq.append((data, item))
                defer = (bool(conn.pending)
                         and len(conn.outq) < _FLUSH_MAX_IOV
                         and not close and item.keep_alive)
            if not defer and not self._flush_out(conn):
                self._request_close(conn)
                return
            if close or not item.keep_alive:
                self._request_close(conn)
                return
            conn.last_active = time.monotonic()
        if close_now:
            self._flush_out(conn)
            self._request_close(conn)

    def _flush_out(self, conn: _Conn, wait: bool = True) -> bool:
        """Drain conn.outq to the socket: one gathered `sendmsg` per
        queued batch (writev — no join copies). wait=False is the
        reactor's opportunistic path: it never blocks, requeueing any
        unsent tail in order for the owning worker."""
        if wait:
            conn.wlock.acquire()
        elif not conn.wlock.acquire(blocking=False):
            return True                # a worker owns egress right now
        try:
            return self._flush_locked(conn, wait)
        finally:
            conn.wlock.release()

    def _flush_locked(self, conn: _Conn, wait: bool) -> bool:
        st = self.stats
        sock = conn.sock
        end = time.monotonic() + _SEND_TIMEOUT_S
        while True:
            with conn.lock:
                if not conn.outq:
                    return True
                items = list(conn.outq)
                conn.outq.clear()
            bufs = [memoryview(d) for d, _ in items]
            idx = 0
            while bufs:
                try:
                    n = sock.sendmsg(bufs)
                except (BlockingIOError, InterruptedError):
                    if not wait:
                        # requeue the unsent tail at the head, in order
                        with conn.lock:
                            conn.outq.extendleft(
                                (bufs[j], items[idx + j][1])
                                for j in range(len(bufs) - 1, -1, -1))
                        return True
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        return self._flush_fail()
                    try:
                        select.select([], [sock], [],
                                      min(remaining, 1.0))
                    except (OSError, ValueError):
                        return self._flush_fail()
                    continue
                except OSError:
                    return self._flush_fail()
                with st.lock:
                    st.flushes += 1
                    st.bytes_out += n
                while n:
                    head = bufs[0]
                    if n >= len(head):
                        n -= len(head)
                        bufs.pop(0)
                        self._mark_sent(items[idx])
                        idx += 1
                    else:
                        bufs[0] = head[n:]
                        break

    def _flush_fail(self) -> bool:
        with self.stats.lock:
            self.stats.send_failures += 1
        return False

    def _mark_sent(self, item: tuple) -> None:
        raw = item[1]
        with self.stats.lock:
            self.stats.responses += 1
        cb = _ON_SENT
        if cb is not None and raw is not None and raw.trace is not None:
            try:
                cb(raw)
            except Exception:
                pass               # tracing must never kill a worker

    def _request_close(self, conn: _Conn) -> None:
        """Workers never touch the selector: shut the socket down and
        let the reactor unregister + close it."""
        with conn.lock:
            conn.closing = True
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._to_close.append(conn)
        self._wake()

    def stats_snapshot(self) -> Dict[str, object]:
        """Point-in-time wire counters for the obs layer's pio_wire_*
        families. Reactor-owned fields are read without the lock —
        single int reads are atomic enough for monitoring."""
        st = self.stats
        with st.lock:
            out: Dict[str, object] = {
                "bytes_out": st.bytes_out,
                "responses": st.responses,
                "send_failures": st.send_failures,
                "busy_workers": st.busy_workers,
                "flushes": st.flushes,
            }
        out["reactor"] = self.index
        out["accepted"] = st.accepted
        out["requests"] = st.requests
        out["bytes_in"] = st.bytes_in
        out["pipeline_hwm"] = st.pipeline_hwm
        out["errors"] = dict(st.errors)
        out["open_conns"] = len(self._conns)
        out["queue_depth"] = self._workq.qsize()
        out["workers"] = self._n_workers
        busy = out["busy_workers"]
        out["utilization"] = (float(busy) / self._n_workers
                              if self._n_workers else 0.0)
        return out

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        self._stop = True
        self._wake()
        self._done.wait(timeout=5.0)

    def server_close(self) -> None:
        with self._lifecycle:
            workers, self._workers = self._workers, []
        for _ in workers:
            self._workq.put(None)
        for t in workers:
            t.join(timeout=2.0)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        while self._adoptq:
            sock, _ = self._adoptq.popleft()
            try:
                sock.close()
            except OSError:
                pass
        for conn in list(self._conns.values()):
            self._unregister(conn)
            self._destroy(conn)
        try:
            self._sel.close()
        except Exception:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


class ShardedWire:
    """N SelectorWire reactors behind one serve port.

    With SO_REUSEPORT every reactor owns its own listener bound to the
    same (host, port) and the KERNEL shards the accept stream — no
    user-space handoff, no shared accept lock. Where SO_REUSEPORT is
    unavailable (or refused at bind), reactor 0 keeps the only
    listener and deals accepted sockets to its siblings round-robin
    via `SelectorWire.adopt`. Each reactor runs its own selector,
    connection table, idle sweep, and worker-pool slice; lifecycle and
    stats mirror SelectorWire so HTTPServerBase treats every wire the
    same. `stats_snapshot()` returns the aggregate plus a
    `"reactors"` list of per-shard snapshots."""

    def __init__(self, server_address: Tuple[str, int],
                 handler: RawHandler, reactors: int = 0,
                 workers: int = 0):
        n = max(1, reactors if reactors > 0 else reactor_count())
        if workers <= 0:
            workers = _default_workers()
        per = max(1, -(-workers // n))     # ceil-divided pool slice
        listeners: List[Optional[socket.socket]] = []
        self.reuse_port = False
        if n > 1:
            try:
                first = _bind_listener(server_address, reuse_port=True)
                listeners.append(first)
                host = server_address[0]
                port = first.getsockname()[1]
                for _ in range(n - 1):
                    listeners.append(
                        _bind_listener((host, port), reuse_port=True))
                self.reuse_port = True
            except OSError:
                for ls in listeners:
                    if ls is not None:
                        try:
                            ls.close()
                        except OSError:
                            pass
                listeners = []
        if not listeners:
            listeners = [_bind_listener(server_address)]
            listeners.extend([None] * (n - 1))
        self.reactors: List[SelectorWire] = [
            SelectorWire(None, handler, workers=per, index=i,
                         listener=listeners[i])
            for i in range(n)
        ]
        self.server_address = self.reactors[0].server_address
        for r in self.reactors[1:]:
            if r._listener is None:
                r.server_address = self.server_address
        self._rr = 0
        if not self.reuse_port and n > 1:
            self.reactors[0]._dispatch = self._dispatch_round_robin
        self._threads: List[threading.Thread] = []

    def _dispatch_round_robin(self, sock: socket.socket,
                              client: str) -> bool:
        i = self._rr = (self._rr + 1) % len(self.reactors)
        if i == 0:
            return False               # reactor 0 keeps its share
        self.reactors[i].adopt(sock, client)
        return True

    def serve_forever(self) -> None:
        for r in self.reactors[1:]:
            t = threading.Thread(target=r.serve_forever, daemon=True,
                                 name=f"wire-reactor-{r.index}")
            t.start()
            self._threads.append(t)
        self.reactors[0].serve_forever()

    def flush_hint(self) -> None:
        for r in self.reactors:
            r.flush_hint()

    def stats_snapshot(self) -> Dict[str, object]:
        """Aggregate counters plus per-reactor snapshots under
        "reactors" — the obs layer emits one `reactor` label per
        entry, the dashboard renders accept-shard balance from it."""
        per = [r.stats_snapshot() for r in self.reactors]
        agg: Dict[str, object] = {
            "reactor": -1,
            "reuse_port": self.reuse_port,
            "reactors": per,
        }
        for k in ("accepted", "requests", "bytes_in", "bytes_out",
                  "responses", "flushes", "send_failures",
                  "busy_workers", "open_conns", "queue_depth",
                  "workers"):
            agg[k] = sum(s[k] for s in per)
        agg["pipeline_hwm"] = max(s["pipeline_hwm"] for s in per)
        agg["utilization"] = (float(agg["busy_workers"]) / agg["workers"]
                              if agg["workers"] else 0.0)
        errors: Dict[int, int] = {}
        for s in per:
            for code, cnt in s["errors"].items():
                errors[code] = errors.get(code, 0) + cnt
        agg["errors"] = errors
        return agg

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        for r in self.reactors:
            r.shutdown()
        for t in self._threads:
            t.join(timeout=5.0)

    def server_close(self) -> None:
        for r in self.reactors:
            r.server_close()


class HTTPConnectionPool:
    """Persistent upstream connections for the fleet proxy.

    The router used to dial a fresh TCP connection per proxied request
    (urllib): at wire-path throughput the handshake dominates. This
    pool checks out a kept-alive `http.client.HTTPConnection` per
    (host, port), retries exactly once on a stale reuse (the upstream
    closed its keep-alive between our requests), and returns transport
    failures as OSError so the caller's retry-next-replica loop and
    ejection bookkeeping stay unchanged.

    Bodies are opaque bytes and Content-Type is forwarded verbatim, so
    binary-framed queries (`application/x-pio-bin`) proxy upstream
    unchanged — the router never re-encodes."""

    def __init__(self, max_idle_per_host: int = 4):
        self.max_idle = max_idle_per_host
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int], Deque] = {}

    def _checkout(self, host: str, port: int):
        with self._lock:
            q = self._idle.get((host, port))
            if q:
                return q.popleft(), True
        return None, False

    def _checkin(self, host: str, port: int, conn) -> None:
        with self._lock:
            q = self._idle.setdefault((host, port), deque())
            if len(q) < self.max_idle:
                q.append(conn)
                return
        conn.close()

    def request(self, host: str, port: int, method: str, path: str,
                body: Optional[bytes], headers: Dict[str, str],
                timeout: float) -> Tuple[int, Dict[str, str], bytes]:
        """One proxied request over a pooled connection. Returns
        (status, response headers, body). Transport-level failures
        raise OSError after at most one stale-connection retry."""
        attempts = 0
        while True:
            conn, reused = self._checkout(host, port)
            if conn is None:
                conn = http.client.HTTPConnection(host, port,
                                                  timeout=timeout)
            elif conn.sock is not None:
                conn.sock.settimeout(timeout)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                # a reused connection the upstream already closed is
                # expected with keep-alive; retry ONCE on a fresh dial
                if reused and attempts == 0:
                    attempts += 1
                    continue
                if isinstance(e, OSError):
                    raise
                raise OSError(f"{type(e).__name__}: {e}") from e
            if resp.will_close:
                conn.close()
            else:
                self._checkin(host, port, conn)
            return resp.status, dict(resp.headers.items()), data

    def close(self) -> None:
        with self._lock:
            pools, self._idle = self._idle, {}
        for q in pools.values():
            for conn in q:
                try:
                    conn.close()
                except Exception:
                    pass
