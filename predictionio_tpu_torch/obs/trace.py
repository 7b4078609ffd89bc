"""Flight recorder: allocation-light request tracing for the serve path.

The port of `predictionio_tpu/obs/trace.py`, with its names, its header
format and its JSON entries. Every request framed by the selector wire
(`utils/wire.py`) gets a `PendingTrace`, a preallocated list of
monotonic stamp slots and a few scalar attributes, attached to its
`RawRequest` by the wire's `set_trace_hooks` (installed by
`utils.http.HTTPServerBase.start`). Hot-path code only *stamps*
(`st[slot] = perf_counter()`); the span list is built once, after the
response bytes are on the socket, and only for requests the recorder
keeps.

Sampling is head-rate (`PIO_TRACE_SAMPLE`, the fraction of requests
marked `sampled` as they arrive; 0, the default, turns tracing off)
plus a tail keep: errored requests and the slowest decile (a frugal
streaming p90 estimate, O(1) state) are kept although the head sampler
passed them by. Kept traces land in a ring of `DEFAULT_RING` entries
served by `/traces.json`, and a kept trace's id is the exemplar of its
`pio_serve_seconds` bucket, so that the p99 bucket links to a real
trace. `slow_ms` (0, off, unless `configure` is given one) logs one
`slow_request` line per kept trace at least that slow.

Fleet stitching: routers forward `X-PIO-Trace`
(`traceid-spanid-flag[-hmac]`, signed with the server key,
`PIO_SERVER_ACCESS_KEY` or `cli deploy --server-key`) on proxy hops and
standby 307 redirects; a replica adopts the incoming trace id and
records its spans under it, so one `/queries.json` call through a fleet
yields router and replica entries under one 128-bit trace id. The
codec is the JAX package's byte for byte, so a header signed by either
package verifies in the other.

Background work (refresher ticks and folds, rolling reloads) records
spans through `background()` into the same ring with `kind=
"background"`.
"""

from __future__ import annotations

import contextvars
import hashlib
import hmac
import json
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs.logs import get_logger
from predictionio_tpu_torch.obs.metrics import (MetricsRegistry,
                                                get_registry)

TRACE_HEADER = "X-PIO-Trace"

# the keep ring's size (the JAX package's PIO_TRACE_RING default)
DEFAULT_RING = 512

# Stamp slots, in request order. A slot left at 0.0 means the request
# never passed that stage (e.g. shed before enqueue); materialization
# spans consecutive *present* stamps so the tree always tiles the full
# first->last interval regardless of which stages ran.
S_WIRE_READ = 0      # first socket read of the bytes framing this request
S_FRAMED = 1         # request framed out of the connection buffer
S_HANDLER = 2        # worker picked it up, handler entered
S_AUTH = 3           # authenticated + admitted (tenancy)
S_ENQ = 4            # enqueued on its micro-batch lane
S_DRAIN = 5          # drained out of the lane into a batch
S_EXEC = 6           # model executed (device exec + d2h complete)
S_SPLICE = 7         # response payload spliced/encoded
S_DONE = 8           # handler returned the response object
S_SENT = 9           # response bytes written to the socket
N_STAMPS = 10

# Segment names, keyed by the stamp that *ends* the segment.
_SEG_NAMES = {
    S_FRAMED: "wire_frame",
    S_HANDLER: "worker_queue",
    S_AUTH: "auth_admission",
    S_ENQ: "batch_submit",
    S_DRAIN: "lane_wait",
    S_EXEC: "device_exec",
    S_SPLICE: "response_splice",
    S_DONE: "respond",
    S_SENT: "wire_write",
}

_log = get_logger("trace")

# Latency buckets for pio_serve_seconds (end-to-end, wire to wire);
# public: the server creates the same family for the tracing-off path.
SERVE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0)


class PendingTrace:
    """Per-request stamp slots + scalar attributes; no dicts, no
    strings built until (and unless) the sampler keeps the request."""

    __slots__ = ("st", "trace_id", "span_id", "parent_id", "sampled",
                 "kind", "app", "route", "status", "dispatch", "error",
                 "batch_id", "batch_size", "rid", "extra", "reactor",
                 "query")

    def __init__(self):
        self.st = [0.0] * N_STAMPS
        self.trace_id = ""
        self.span_id = ""
        self.parent_id = ""
        self.sampled = False
        self.kind = ""           # "serve" | "router" | "" (generic)
        self.app = ""
        self.route = ""
        self.status = 0
        self.dispatch = ""       # host|device|sharded|fused
        self.error = ""
        self.batch_id = 0
        self.batch_size = 0
        self.rid = ""
        self.extra = None        # optional [(name, t0, t1), ...]
        self.reactor = -1        # accept-shard index (set by the wire)
        self.query = None        # (user, num) tuple or query dict,
        #                          written into the kept entry


# -- X-PIO-Trace codec (signed-header compatible with X-PIO-App) -------------

def _sign(payload: str, key: str) -> str:
    return hmac.new(key.encode(), payload.encode(),
                    hashlib.sha256).hexdigest()[:16]


def encode_header(trace_id: str, span_id: str, sampled: bool,
                  key: str = "") -> str:
    """`traceid-spanid-flag[-hmac16]`: the value a router asserts to
    its replicas (and a standby attaches to its 307 redirect)."""
    payload = f"{trace_id}-{span_id}-{'1' if sampled else '0'}"
    if not key:
        return payload
    return f"{payload}-{_sign(payload, key)}"


def decode_header(value: Optional[str],
                  key: str = "") -> Optional[Tuple[str, str, bool]]:
    """Parse + verify an X-PIO-Trace value -> (trace_id, parent_span,
    sampled), or None on malformed/unverified input (the request then
    starts a fresh trace — refuse-by-default, like X-PIO-App)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) not in (3, 4):
        return None
    tid, sid, flag = parts[0], parts[1], parts[2]
    if len(tid) != 32 or len(sid) != 16 or flag not in ("0", "1"):
        return None
    try:
        int(tid, 16)
        int(sid, 16)
    except ValueError:
        return None
    if key:
        if len(parts) != 4:
            return None
        payload = f"{tid}-{sid}-{flag}"
        if not hmac.compare_digest(parts[3], _sign(payload, key)):
            return None
    return tid, sid, flag == "1"


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


# -- the recorder ------------------------------------------------------------

class TraceRecorder:
    """Process-global flight recorder: head/tail sampling, the bounded
    keep ring, serve-latency exemplars, and the slow-request log."""

    def __init__(self, sample: float = 0.0, ring: int = DEFAULT_RING,
                 slow_ms: float = 0.0, key: str = "",
                 metrics: Optional[MetricsRegistry] = None):
        self.sample = max(0.0, min(1.0, float(sample)))
        self.enabled = self.sample > 0.0
        self.slow_ms = max(0.0, float(slow_ms))
        self.key = key or ""
        self._metrics = metrics if metrics is not None else get_registry()
        self._ring: "deque" = deque(maxlen=max(1, int(ring)))
        self._lock = threading.Lock()
        # frugal-streaming p90 estimate of request duration: O(1)
        # state, no reservoir — accurate enough to flag the slow tail
        self._q90 = 0.0
        self._q_n = 0
        self._kept = self._metrics.counter(
            "pio_trace_kept_total", "Traces kept in the ring, by reason",
            labels=("why",))
        self._serve_hist = self._metrics.histogram(
            "pio_serve_seconds",
            "End-to-end serve latency (wire read to wire write)",
            labels=("app",), buckets=SERVE_BUCKETS)
        # app -> histogram child: labels() rebuilds key tuples and takes
        # the family lock per call; finish() runs once per request, so
        # resolve each app's child once (cardinality already bounded by
        # admission's label sanitization; capped regardless)
        self._hist_by_app: Dict[str, Any] = {}

    # -- hot-path entry points (called via the wire hooks) -------------------
    def new_stamps(self, t0: float) -> Optional[PendingTrace]:
        """Allocate stamp slots for an arriving request; None when
        tracing is off (the wire then skips all further trace work)."""
        if not self.enabled:
            return None
        p = PendingTrace()
        if t0 > 0.0:
            p.st[S_WIRE_READ] = t0
        # the hook runs as the request is framed out of the buffer
        p.st[S_FRAMED] = time.perf_counter()
        if random.random() < self.sample:
            p.sampled = True
        return p

    def on_sent(self, raw) -> None:
        """Wire write completed: stamp S_SENT and finish the trace."""
        p = raw.trace
        if p is None:
            return
        p.st[S_SENT] = time.perf_counter()
        self.finish(p)

    # -- finish / keep -------------------------------------------------------
    def finish(self, p: PendingTrace) -> None:
        st = p.st
        t0 = 0.0
        tend = 0.0
        for t in st:
            if t > 0.0:
                if t0 == 0.0:
                    t0 = t
                if t > tend:
                    tend = t
        if t0 == 0.0:
            return
        dur = max(tend - t0, 0.0)
        why = ""
        with self._lock:
            slow = self._tail_slow_locked(dur)
            if p.sampled:
                why = "sampled"
            elif p.error or p.status >= 400:
                why = "error"
            elif slow:
                why = "slow"
            if why:
                entry = self._materialize(p, t0, dur, why)
                self._ring.append(entry)
        if why:
            self._kept.labels(why=why).inc()
            if self.slow_ms > 0.0 and dur * 1000.0 >= self.slow_ms:
                self._slow_log(p, dur)
        if p.kind == "serve":
            child = self._hist_by_app.get(p.app)
            if child is None:
                child = self._serve_hist.labels(app=p.app)
                if len(self._hist_by_app) < 1024:
                    self._hist_by_app[p.app] = child
            child.observe(dur, exemplar=p.trace_id if why else None)

    def _tail_slow_locked(self, dur: float) -> bool:
        """Frugal-streaming quantile step toward p90; True once the
        estimate has warmed up and `dur` lands in the slow decile."""
        q = self._q90
        self._q_n += 1
        step = max(q * 0.05, 1e-5)
        if dur > q:
            self._q90 = q + step
        else:
            self._q90 = max(q - step / 9.0, 0.0)
        return self._q_n > 64 and dur >= self._q90

    def _materialize(self, p: PendingTrace, t0: float, dur: float,
                     why: str) -> Dict[str, Any]:
        if not p.trace_id:
            p.trace_id = _new_trace_id()
        if not p.span_id:
            p.span_id = _new_span_id()
        spans: List[Dict[str, Any]] = []
        prev = p.st[S_WIRE_READ] if p.st[S_WIRE_READ] > 0.0 else 0.0
        for slot in range(1, N_STAMPS):
            t = p.st[slot]
            if t <= 0.0:
                continue
            if prev > 0.0 and t >= prev:
                spans.append({
                    "name": _SEG_NAMES.get(slot, f"stage{slot}"),
                    "start_ms": round((prev - t0) * 1000.0, 3),
                    "dur_ms": round((t - prev) * 1000.0, 3),
                })
            prev = t
        if p.extra:
            for name, a, b in p.extra:
                spans.append({
                    "name": name,
                    "start_ms": round((a - t0) * 1000.0, 3),
                    "dur_ms": round((b - a) * 1000.0, 3),
                })
        entry: Dict[str, Any] = {
            "trace_id": p.trace_id,
            "span_id": p.span_id,
            "parent_id": p.parent_id,
            "kind": p.kind or "request",
            "name": p.route or "request",
            "app": p.app,
            "status": p.status,
            "dispatch": p.dispatch,
            "duration_ms": round(dur * 1000.0, 3),
            "keep": why,
            "ts": time.time(),
            "spans": spans,
        }
        if p.batch_size:
            entry["batch_id"] = p.batch_id
            entry["batch_size"] = p.batch_size
        if p.error:
            entry["error"] = p.error
        if p.rid:
            entry["request_id"] = p.rid
        if p.reactor >= 0:
            entry["reactor"] = p.reactor
        q = p.query
        if q is not None:
            if isinstance(q, tuple):
                entry["query"] = {"user": q[0], "num": q[1]}
            else:
                entry["query"] = q
        return entry

    def _slow_log(self, p: PendingTrace, dur: float) -> None:
        """One grep-able JSON line per kept trace past `slow_ms`."""
        stages = {}
        st = p.st
        prev = 0.0
        for slot in range(N_STAMPS):
            t = st[slot]
            if t <= 0.0:
                continue
            if prev > 0.0 and slot in _SEG_NAMES:
                stages[_SEG_NAMES[slot]] = round((t - prev) * 1000.0, 3)
            prev = t
        _log.warning("slow_request", trace_id=p.trace_id, app=p.app,
                     route=p.route, status=p.status, dispatch=p.dispatch,
                     duration_ms=round(dur * 1000.0, 3), stages=stages)

    # -- background spans ----------------------------------------------------
    def record_background(self, name: str, t0: float, t1: float,
                          app: str = "", error: str = "") -> None:
        entry = {
            "trace_id": _new_trace_id(),
            "span_id": _new_span_id(),
            "parent_id": "",
            "kind": "background",
            "name": name,
            "app": app,
            "status": 0,
            "dispatch": "",
            "duration_ms": round((t1 - t0) * 1000.0, 3),
            "keep": "background",
            "ts": time.time(),
            "spans": [],
        }
        if error:
            entry["error"] = error
        with self._lock:
            self._ring.append(entry)

    # -- export --------------------------------------------------------------
    def snapshot(self, app: Optional[str] = None,
                 min_ms: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 limit: int = 0) -> List[Dict[str, Any]]:
        """Ring contents newest-first, filtered by app / min duration /
        trace id — the body of `/traces.json`."""
        with self._lock:
            entries = list(self._ring)
        entries.reverse()
        out = []
        for e in entries:
            if app is not None and e.get("app") != app:
                continue
            if min_ms is not None and e.get("duration_ms", 0.0) < min_ms:
                continue
            if trace_id is not None and e.get("trace_id") != trace_id:
                continue
            out.append(e)
            if limit and len(out) >= limit:
                break
        return out

    def ring_len(self) -> int:
        with self._lock:
            return len(self._ring)

    def trim(self, keep_frac: float = 0.5) -> int:
        """Soft-memory-pressure hook: drop the oldest trace entries
        down to `keep_frac` of the current ring; returns approximate
        bytes released (entries are small dicts of spans/stamps)."""
        dropped = 0
        with self._lock:
            keep = max(1, int(len(self._ring) * keep_frac))
            while len(self._ring) > keep:
                self._ring.popleft()
                dropped += 1
        return dropped * 512     # span-list dict estimate


# -- process-global recorder + module-level stamp API ------------------------
# The functions below are the only trace calls the hot routes make.

_REC: Optional[TraceRecorder] = None
_REC_LOCK = threading.Lock()


def configure(sample: Optional[float] = None, ring: Optional[int] = None,
              slow_ms: Optional[float] = None, key: Optional[str] = None,
              metrics: Optional[MetricsRegistry] = None) -> TraceRecorder:
    """(Re)build the process recorder. An unset `sample` reads
    PIO_TRACE_SAMPLE (default 0: off), an unset `key`
    PIO_SERVER_ACCESS_KEY; `ring` defaults to DEFAULT_RING and `slow_ms`
    to 0 (no slow-request log)."""
    global _REC
    env = os.environ

    def _envf(name: str, default: float) -> float:
        try:
            return float(env.get(name, "") or default)
        except ValueError:
            return default

    if sample is None:
        sample = _envf("PIO_TRACE_SAMPLE", 0.0)
    if ring is None:
        ring = DEFAULT_RING
    if slow_ms is None:
        slow_ms = 0.0
    if key is None:
        key = env.get("PIO_SERVER_ACCESS_KEY", "") or ""
    with _REC_LOCK:
        _REC = TraceRecorder(sample=sample, ring=ring, slow_ms=slow_ms,
                             key=key, metrics=metrics)
        return _REC


def get_recorder() -> TraceRecorder:
    rec = _REC
    if rec is None:
        rec = configure()
    return rec


def new_stamps(t0: float) -> Optional[PendingTrace]:
    """Wire hook: stamp slots for an arriving request (None = off)."""
    rec = _REC
    if rec is None or not rec.enabled:
        return None
    return rec.new_stamps(t0)


def on_sent(raw) -> None:
    """Wire hook: response bytes on the socket — finish the trace."""
    rec = _REC
    if rec is not None:
        rec.on_sent(raw)


def stamp(raw, slot: int) -> None:
    """Stamp one stage slot on a RawRequest's pending trace."""
    p = raw.trace
    if p is not None:
        p.st[slot] = time.perf_counter()


def mark(p: Optional[PendingTrace], slot: int) -> None:
    """Stamp one stage slot on a PendingTrace (or None: no-op)."""
    if p is not None:
        p.st[slot] = time.perf_counter()


def begin_raw(raw, header_value: Optional[str] = None,
              kind: str = "") -> Optional[PendingTrace]:
    """Handler entry on the raw fast path: stamp S_HANDLER, adopt any
    incoming X-PIO-Trace context, tag the entry kind."""
    p = raw.trace
    if p is None:
        return None
    p.st[S_HANDLER] = time.perf_counter()
    if kind:
        p.kind = kind
    if header_value:
        adopt(p, header_value)
    return p


def adopt(p: Optional[PendingTrace],
          header_value: Optional[str]) -> None:
    """Join the trace asserted by an upstream hop: same trace id, our
    span parented under the asserting span; an upstream sampled flag
    forces keep so the stitched view is complete."""
    if p is None or not header_value:
        return
    rec = _REC
    ctx = decode_header(header_value, rec.key if rec is not None else "")
    if ctx is None:
        return
    p.trace_id, p.parent_id, flag = ctx
    if flag:
        p.sampled = True


def ensure_ids(p: PendingTrace) -> None:
    if not p.trace_id:
        p.trace_id = _new_trace_id()
    if not p.span_id:
        p.span_id = _new_span_id()


def child_header(p: PendingTrace) -> str:
    """The X-PIO-Trace value to assert downstream of `p`'s span."""
    ensure_ids(p)
    rec = _REC
    return encode_header(p.trace_id, p.span_id, p.sampled,
                         rec.key if rec is not None else "")


def annotate(raw, status: int = 0, app: Optional[str] = None,
             route: Optional[str] = None, dispatch: Optional[str] = None,
             error: Optional[str] = None,
             kind: Optional[str] = None, query=None) -> None:
    """Attach scalar attributes to a RawRequest's pending trace —
    keyword scalars only, nothing allocated on the hot path."""
    p = raw.trace
    if p is None:
        return
    if status:
        p.status = status
    if app is not None:
        p.app = app
    if route is not None:
        p.route = route
    if dispatch is not None:
        p.dispatch = dispatch
    if error is not None:
        p.error = error
    if kind is not None:
        p.kind = kind
    if query is not None:
        p.query = query


def annotate_pending(p: Optional[PendingTrace], status: int = 0,
                     app: Optional[str] = None, route: Optional[str] = None,
                     dispatch: Optional[str] = None,
                     error: Optional[str] = None,
                     kind: Optional[str] = None, query=None) -> None:
    """`annotate` for call sites that hold the PendingTrace itself."""
    if p is None:
        return
    if status:
        p.status = status
    if app is not None:
        p.app = app
    if route is not None:
        p.route = route
    if dispatch is not None:
        p.dispatch = dispatch
    if error is not None:
        p.error = error
    if kind is not None:
        p.kind = kind
    if query is not None:
        p.query = query


def add_span(p: Optional[PendingTrace], name: str, t0: float,
             t1: float) -> None:
    """Append a named sub-span (router proxy attempts, redirects)."""
    if p is None:
        return
    if p.extra is None:
        p.extra = []
    p.extra.append((name, t0, t1))


# -- contextvar plumbing for the generic (non-fast) route --------------------
_current: "contextvars.ContextVar[Optional[PendingTrace]]" = \
    contextvars.ContextVar("pio_trace", default=None)


def set_current(p: Optional[PendingTrace]):
    return _current.set(p)


def reset_current(token) -> None:
    _current.reset(token)


def current() -> Optional[PendingTrace]:
    return _current.get()


@contextmanager
def background(name: str, app: str = ""):
    """Record a background span (refresher tick/fold-in, rolling
    reload) into the ring; no-op when tracing is off."""
    rec = _REC
    if rec is None or not rec.enabled:
        yield None
        return
    t0 = time.perf_counter()
    err = ""
    try:
        yield None
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        rec.record_background(name, t0, time.perf_counter(), app=app,
                              error=err)


def traces_json_body(query_get) -> bytes:
    """Build the `/traces.json` response body. `query_get(name)` pulls
    one query parameter (the Request.query_get shape)."""
    rec = get_recorder()
    app = query_get("app")
    min_ms = query_get("min_ms") or query_get("min_duration_ms")
    tid = query_get("trace_id")
    limit = query_get("limit")
    try:
        min_ms_f = float(min_ms) if min_ms else None
    except ValueError:
        min_ms_f = None
    try:
        limit_i = int(limit) if limit else 0
    except ValueError:
        limit_i = 0
    entries = rec.snapshot(app=app or None, min_ms=min_ms_f,
                           trace_id=tid or None, limit=limit_i)
    return json.dumps({"traces": entries, "count": len(entries),
                       "enabled": rec.enabled}).encode()
