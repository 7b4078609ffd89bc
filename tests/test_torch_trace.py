"""The port's flight recorder (`predictionio_tpu_torch/obs/trace.py`) on
the CPU, against the JAX package's `obs/trace.py`.

Mirrors `tests/test_trace.py`'s header codec, keep policy, server traces
and fleet stitching against the port, and across the packages: a header
encoded by either decodes to the same fields in the other (with and
without a key) and a forged one is refused by both; the same stamp
vectors give the same `/traces.json` entries and the same keep and drop
decisions from both recorders; a JAX router in front of a port replica
and a port router in front of a JAX replica stitch one trace id across
the hop. The slice as a whole: a port server traced at sample 1 keeps
one trace per request on the fast, generic and binary routes, with
stamps in slot order, segments tiling the duration, `pio_serve_seconds`
counting every request with exemplars in the ring, and answers equal
to the untraced server's.

Every test has its own SIGALRM limit; sampling is driven by stamps and
requests, never by wall-clock rates."""

import base64
import re
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.obs import trace as jtrace
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.obs import trace
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
from predictionio_tpu_torch.utils.wire import encode_bin_query

pytestmark = [pytest.mark.torch, pytest.mark.trace]

LIMIT_S = 120     # each test's own time limit
N_USERS, N_ITEMS, RANK = 24, 200, 8
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


@pytest.fixture(autouse=True)
def _limits():
    """A time limit per test; both recorders back at sampling off."""
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    trace.configure(sample=0.0)
    jtrace.configure(sample=0.0)


def _model():
    rng = np.random.default_rng(21)
    x = rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32)
    y = rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32)
    return pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")


def call(port, method, path, body=None, headers=None, raw=None,
         content_type="application/json"):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data:
        req.add_header("Content-Type", content_type)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            text = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(text) if "json" in ct else text)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _wait(pred, what, timeout_s=10.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _serve_entries(snap):
    return [e for e in snap if e["kind"] == "serve"]


# -- header codec -------------------------------------------------------------

class TestHeaderCodec:
    def test_roundtrip_unsigned(self):
        tid, sid = "ab" * 16, "cd" * 8
        value = trace.encode_header(tid, sid, True)
        assert trace.decode_header(value) == (tid, sid, True)
        value = trace.encode_header(tid, sid, False)
        assert trace.decode_header(value) == (tid, sid, False)

    def test_roundtrip_signed(self):
        tid, sid = "12" * 16, "34" * 8
        value = trace.encode_header(tid, sid, True, key="sekrit")
        assert trace.decode_header(value, key="sekrit") == (tid, sid, True)

    def test_forged_signature_refused(self):
        tid, sid = "12" * 16, "34" * 8
        value = trace.encode_header(tid, sid, True, key="sekrit")
        assert trace.decode_header(value, key="other") is None
        bare = trace.encode_header(tid, sid, True)
        assert trace.decode_header(bare, key="sekrit") is None

    @pytest.mark.parametrize("bad", [
        None, "", "garbage", "xx-yy-1", "ab" * 16 + "-" + "cd" * 8,
        "zz" * 16 + "-" + "cd" * 8 + "-1",          # non-hex trace id
        "ab" * 16 + "-" + "cd" * 8 + "-2",          # bad flag
        "ab" * 15 + "-" + "cd" * 8 + "-1",          # short trace id
    ])
    def test_malformed_refused(self, bad):
        assert trace.decode_header(bad) is None
        assert jtrace.decode_header(bad) is None

    def test_adopt_joins_upstream_trace(self):
        trace.configure(sample=1.0, ring=16)
        p = trace.PendingTrace()
        tid, sid = "ef" * 16, "01" * 8
        trace.adopt(p, trace.encode_header(tid, sid, True))
        assert (p.trace_id, p.parent_id, p.sampled) == (tid, sid, True)

    @pytest.mark.parametrize("key", ["", "sekrit"])
    @pytest.mark.parametrize("flag", [True, False])
    @pytest.mark.parametrize("encoder", ["port", "jax"])
    def test_headers_cross_the_packages(self, encoder, flag, key):
        """A header encoded by either package is the same string and
        decodes to the same fields in both."""
        rng = np.random.default_rng(3)
        tid = bytes(rng.integers(0, 256, 16, dtype=np.uint8)).hex()
        sid = bytes(rng.integers(0, 256, 8, dtype=np.uint8)).hex()
        enc = (trace if encoder == "port" else jtrace).encode_header
        value = enc(tid, sid, flag, key=key)
        assert value == trace.encode_header(tid, sid, flag, key=key) \
            == jtrace.encode_header(tid, sid, flag, key=key)
        for mod in (trace, jtrace):
            assert mod.decode_header(value, key=key) == (tid, sid, flag)

    @pytest.mark.parametrize("encoder", ["port", "jax"])
    def test_forgery_refused_by_both(self, encoder):
        tid, sid = "5a" * 16, "a5" * 8
        enc = (trace if encoder == "port" else jtrace).encode_header
        value = enc(tid, sid, True, key="sekrit")
        forged = value[:-1] + ("0" if value[-1] != "0" else "1")
        for mod in (trace, jtrace):
            assert mod.decode_header(value, key="wrong") is None
            assert mod.decode_header(forged, key="sekrit") is None
            assert mod.decode_header(enc(tid, sid, True),
                                     key="sekrit") is None


# -- keep policy and ring -----------------------------------------------------

def _run_one(mod, rec_, sampled=False, status=200, dur_s=0.001, app=""):
    """One synthetic request through `mod`'s recorder."""
    p = mod.PendingTrace()
    t0 = time.perf_counter() - dur_s
    p.st[mod.S_WIRE_READ] = t0
    p.st[mod.S_FRAMED] = t0 + dur_s * 0.1
    p.st[mod.S_HANDLER] = t0 + dur_s * 0.2
    p.st[mod.S_EXEC] = t0 + dur_s * 0.8
    p.st[mod.S_SENT] = t0 + dur_s
    p.sampled = sampled
    p.status = status
    p.kind = "serve"
    p.app = app
    rec_.finish(p)
    return p


class TestKeepPolicy:
    def test_head_sample_kept(self):
        rec_ = trace.configure(sample=1.0, ring=32,
                               metrics=MetricsRegistry())
        _run_one(trace, rec_, sampled=True)
        snap = rec_.snapshot()
        assert len(snap) == 1 and snap[0]["keep"] == "sampled"

    def test_error_kept_even_unsampled(self):
        rec_ = trace.configure(sample=0.5, ring=32,
                               metrics=MetricsRegistry())
        _run_one(trace, rec_, sampled=False, status=500)
        snap = rec_.snapshot()
        assert len(snap) == 1 and snap[0]["keep"] == "error"

    def test_slow_decile_kept_after_warmup(self):
        rec_ = trace.configure(sample=0.5, ring=256,
                               metrics=MetricsRegistry())
        for _ in range(100):                      # warm the p90 estimate
            _run_one(trace, rec_, dur_s=0.0005)
        _run_one(trace, rec_, dur_s=0.25)         # a 500x outlier
        snap = rec_.snapshot(min_ms=100.0)
        assert snap and snap[0]["keep"] == "slow"

    def test_ring_bounded_under_sustained_load(self):
        rec_ = trace.configure(sample=1.0, ring=16,
                               metrics=MetricsRegistry())
        for _ in range(500):
            _run_one(trace, rec_, sampled=True)
        assert rec_.ring_len() == 16
        assert len(rec_.snapshot()) == 16

    def test_snapshot_filters(self):
        rec_ = trace.configure(sample=1.0, ring=64,
                               metrics=MetricsRegistry())
        _run_one(trace, rec_, sampled=True, app="a", dur_s=0.001)
        _run_one(trace, rec_, sampled=True, app="b", dur_s=0.05)
        assert {e["app"] for e in rec_.snapshot()} == {"a", "b"}
        assert all(e["app"] == "a" for e in rec_.snapshot(app="a"))
        assert all(e["duration_ms"] >= 10.0
                   for e in rec_.snapshot(min_ms=10.0))
        tid = rec_.snapshot()[0]["trace_id"]
        assert [e["trace_id"] for e in rec_.snapshot(trace_id=tid)] == [tid]
        assert len(rec_.snapshot(limit=1)) == 1

    def test_spans_tile_the_duration(self):
        rec_ = trace.configure(sample=1.0, ring=8,
                               metrics=MetricsRegistry())
        _run_one(trace, rec_, sampled=True, dur_s=0.01)
        entry = rec_.snapshot()[0]
        covered = sum(s["dur_ms"] for s in entry["spans"])
        assert covered >= 0.9 * entry["duration_ms"]

    def test_background_span_lands_in_ring(self):
        rec_ = trace.configure(sample=1.0, ring=8,
                               metrics=MetricsRegistry())
        with trace.background("unit_tick"):
            pass
        with pytest.raises(RuntimeError):
            with trace.background("unit_fail"):
                raise RuntimeError("boom")
        names = {(e["name"], e.get("error", "")) for e in rec_.snapshot()}
        assert ("unit_tick", "") in names
        assert ("unit_fail", "RuntimeError") in names
        assert all(e["kind"] == "background" for e in rec_.snapshot())

    def test_disabled_recorder_allocates_nothing(self):
        trace.configure(sample=0.0)
        assert trace.new_stamps(time.perf_counter()) is None

    def test_trim_drops_the_oldest(self):
        rec_ = trace.configure(sample=1.0, ring=64,
                               metrics=MetricsRegistry())
        for n in range(40):
            _run_one(trace, rec_, sampled=True, app=f"a{n}")
        assert rec_.trim(0.25) == 30 * 512
        assert [e["app"] for e in rec_.snapshot()] == \
            [f"a{n}" for n in range(39, 29, -1)]

    def test_slow_log_line_past_slow_ms(self, caplog):
        rec_ = trace.configure(sample=1.0, ring=8, slow_ms=5.0,
                               metrics=MetricsRegistry())
        with caplog.at_level("WARNING"):
            _run_one(trace, rec_, sampled=True, dur_s=0.001)
            _run_one(trace, rec_, sampled=True, dur_s=0.02)
        lines = [r.getMessage() for r in caplog.records
                 if "slow_request" in r.getMessage()]
        assert len(lines) == 1
        assert json.loads(lines[0])["stages"]["device_exec"] > 0

    def test_same_stamps_give_the_jax_entries(self):
        """The same stamp vectors, attributes and ids through both
        recorders give the same entries (the wall-clock `ts` aside)."""
        from predictionio_tpu.obs import MetricsRegistry as JMetrics
        rng = np.random.default_rng(7)
        recs = {trace: trace.configure(sample=1.0, ring=64,
                                       metrics=MetricsRegistry()),
                jtrace: jtrace.configure(sample=1.0, ring=64,
                                         metrics=JMetrics())}
        base = time.perf_counter()
        for n in range(24):
            present = rng.random(trace.N_STAMPS) < 0.7
            gaps = rng.uniform(1e-5, 2e-3, trace.N_STAMPS)
            st = [base + float(np.sum(gaps[:i + 1])) if present[i] else 0.0
                  for i in range(trace.N_STAMPS)]
            for mod, rec_ in recs.items():
                p = mod.PendingTrace()
                p.st[:] = st
                p.trace_id, p.span_id = f"{n:032x}", f"{n:016x}"
                p.parent_id = "" if n % 2 else f"{n + 7:016x}"
                p.sampled = True
                p.kind = ("serve", "router", "")[n % 3]
                p.route = "/queries.json"
                p.app = f"app{n % 4}"
                p.status = (200, 503)[n % 5 == 0]
                p.error = "OverloadedError" if n % 5 == 0 else ""
                p.dispatch = "fused" if n % 2 else ""
                p.batch_id, p.batch_size = (n, 4) if n % 3 == 0 else (0, 0)
                p.rid = f"rid{n}"
                p.reactor = n % 3 - 1
                p.query = ("u1", 3) if n % 4 == 0 else (
                    {"user": "u2", "num": 2} if n % 4 == 1 else None)
                if n % 6 == 0:
                    mod.add_span(p, "proxy:127.0.0.1:9", st[2] or base,
                                 (st[2] or base) + 1e-4)
                rec_.finish(p)
        port, jax = ([{k: v for k, v in e.items() if k != "ts"}
                      for e in recs[mod].snapshot()]
                     for mod in (trace, jtrace))
        assert len(port) == 24 and port == jax

    def test_same_keep_and_drop_decisions_as_jax(self):
        """Seeded durations, errors and head-sample flags through both
        recorders: the same entries kept, for the same reasons, and the
        same pio_serve_seconds counts."""
        from predictionio_tpu.obs import MetricsRegistry as JMetrics
        rng = np.random.default_rng(11)
        preg, jreg = MetricsRegistry(), JMetrics()
        prec = trace.configure(sample=0.3, ring=1024, metrics=preg)
        jrec = jtrace.configure(sample=0.3, ring=1024, metrics=jreg)
        durs = rng.lognormal(np.log(2e-3), 0.8, 600)
        base = time.perf_counter()
        for n, d in enumerate(durs):
            sampled = bool(rng.random() < 0.3)
            status = 500 if rng.random() < 0.03 else 200
            for mod, rec_ in ((trace, prec), (jtrace, jrec)):
                p = mod.PendingTrace()
                p.st[mod.S_WIRE_READ] = base + n
                p.st[mod.S_EXEC] = base + n + d * 0.7
                p.st[mod.S_SENT] = base + n + d
                p.sampled, p.status, p.kind = sampled, status, "serve"
                p.trace_id, p.span_id = f"{n:032x}", f"{n:016x}"
                rec_.finish(p)
        keep = [(e["trace_id"], e["keep"]) for e in prec.snapshot()]
        assert keep == [(e["trace_id"], e["keep"])
                        for e in jrec.snapshot()]
        assert {k for _, k in keep} == {"sampled", "error", "slow"}
        assert preg.value("pio_trace_kept_total", why="slow") == \
            jreg.value("pio_trace_kept_total", why="slow") > 0
        assert preg.value("pio_serve_seconds", app="") is not None


# -- server traces --------------------------------------------------------------

@pytest.fixture()
def served():
    reg = MetricsRegistry()
    srv = cli.deploy(_model(), port=0, batch_max=16, window_s=0.002,
                     metrics=reg)
    yield srv
    srv.stop()


def _traced(srv, ring=256, sample=1.0):
    return trace.configure(sample=sample, ring=ring, metrics=srv.metrics)


class TestServerTraces:
    def test_query_trace_covers_wall_time(self, served):
        rec_ = _traced(served, ring=64)
        status, _ = call(served.port, "POST", "/queries.json",
                         {"user": "u1", "num": 3})
        assert status == 200
        e, = _wait(lambda: _serve_entries(rec_.snapshot()), "a serve trace")
        assert e["status"] == 200 and e["name"] == "/queries.json"
        covered = sum(s["dur_ms"] for s in e["spans"])
        assert covered >= 0.9 * e["duration_ms"]
        names = {s["name"] for s in e["spans"]}
        assert {"device_exec", "wire_write", "respond"} <= names

    def test_batched_trace_carries_batch_and_dispatch(self, served):
        rec_ = _traced(served, ring=64)
        for n in range(4):
            assert call(served.port, "POST", "/queries.json",
                        {"user": f"u{n}", "num": 3})[0] == 200
        e = _wait(lambda: [x for x in _serve_entries(rec_.snapshot())
                           if x.get("batch_size")], "a batched trace")[0]
        assert e["batch_id"] >= 1 and e["batch_size"] >= 1
        assert e["dispatch"] in ("host", "device", "sharded", "fused")
        assert "device_exec" in {s["name"] for s in e["spans"]}

    def test_traces_json_endpoint_and_exemplar(self, served):
        rec_ = _traced(served)
        for n in range(40):
            call(served.port, "POST", "/queries.json",
                 {"user": f"u{n % 20}", "num": 3})
        status, body = call(served.port, "GET", "/traces.json")
        assert status == 200 and body["enabled"] is True
        assert body["count"] == len(body["traces"]) > 0
        child = served.metrics.histogram(
            "pio_serve_seconds", "", labels=("app",),
            buckets=trace.SERVE_BUCKETS).labels(app="")
        tid = _wait(lambda: next(
            (c[0] for c in sorted((child.exemplars or {}).values(),
                                  key=lambda c: -c[2])
             if rec_.snapshot(trace_id=c[0])), None), "an exemplar")
        status, body = call(served.port, "GET",
                            f"/traces.json?trace_id={tid}")
        assert status == 200 and [t["trace_id"]
                                  for t in body["traces"]] == [tid]
        status, body = call(served.port, "GET", "/traces.json?min_ms=1e9")
        assert status == 200 and body["count"] == 0

    def test_tracing_off_serves_counts_and_reports_disabled(self, served):
        trace.configure(sample=0.0, metrics=served.metrics)
        for body, kw in (({"user": "u1", "num": 3}, {}),
                         ({"user": "u1", "num": 3, "blackList": ["i1"]},
                          {}),
                         (None, {"raw": encode_bin_query("u2", 2),
                                 "content_type": "application/x-pio-bin"})):
            assert call(served.port, "POST", "/queries.json", body,
                        **kw)[0] == 200
        status, body = call(served.port, "GET", "/traces.json")
        assert status == 200 and body["enabled"] is False
        # pio_serve_seconds exists and counts with tracing off
        assert served.metrics.snapshot()["pio_serve_seconds"]["series"][0][
            "count"] == 3

    def test_quota_shed_tags_the_app_on_the_trace(self):
        from predictionio_tpu_torch.core.runtime import RuntimeContext
        from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                         StorageRegistry)
        from predictionio_tpu_torch.tenancy import TenancyConfig
        reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
        app = reg.get_meta_data_apps().insert(App(0, "shedapp"))
        reg.get_meta_data_access_keys().insert(AccessKey("SKEY", app, ()))
        srv = cli.deploy(_model(), port=0, metrics=MetricsRegistry(),
                         ctx=RuntimeContext(registry=reg, device="cpu"),
                         tenancy=TenancyConfig(enabled=True, rate=0.01,
                                               burst=1.0))
        rec_ = _traced(srv, ring=64)
        try:
            codes = [call(srv.port, "POST", "/queries.json?accessKey=SKEY",
                          {"user": "u1", "num": 2, "blackList": ["i3"]})[0]
                     for _ in range(3)]
            assert codes[0] == 200 and 429 in codes
            shed = _wait(lambda: [e for e in rec_.snapshot()
                                  if e["status"] == 429], "a shed trace")
            assert shed[0]["app"] == "shedapp"
            assert shed[0]["keep"] in ("sampled", "error")
        finally:
            srv.stop()


# -- the slice as a whole -------------------------------------------------------

def _mix(n=24, seed=5):
    """Fast (JSON {"user", "num"}), generic (with a blackList) and binary
    requests, shuffled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        user, num = USERS[int(rng.integers(N_USERS))], int(1 + i % 7)
        kind = ("fast", "generic", "binary")[i % 3]
        if kind == "fast":
            out.append((kind, {"user": user, "num": num}, {}))
        elif kind == "generic":
            ban = [ITEMS[j] for j in rng.choice(N_ITEMS, 9, replace=False)]
            out.append((kind, {"user": user, "num": num, "blackList": ban},
                        {}))
        else:
            out.append((kind, None, {
                "raw": encode_bin_query(user, num),
                "content_type": "application/x-pio-bin"}))
    return [out[i] for i in rng.permutation(n)]


def _send(port, mix):
    return [call(port, "POST", "/queries.json", body, **kw)
            for _, body, kw in mix]


def test_the_slice_traces_every_route_and_changes_no_answer():
    """A port server at sample 1: one kept serve trace per request on
    the fast, generic and binary routes, its stamps non-decreasing in
    slot order, its segments summing to its duration within the
    entries' 1-µs rounding, pio_serve_seconds counting every request
    with exemplars naming kept traces; the answers equal the same
    server's with tracing off."""
    mix = _mix()
    srv = cli.deploy(_model(), port=0, batch_max=16, window_s=0.002,
                     metrics=MetricsRegistry())
    try:
        trace.configure(sample=0.0, metrics=srv.metrics)
        untraced = _send(srv.port, mix)
        assert [s for s, _ in untraced] == [200] * len(mix)
    finally:
        srv.stop()
    reg = MetricsRegistry()
    srv = cli.deploy(_model(), port=0, batch_max=16, window_s=0.002,
                     metrics=reg)
    rec_ = trace.configure(sample=1.0, ring=256, metrics=reg)
    stamps = []
    finish = rec_.finish

    def recording(p):
        finish(p)
        stamps.append((p.kind, list(p.st)))

    rec_.finish = recording
    try:
        traced = _send(srv.port, mix)
        _wait(lambda: len(stamps) >= len(mix), "every trace finished")
    finally:
        srv.stop()
    assert traced == untraced
    serve = _serve_entries(rec_.snapshot())
    assert len(serve) == len(mix) == len(stamps)
    assert len({e["trace_id"] for e in serve}) == len(mix)
    for kind, st in stamps:
        assert kind == "serve"
        present = [t for t in st if t > 0.0]
        assert present == sorted(present)
        assert st[trace.S_WIRE_READ] > 0 and st[trace.S_EXEC] > 0
        assert st[trace.S_SENT] == max(present)
    for e in serve:
        names = [s["name"] for s in e["spans"]]
        assert "device_exec" in names and e["keep"] == "sampled"
        total = sum(s["dur_ms"] for s in e["spans"])
        assert abs(total - e["duration_ms"]) <= 5e-4 * (len(names) + 1)
        for a, b in zip(e["spans"], e["spans"][1:]):
            assert abs(a["start_ms"] + a["dur_ms"] - b["start_ms"]) <= 1.5e-3
    routes = {k: sum(1 for m in mix if m[0] == k)
              for k in ("fast", "generic", "binary")}
    assert min(routes.values()) > 0
    row, = reg.snapshot()["pio_serve_seconds"]["series"]
    assert row["count"] == len(mix)
    ring = {e["trace_id"] for e in serve}
    assert row["exemplars"] and all(x["trace_id"] in ring
                                    for x in row["exemplars"])


def test_kernel_launches_and_builds_on_metrics(served):
    """/metrics carries the probe's families: launches read from the
    wrapper (CPU calls count none), builds none in a steady state."""
    from predictionio_tpu_torch.obs import build_watch
    from predictionio_tpu_torch.ops import fused_topk
    with build_watch(served.metrics) as w:
        assert call(served.port, "POST", "/queries.json",
                    {"user": "u1", "num": 3})[0] == 200
    assert w.count == 0
    saved = fused_topk.LAUNCHES
    fused_topk.LAUNCHES = saved + 7
    try:
        status, text = call(served.port, "GET", "/metrics")
    finally:
        fused_topk.LAUNCHES = saved
    assert status == 200
    assert 'pio_kernel_launches_total{kernel="fused_topk"}' in text
    assert "pio_kernel_builds_total 0" in text


# -- fleet stitching ------------------------------------------------------------

def _factory(i, *, mesh=None, tenancy=None):
    return cli.deploy(_model(), port=0, batch_max=16, window_s=0.002,
                      mesh=mesh, tenancy=tenancy, metrics=MetricsRegistry())


def _fleet(replicas=3, **kw):
    cfg = dict(replicas=replicas, health_interval_s=0.1, eject_threshold=2,
               drain_timeout_s=2.0)
    cfg.update(kw.pop("fleet", {}))
    srv = FleetServer(kw.pop("factory", _factory),
                      fleet=FleetConfig(**cfg), port=0,
                      metrics=MetricsRegistry(), **kw)
    srv.start()
    return srv


def _stitched(rec_, kinds=("router", "serve")):
    by_tid = {}
    for e in rec_.snapshot():
        by_tid.setdefault(e["trace_id"], []).append(e)
    return next((g for g in by_tid.values()
                 if set(kinds) <= {e["kind"] for e in g}), None)


class _Loader:
    """Client threads recording every response status."""

    def __init__(self, port, threads=2):
        self.port = port
        self.halt = threading.Event()
        self.statuses = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(threads)]

    def _run(self):
        while not self.halt.is_set():
            try:
                status, _ = call(self.port, "POST", "/queries.json",
                                 {"user": "u1", "num": 2})
            except OSError:
                status = -1
            with self._lock:
                self.statuses.append(status)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.halt.set()
        for t in self._threads:
            t.join(5)


class TestFleetStitching:
    def test_fleet_hop_stitches_under_one_trace_id(self):
        rec_ = trace.configure(sample=1.0, ring=256,
                               metrics=MetricsRegistry())
        fleet = _fleet(replicas=3)
        try:
            assert call(fleet.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2})[0] == 200
            group = _wait(lambda: _stitched(rec_), "a stitched trace")
        finally:
            fleet.stop()
        router = next(e for e in group if e["kind"] == "router")
        serve = next(e for e in group if e["kind"] == "serve")
        assert serve["parent_id"] == router["span_id"]
        assert any(s["name"].startswith("proxy:") for s in router["spans"])
        for e in (router, serve):
            covered = sum(s["dur_ms"] for s in e["spans"]
                          if not s["name"].startswith("proxy"))
            assert covered >= 0.9 * e["duration_ms"], e

    def test_mesh_fan_out_records_shard_spans(self):
        rec_ = trace.configure(sample=1.0, ring=256,
                               metrics=MetricsRegistry())
        fleet = _fleet(replicas=2, mesh="items=2@fleet")
        try:
            assert call(fleet.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2})[0] == 200
            router = _wait(lambda: [e for e in rec_.snapshot()
                                    if e["kind"] == "router"], "router")[0]
        finally:
            fleet.stop()
        shards = sorted(s["name"].split(":")[1] for s in router["spans"]
                        if s["name"].startswith("shard:"))
        assert shards == ["0/2", "1/2"]

    def test_router_hop_not_double_counted_in_serve_hist(self):
        reg = MetricsRegistry()
        trace.configure(sample=1.0, ring=256, metrics=reg)
        fleet = _fleet(replicas=2)
        try:
            for _ in range(4):
                assert call(fleet.port, "POST", "/queries.json",
                            {"user": "u1", "num": 2})[0] == 200

            def counted():
                fam = reg.snapshot().get("pio_serve_seconds")
                return sum(s["count"] for s in fam["series"]) if fam else 0
            _wait(lambda: counted() >= 4, "four observations")
            time.sleep(0.05)
            assert counted() == 4
        finally:
            fleet.stop()

    def test_standby_redirect_carries_trace_header(self, tmp_path):
        from predictionio_tpu_torch.data.storage import StorageRegistry

        def registry():
            return StorageRegistry({
                "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")})
        rec_ = trace.configure(sample=1.0, ring=256,
                               metrics=MetricsRegistry())
        leader = _fleet(replicas=1, registry=registry(),
                        fleet={"lease_ttl_s": 0.5})
        _wait(leader.is_leader, "the leader's lease")
        standby = _fleet(replicas=0, registry=registry(),
                         fleet={"lease_ttl_s": 0.5})
        try:
            code = _wait(lambda: call(standby.port, "POST", "/queries.json",
                                      {"user": "u1", "num": 2})[0] == 307,
                         "the standby's redirect")
            assert code
            req = urllib.request.Request(
                f"http://127.0.0.1:{standby.port}/queries.json",
                data=json.dumps({"user": "u1", "num": 2}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 307
            hdr = err.value.headers.get(trace.TRACE_HEADER)
            tid, parent_span, _ = trace.decode_header(hdr)
            assert call(leader.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2},
                        headers={trace.TRACE_HEADER: hdr})[0] == 200
            # the standby's own entry carries the id too: wait for the
            # leader's entries, parented under the standby's span
            group = _wait(lambda: [e for e in rec_.snapshot(trace_id=tid)
                                   if e["parent_id"] == parent_span],
                          "the redirected request's entries")
            assert {e["kind"] for e in group} <= {"router", "serve"}
        finally:
            standby.stop()
            leader.stop()

    def test_replica_killed_at_full_sampling_zero_failures(self):
        rec_ = trace.configure(sample=1.0, ring=512,
                               metrics=MetricsRegistry())
        fleet = _fleet(replicas=3)
        try:
            victim = fleet.replicas()[0]
            with _Loader(fleet.port) as load:
                _wait(lambda: len(load.statuses) > 10, "load")
                victim.server.shutdown()
                n = len(load.statuses)
                _wait(lambda: len(load.statuses) > n + 20, "more load")
            assert set(load.statuses) == {200}
            assert any(e["kind"] == "router" for e in rec_.snapshot())
        finally:
            fleet.stop()

    def test_rolling_reload_records_background_span(self):
        """A roll of members serving a model file: each refuses its
        reload and is admitted again, the roll aborts, and the ring
        holds its `rolling_reload` span with the abort."""
        rec_ = trace.configure(sample=1.0, ring=256,
                               metrics=MetricsRegistry())
        fleet = _fleet(replicas=2, server_key="rk")
        try:
            status, report = call(fleet.port, "POST", "/reload", headers={
                "Authorization": "Basic " + base64.b64encode(
                    b"rk:").decode()})
            assert status == 500 and report["aborted"] is True
            rolls = [e for e in rec_.snapshot()
                     if e["name"] == "rolling_reload"]
            assert len(rolls) == 1 and rolls[0]["kind"] == "background"
            assert rolls[0]["error"] == "aborted"
        finally:
            fleet.stop()


# -- stitching across the packages ----------------------------------------------

def _jax_registry_and_engine():
    """A JAX MEM store holding one COMPLETED recommendation instance of
    `_model()`'s factors (the JAX train replaced by the model)."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import EngineParams as JParams
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.event import DataMap as JMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import App as JApp
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.ingest import BiMap
    from predictionio_tpu.models import recommendation as jrec
    from predictionio_tpu.ops import als as jals
    reg = JReg({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(JApp(0, "stitch"))
    reg.get_events().init(app)
    reg.get_events().insert(JEvent(
        event="rate", entity_type="user", entity_id="u0",
        target_entity_type="item", target_entity_id="i0",
        properties=JMap({"rating": 4.0})), app)
    m = _model()
    jmodel = jals.ALSModel(m.user_factors.numpy(), m.item_factors.numpy(),
                           BiMap.from_keys(USERS), BiMap.from_keys(ITEMS))
    train = jrec.ALSAlgorithm.train
    jrec.ALSAlgorithm.train = lambda self, ctx, pd: jmodel
    try:
        JWorkflow.run_train(jrec.engine(), JParams(
            data_source_params=("", jrec.DataSourceParams(
                app_name="stitch")),
            algorithm_params_list=(("als", jrec.ALSAlgorithmParams()),)),
            JCtx(registry=reg))
    finally:
        jrec.ALSAlgorithm.train = train
    return reg, jrec.engine()


def _join(router_port, member_port):
    """Register a member with a router of either package by its
    heartbeat route, then wait for its admission."""
    body = {"member": f"127.0.0.1:{member_port}", "ready": True}
    assert call(router_port, "POST", "/fleet/register", body)[0] == 200

    def admitted():
        _, st = call(router_port, "GET", "/status.json")
        return any(m.get("admitted") for m in st.get("replicas", ()))
    _wait(admitted, "the member's admission")


@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_routers_and_replicas_of_either_package_stitch(router_pkg):
    """A JAX router in front of a port replica, and a port router in
    front of a JAX replica: one signed, sampled request yields the
    router's entry in its package's ring and the replica's serve entry
    in the other's, under one trace id, the replica's span parented
    under the router's."""
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.serving import FleetConfig as JFleetConfig
    from predictionio_tpu.serving import FleetServer as JFleet
    from predictionio_tpu.serving import PredictionServer as JServer
    from predictionio_tpu.serving import ServerConfig
    key = "stitch-key"
    prec = trace.configure(sample=1.0, ring=256, key=key,
                           metrics=MetricsRegistry())
    jrec = jtrace.configure(sample=1.0, ring=256, key=key,
                            metrics=JMetrics())
    cfg = dict(replicas=0, health_interval_s=0.1)
    if router_pkg == "jax":
        router = JFleet(ServerConfig(ip="127.0.0.1", port=0),
                        JFleetConfig(**cfg), metrics=JMetrics())
        replica = cli.deploy(_model(), port=0, batch_max=8,
                             metrics=MetricsRegistry())
        router_rec, replica_rec = jrec, prec
    else:
        router = FleetServer(None, fleet=FleetConfig(**cfg), port=0,
                             metrics=MetricsRegistry())
        jreg, jengine = _jax_registry_and_engine()
        replica = JServer(ServerConfig(ip="127.0.0.1", port=0),
                          registry=jreg, engine=jengine,
                          metrics=JMetrics())
        router_rec, replica_rec = prec, jrec
    router.start()
    if router_pkg == "port":
        replica.start()
    try:
        _join(router.port, replica.port)
        tid, sid = "c0ffee" + "0" * 26, "1234" * 4
        hdr = trace.encode_header(tid, sid, True, key=key)
        status, body = call(router.port, "POST", "/queries.json",
                            {"user": "u1", "num": 3},
                            headers={trace.TRACE_HEADER: hdr})
        assert status == 200 and len(body["itemScores"]) == 3
        serve = _wait(lambda: [e for e in replica_rec.snapshot(trace_id=tid)
                               if e["kind"] == "serve"], "the replica entry")
        hop, = _wait(lambda: router_rec.snapshot(trace_id=tid),
                     "the router entry")
        assert hop["kind"] == "router" and hop["parent_id"] == sid
        assert any(s["name"].startswith("proxy:") for s in hop["spans"])
        assert len(serve) == 1 and serve[0]["parent_id"] == hop["span_id"]
    finally:
        router.stop()
        if router_pkg == "jax":
            replica.stop()
        else:
            replica.shutdown()


# -- the refresher's spans --------------------------------------------------------

def test_refresher_ticks_record_the_jax_spans(tmp_path):
    """On one SQLITE + PEVLOG store, the port's refresher over the port's
    instance and the JAX one over the JAX package's: baseline, noop, and
    a fold of the same drip record the same background spans
    (`refresh_tick` per tick, `refresh_fold` per fold)."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.models import recommendation as jrec
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.serving import PredictionServer as JServer
    from predictionio_tpu.serving import ServerConfig
    from predictionio_tpu.streaming import Refresher as JRefresher
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import App, StorageRegistry
    from predictionio_tpu_torch.models import recommendation as prec
    from predictionio_tpu_torch.streaming import Refresher
    config = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}

    def rate(user, item, r):
        return Event(event="rate", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     properties=DataMap({"rating": float(r)}))

    reg = StorageRegistry(config)
    app_id = reg.get_meta_data_apps().insert(App(0, "spanapp"))
    events = reg.get_events()
    events.init(app_id)
    rng = np.random.RandomState(3)
    events.insert_batch([rate(f"u{u}", f"i{i}", 1 + (u + i) % 5)
                         for u in range(10) for i in range(8)
                         if rng.rand() < 0.6], app_id)
    variant = {"datasource": {"params": {"app_name": "spanapp"}},
               "algorithms": [{"name": "als", "params": {
                   "rank": 4, "num_iterations": 3, "seed": 1}}]}
    engine = prec.RecommendationEngine.apply()
    row = CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(variant),
        RuntimeContext(registry=reg, device="cpu"))
    psrv = cli.deploy_instance(engine, row,
                               RuntimeContext(registry=reg, device="cpu"),
                               port=0, batch_max=4,
                               metrics=MetricsRegistry())
    jreg = JReg(config)
    jengine = jrec.engine()
    JWorkflow.run_train(jengine, jengine.engine_params_from_variant(variant),
                        JCtx(registry=jreg))
    jsrv = JServer(ServerConfig(ip="127.0.0.1", port=0), registry=jreg,
                   engine=jengine, metrics=JMetrics())
    jsrv.start()
    prec_ = trace.configure(sample=1.0, ring=64, metrics=MetricsRegistry())
    jrec_ = jtrace.configure(sample=1.0, ring=64, metrics=JMetrics())
    try:
        ours = Refresher(psrv, interval_s=999.0)
        theirs = JRefresher(jsrv, interval_s=999.0)
        outcomes = [(ours.tick(), theirs.tick()),
                    (ours.tick(), theirs.tick())]
        events.insert_batch([rate("u1", "i6", 5.0), rate("u99", "i2", 4.0)],
                            app_id)
        outcomes.append((ours.tick(), theirs.tick()))
        assert outcomes == [("baseline", "baseline"), ("noop", "noop"),
                            ("folded", "folded")]

        def spans(rec_):
            return sorted((e["name"], e["kind"], e.get("error", ""))
                          for e in rec_.snapshot())
        assert spans(prec_) == spans(jrec_) == sorted(
            [("refresh_tick", "background", "")] * 3
            + [("refresh_fold", "background", "")])
    finally:
        jsrv.shutdown()
        psrv.stop()
        jreg.close()
        reg.close()


# -- cli train --profile-dir ------------------------------------------------------

def test_cli_train_profile_dir_writes_a_trace(tmp_path):
    """`cli train --device cpu --profile-dir` writes a Chrome trace that
    parses, and its report has the JAX `cli train` report's keys with
    `kernelBuilds` (0 here) where the JAX one has `jaxCompiles`."""
    import inspect
    import os
    import subprocess
    import sys
    from pathlib import Path

    from predictionio_tpu.cli import ops as jops
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo),
           "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}

    def cli_run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout)

    cli_run("app", "new", "ProfApp")
    rng = np.random.RandomState(5)
    lines = [json.dumps({
        "event": "rate", "entityType": "user", "entityId": f"u{u}",
        "targetEntityType": "item", "targetEntityId": f"i{i}",
        "properties": {"rating": float(1 + (u * i) % 5)},
        "eventTime": "2026-01-01T00:00:00.000Z"})
        for u in range(12) for i in range(10) if rng.rand() < 0.5]
    (tmp_path / "events.jsonl").write_text("\n".join(lines) + "\n")
    cli_run("import", "--appid", "1", "--input", "events.jsonl")
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "ProfApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 2, "seed": 7}}]}))
    report = cli_run("train", "--device", "cpu", "--profile-dir", "prof")
    assert report["status"] == "COMPLETED" and report["kernelBuilds"] == 0
    # the JAX report's keys, read off its return statement
    src = inspect.getsource(jops.train)
    jkeys = set(re.findall(r'"(\w+)":', src[src.rindex("return {"):]))
    assert set(report) == (jkeys - {"jaxCompiles"}) | {"kernelBuilds"}
    traces = list((tmp_path / "prof").glob("pio-train-*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
