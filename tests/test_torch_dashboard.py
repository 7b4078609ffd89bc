"""The port's dashboard, admin server and `cli top` (`predictionio_tpu_
torch/tools/dashboard.py`, `tools/admin.py`) on the CPU, against the JAX
package's: the evaluation pages of one shared sqlite store, every
`/metrics.html` panel and the history sparklines for the same registry
script and ring, the trace waterfall for the same ring, and `top_view`
for the same endpoints are the JAX text character for character; the
app CRUD over REST, the dashboard's key, and `top` against live port
servers (the quality line after served queries).

Every test has its own SIGALRM limit."""

import json
import signal
import threading
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from predictionio_tpu.obs import metrics as jmetrics
from predictionio_tpu.obs import tsdb as jtsdb
from predictionio_tpu.tools import admin as jadmin
from predictionio_tpu.tools import dashboard as jdash
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.obs import metrics as pmetrics
from predictionio_tpu_torch.obs import tsdb as ptsdb
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.tools import admin as padmin
from predictionio_tpu_torch.tools import dashboard as pdash

pytestmark = pytest.mark.torch

LIMIT_S = 90
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


@pytest.fixture(autouse=True)
def _limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def call(port, method, path, body=None, raw=False):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            text = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return resp.status, (text if raw or "json" not in ct
                                 else json.loads(text)), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), dict(e.headers)


# -- the evaluation pages ------------------------------------------------------

def _evaluations(registry, base):
    """Three evaluation rows as `cli eval` writes them (one still
    running), through the given package's DAO."""
    t0 = datetime(2026, 3, 1, 12, 0, tzinfo=timezone.utc)
    dao = registry.get_meta_data_evaluation_instances()
    ids = []
    for n, status in enumerate((base.EvaluationInstanceStatus.COMPLETED,
                                base.EvaluationInstanceStatus.COMPLETED,
                                base.EvaluationInstanceStatus.RUNNING)):
        result = {"bestScore": 0.25 * (n + 1), "bestIndex": n,
                  "scores": [0.1, 0.25 * (n + 1)]}
        ids.append(dao.insert(base.EvaluationInstance(
            status=status, start_time=t0 + timedelta(minutes=n),
            end_time=t0 + timedelta(minutes=n, seconds=30),
            evaluation_class=f"my_eval.Eval<{n}>",
            engine_params_generator_class="my_eval.Gen",
            evaluator_results=f"best 0.{n}5 & more",
            evaluator_results_html=f"<table><tr><td>{n}</td></tr></table>",
            evaluator_results_json=json.dumps(result))))
    return ids


def test_evaluation_pages_equal_the_jax_dashboards(tmp_path):
    """One sqlite store, rows written by the port: the port's and the JAX
    dashboard serve the same bytes on every evaluation route, in the
    JAX routes' order (`<iid>.json` before `<iid>`)."""
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu_torch.data.storage import StorageRegistry, base
    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")}
    preg = StorageRegistry(config)
    ids = _evaluations(preg, base)
    mine = pdash.Dashboard(pdash.DashboardConfig(ip="127.0.0.1", port=0),
                           preg, metrics=pmetrics.MetricsRegistry())
    theirs = jdash.Dashboard(jdash.DashboardConfig(ip="127.0.0.1", port=0),
                             JReg(config), metrics=jmetrics.MetricsRegistry())
    mine.start()
    theirs.start()
    try:
        for path in ["/", f"/engine_instances/{ids[0]}",
                     f"/engine_instances/{ids[1]}.json",
                     f"/engine_instances/{ids[2]}", "/engine_instances/zzz",
                     "/engine_instances/zzz.json"]:
            m = call(mine.port, "GET", path, raw=True)
            t = call(theirs.port, "GET", path, raw=True)
            assert m[:2] == t[:2], path
            if m[0] == 200:
                for h in ("Access-Control-Allow-Origin",
                          "Access-Control-Allow-Methods", "Content-Type"):
                    assert m[2].get(h) == t[2].get(h), (path, h)
        status, index, headers = call(mine.port, "GET", "/")
        assert status == 200 and headers["Access-Control-Allow-Origin"] == "*"
        # newest first, only the completed ones, escaped
        assert index.index(ids[1]) < index.index(ids[0])
        assert ids[2] not in index and "my_eval.Eval&lt;1&gt;" in index
        assert "/metrics.html" in index
        status, body, _ = call(mine.port, "GET",
                               f"/engine_instances/{ids[1]}.json")
        assert status == 200 and body["bestScore"] == 0.5
        status, page, _ = call(mine.port, "GET", f"/engine_instances/{ids[0]}")
        assert status == 200 and "<table><tr><td>0</td>" in page
        assert call(mine.port, "GET", "/engine_instances/zzz")[0] == 404
    finally:
        mine.shutdown()
        theirs.shutdown()


def test_dashboard_key_auth():
    from predictionio_tpu_torch.data.storage import StorageRegistry
    srv = pdash.Dashboard(pdash.DashboardConfig(ip="127.0.0.1", port=0,
                                                server_key="dk"),
                          StorageRegistry(MEM))
    srv.start()
    try:
        for path in ("/", "/metrics.html", "/traces.html"):
            assert call(srv.port, "GET", path)[0] == 401, path
            assert call(srv.port, "GET", path + "?accessKey=dk",
                        raw=True)[0] == 200, path
    finally:
        srv.shutdown()


# -- /metrics.html ---------------------------------------------------------------

def _script(reg):
    """Families of every panel group, with labels, histograms and an
    exemplar, on either package's registry."""
    reg.counter("pio_topk_dispatch_total", "d", labels=("path",)).labels(
        path="fused").inc(7)
    reg.gauge("pio_serve_warmup_seconds", "w").set(0.125)
    h = reg.histogram("pio_serve_batch_size", "b",
                      buckets=(1, 2, 4, 8, 16, 32, 64))
    for v in (1, 1, 3, 9, 40):
        h.observe(v)
    reg.gauge("pio_freshness_seconds", "f").set(2.5)
    s = reg.histogram("pio_serve_seconds", "s", labels=("app",))
    for n, v in enumerate((0.001, 0.002, 0.004, 0.2)):
        s.labels(app="").observe(v, exemplar=f"trace{n:02d}")
    reg.gauge("pio_slo_burn_rate", "burn", labels=("app", "window")).labels(
        app="", window="5m").set(1.5)
    reg.gauge("pio_pred_top1_psi", "psi", labels=("app",)).labels(
        app="a").set(0.02)
    reg.counter("pio_canary_total", "c", labels=("outcome",)).labels(
        outcome="pass").inc()
    for r, n in (("0", 30.0), ("1", 10.0)):
        reg.counter("pio_wire_requests_total", "r",
                    labels=("listen", "reactor")).labels(
            listen="127.0.0.1:1", reactor=r).inc(n)
        reg.counter("pio_wire_connections_accepted_total", "a",
                    labels=("listen", "reactor")).labels(
            listen="127.0.0.1:1", reactor=r).inc(n / 10)
    reg.counter("pio_shed_total", "s", labels=("surface", "app")).labels(
        surface="quota", app="<x>").inc(3)
    reg.counter("pio_tenant_admitted_total", "t", labels=("app",)).labels(
        app="a").inc(11)
    reg.gauge("pio_tier_hot_items", "h", labels=("plan",)).labels(
        plan="0").set(125)
    reg.gauge("pio_fleet_shard_owner", "o", labels=("shard", "member")
              ).labels(shard="0/3", member="m").set(1)
    reg.gauge("pio_thread_beat_age_seconds", "age", labels=("role",)
              ).labels(role="refresher").set(0.3)
    reg.counter("pio_watchdog_stalls_total", "st", labels=("role",)
                ).labels(role="refresher").inc()
    reg.gauge("pio_mem_pressure_state", "m").set(1)
    reg.counter("pio_supervisor_respawns_total", "r", labels=("child",)
                ).labels(child="replica0").inc(2)
    reg.gauge("pio_breaker_state", "b", labels=("source",)).labels(
        source="PG").set(2)
    reg.counter("pio_fsck_findings_total", "f", labels=("kind",)).labels(
        kind="torn_tail").inc()
    reg.counter("custom_total", "c").inc(3)


def _ring(mod):
    db = mod.TSDB(points=16)
    rng = np.random.default_rng(4)
    keys = ["pio_host_rss_bytes", "pio_http_requests_total{route=/q}:rate",
            "pio_http_request_duration_seconds{route=/q}:p99",
            "pio_shed_total{surface=memory}:rate",
            "pio_slo_burn_rate{window=5m}", "pio_gc_pause_seconds:p99"]
    keys += [f"pio_http_requests_total{{route=/r{n}}}:rate"
             for n in range(10)]
    for step in range(6):
        for key in keys:
            db.record_value(key, "gauge", 1000.0 + step,
                            float(rng.integers(0, 80)) / 8.0)
    return db


PANELS = ("_serving_panel", "_slo_panel", "_quality_panel", "_wire_panel",
          "_tenancy_panel", "_tier_panel", "_selfheal_panel",
          "_durability_panel")


def test_every_panel_and_the_page_equal_the_jax_ones():
    preg, jreg = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _script(preg)
    _script(jreg)
    psnap, jsnap = preg.snapshot(), jreg.snapshot()
    for name in PANELS:
        assert getattr(pdash, name)(psnap) == getattr(jdash, name)(jsnap), \
            name
        assert getattr(pdash, name)({}) == getattr(jdash, name)({}), name
    pring, jring = _ring(ptsdb), _ring(jtsdb)
    assert pdash._history_panel(pring) == jdash._history_panel(jring)
    assert pdash._history_panel(None) == jdash._history_panel(None) == ""
    assert pdash._metrics_page(preg, tsdb=pring) == \
        jdash._metrics_page(jreg, tsdb=jring)
    page = pdash._metrics_page(preg, tsdb=None)
    assert page == jdash._metrics_page(jreg, tsdb=None)
    # the p99 exemplar links into the waterfall
    assert "/traces.html?trace=trace03" in page
    assert "<svg" in pdash._history_panel(pring)


def test_serving_panel_shows_kernel_builds_where_jax_shows_compiles():
    """The one panel difference: the port has no XLA compile families;
    its kernel builds stand in their place."""
    preg, jreg = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    preg.counter("pio_kernel_builds_total", "k").inc()
    jreg.counter("pio_jax_backend_compiles_total", "k").inc()
    assert "pio_kernel_builds_total" in pdash._serving_panel(preg.snapshot())
    assert "pio_jax_backend_compiles_total" in \
        jdash._serving_panel(jreg.snapshot())
    assert "pio_jax_backend_compile" not in pdash._SERVING_PREFIXES
    assert [p for p in pdash._SERVING_PREFIXES if p != "pio_kernel_build"] \
        == [p for p in jdash._SERVING_PREFIXES
            if p != "pio_jax_backend_compile"]


class TestReactorBalance:
    @staticmethod
    def _series(value, reactor):
        return {"labels": {"listen": "127.0.0.1:1", "reactor": reactor},
                "value": value}

    def test_renders_per_reactor_share(self):
        snap = {
            "pio_wire_requests_total": {"series": [
                self._series(30.0, "0"), self._series(10.0, "1")]},
            "pio_wire_connections_accepted_total": {"series": [
                self._series(3.0, "0"), self._series(1.0, "1")]},
            "pio_wire_connections_open": {"series": [
                self._series(2.0, "0")]},
        }
        out = pdash._reactor_balance(snap)
        assert out == jdash._reactor_balance(snap)
        assert "Reactor balance" in out
        assert "75.0%" in out and "25.0%" in out
        assert out.index("<td>0</td>") < out.index("<td>1</td>")

    def test_single_reactor_renders_nothing(self):
        snap = {"pio_wire_requests_total": {"series": [
            self._series(5.0, "0")]}}
        assert pdash._reactor_balance(snap) == ""
        assert pdash._reactor_balance({}) == ""


def test_dashboard_serves_metrics_page_of_its_registry():
    from predictionio_tpu_torch.data.storage import StorageRegistry
    reg = pmetrics.MetricsRegistry()
    reg.counter("custom_total", "c").inc(3)
    reg.histogram("custom_seconds").observe(0.01)
    srv = pdash.Dashboard(pdash.DashboardConfig(ip="127.0.0.1", port=0),
                          registry=StorageRegistry(MEM), metrics=reg)
    srv.start()
    try:
        status, text, _ = call(srv.port, "GET", "/metrics", raw=True)
        assert status == 200 and "custom_total 3" in text
        status, page, headers = call(srv.port, "GET", "/metrics.html")
        assert status == 200 and "Live metrics" in page
        assert headers["Access-Control-Allow-Origin"] == "*"
        assert "custom_total" in page and "custom_seconds" in page
        assert "p99" in page
        status, page, _ = call(srv.port, "GET", "/traces.html")
        assert status == 200 and "Flight recorder" in page
    finally:
        srv.shutdown()


# -- /traces.html ------------------------------------------------------------------

def _entries():
    return [
        {"trace_id": "t1", "kind": "replica", "name": "/queries.json",
         "app": "", "status": 200, "dispatch": "fused",
         "duration_ms": 2.5, "keep": "sampled", "batch_size": 4,
         "spans": [{"name": "device_exec", "start_ms": 0.5, "dur_ms": 1.25},
                   {"name": "wire_write", "start_ms": 2.0, "dur_ms": 0.1}]},
        {"trace_id": "t1", "kind": "router", "name": "/queries.json",
         "app": "a<b>", "status": 200, "duration_ms": 4.0,
         "keep": "sampled", "spans": []},
        {"trace_id": "t2", "kind": "replica", "name": "/queries.json",
         "app": "", "status": 500, "error": "boom", "duration_ms": 0.0,
         "keep": "error", "spans": [{"name": "x", "start_ms": 0.0,
                                     "dur_ms": 0.0}]},
    ]


class _Ring:
    def __init__(self, entries):
        self.entries = entries
        self.asked = []

    def snapshot(self, **kw):
        self.asked.append(kw)
        return list(self.entries)


@pytest.mark.parametrize("query", [{}, {"app": "a", "min_ms": "1.5",
                                        "trace": "t1", "limit": "7"}])
def test_traces_page_equals_the_jax_one(monkeypatch, query):
    mine, theirs = _Ring(_entries()), _Ring(_entries())
    monkeypatch.setattr(pdash._trace, "get_recorder", lambda: mine)
    monkeypatch.setattr(jdash._trace, "get_recorder", lambda: theirs)
    page = pdash._traces_page(query.get)
    assert page == jdash._traces_page(query.get)
    assert mine.asked == theirs.asked
    assert page.count("<h3>") == 2
    assert pdash._waterfall(_entries()) == jdash._waterfall(_entries())
    empty = _Ring([])
    monkeypatch.setattr(pdash._trace, "get_recorder", lambda: empty)
    monkeypatch.setattr(jdash._trace, "get_recorder", lambda: empty)
    assert pdash._traces_page(query.get) == jdash._traces_page(query.get)


# -- the admin server --------------------------------------------------------------

def test_app_crud_over_rest():
    from predictionio_tpu_torch.data.storage import StorageRegistry
    srv = padmin.AdminServer(padmin.AdminConfig(ip="127.0.0.1", port=0),
                             StorageRegistry(MEM))
    srv.start()
    try:
        status, body, _ = call(srv.port, "GET", "/")
        assert status == 200 and body["status"] == "alive"
        status, body, _ = call(srv.port, "POST", "/cmd/app",
                               {"name": "adminapp", "description": "d"})
        assert status == 201 and body["accessKey"]
        key = body["accessKey"]
        assert call(srv.port, "POST", "/cmd/app", {"name": "adminapp"}
                    )[0] == 409
        assert call(srv.port, "POST", "/cmd/app", {})[0] == 400
        status, body, _ = call(srv.port, "GET", "/cmd/app")
        assert status == 200 and body == [{
            "name": "adminapp", "id": body[0]["id"], "description": "d",
            "accessKeys": [key]}]
        assert call(srv.port, "DELETE", "/cmd/app/adminapp/data")[0] == 200
        assert call(srv.port, "DELETE", "/cmd/app/adminapp")[0] == 200
        assert call(srv.port, "GET", "/cmd/app")[1] == []
        assert call(srv.port, "DELETE", "/cmd/app/ghost")[0] == 404
        assert call(srv.port, "DELETE", "/cmd/app/ghost/data")[0] == 404
    finally:
        srv.shutdown()


# -- `cli top` ---------------------------------------------------------------------

def _series(points):
    return {"kind": "gauge", "points": points}


TOP_TSDB = {"series": {
    "pio_http_requests_total{route=/queries.json}:rate":
        _series([[1.0, 10.0], [2.0, 12.5]]),
    "pio_http_requests_total{route=/}:rate": _series([[2.0, 0.5]]),
    "pio_http_request_duration_seconds{route=/queries.json}:p50":
        _series([[2.0, 0.0021]]),
    "pio_http_request_duration_seconds{route=/queries.json}:p99":
        _series([[2.0, 0.0187]]),
    "pio_shed_total{surface=memory}:rate": _series([[2.0, 0.25]]),
    "pio_slo_burn_rate{app=,window=5m}": _series([[2.0, 3.5]]),
    "pio_host_rss_bytes": _series([[2.0, 123456789.0]]),
    "pio_thread_beat_age_seconds{role=refresher}": _series([[2.0, 0.4]]),
    "pio_thread_beat_age_seconds{role=reactor}": _series([[2.0, 1.2]]),
    "pio_thread_degraded{role=refresher}": _series([[2.0, 0.0]]),
    "pio_watchdog_stalls_total{role=refresher}:rate": _series([[2.0, 0.1]]),
    "pio_thread_restarts_total{role=refresher}:rate": _series([[2.0, 0.1]]),
    "pio_mem_pressure_state": _series([[2.0, 1.0]]),
    "pio_autoscale_children": _series([[2.0, 3.0]]),
    "pio_autoscale_decisions_total{direction=up}:rate":
        _series([[2.0, 0.2]]),
    "pio_fleet_member_qps{member=a}": _series([[2.0, 40.0]]),
    "pio_fleet_member_qps{member=b}": _series([[2.0, 60.0]]),
    "pio_fleet_member_p99_seconds{member=a}": _series([[2.0, 0.012]]),
    "pio_empty": _series([]),
}}
TOP_PROFILE = {"samples": 420, "hz": 19.0, "running": True,
               "top_self": [{"share": 0.25, "frame": "wire.py:poll:10"},
                            {"share": 0.125, "frame": "topk.py:call:5"},
                            {"share": 0.0625, "frame": "a.py:b:1"},
                            {"share": 0.01, "frame": "c.py:d:2"}],
               "roles": {"reactor": {"share": 0.5},
                         "drainer": {"share": 0.25}}}
TOP_QUALITY = {"enabled": True,
               "apps": {"a": {"windows": {"5m": {"top1_psi": 0.031,
                                                 "margin_psi": 0.2}}}},
               "joiner": {"apps": {"a": {"reward_rate": 0.125}}},
               "canary": {"overlap": 0.875}}


@pytest.fixture()
def canned():
    """A stand-in server answering the observatory endpoints with fixed
    JSON; `docs` may be changed by a test."""
    docs = {"/tsdb.json": TOP_TSDB, "/profile.json": TOP_PROFILE,
            "/quality.json": TOP_QUALITY}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            doc = docs.get(self.path)
            body = json.dumps(doc).encode() if doc is not None else b"{}"
            self.send_response(200 if doc is not None else 404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield httpd.server_address[1], docs
    httpd.shutdown()
    httpd.server_close()


def test_top_view_equals_the_jax_one(canned):
    port, docs = canned
    view = padmin.top_view("127.0.0.1", port)
    assert view == jadmin.top_view("127.0.0.1", port)
    for want in ("qps", "drift(psi)  0.200", "reward", "canary",
                 "beats   2", "mem soft", "autoscale   3 children",
                 "roles: reactor=50%"):
        assert want in view, (want, view)
    # without the quality endpoint and the rings of the optional lines
    del docs["/quality.json"]
    docs["/tsdb.json"] = {"series": {
        k: v for k, v in TOP_TSDB["series"].items()
        if k.startswith(("pio_http", "pio_host"))}}
    view = padmin.top_view("127.0.0.1", port)
    assert view == jadmin.top_view("127.0.0.1", port)
    assert "drift" not in view and "beats" not in view


def test_top_renders_a_live_server_and_errors_on_a_dead_one():
    from predictionio_tpu_torch.obs import profiler as prof_mod
    rng = np.random.default_rng(2)
    users, items = [f"u{n}" for n in range(20)], [f"i{n}" for n in range(60)]
    model = pals.als_model_from_numpy(
        rng.integers(-3, 4, (20, 4)).astype(np.float32),
        rng.integers(-3, 4, (60, 4)).astype(np.float32), users, items,
        device="cpu")
    server = cli.deploy(model, port=0, batch_max=4,
                        metrics=pmetrics.MetricsRegistry())
    try:
        for n in range(12):
            assert call(server.port, "POST", "/queries.json",
                        {"user": users[n], "num": 3})[0] == 200
        prof_mod.get_profiler().sample_once()
        ptsdb.Scraper(server.tsdb, server.metrics, interval_s=0,
                      collectors=server._obs_collectors()).tick()
        view = padmin.top_view("127.0.0.1", server.port)
        assert f"127.0.0.1:{server.port}" in view
        assert "profiler:" in view and "rss" in view
        # the quality line reads the server's /quality.json
        assert "drift(psi)" in view
        assert padmin._quality_line("127.0.0.1", server.port) is not None
        lines = []
        assert padmin.run_top("127.0.0.1", server.port,
                              out=lines.append) == 0
        assert "pio-tpu top" in lines[0]
        assert padmin.run_top("127.0.0.1", server.port, watch_s=0.01,
                              iterations=2, out=lines.append) == 0
        assert len(lines) == 3
    finally:
        server.stop()
    assert padmin.run_top("127.0.0.1", 1, out=lines.append) == 1
    assert lines[-1].startswith("[ERROR]")
