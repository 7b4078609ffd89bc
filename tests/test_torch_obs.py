"""The port's observability (`predictionio_tpu_torch/obs/`) on the CPU:
the exposition text and the snapshot of its registry equal the JAX
registry's for one script of operations; the HTTP middleware (request
ids, structured request lines, 500s, `/metrics`) on both wires; the
serve chain's metric families after queries through the fast and the
generic route; the event server's ingest families; the train report.
Counts are exact; no test asserts a time."""

import json
import logging
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.obs import metrics as jmetrics
from predictionio_tpu.obs import report as jreport
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.obs import (MetricsRegistry, get_logger,
                                        record_train_phases, train_report)
from predictionio_tpu_torch.obs import metrics as pmetrics
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.utils.http import HTTPServerBase, Response

pytestmark = pytest.mark.torch

USERS = [f"u{n}" for n in range(40)]
ITEMS = [f"i{n}" for n in range(300)]


def _script(reg):
    """One script of registry operations, run on either package's."""
    c = reg.counter("req_total", "requests", labels=("route", "status"))
    c.labels(route="/a", status="200").inc(2)
    c.labels(route="/b", status="503").inc()
    c.labels(route='a"b\\c\nd', status="x").inc(0.5)
    reg.counter("plain_total", "no labels").inc(3)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2.5)
    reg.gauge("by_dev", "bytes", labels=("device",)).labels(
        device="cuda:0").set(1e16)
    h = reg.histogram("lat_seconds", "latency", labels=("stage",),
                      buckets=[0.001, 0.01, 1.0])
    for v in (0.0005, 0.002, 0.5, 3.0, 0.01):
        h.labels(stage="predict").observe(v)
    h.labels(stage="serve").observe(0.2)
    d = reg.histogram("default_buckets", "defaults")
    for v in np.linspace(0.0, 2.0, 17):
        d.observe(float(v))
    assert reg.counter("req_total", labels=("route", "status")) is c
    return reg


def test_exposition_and_snapshot_equal_the_jax_registry():
    p = _script(pmetrics.MetricsRegistry())
    j = _script(jmetrics.MetricsRegistry())
    assert p.render() == j.render()
    assert p.snapshot() == j.snapshot()
    assert p.value("req_total", route="/a", status="200") == 2.0
    assert p.value("missing") == 0.0
    with pytest.raises(ValueError):
        p.gauge("req_total")


def test_train_report_equals_the_jax_report():
    timings = {"read_s": 1.5, "pack_s": 0.25, "solve_s": 2.0}
    p, j = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    record_train_phases(timings, p)
    jreport.record_train_phases(timings, j)
    assert train_report(p) == jreport.train_report(j)
    assert p.render() == j.render()
    assert "(no training phases recorded)" in train_report(
        pmetrics.MetricsRegistry())


def _get(port, path, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), resp.read().decode()


def _post(port, path, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def parse_metrics(text):
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            series[key] = float(value)
    return series


@pytest.fixture(params=["selector", "threaded"])
def bare_server(request):
    srv = HTTPServerBase(host="127.0.0.1", metrics=MetricsRegistry(),
                         wire=request.param)

    @srv.router.get("/ping")
    def ping(req):
        return Response.json({"ok": True})

    @srv.router.get("/boom")
    def boom(req):
        raise RuntimeError("kapow")

    srv.start()
    assert srv.wire == request.param
    yield srv
    srv.shutdown()


def test_request_id_echoed_and_generated(bare_server):
    _, headers, _ = _get(bare_server.port, "/ping",
                         {"X-Request-ID": "client-rid-1"})
    assert headers["X-Request-ID"] == "client-rid-1"
    _, headers, _ = _get(bare_server.port, "/ping")
    rid = headers["X-Request-ID"]
    assert len(rid) == 16 and all(c in "0123456789abcdef" for c in rid)


def test_structured_request_log(bare_server, caplog):
    with caplog.at_level(logging.INFO, logger="pio.torch.obs"):
        _get(bare_server.port, "/ping", {"X-Request-ID": "ridlog1"})
    recs = [json.loads(r.getMessage()) for r in caplog.records]
    line = [r for r in recs if r.get("event") == "request"
            and r.get("request_id") == "ridlog1"][0]
    assert (line["method"], line["path"], line["route"], line["status"],
            line["level"]) == ("GET", "/ping", "/ping", 200, "info")
    assert line["duration_ms"] >= 0.0 and "ts" in line


def test_500_carries_request_id_and_traceback(bare_server, caplog):
    with caplog.at_level(logging.INFO, logger="pio.torch.obs"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(bare_server.port, "/boom", {"X-Request-ID": "boomrid1"})
    assert ei.value.code == 500
    assert ei.value.headers["X-Request-ID"] == "boomrid1"
    recs = [json.loads(r.getMessage()) for r in caplog.records]
    err = [r for r in recs if r.get("event") == "unhandled_error"][0]
    assert err["request_id"] == "boomrid1"
    assert "RuntimeError: kapow" in err["traceback"]


def test_metrics_endpoint_counts_requests(bare_server):
    for _ in range(3):
        _get(bare_server.port, "/ping")
    with pytest.raises(urllib.error.HTTPError):
        _get(bare_server.port, "/nope")
    status, headers, text = _get(bare_server.port, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith(
        "text/plain")
    series = parse_metrics(text)
    assert series['pio_http_requests_total{route="/ping",method="GET",'
                  'status="200"}'] == 3
    assert series['pio_http_requests_total{route="(unmatched)",'
                  'method="GET",status="404"}'] == 1
    assert series['pio_http_request_duration_seconds_count'
                  '{route="/ping"}'] == 3
    if bare_server.wire == "selector":   # summed over the reactors
        listen = f'pio_wire_requests_total{{listen="127.0.0.1:' \
            f'{bare_server.port}",'
        assert sum(v for k, v in series.items()
                   if k.startswith(listen)) >= 5


def test_structured_logger_lines_are_json(caplog):
    log = get_logger("obs-test")
    with caplog.at_level(logging.INFO, logger="pio.torch.obs"):
        log.info("evt", a=1, b="x")
        try:
            raise ValueError("bad")
        except ValueError:
            log.exception("failed", request_id="r")
    recs = [json.loads(r.getMessage()) for r in caplog.records]
    assert recs[0]["event"] == "evt" and recs[0]["a"] == 1
    assert recs[1]["level"] == "error" and "ValueError: bad" in \
        recs[1]["traceback"]


@pytest.fixture(scope="module")
def served():
    rng = np.random.default_rng(5)
    model = pals.als_model_from_numpy(
        rng.integers(-4, 5, (40, 16)).astype(np.float32),
        rng.integers(-4, 5, (300, 16)).astype(np.float32), USERS, ITEMS,
        device="cpu")
    server = cli.deploy(model, port=0, batch_max=8, window_s=0.02,
                        metrics=MetricsRegistry())
    yield server
    server.stop()


def test_serve_chain_metrics_after_queries(served):
    before = parse_metrics(_get(served.port, "/metrics")[2])
    queries = ([{"user": "u1", "num": 3}] * 3
               + [{"user": "u2", "num": 2, "blackList": ["i1"]}])
    barrier = threading.Barrier(len(queries))
    out = []

    def one(q):
        barrier.wait(timeout=30)
        out.append(_post(served.port, "/queries.json", q)[0])

    threads = [threading.Thread(target=one, args=(q,)) for q in queries]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert out == [200] * 4
    series = parse_metrics(_get(served.port, "/metrics")[2])

    def grew(key):
        return series.get(key, 0.0) - before.get(key, 0.0)

    assert grew('pio_http_requests_total{route="/queries.json",'
                'method="POST",status="200"}') == 4
    assert grew('pio_http_request_duration_seconds_count'
                '{route="/queries.json"}') == 4
    assert grew('pio_serve_stage_seconds_count{stage="extract"}') == 1
    for stage in ("supplement", "predict", "serve"):
        assert grew(f'pio_serve_stage_seconds_count{{stage="{stage}"}}') \
            >= 1
    assert grew('pio_serve_algo_predict_seconds_count'
                '{algo="0:ALSAlgorithm"}') >= 1
    assert grew("pio_serve_batch_size_sum") == 4
    assert series["pio_serve_batch_queue_depth"] == 0
    assert grew("pio_queue_delay_seconds_count") == 4


def test_event_server_ingest_metrics(tmp_path):
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                     StorageRegistry)
    reg = StorageRegistry({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(App(0, "obsapp"))
    reg.get_events().init(app)
    key = reg.get_meta_data_access_keys().insert(AccessKey("", app, ()))
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0), reg,
                      metrics=MetricsRegistry())
    srv.start()
    try:
        ev = {"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1",
              "properties": {"rating": 4}}
        assert _post(srv.port, f"/events.json?accessKey={key}", ev)[0] \
            == 201
        assert _post(srv.port, f"/batch/events.json?accessKey={key}",
                     [ev, ev])[0] == 200
        series = parse_metrics(_get(srv.port, "/metrics")[2])
    finally:
        srv.shutdown()
    assert series['pio_events_ingested_total{via="single"}'] == 1
    assert series['pio_events_ingested_total{via="batch"}'] == 2
    assert series["pio_ingest_payload_bytes_count"] == 2
    assert series['pio_http_requests_total{route="/events.json",'
                  'method="POST",status="201"}'] == 1
