"""The port's prediction server (`predictionio_tpu_torch/serving/
server.py`) on the CPU: concurrent `POST /queries.json` requests are
coalesced by the micro-batcher and each answer equals the JAX package's
`batch_predict` for the same query on the same (integer-valued, so
bit-exact) model; `GET /` reports status and the kernel launch count."""

import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.serving import server as srv

pytestmark = pytest.mark.torch

N_USERS, N_ITEMS, RANK = 40, 300, 16
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _factors():
    rng = np.random.default_rng(5)
    return (rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
            rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32))


def _queries():
    rng = np.random.default_rng(6)
    out = []
    for n in range(32):
        q = {"user": USERS[n % N_USERS], "num": int(1 + n % 10)}
        if n % 3 == 0:
            q["blackList"] = [ITEMS[j] for j in
                              rng.choice(N_ITEMS, 20, replace=False)]
        if n == 7:
            q["user"] = "ghost"
        out.append(q)
    return out


@pytest.fixture(scope="module")
def served():
    x, y = _factors()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=64, window_s=0.02)
    yield server
    server.stop()


def _post(port, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _reference(queries):
    x, y = _factors()
    model = jals.ALSModel(x, y, BiMap.from_keys(USERS),
                          BiMap.from_keys(ITEMS))
    algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
    algo.warm_serving(model, [1, 2, 4, 8, 16, 32, 64])
    out = []
    for q in queries:
        (_, pred), = algo.batch_predict(model, [(0, jrec.Query(**q))])
        out.append({"itemScores": [{"item": s.item, "score": s.score}
                                   for s in pred.itemScores]})
    return out


def test_concurrent_queries_match_jax(served):
    queries = _queries()
    before = served.batcher.batch_sizes()
    barrier = threading.Barrier(len(queries))

    def fire(q):
        barrier.wait(timeout=30)
        return _post(served.port, q)

    with ThreadPoolExecutor(len(queries)) as pool:
        answers = list(pool.map(fire, queries))
    assert all(status == 200 for status, _ in answers)
    assert [body for _, body in answers] == _reference(queries)
    after = served.batcher.batch_sizes()
    grew = {n: after.get(n, 0) - before.get(n, 0) for n in after}
    assert sum(n * c for n, c in grew.items()) == len(queries)
    assert any(n > 1 and c > 0 for n, c in grew.items())


def test_status_reports_launches_and_batches(served):
    _post(served.port, {"user": "u1", "num": 3})
    with urllib.request.urlopen(
            f"http://127.0.0.1:{served.port}/", timeout=30) as resp:
        status = json.loads(resp.read())
    assert status["status"] == "alive"
    assert status["devices"] == ["cpu"]
    assert status["kernel_launches"]["fused_topk"] >= 0
    assert status["requests"] >= 1 and status["batch_sizes"]


@pytest.mark.parametrize("body,code", [
    ({"num": 3}, 400),                      # user missing
    ({"user": "u1", "bogus": 1}, 400),      # unknown field
    ({"user": "u1", "num": "x"}, 400),
])
def test_bad_queries_are_400(served, body, code):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(served.port, body)
    assert err.value.code == code


def test_unknown_route_is_404(served):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{served.port}/nope",
                               timeout=30)
    assert err.value.code == 404


class _SlowDep:
    query_class = None

    def __init__(self, release: threading.Event):
        self.release = release

    def predict_batch(self, queries):
        self.release.wait(timeout=30)
        return [q * 2 for q in queries]


def test_batcher_times_out_a_stuck_drain():
    release = threading.Event()
    batcher = srv._MicroBatcher(0.001, batch_max=2, submit_timeout_s=0.2)
    with pytest.raises(srv.DeadlineExceeded):
        batcher.submit(_SlowDep(release), 1)
    release.set()
    assert batcher.close(timeout=30)


def test_batcher_bounds_its_queue():
    release = threading.Event()
    dep = _SlowDep(release)
    batcher = srv._MicroBatcher(0.001, batch_max=1, queue_max=1)
    results = []
    held = [threading.Thread(target=lambda q=q: results.append(
        batcher.submit(dep, q))) for q in (1, 2)]
    held[0].start()
    time.sleep(0.1)                        # the drainer now holds query 1
    held[1].start()
    time.sleep(0.1)                        # query 2 fills the queue
    with pytest.raises(srv.OverloadedError):
        batcher.submit(dep, 3)
    release.set()
    for th in held:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in held)
    assert sorted(results) == [2, 4]
    assert batcher.batch_sizes() == {1: 2}
    assert batcher.close(timeout=30)


def test_cli_deploy_serves_an_npz(tmp_path):
    """`python -m predictionio_tpu_torch.cli deploy` end to end: loads an
    `.npz`, warms, serves /queries.json, and exits 0 on SIGTERM."""
    import signal
    import subprocess
    import sys
    from pathlib import Path

    x, y = _factors()
    path = tmp_path / "model.npz"
    pals.als_model_from_numpy(x, y, USERS, ITEMS,
                              device="cpu").save_npz(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--model", str(path), "--port", "0", "--device", "cpu",
         "--batch-max", "8"],
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving "), proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        q = {"user": "u3", "num": 5, "blackList": ["i1", "i2"]}
        status, body = _post(port, q)
        assert status == 200 and body == _reference([q])[0]
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0


# -- the serve plane: wire, routes, parity with the JAX server --------------

import base64  # noqa: E402
import http.client  # noqa: E402

from predictionio_tpu.utils.wire import encode_bin_query  # noqa: E402
from predictionio_tpu_torch.core.runtime import RuntimeContext  # noqa: E402
from predictionio_tpu_torch.core.workflow import CoreWorkflow  # noqa: E402
from predictionio_tpu_torch.data.event import (  # noqa: E402
    DataMap, Event, utcnow)
from predictionio_tpu_torch.data.storage import (  # noqa: E402
    AccessKey, App, StorageRegistry)
from predictionio_tpu_torch.models import recommendation as prec  # noqa
from predictionio_tpu_torch.obs import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.resilience import faults  # noqa: E402
from predictionio_tpu_torch.serving.plugins import (  # noqa: E402
    OUTPUT_BLOCKER, OUTPUT_SNIFFER, EngineServerPlugin)


def _call(port, method, path, body=None, headers=None, raw=None,
          timeout=30):
    """(status, headers, parsed body) over a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        text = resp.read()
        return resp.status, dict(resp.headers), (
            json.loads(text) if text else None)
    finally:
        conn.close()


def _bin(port, user, num, headers=None):
    return _call(port, "POST", "/queries.json",
                 raw=encode_bin_query(user, num),
                 headers={"Content-Type": "application/x-pio-bin",
                          **(headers or {})})


def _parity_queries():
    rng = np.random.default_rng(11)
    out = []
    for n in range(24):
        q = {"user": USERS[n % N_USERS], "num": int(1 + n % 10)}
        if n % 3 == 1:
            q["blackList"] = [ITEMS[j] for j in
                              rng.choice(N_ITEMS, 12, replace=False)]
        out.append(q)
    out.append({"user": "ghost", "num": 3})
    return out


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's PredictionServer over the same integer-valued
    factors: an instance whose train returns them, in a MEM store."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import EngineParams as JParams
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.event import DataMap as JMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import App as JApp
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.serving import PredictionServer as JServer
    from predictionio_tpu.serving import ServerConfig

    reg = JReg({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(JApp(0, "parity"))
    reg.get_events().init(app)
    for u in range(3):
        reg.get_events().insert(JEvent(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{u}",
            properties=JMap({"rating": 4.0})), app)
    x, y = _factors()
    jmodel = jals.ALSModel(x, y, BiMap.from_keys(USERS),
                           BiMap.from_keys(ITEMS))
    train = jrec.ALSAlgorithm.train
    jrec.ALSAlgorithm.train = lambda self, ctx, pd: jmodel
    try:
        JWorkflow.run_train(jrec.engine(), JParams(
            data_source_params=("", jrec.DataSourceParams(
                app_name="parity")),
            algorithm_params_list=(("als", jrec.ALSAlgorithmParams()),)),
            JCtx(registry=reg))
    finally:
        jrec.ALSAlgorithm.train = train
    srv = JServer(ServerConfig(ip="127.0.0.1", port=0, batch_window_ms=2),
                  registry=reg, engine=jrec.engine(),
                  metrics=JMetrics())
    srv.start()
    yield srv
    srv.shutdown()


def _scores32(body):
    return [(s["item"], np.float32(s["score"]))
            for s in body["itemScores"]]


def test_answers_equal_the_jax_server_on_every_route(served, jax_server):
    """Fast route, generic route (bans) and binary frames: the same
    items and the same float32 scores as the JAX server's; the port's
    fast-route bytes parse to exactly what its generic route serves."""
    for q in _parity_queries():
        mine = _call(served.port, "POST", "/queries.json", q)
        theirs = _call(jax_server.port, "POST", "/queries.json", q)
        assert mine[0] == theirs[0] == 200, (mine, theirs)
        assert _scores32(mine[2]) == _scores32(theirs[2]), q
        if "blackList" not in q:
            mb, jb = _bin(served.port, q["user"], q["num"]), \
                _bin(jax_server.port, q["user"], q["num"])
            assert mb[0] == jb[0] == 200
            assert _scores32(mb[2]) == _scores32(jb[2])
            assert mb[2] == mine[2]
            # the generic route's answer for the same query, bit for bit
            padded = dict(q, blackList=[])
            assert _call(served.port, "POST", "/queries.json",
                         padded)[2] == mine[2]
    assert _call(served.port, "POST", "/queries.json",
                 raw=b"\x82\xa4user\xff",
                 headers={"Content-Type": "application/x-pio-bin"})[0] \
        == 400


def test_status_json_has_the_jax_keys(served, jax_server):
    mine = _call(served.port, "GET", "/status.json")[2]
    theirs = _call(jax_server.port, "GET", "/status.json")[2]
    assert set(theirs) <= set(mine)
    assert mine["status"] == "alive" and mine["engineVariant"] == "default"
    assert isinstance(mine["startTime"], str)
    assert mine["requestCount"] >= 0
    assert "kernel_launches" in mine and "plan_calls" in mine
    assert mine["wire"] in ("selector", "threaded")


def _rated_registry():
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(App(0, "servapp"))
    reg.get_meta_data_access_keys().insert(AccessKey("SKEY", app, ()))
    events = reg.get_events()
    events.init(app)
    rng = np.random.RandomState(0)
    for u in range(20):
        for i in range(15):
            if rng.rand() > 0.5:
                continue
            events.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": 5.0 if i % 3 == u % 3
                                    else 1.0})), app)
    return reg


def _train(reg, seed):
    engine = prec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "servapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 2, "seed": seed}}]})
    ctx = RuntimeContext(registry=reg, device="cpu")
    return engine, CoreWorkflow.run_train(engine, params, ctx), ctx


@pytest.fixture()
def instance_server():
    reg = _rated_registry()
    engine, row, ctx = _train(reg, 1)
    servers = []

    def start(**kw):
        srv = cli.deploy_instance(engine, row, ctx, port=0, batch_max=8,
                                  metrics=MetricsRegistry(), **kw)
        servers.append(srv)
        return srv

    yield reg, row, start
    for srv in servers:
        srv.stop()
    faults().clear()


def test_reload_picks_the_latest_instance_and_rolls_back(instance_server):
    reg, row1, start = instance_server
    srv = start()
    assert _call(srv.port, "GET", "/status.json")[2][
        "engineInstanceId"] == row1.id
    _, row2, _ = _train(reg, 2)
    code, _, body = _call(srv.port, "POST", "/reload")
    assert (code, body) == (200, {"message": "Reloaded"})
    assert _call(srv.port, "GET", "/status.json")[2][
        "engineInstanceId"] == row2.id
    # a COMPLETED instance whose blob is gone: 500, the old one serves
    instances = reg.get_meta_data_engine_instances()
    ghost = instances.insert(instances.get(row2.id).with_(
        id="", start_time=utcnow()))
    assert instances.get_latest_completed(
        "default", "default", "default").id == ghost
    code, _, body = _call(srv.port, "POST", "/reload")
    assert code == 500 and "previous deployment still serving" in \
        body["message"]
    assert _call(srv.port, "GET", "/status.json")[2][
        "engineInstanceId"] == row2.id
    assert _call(srv.port, "POST", "/queries.json",
                 {"user": "u1", "num": 3})[0] == 200
    # a fault at the load seam rolls back the same way
    instances.delete(ghost)
    faults().arm("deploy.prepare", error=RuntimeError, times=1)
    assert _call(srv.port, "POST", "/reload")[0] == 500
    assert _call(srv.port, "POST", "/reload")[0] == 200
    series = srv.metrics.render()
    assert 'pio_reload_total{outcome="failed"} 2' in series
    assert 'pio_reload_total{outcome="ok"} 3' in series


def test_stop_drains_accepted_requests(instance_server):
    _, _, start = instance_server
    srv = start()
    faults().arm("serve.predict", latency=0.3, times=1)
    out = []
    threads = [threading.Thread(target=lambda: out.append(_call(
        srv.port, "POST", "/queries.json", {"user": "u1", "num": 2})[0]))
        for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)                  # the four are queued or in a batch
    assert _call(srv.port, "POST", "/stop")[0] == 200
    for t in threads:
        t.join(timeout=30)
    assert out == [200] * 4
    assert srv.stopped.wait(30)
    assert not srv.is_running()


def test_the_server_key_guards_reload_and_stop(instance_server):
    _, _, start = instance_server
    srv = start(server_key="sekrit")
    basic = {"Authorization": "Basic " + base64.b64encode(
        b"sekrit:").decode()}
    assert _call(srv.port, "POST", "/queries.json",
                 {"user": "u1", "num": 2})[0] == 200
    assert _call(srv.port, "POST", "/reload")[0] == 401
    assert _call(srv.port, "POST", "/reload?accessKey=wrong")[0] == 401
    assert _call(srv.port, "POST", "/reload", headers=basic)[0] == 200
    assert _call(srv.port, "POST", "/stop")[0] == 401
    assert _call(srv.port, "POST", "/stop?accessKey=sekrit")[0] == 200
    assert srv.stopped.wait(30)


class _Rewrite(EngineServerPlugin):
    plugin_name = "rewriter"
    plugin_type = OUTPUT_BLOCKER

    def process(self, info, context):
        return {"rewritten": True, "orig": srv.to_jsonable(info.prediction)}

    def handle_rest(self, args):
        return {"args": list(args)}


class _Sniff(EngineServerPlugin):
    plugin_name = "sniffer"
    plugin_type = OUTPUT_SNIFFER

    def __init__(self):
        self.seen = []
        self.got = threading.Event()

    def process(self, info, context):
        self.seen.append((info.query.user, info.engine_variant))
        self.got.set()


def test_blocker_and_sniffer_plugins(instance_server):
    _, _, start = instance_server
    sniff = _Sniff()
    server = start(plugins=[_Rewrite(), sniff])
    code, _, body = _call(server.port, "POST", "/queries.json",
                          {"user": "u1", "num": 2})
    assert code == 200 and body["rewritten"] is True
    assert len(body["orig"]["itemScores"]) == 2
    assert sniff.got.wait(10) and sniff.seen == [("u1", "default")]
    plugins = _call(server.port, "GET", "/plugins.json")[2]["plugins"]
    assert "rewriter" in plugins["outputblockers"]
    assert "sniffer" in plugins["outputsniffers"]
    assert _call(server.port, "GET", "/plugins/rewriter/a/b")[2] == {
        "args": ["a", "b"]}
    assert _call(server.port, "GET", "/plugins/nope")[0] == 404


def _metric(server, prefix, suffix=""):
    return sum(float(value)
               for key, _, value in (
                   line.rpartition(" ") for line in
                   server.metrics.render().splitlines())
               if key.startswith(prefix) and key.endswith(suffix))


@pytest.mark.parametrize("wire", ["selector", "threaded"])
def test_max_inflight_sheds_503_and_deadlines_answer_504(instance_server,
                                                         wire):
    _, _, start = instance_server
    server = start(max_inflight=2, wire=wire)
    assert server.wire == wire
    faults().arm("serve.predict", latency=0.4)
    try:
        barrier = threading.Barrier(8)
        out = []

        def one(i):
            barrier.wait(timeout=30)
            out.append(_call(server.port, "POST", "/queries.json",
                             {"user": f"u{i}", "num": 2}))

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        codes = sorted(c for c, _, _ in out)
        assert 200 in codes and 503 in codes and set(codes) <= {200, 503}
        for code, headers, body in out:
            if code == 503:
                assert int(headers["Retry-After"]) >= 1
            else:
                assert len(body["itemScores"]) == 2
        n503 = codes.count(503)
        # a budget the queue cannot meet: 504, counted
        code, _, body = _call(server.port, "POST", "/queries.json",
                              {"user": "u1", "num": 2},
                              headers={"X-PIO-Deadline-Ms": "50"})
        assert code == 504
        assert _call(server.port, "POST", "/queries.json",
                     {"user": "u1", "num": 2},
                     headers={"X-PIO-Deadline-Ms": "-1"})[0] == 400
    finally:
        faults().clear()
    # a shed before routing counts under route "(unmatched)", as in the
    # JAX middleware; the fast route knows its route
    req = "pio_http_requests_total{"
    assert _metric(server, req, 'status="503"}') == n503
    assert _metric(server, req, 'status="504"}') == 1
    assert _metric(server, req + 'route="/queries.json"',
                   'status="200"}') == 8 - n503
    assert _metric(server, 'pio_shed_total{surface="PredictionServer"') \
        == n503
    assert _metric(server, 'pio_deadline_expired_total') == 1


def test_tls_config_and_the_threaded_wire_under_tls():
    import ssl

    from predictionio_tpu_torch.utils.http import HTTPServerBase
    from predictionio_tpu_torch.utils.security import ssl_context_from_config
    assert ssl_context_from_config({}) is None
    with pytest.raises(ValueError):
        ssl_context_from_config({"PIO_SERVER_SSL_ENFORCED": "true"})
    base = HTTPServerBase(host="127.0.0.1", wire="selector",
                          ssl_context=ssl.SSLContext(
                              ssl.PROTOCOL_TLS_SERVER),
                          metrics=MetricsRegistry())
    base.start()
    try:
        assert base.wire == "threaded"     # the selector loop has no TLS
    finally:
        base.shutdown()
