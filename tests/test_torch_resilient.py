"""The port's storage resilience: `CircuitBreaker`, `RetryBudget` and
`ResilientDAO` driven through the same fault sequences as the JAX
package's (the states, the calls that reach the DAO, the retries and
the budget's draws equal), the registry's wrapping (one breaker and one
budget per source, REPLICATED and `RESILIENCE=off` bare), and the HTTP
planes: an open breaker answers 503 with `Retry-After` on the event
server and on both prediction-server routes, and `/ready` is false and
names the source; the port's event server over a crashed Postgres comes
back once it restarts."""

import json
import signal
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.eventserver import (EventServer as JEventServer,
                                               EventServerConfig as JConfig)
from predictionio_tpu.data.storage import AccessKey as JAccessKey
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import registry as jreg
from predictionio_tpu.data.storage.resilient import ResilientDAO as JDAO
from predictionio_tpu.obs import MetricsRegistry as JMetrics
from predictionio_tpu.resilience import CircuitBreaker as JBreaker
from predictionio_tpu.resilience import CircuitOpenError as JOpen
from predictionio_tpu.resilience import RetryBudget as JBudget
from predictionio_tpu.resilience import RetryPolicy as JPolicy
from predictionio_tpu.resilience import faults as jfaults
from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                     EventServerConfig)
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageUnavailableError,
                                                 StorageWriteError)
from predictionio_tpu_torch.data.storage import registry as preg
from predictionio_tpu_torch.data.storage.base import \
    TRANSIENT_STORAGE_ERRORS
from predictionio_tpu_torch.data.storage.resilient import ResilientDAO
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.resilience import (CircuitBreaker,
                                               CircuitOpenError, RetryBudget,
                                               RetryPolicy, faults)
from tests.fakepg import FakePgServer

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError("test exceeded its 60-s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    faults().clear()
    jfaults().clear()


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(seed: int, n: int):
    """A seeded sequence of (outcome, seconds the clock moves)."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["ok", "transient", "client"], n, p=[.35, .5, .15])
    return [(str(k), float(rng.choice([0.0, 0.5, 3.0])))
            for k in kinds]


@pytest.mark.parametrize("seed", range(4))
def test_breaker_walks_the_jax_states(seed):
    runs = []
    for breaker_cls, open_err in ((JBreaker, JOpen),
                                  (CircuitBreaker, CircuitOpenError)):
        clock = Clock()
        metrics = JMetrics() if breaker_cls is JBreaker else \
            MetricsRegistry()
        b = breaker_cls("s", failure_threshold=3, recovery_time=2.0,
                        clock=clock, metrics=metrics)
        trace = []
        for kind, dt in _script(seed, 60):
            clock.t += dt
            before = b.state

            def fn():
                if kind == "transient":
                    raise OSError("down")
                if kind == "client":
                    raise StorageWriteError("dup")
                return "ok"
            try:
                got = b.call(fn, failure_types=(OSError,))
            except open_err as e:
                got = f"open {e.retry_after:.3f}"
            except (OSError, StorageWriteError) as e:
                got = type(e).__name__
            trace.append((before, got, b.state))
        runs.append(trace)
    assert runs[0] == runs[1]
    assert {s for s, _, _ in runs[1]} == {"closed", "open", "half-open"}


def test_budget_draws_equal_the_jax_budget(monkeypatch):
    import time as _time
    t = [1000.0]
    monkeypatch.setattr(_time, "monotonic", lambda: t[0])
    draws = []
    for cls in (JBudget, RetryBudget):
        t[0] = 1000.0
        b = cls(capacity=4.0, refill_per_s=0.5)
        seq = []
        for step in range(30):
            t[0] += 0.7 if step % 4 == 0 else 0.0
            seq.append((b.try_acquire(), round(b.remaining(), 6)))
        draws.append(seq)
    assert draws[0] == draws[1]
    with pytest.raises(ValueError):
        RetryBudget(capacity=0)


class FlakyDAO:
    """`get` fails per a script: 'T' transient, 'C' client error, else
    it answers."""

    def __init__(self, script, error):
        self.script = list(script)
        self.calls = 0
        self.error = error
        self.c = "client"

    def get(self, key):
        self.calls += 1
        step = self.script.pop(0) if self.script else "."
        if step == "T":
            raise self.error("unavailable")
        if step == "C":
            raise StorageWriteError("constraint")
        return key


@pytest.mark.parametrize("script", ["TT.", "TTT", "TTTTTT...", "C.TT.",
                                    "TTTTTTTTTTTTT..", "T.T.T.TTT"])
def test_resilient_dao_matches_the_jax_proxy(script):
    from predictionio_tpu.data.storage.base import \
        StorageUnavailableError as JUnavailable
    outcomes = []
    for dao_cls, breaker_cls, budget_cls, policy_cls, metrics_cls, err, \
            open_err in (
            (JDAO, JBreaker, JBudget, JPolicy, JMetrics, JUnavailable,
             JOpen),
            (ResilientDAO, CircuitBreaker, RetryBudget, RetryPolicy,
             MetricsRegistry, StorageUnavailableError, CircuitOpenError)):
        metrics = metrics_cls()
        from predictionio_tpu.data.storage.base import \
            TRANSIENT_STORAGE_ERRORS as JT
        transient = JT if dao_cls is JDAO else TRANSIENT_STORAGE_ERRORS
        raw = FlakyDAO(script, err)
        dao = dao_cls(raw, seam="storage.S.X", source="S",
                      breaker=breaker_cls("storage.S", failure_threshold=2,
                                          recovery_time=60.0,
                                          metrics=metrics),
                      policy=policy_cls(attempts=3, base_delay=1e-5,
                                        retryable=transient),
                      metrics=metrics, budget=budget_cls(capacity=5.0,
                                                         refill_per_s=1e-9))
        seen = []
        for n in range(5):
            try:
                seen.append(dao.get(n))
            except open_err:
                seen.append("open")
            except (err, StorageWriteError) as e:
                seen.append(type(e).__name__)
        text = metrics.render()
        counts = {line.split(" ")[0]: float(line.split(" ")[1])
                  for line in text.splitlines()
                  if line.startswith(("pio_storage_retries_total",
                                      "pio_retry_budget_exhausted_total"))}
        outcomes.append((seen, raw.calls, counts, dao.c))
    assert outcomes[0] == outcomes[1]


def test_the_registry_wraps_each_source(tmp_path):
    cfg = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
           "PIO_STORAGE_SOURCES_DB_BREAKER_THRESHOLD": "2",
           "PIO_STORAGE_SOURCES_DB_RETRY_BUDGET": "off",
           "PIO_STORAGE_SOURCES_DB_RETRY_ATTEMPTS": "4",
           "PIO_STORAGE_SOURCES_DB_RETRY_BASE_DELAY": "0.0001",
           "PIO_STORAGE_SOURCES_FS1_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS1_PATH": str(tmp_path / "a"),
           "PIO_STORAGE_SOURCES_FS2_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS2_PATH": str(tmp_path / "b"),
           "PIO_STORAGE_SOURCES_FS2_RESILIENCE": "off",
           "PIO_STORAGE_SOURCES_REP_TYPE": "REPLICATED",
           "PIO_STORAGE_SOURCES_REP_REPLICAS": "FS1,FS2",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "REP"}
    reg = preg.StorageRegistry(cfg)
    apps, events = reg.get_meta_data_apps(), reg.get_events()
    assert isinstance(apps, ResilientDAO) and isinstance(events,
                                                         ResilientDAO)
    models = reg.get_model_data_models()
    assert not isinstance(models, ResilientDAO)
    models.insert(__import__(
        "predictionio_tpu_torch.data.storage", fromlist=["Model"]).Model(
            "m", b"x"))
    models._drain()
    assert isinstance(reg.get_data_object("FS1", "Models"), ResilientDAO)
    assert not isinstance(reg.get_data_object("FS2", "Models"),
                          ResilientDAO)
    assert reg.breaker_states() == {"DB": "closed", "FS1": "closed"}
    assert reg._budgets["DB"] is None and reg._budgets["FS1"] is not None
    # RETRY_ATTEMPTS tries per call; one breaker per source: the apps'
    # failures open the events' too
    rule = faults().arm("storage.DB.Apps.get", error=OSError)
    for _ in range(2):
        with pytest.raises(OSError):
            apps.get(1)
    assert rule.hits == 2 * 4
    assert reg.breaker_states()["DB"] == "open"
    with pytest.raises(CircuitOpenError):
        list(events.find(1))
    reg.close()


# -- HTTP planes ---------------------------------------------------------------------

MEM = {"PIO_STORAGE_SOURCES_M_TYPE": "MEM",
       "PIO_STORAGE_SOURCES_M_BREAKER_THRESHOLD": "2",
       "PIO_STORAGE_SOURCES_M_BREAKER_RECOVERY_S": "30",
       "PIO_STORAGE_SOURCES_M_RETRY_BASE_DELAY": "0.0001"}
EV = {"event": "rate", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1",
      "properties": {"rating": 4}}


def _call(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Retry-After"), \
                json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After"), json.loads(e.read())


def _event_server(mod_reg, app_cls, key_cls, server_cls, config_cls):
    reg = mod_reg.StorageRegistry(dict(MEM))
    aid = reg.get_meta_data_apps().insert(app_cls(0, "a"))
    key = reg.get_meta_data_access_keys().insert(key_cls("k", aid, ()))
    server = server_cls(config_cls(ip="127.0.0.1", port=0), reg)
    return server, server.start(), key


def test_event_servers_shed_503_under_an_open_breaker():
    runs = []
    for mod_reg, app_cls, key_cls, server_cls, config_cls, fs in (
            (jreg, JApp, JAccessKey, JEventServer, JConfig, jfaults),
            (preg, App, AccessKey, EventServer, EventServerConfig, faults)):
        server, port, key = _event_server(mod_reg, app_cls, key_cls,
                                          server_cls, config_cls)
        try:
            assert _call(port, "POST", f"/events.json?accessKey={key}",
                         EV)[0] == 201
            fs().arm("storage.M.AccessKeys.get", error=OSError)
            got = [_call(port, "POST", f"/events.json?accessKey={key}", EV)
                   for _ in range(3)]
            ready = _call(port, "GET", "/ready")
            runs.append(([(s, ra is not None) for s, ra, _ in got],
                         ready[0], ready[2]))
            fs().clear()
        finally:
            server.shutdown()
    assert runs[0] == runs[1]
    assert runs[1][0] == [(500, False), (500, False), (503, True)]
    assert runs[1][1] == 503 and runs[1][2]["storageBreakers"] == {
        "M": "open"}


def _restartable(port=0, db=None):
    class Pg(FakePgServer):
        def __init__(self):
            self.sessions = []
            super().__init__()
            if db is not None:
                self._db.close()
                self._db = db

        def server_bind(self):
            self.server_address = ("127.0.0.1", port)
            super().server_bind()

        def get_request(self):
            sock, addr = super().get_request()
            self.sessions.append(sock)
            return sock, addr

        def crash(self):
            self.shutdown()
            self.server_close()
            for s in self.sessions:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
    return Pg()


def test_event_server_over_a_crashed_postgres_recovers():
    pg = _restartable()
    url = pg.__enter__()
    reg = preg.StorageRegistry({
        "PIO_STORAGE_SOURCES_PG_TYPE": "POSTGRES",
        "PIO_STORAGE_SOURCES_PG_URL": url,
        "PIO_STORAGE_SOURCES_PG_BREAKER_THRESHOLD": "2",
        "PIO_STORAGE_SOURCES_PG_BREAKER_RECOVERY_S": "0.5",
        "PIO_STORAGE_SOURCES_PG_RETRY_BASE_DELAY": "0.001"})
    aid = reg.get_meta_data_apps().insert(App(0, "a"))
    key = reg.get_meta_data_access_keys().insert(AccessKey("", aid, ()))
    server = EventServer(EventServerConfig(ip="127.0.0.1", port=0), reg)
    port = server.start()
    try:
        db, pg_port = pg._db, pg.server_address[1]
        pg.crash()
        got = [_call(port, "POST", f"/events.json?accessKey={key}", EV)[0]
               for _ in range(3)]
        assert got == [500, 500, 503]
        status, _, body = _call(port, "GET", "/ready")
        assert status == 503 and body["storageBreakers"] == {"PG": "open"}
        pg = _restartable(pg_port, db)
        pg.__enter__()
        import time
        t0 = time.monotonic()
        while _call(port, "GET", "/ready")[0] != 200:
            assert time.monotonic() - t0 < 5.0
            time.sleep(0.05)
        status, _, body = _call(port, "POST",
                                f"/events.json?accessKey={key}", EV)
        assert status == 201
        assert reg.get_events().get(body["eventId"], aid) is not None
        assert reg.breaker_states() == {"PG": "closed"}
    finally:
        server.shutdown()
        reg.close()
        pg.__exit__(None, None, None)


@pytest.fixture()
def prediction_server(request):
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.ops import als as pals
    from predictionio_tpu_torch.serving.server import (PredictionServer,
                                                       _Deployment)
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.models.recommendation import \
        RecommendationEngine
    from predictionio_tpu_torch.tenancy import TenancyConfig
    rng = np.random.default_rng(1)
    model = pals.als_model_from_numpy(
        rng.integers(-3, 4, (8, 4)).astype(np.float32),
        rng.integers(-3, 4, (20, 4)).astype(np.float32),
        [f"u{n}" for n in range(8)], [f"i{n}" for n in range(20)],
        device="cpu")
    reg = preg.StorageRegistry(dict(MEM))
    aid = reg.get_meta_data_apps().insert(App(0, "a"))
    reg.get_meta_data_access_keys().insert(AccessKey("k", aid, ()))
    algos, models, serving = prepare_deploy(
        RecommendationEngine.apply(), [model], warm_batch_max=4)
    server = PredictionServer(
        _Deployment(algos, models, serving), port=0, batch_max=4,
        ctx=RuntimeContext(registry=reg, device="cpu"),
        wire=request.param, tenancy=TenancyConfig(enabled=True))
    server.start()
    yield server, reg
    server.stop()
    del cli


@pytest.mark.parametrize("prediction_server", ["selector", "threaded"],
                         indirect=True)
def test_prediction_server_routes_answer_503_and_ready_false(
        prediction_server):
    server, reg = prediction_server
    port = server.port
    assert _call(port, "POST", "/queries.json?accessKey=k",
                 {"user": "u1", "num": 3})[0] == 200
    status, _, body = _call(port, "GET", "/ready")
    assert status == 200 and body["storageBreakers"]["M"] == "closed"

    def boom(*a, **k):
        raise CircuitOpenError("storage.M", 7.2)
    server.admission.resolve_raw = boom        # the fast route's lookup
    server.admission.resolve = boom            # the generic route's
    for q in ({"user": "u1", "num": 3},                   # fast
              {"user": "u1", "num": 3, "blackList": ["i1"]}):  # generic
        status, retry, body = _call(port, "POST",
                                    "/queries.json?accessKey=k", q)
        assert (status, retry) == (503, "7"), body
        assert "storage.M" in body["message"]
    # trip the source's breaker: /ready names it
    faults().arm("storage.M.Apps.get", error=OSError)
    apps = reg.get_meta_data_apps()
    for _ in range(2):
        with pytest.raises(OSError):
            apps.get(1)
    status, _, body = _call(port, "GET", "/ready")
    assert status == 503 and body["storageBreakers"] == {"M": "open"}
