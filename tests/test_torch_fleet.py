"""The port's serving fleet (`predictionio_tpu_torch/serving/fleet.py`) on
the CPU, against the JAX package's: a port fleet of 3 replicas answers
what the JAX fleet answers on the same (integer-valued, so exact) weights,
as float32; an `items=3@fleet` catalog mesh answers bit for bit what one
port server answers, its merge over three `ShardSliceTopK` slices, each
replica's plan calls = warmed buckets + drained chunks; a rolling
`/reload` and a replica killed under load cost no request; two routers
(of either package) racing for the lease elect exactly one leader; a
dead lease loop fails the router's `/ready`; a `--join` member registers
and serves; the router is the tenancy boundary; the watchdog restarts,
breaks and degrades loops."""

import base64
import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry)
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience.watchdog import Watchdog, watchdog
from predictionio_tpu_torch.serving.fleet import (FleetConfig, FleetServer,
                                                  ReplicaAgent)
from predictionio_tpu_torch.tenancy import TenancyConfig
from predictionio_tpu_torch.utils.wire import encode_bin_query

pytestmark = pytest.mark.torch

LIMIT_S = 150     # each test's own time limit
N_USERS, N_ITEMS, RANK = 40, 301, 8   # 301 = slices of 101, 101, 99
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    faults().clear()
    yield
    faults().clear()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _factors():
    rng = np.random.default_rng(11)
    return (rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
            rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32))


def _model():
    x, y = _factors()
    return pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")


def _factory(i, *, mesh=None, tenancy=None):
    return cli.deploy(_model(), port=0, batch_max=16, window_s=0.002,
                      mesh=mesh, tenancy=tenancy, metrics=MetricsRegistry())


def _fleet(factory=_factory, replicas=3, **kw):
    cfg = dict(replicas=replicas, health_interval_s=0.1, eject_threshold=2,
               drain_timeout_s=2.0)
    cfg.update(kw.pop("fleet", {}))
    srv = FleetServer(factory, fleet=FleetConfig(**cfg), port=0,
                      metrics=MetricsRegistry(), **kw)
    srv.start()
    return srv


def _queries(n=36, seed=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = {"user": USERS[i % N_USERS], "num": int(1 + i % 10)}
        if i % 3 == 0:
            q["blackList"] = [ITEMS[j] for j in
                              rng.choice(N_ITEMS, 25, replace=False)]
        if i == 5:
            q["user"] = "ghost"
        out.append(q)
    return out


def _call(port, method, path, body=None, raw=None, headers=None,
          timeout=30):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _wait(pred, what, timeout_s=30.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _plan_calls_match(server):
    """A replica's plan calls = warmed buckets + drained chunks."""
    plan = server.deployment.algos[0]._serve_plan
    sizes = server.batcher.batch_sizes()
    return plan.calls == len(plan.buckets) + sum(
        c * -(-n // plan.max_bucket) for n, c in sizes.items())


# -- answers --------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    srv = cli.deploy(_model(), port=0, batch_max=16,
                     metrics=MetricsRegistry())
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def mesh_fleet():
    srv = _fleet(mesh="items=3@fleet")
    yield srv
    srv.stop()


def test_mesh_fleet_is_bit_identical_to_one_server(single, mesh_fleet):
    """Integer factors make every score exact: the merged slices' answers
    (ties broken by global id, bans across slice edges, an unknown user)
    equal one server's answers bit for bit, JSON and binary frames."""
    reps = mesh_fleet.replicas()
    assert sorted(r.shard for r in reps) == ["0/3", "1/3", "2/3"]
    assert [r.server.deployment.algos[0]._serve_plan.slice_items
            for r in sorted(reps, key=lambda r: r.shard)] == [101, 101, 99]
    for q in _queries():
        mine = _call(mesh_fleet.port, "POST", "/queries.json", q)
        theirs = _call(single.port, "POST", "/queries.json", q)
        assert mine[0] == theirs[0] == 200
        assert mine[2] == theirs[2], q
        if "blackList" not in q:
            frame = encode_bin_query(q["user"], q["num"])
            hdr = {"Content-Type": "application/x-pio-bin"}
            assert _call(mesh_fleet.port, "POST", "/queries.json",
                         raw=frame, headers=hdr)[2] == theirs[2]


def test_each_members_plan_calls_are_warmup_plus_drained_chunks():
    """Concurrent known-user queries through a mesh: every member's slice
    plan was called once per warmed bucket and once per drained chunk."""
    from concurrent.futures import ThreadPoolExecutor
    srv = _fleet(mesh="items=3@fleet")
    try:
        qs = [q for q in _queries(60, seed=14) if q["user"] != "ghost"]
        with ThreadPoolExecutor(12) as pool:
            codes = list(pool.map(lambda q: _call(
                srv.port, "POST", "/queries.json", q)[0], qs))
        assert set(codes) == {200}
        for rep in srv.replicas():
            assert _plan_calls_match(rep.server)
            assert sum(n * c for n, c in
                       rep.server.batcher.batch_sizes().items()) == len(qs)
    finally:
        srv.stop()


def test_mesh_shard_route_returns_global_ids(mesh_fleet):
    rep = next(r for r in mesh_fleet.replicas() if r.shard == "1/3")
    code, _, out = _call(rep.port, "POST", "/shard/queries.json",
                         {"user": "u3", "num": 10})
    assert code == 200 and out["shard"] == "1/3" and out["num"] == 10
    assert all(101 <= gid < 202 and name == ITEMS[gid]
               for gid, _, name in out["cands"])
    # each member publishes its own slice's gauges (the JAX names)
    from predictionio_tpu_torch.obs import get_registry
    text = get_registry().render()
    assert "pio_serve_shards 3" in text
    assert f'pio_serve_shard_bytes{{shard="1"}} {101 * RANK * 4}' in text


def test_mesh_degrades_to_partial_without_a_slice_owner():
    srv = _fleet(mesh="items=3@fleet")
    try:
        dead = next(r for r in srv.replicas() if r.shard == "2/3")
        dead.server.shutdown()
        code, _, out = _call(srv.port, "POST", "/queries.json",
                             {"user": "u1", "num": 10})
        assert code == 200
        if out.get("partial"):
            assert out["degradedShards"] == ["2/3"]
            assert all(int(s["item"][1:]) < 202 for s in out["itemScores"])
        _wait(lambda: not dead.admitted, "the dead slice owner's ejection")
        code, _, out = _call(srv.port, "POST", "/queries.json",
                             {"user": "u1", "num": 10})
        assert code == 200 and out["partial"] is True
        assert out["degradedShards"] == ["2/3"]
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's fleet of 3 replicas over the same integer
    factors: an instance whose train returns them, in a MEM store."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import EngineParams as JParams
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.event import DataMap as JMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import App as JApp
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.serving import FleetConfig as JFleetConfig
    from predictionio_tpu.serving import FleetServer as JFleet
    from predictionio_tpu.serving import ServerConfig

    reg = JReg({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(JApp(0, "parity"))
    reg.get_events().init(app)
    reg.get_events().insert(JEvent(
        event="rate", entity_type="user", entity_id="u0",
        target_entity_type="item", target_entity_id="i0",
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
    srv = JFleet(ServerConfig(ip="127.0.0.1", port=0, batch_window_ms=2),
                 JFleetConfig(replicas=3, health_interval_s=0.1),
                 registry=reg, engine=jrec.engine(), metrics=JMetrics())
    srv.start()
    yield srv
    srv.stop()


def _scores32(body):
    return [(s["item"], np.float32(s["score"])) for s in body["itemScores"]]


@pytest.mark.parametrize("mesh", ["", "items=3@fleet"])
def test_port_fleet_answers_the_jax_fleet(jax_fleet, mesh):
    """The same items and float32 scores as the JAX fleet of 3 replicas,
    through a plain port fleet and a catalog mesh alike; the router's
    /status.json has the JAX router's keys."""
    srv = _fleet(mesh=mesh)
    try:
        for q in _queries(seed=13):
            mine = _call(srv.port, "POST", "/queries.json", q)
            theirs = _call(jax_fleet.port, "POST", "/queries.json", q)
            assert mine[0] == theirs[0] == 200, (mine, theirs)
            assert _scores32(mine[2]) == _scores32(theirs[2]), q
        mine = _call(srv.port, "GET", "/status.json")[2]
        theirs = _call(jax_fleet.port, "GET", "/status.json")[2]
        assert set(theirs) <= set(mine)
        assert set(theirs["replicas"][0]) <= set(mine["replicas"][0])
        assert mine["leader"] is True and len(mine["replicas"]) == 3
    finally:
        srv.stop()


# -- reloads and kills under load ---------------------------------------------

class _Loader:
    """Client threads hammering the router; every status recorded."""

    def __init__(self, port, threads=3):
        self.port = port
        self.halt = threading.Event()
        self.statuses = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, args=(n,),
                                          daemon=True)
                         for n in range(threads)]

    def _run(self, n):
        i = 0
        while not self.halt.is_set():
            q = {"user": f"u{(n * 7 + i) % 20}", "num": 3}
            i += 1
            try:
                code = _call(self.port, "POST", "/queries.json", q,
                             timeout=30)[0]
            except Exception as e:  # noqa: BLE001 — a failed request
                code = repr(e)
            with self._lock:
                self.statuses.append(code)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.halt.set()
        for t in self._threads:
            t.join(timeout=30)


def _rated_registry():
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
    app = reg.get_meta_data_apps().insert(App(0, "fleetapp"))
    reg.get_meta_data_access_keys().insert(AccessKey("FKEY", app, ()))
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
        "datasource": {"params": {"app_name": "fleetapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 2, "seed": seed}}]})
    ctx = RuntimeContext(registry=reg, device="cpu")
    return engine, CoreWorkflow.run_train(engine, params, ctx), ctx


@pytest.mark.parametrize("mesh", ["", "items=2@fleet"])
def test_rolling_reload_under_load_fails_no_request(mesh):
    """Instances from the store through `fleet_replica_factory` (slices
    rebuilt by each member's own /reload in mesh mode): the roll reaches
    every member one at a time while clients run, no request fails, and
    every member then serves the new instance."""
    reg = _rated_registry()
    engine, row1, ctx = _train(reg, 1)
    factory = cli.fleet_replica_factory(
        engine, row1, ctx, batch_max=8, server_key="rk",
        metrics=MetricsRegistry())
    n = 4 if mesh else 3
    srv = _fleet(factory, replicas=n, mesh=mesh, server_key="rk",
                 registry=reg)
    try:
        assert {r.model_id for r in srv.replicas()} == {row1.id}
        _, row2, _ = _train(reg, 2)
        with _Loader(srv.port) as load:
            _wait(lambda: len(load.statuses) > 20, "load")
            assert _call(srv.port, "POST", "/reload")[0] == 401
            code, _, report = _call(
                srv.port, "POST", "/reload", headers={
                    "Authorization": "Basic " + base64.b64encode(
                        b"rk:").decode()}, timeout=120)
            time.sleep(0.2)
        assert code == 200 and report["aborted"] is False
        assert [r["outcome"] for r in report["results"]] == ["reloaded"] * n
        assert len(load.statuses) > 20
        assert set(load.statuses) == {200}, \
            sorted({str(s) for s in load.statuses})
        for rep in srv.replicas():
            assert rep.server.deployment.instance_id == row2.id
            assert rep.model_id == row2.id
            if mesh:
                plan = rep.server.deployment.algos[0]._serve_plan
                assert type(plan).__name__ == "ShardSliceTopK"
                assert rep.server.shard_spec() == rep.shard
        # the roll's journal is cleared from the lease row
        assert reg.get_leases().get("fleet-leader-default").journal \
            in ("", None)
    finally:
        srv.stop()


def test_a_replica_killed_under_load_fails_no_request():
    srv = _fleet()
    try:
        with _Loader(srv.port) as load:
            _wait(lambda: len(load.statuses) > 20, "load")
            victim = srv.replicas()[0]
            victim.server.shutdown()          # dies mid-traffic
            _wait(lambda: not victim.admitted, "the victim's ejection")
            n = len(load.statuses)
            _wait(lambda: len(load.statuses) > n + 20, "more load")
        assert set(load.statuses) == {200}, \
            sorted({str(s) for s in load.statuses})
        assert sum(1 for r in srv.replicas() if r.admitted) == 2
    finally:
        srv.stop()


# -- leadership -----------------------------------------------------------------

def _sqlite_registry(path):
    return StorageRegistry({"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                            "PIO_STORAGE_SOURCES_DB_PATH": str(path)})


@pytest.mark.parametrize("other", ["port", "jax"])
def test_two_routers_race_for_the_lease_and_one_leads(tmp_path, other):
    """Two routers on one sqlite store started at once: exactly one
    leads, the other redirects /queries.json (307) to it; when the leader
    stops (releasing the lease) the other takes over."""
    path = tmp_path / "pio.db"
    fleet = dict(replicas=0, health_interval_s=0.1, lease_ttl_s=0.6)

    def port_router():
        return FleetServer(None, fleet=FleetConfig(**fleet), port=0,
                           registry=_sqlite_registry(path),
                           metrics=MetricsRegistry())

    def jax_router():
        from predictionio_tpu.data.storage import StorageRegistry as JReg
        from predictionio_tpu.obs import MetricsRegistry as JMetrics
        from predictionio_tpu.serving import FleetConfig as JFleetConfig
        from predictionio_tpu.serving import FleetServer as JFleet
        from predictionio_tpu.serving import ServerConfig
        return JFleet(ServerConfig(ip="127.0.0.1", port=0),
                      JFleetConfig(**fleet),
                      registry=JReg({
                          "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                          "PIO_STORAGE_SOURCES_DB_PATH": str(path)}),
                      metrics=JMetrics())

    routers = [port_router(), port_router() if other == "port"
               else jax_router()]
    barrier = threading.Barrier(2)

    def go(r):
        barrier.wait(timeout=30)
        r.start()

    threads = [threading.Thread(target=go, args=(r,)) for r in routers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        leaders = [r for r in routers if r.is_leader()]
        assert len(leaders) == 1
        lead = leaders[0]
        standby = routers[1 - routers.index(lead)]
        # a standby that lost the race learns the holder on its next
        # lease tick (503 "no leader" until then)
        _wait(lambda: _call(standby.port, "POST", "/queries.json",
                            {"user": "u1", "num": 2})[0] == 307,
              "the standby's redirect")
        code, hdrs, _ = _call(standby.port, "POST", "/queries.json",
                              {"user": "u1", "num": 2})
        assert code == 307 and hdrs["Location"].endswith(
            f":{lead.port}/queries.json")
        lead.stop()
        _wait(standby.is_leader, "the standby's takeover")
        assert sum(1 for r in routers if r.is_leader()) == 1
    finally:
        for r in routers:
            r.stop()


def test_a_dead_lease_loop_fails_the_routers_ready():
    srv = _fleet(replicas=1, fleet={"lease_ttl_s": 0.3},
                 registry=StorageRegistry(
                     {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"}))
    try:
        assert _call(srv.port, "GET", "/ready")[0] == 200
        faults().arm("thread.lease.die", error=RuntimeError, times=1)
        _wait(lambda: srv._lease_beat.dead, "the lease loop's death")
        watchdog().sweep()
        code, _, body = _call(srv.port, "GET", "/ready")
        assert code == 503 and body["degradedLoops"] == ["lease"]
    finally:
        srv.stop()


def test_a_joined_member_registers_and_serves():
    router = _fleet(replicas=0, server_key="sk")
    member = cli.deploy(_model(), port=0, metrics=MetricsRegistry())
    agent = ReplicaAgent(member, [f"http://127.0.0.1:{router.port}"],
                         server_key="sk", heartbeat_s=0.1,
                         member_name="m0")
    try:
        agent.start()
        _wait(lambda: any(r.admitted for r in router.replicas()),
              "the member's admission")
        rep = router.replicas()[0]
        assert (rep.remote, rep.name, rep.key) == \
            (True, "m0", f"127.0.0.1:{member.port}")
        code, _, out = _call(router.port, "POST", "/queries.json",
                             {"user": "u1", "num": 4})
        assert code == 200 and len(out["itemScores"]) == 4
        # the membership routes take the server key
        assert _call(router.port, "POST", "/fleet/heartbeat",
                     {"member": "127.0.0.1:1"})[0] == 401
    finally:
        agent.stop()
        member.stop()
        router.stop()


# -- tenancy through the router -------------------------------------------------

def test_the_router_is_the_tenancy_boundary():
    """The router authenticates and charges once; replicas trust only its
    signed header (a forged one on a replica is 401); an app over its
    quota gets 429 with Retry-After at the router, the other app 200."""
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
    apps = reg.get_meta_data_apps()
    for name, key in (("alpha", "AKEY"), ("beta", "BKEY")):
        reg.get_meta_data_access_keys().insert(
            AccessKey(key, apps.insert(App(0, name)), ()))
    srv = _fleet(replicas=2, registry=reg, tenancy=TenancyConfig(
        enabled=True, rate=0.001, burst=3.0))
    try:
        codes = {"AKEY": [], "BKEY": []}
        for n in range(6):
            codes["BKEY"].append(_call(srv.port, "POST",
                                       "/queries.json?accessKey=BKEY",
                                       {"user": "u1", "num": 2})[0])
            if n < 3:
                codes["AKEY"].append(_call(srv.port, "POST",
                                           "/queries.json?accessKey=AKEY",
                                           {"user": "u2", "num": 2})[0])
        assert codes == {"AKEY": [200] * 3, "BKEY": [200] * 3 + [429] * 3}
        code, hdrs, _ = _call(srv.port, "POST", "/queries.json",
                              {"user": "u1", "num": 2},
                              headers={"X-PIO-App": "1:alpha::00"})
        assert code == 401
        rep = srv.replicas()[0]
        assert _call(rep.port, "POST", "/queries.json",
                     {"user": "u1", "num": 2},
                     headers={"X-PIO-App": "1:alpha::deadbeef"})[0] == 401
        text = srv.metrics.render()
        assert 'pio_shed_total{surface="quota",app="beta"} 3' in text
        assert 'pio_tenant_admitted_total{app="alpha"} 3' in text
    finally:
        srv.stop()


# -- the watchdog ---------------------------------------------------------------

def test_watchdog_restarts_breaks_and_degrades():
    wd = Watchdog(stall_s=0.1, interval_s=0.05)
    runs = []

    def body(beat):
        runs.append(1)
        beat.tick()
        raise RuntimeError("boom")

    beat = wd.register("loop", restart=lambda: threading.Thread(
        target=beat.guard, args=(lambda: body(beat),)).start())
    threading.Thread(target=beat.guard, args=(lambda: body(beat),)).start()
    end = time.monotonic() + 30
    while not beat.degraded and time.monotonic() < end:
        wd.sweep()
        time.sleep(0.02)
    assert beat.degraded and "crash loop" in beat.reason
    assert len(runs) == 5 and beat.restarts == 4
    stuck = wd.register("lease")        # not restartable
    stuck.attach()
    time.sleep(0.15)
    wd.sweep()
    assert stuck.degraded and stuck.reason.startswith("stalled")
    stuck.close()
    beat.close()
    wd.sweep()
    assert wd.beats() == []
