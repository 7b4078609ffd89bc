"""Tenancy of the port (`predictionio_tpu_torch/tenancy/`, the storage
rows it reads, `obs/slo.py`) against the JAX package's, in one process:
the same DRR push/take sequences drain in the same order; the same
admission script under one fake clock gives the same decisions (429 and
`Retry-After` alike); an `X-PIO-App` header signed by either package
verifies in the other; quota, SLO and lease rows written by either
package's SQLITE DAO read back in the other's; and a tenanted port
server answers 401 / 200 / 429 on both routes, with `/metrics` counting
what its clients saw."""

import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.data.storage import base as jbase
from predictionio_tpu.obs import MetricsRegistry as JMetrics
from predictionio_tpu.obs.slo import SLOTracker as JSLOTracker
from predictionio_tpu.tenancy import admission as jadm
from predictionio_tpu.tenancy import drr as jdrr
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.cli import ops as pops
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry)
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.obs.slo import SLOTracker
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.tenancy import admission as padm
from predictionio_tpu_torch.tenancy import drr as pdrr

pytestmark = pytest.mark.torch

LIMIT_S = 120     # each test's own time limit


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# -- DRR ----------------------------------------------------------------------

def _drr_script(seed: int):
    rng = np.random.default_rng(seed)
    tenants = [f"t{n}" for n in range(int(rng.integers(1, 6)))]
    ops = []
    for n in range(400):
        if rng.random() < 0.7:
            t = tenants[int(rng.integers(len(tenants)))]
            ops.append(("push", t, n, float(rng.choice([0.5, 1.0, 2.0, 3.0])),
                        int(rng.choice([0, 3, 8]))))
        elif rng.random() < 0.8:
            ops.append(("take", int(rng.integers(1, 9))))
        else:
            ops.append(("remove", tenants[int(rng.integers(len(tenants)))],
                        int(rng.integers(n + 1))))
    return ops


def _run_drr(mod, script, quantum, max_tenants):
    q = mod.DRRQueue(quantum=quantum, max_tenants=max_tenants)
    out = []
    for op in script:
        if op[0] == "push":
            _, t, item, w, cap = op
            out.append(q.push(t, item, weight=w, queue_max=cap))
            q.observe_delay(t, item * 1e-3)
        elif op[0] == "take":
            out.append(q.take(op[1]))
        else:
            out.append(q.remove(op[1], op[2]))
        out.append((len(q), [(t, q.depth(t), q.delay_ewma(t))
                             for t in q._lanes]))
    out.append(q.drain_all())
    return out


@pytest.mark.parametrize("seed,quantum,max_tenants", [
    (0, 4.0, 1024), (1, 1.0, 1024), (2, 2.5, 2), (3, 4.0, 3),
    (4, 8.0, 1)])
def test_drr_orders_equal_the_jax_queue(seed, quantum, max_tenants):
    """Pushes with weights and lane caps, takes, removals, evictions of
    idle lanes: every result, order and delay EWMA equal."""
    script = _drr_script(seed)
    assert _run_drr(pdrr, script, quantum, max_tenants) == \
        _run_drr(jdrr, script, quantum, max_tenants)


# -- admission ----------------------------------------------------------------

def _registries():
    """A MEM registry of each package with apps "alpha" (key AKEY) and
    "beta" (key BKEY), beta with a quota row."""
    cfg = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
    out = []
    for reg_cls, app_cls, key_cls, quota_cls in (
            (StorageRegistry, App, AccessKey, pbase.TenantQuota),
            (JRegistry, jbase.App, jbase.AccessKey, jbase.TenantQuota)):
        reg = reg_cls(dict(cfg))
        apps, keys = reg.get_meta_data_apps(), reg.get_meta_data_access_keys()
        a = apps.insert(app_cls(0, "alpha"))
        b = apps.insert(app_cls(0, "beta"))
        keys.insert(key_cls("AKEY", a, ()))
        keys.insert(key_cls("BKEY", b, ()))
        reg.get_meta_data_tenant_quotas().upsert(
            quota_cls(appid=b, rate=2.0, burst=3.0, concurrency=2,
                      weight=3.0))
        reg.get_meta_data_tenant_quotas().upsert(
            quota_cls(appid=b, rate=0.5, channel="slow"))
        out.append(reg)
    return out


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _admission_script(mod, reg, clock, script):
    ctl = mod.AdmissionController(
        mod.TenancyConfig(enabled=True, rate=5.0, burst=4.0,
                          queue_max=16, overrides_ttl_s=1e9),
        registry=reg, metrics=(MetricsRegistry() if mod is padm
                               else JMetrics()))
    held, out = [], []
    for step in script:
        if step[0] == "tick":
            clock.t += step[1]
            continue
        if step[0] == "release":
            if held:
                held.pop(0).__exit__(None, None, None)
            continue
        _, key, channel = step
        ident = ctl.resolve_raw(key, None, None, channel)
        try:
            guard = ctl.admit(ident)
        except Exception as e:  # noqa: BLE001 — the decision is the data
            out.append((ident.label, ident.channel, e.status,
                        round(e.retry_after, 9)))
            continue
        held.append(guard)
        out.append((ident.label, ident.channel, 200,
                    ctl.batch_params(ident)))
    return out, ctl.export_buckets()["buckets"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_decisions_equal_the_jax_controller(seed, monkeypatch):
    """One script of admits, releases and clock steps over two apps and a
    channel: the same 200 / 429 decisions, the same Retry-After, the same
    DRR parameters and the same spent buckets, under one fake clock."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(120):
        r = rng.random()
        if r < 0.15:
            script.append(("tick", float(rng.choice([0.01, 0.2, 0.5, 1.7]))))
        elif r < 0.3:
            script.append(("release",))
        else:
            script.append(("admit", str(rng.choice(["AKEY", "BKEY"])),
                           str(rng.choice(["", "", "slow"])) or None))
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    preg, jreg = _registries()
    mine = _admission_script(padm, preg, clock, script)
    clock.t = 1000.0
    theirs = _admission_script(jadm, jreg, clock, script)
    assert mine == theirs
    assert any(d[2] == 429 for d in mine[0])
    assert any(d[2] == 200 for d in mine[0])


def test_quota_shed_is_429_and_the_inflight_shed_stays_503():
    """The tenancy shed keeps the JAX status; the port's InflightLimiter
    keeps its own."""
    from predictionio_tpu_torch.resilience import (InflightLimiter,
                                                   OverloadedError)
    assert padm.QuotaExceeded.status == 429
    assert issubclass(padm.QuotaExceeded, OverloadedError)
    lim = InflightLimiter(1)
    with lim, pytest.raises(OverloadedError) as err:
        with lim:
            pass
    assert err.value.status == 503


@pytest.mark.parametrize("signer,verifier", [("port", "jax"),
                                             ("jax", "port")])
def test_signed_tenant_header_verifies_across_packages(signer, verifier):
    mods = {"port": padm, "jax": jadm}
    cfg = {"enabled": True, "header_key": "fleet-secret"}
    sign = mods[signer].AdmissionController(
        mods[signer].TenancyConfig(**cfg),
        metrics=MetricsRegistry() if signer == "port" else JMetrics())
    check = mods[verifier].AdmissionController(
        mods[verifier].TenancyConfig(trust_header=True, **cfg),
        metrics=MetricsRegistry() if verifier == "port" else JMetrics())
    ident = mods[signer].TenantIdentity(app_id=7, label="alpha",
                                        channel="web")
    value = sign.signed_header(ident)
    got = check.resolve_raw(None, value, None)
    assert (got.app_id, got.label, got.channel, got.pre_admitted) == \
        (7, "alpha", "web", True)
    # a forged signature falls through to key auth: 401 without a key
    forged = value[:-1] + ("0" if value[-1] != "0" else "1")
    with pytest.raises(Exception) as err:
        check.resolve_raw(None, forged, None)
    assert err.value.status == 401


def test_spent_buckets_journal_adopts_across_packages(monkeypatch):
    """The lease journal's bucket snapshot of one package clamps the
    other's bucket (a standby of either package inherits the budget)."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    preg, jreg = _registries()
    cfg = dict(enabled=True, rate=1.0, burst=5.0, overrides_ttl_s=1e9)
    mine = padm.AdmissionController(padm.TenancyConfig(**cfg),
                                    registry=preg, metrics=MetricsRegistry())
    theirs = jadm.AdmissionController(jadm.TenancyConfig(**cfg),
                                      registry=jreg, metrics=JMetrics())
    ident = mine.resolve_raw("AKEY", None, None)
    for _ in range(5):
        mine.admit(ident).__exit__(None, None, None)
    doc = json.loads(json.dumps(mine.export_buckets()))
    assert theirs.adopt_buckets(doc) == 1
    jident = theirs.resolve_raw("AKEY", None, None)
    with pytest.raises(Exception) as err:
        theirs.admit(jident)
    assert err.value.status == 429
    back = padm.AdmissionController(padm.TenancyConfig(**cfg),
                                    registry=preg, metrics=MetricsRegistry())
    assert back.adopt_buckets(json.loads(json.dumps(
        theirs.export_buckets()))) == 1
    with pytest.raises(padm.QuotaExceeded):
        back.admit(back.resolve_raw("AKEY", None, None))


# -- rows across packages -----------------------------------------------------

def _sqlite(reg_cls, path):
    return reg_cls({"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                    "PIO_STORAGE_SOURCES_DB_PATH": str(path)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_quota_slo_and_lease_rows_read_across_packages(tmp_path, writer):
    path = tmp_path / "pio.db"
    pkgs = {"port": (StorageRegistry, pbase), "jax": (JRegistry, jbase)}
    wreg, wb = pkgs[writer][0](
        {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
         "PIO_STORAGE_SOURCES_DB_PATH": str(path)}), pkgs[writer][1]
    other = "jax" if writer == "port" else "port"
    quotas = wreg.get_meta_data_tenant_quotas()
    quotas.upsert(wb.TenantQuota(appid=3, rate=2.5, burst=None,
                                 concurrency=4, queue_max=None,
                                 weight=1.5))
    quotas.upsert(wb.TenantQuota(appid=3, rate=0.25, channel="mob"))
    wreg.get_meta_data_slo_objectives().upsert(
        wb.SLOObjective(appid=3, latency_ms=40.0, target=0.99))
    leases = wreg.get_leases()
    assert leases.acquire("fleet-leader-default", "h1:1", 30.0,
                          journal='{"roll": ["a:1"]}') is not None
    wreg.close()
    rreg = _sqlite(pkgs[other][0], path)
    q = rreg.get_meta_data_tenant_quotas()
    assert [(r.appid, r.rate, r.burst, r.concurrency, r.queue_max,
             r.weight, r.channel) for r in q.get_all()] == [
        (3, 2.5, None, 4, None, 1.5, ""), (3, 0.25, None, None, None,
                                           None, "mob")]
    assert q.get(3, "mob").rate == 0.25 and q.get(9) is None
    slo = rreg.get_meta_data_slo_objectives().get(3)
    assert (slo.latency_ms, slo.target) == (40.0, 0.99)
    ls = rreg.get_leases()
    row = ls.get("fleet-leader-default")
    assert (row.holder, row.journal, row.expired()) == \
        ("h1:1", '{"roll": ["a:1"]}', False)
    # the CAS holds across packages: another holder is refused, the
    # holder renews (journal kept on None) and releases
    assert ls.acquire("fleet-leader-default", "h2:2", 30.0) is None
    renewed = ls.acquire("fleet-leader-default", "h1:1", 30.0)
    assert renewed.journal == '{"roll": ["a:1"]}'
    assert ls.release("fleet-leader-default", "h1:1") is True
    assert ls.get("fleet-leader-default") is None
    q.delete(3, "mob")
    assert len(q.get_all()) == 1


def test_mem_lease_cas_expiry_and_journal():
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
    ls = reg.get_leases()
    assert ls.acquire("l", "a", 0.05, journal="j1").holder == "a"
    assert ls.acquire("l", "b", 1.0) is None
    time.sleep(0.06)
    took = ls.acquire("l", "b", 1.0)
    assert (took.holder, took.journal) == ("b", "j1")   # journal inherited
    assert ls.release("l", "a") is False and ls.release("l", "b") is True


def test_app_quota_ops_write_what_the_jax_package_reads(tmp_path):
    path = tmp_path / "pio.db"
    reg = _sqlite(StorageRegistry, path)
    pops.app_new(reg, "shop")
    shown = pops.app_quota_set(reg, "shop", rate=3.0, weight=2.0)
    assert shown["quota"] == {"rate": 3.0, "burst": None,
                              "concurrency": None, "queue_max": None,
                              "weight": 2.0}
    # a later set keeps the fields it does not name
    assert pops.app_quota_set(reg, "shop", burst=9.0)["quota"]["rate"] == 3.0
    app_id = shown["id"]
    jq = _sqlite(JRegistry, path).get_meta_data_tenant_quotas().get(app_id)
    assert (jq.rate, jq.burst, jq.weight) == (3.0, 9.0, 2.0)
    pops.app_quota_delete(reg, "shop")
    assert pops.app_quota_show(reg, "shop")["quota"]["rate"] is None


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_burn_equals_the_jax_tracker(seed):
    rng = np.random.default_rng(seed)
    now = 1_700_000_000.0
    mine = SLOTracker(metrics=MetricsRegistry(), latency_ms=50.0,
                      target=0.99)
    theirs = JSLOTracker(metrics=JMetrics(), latency_ms=50.0, target=0.99)
    for _ in range(300):
        now += float(rng.choice([0.5, 5.0, 61.0]))
        app = str(rng.choice(["", "alpha", "beta"]))
        dur, ok = float(rng.random() * 0.1), bool(rng.random() < 0.9)
        mine.record(app, dur, ok, now=now)
        theirs.record(app, dur, ok, now=now)
    assert mine.snapshot(now=now) == theirs.snapshot(now=now)


# -- a tenanted server --------------------------------------------------------

N_USERS, N_ITEMS, RANK = 20, 200, 8


@pytest.fixture()
def tenanted():
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM"})
    apps = reg.get_meta_data_apps()
    a = apps.insert(App(0, "alpha"))
    b = apps.insert(App(0, "beta"))
    reg.get_meta_data_access_keys().insert(AccessKey("AKEY", a, ()))
    reg.get_meta_data_access_keys().insert(AccessKey("BKEY", b, ()))
    reg.get_meta_data_tenant_quotas().upsert(
        pbase.TenantQuota(appid=b, rate=0.001, burst=2.0))
    rng = np.random.default_rng(3)
    model = pals.als_model_from_numpy(
        rng.integers(-3, 4, (N_USERS, RANK)).astype(np.float32),
        rng.integers(-3, 4, (N_ITEMS, RANK)).astype(np.float32),
        [f"u{n}" for n in range(N_USERS)], [f"i{n}" for n in range(N_ITEMS)],
        device="cpu")
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.tenancy import TenancyConfig
    srv = cli.deploy(model, port=0, metrics=MetricsRegistry(),
                     ctx=RuntimeContext(registry=reg, device="cpu"),
                     tenancy=TenancyConfig(enabled=True, rate=1000.0,
                                           burst=1000.0))
    yield srv
    srv.stop()


def _post(port, body, query="", headers=None, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json{query}",
        data=raw if raw is not None else json.dumps(body).encode(),
        method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_tenanted_server_auth_quota_and_metrics(tenanted):
    """No key 401, a bad key 401, the app keys 200 on the fast and the
    generic route and the binary frame; beta past its burst of 2 gets 429
    with Retry-After while alpha keeps 200; /metrics counts it all."""
    import base64
    from predictionio_tpu_torch.utils.wire import encode_bin_query
    port = tenanted.port
    plain = {"user": "u1", "num": 3}
    banned = {"user": "u2", "num": 3, "blackList": ["i1", "i2"]}
    assert _post(port, plain)[0] == 401
    assert _post(port, plain, "?accessKey=NOPE")[0] == 401
    assert _post(port, banned)[0] == 401
    seen = {"alpha": {200: 0, 429: 0}, "beta": {200: 0, 429: 0}}
    basic = {"Authorization": "Basic " + base64.b64encode(b"BKEY:").decode()}
    for n in range(6):
        code, hdrs, body = _post(port, plain, "?accessKey=AKEY")
        assert code == 200 and len(body["itemScores"]) == 3
        seen["alpha"][200] += 1
        q = plain if n % 2 else banned
        code, hdrs, body = _post(port, q, headers=basic)
        seen["beta"][code] += 1
        if code == 429:
            assert int(hdrs["Retry-After"]) >= 1
            assert "quota" in body["message"]
    code, _, body = _post(
        port, None, "?accessKey=AKEY", raw=encode_bin_query("u3", 2),
        headers={"Content-Type": "application/x-pio-bin"})
    assert code == 200 and len(body["itemScores"]) == 2
    seen["alpha"][200] += 1
    assert seen["beta"] == {200: 2, 429: 4}
    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=30).read().decode()
    assert 'pio_tenant_admitted_total{app="alpha"} 7' in text
    assert 'pio_tenant_admitted_total{app="beta"} 2' in text
    assert 'pio_shed_total{surface="quota",app="beta"} 4' in text
    assert 'pio_tenant_serve_seconds_count{app="alpha"} 7' in text
    ready = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/ready", timeout=30).read())
    assert ready["ready"] is True


def test_one_tenant_fills_only_its_own_lane():
    """The batcher's DRR lanes: an aggressor past its lane cap sheds, the
    other tenant still queues, and the drain alternates by weight."""
    from predictionio_tpu_torch.resilience import OverloadedError
    from predictionio_tpu_torch.serving.server import _MicroBatcher

    release = threading.Event()
    order = []

    class _Dep:
        query_class = None

        def predict_batch(self, queries):
            release.wait(timeout=30)
            order.extend(queries)
            return queries

    batcher = _MicroBatcher(0.001, batch_max=4)
    dep = _Dep()
    out = []
    threads = [threading.Thread(target=lambda q=q, t=t: out.append(
        batcher.submit(dep, q, None, t, 1.0, 3))) for q, t in
        [("first", "a")]]
    threads[0].start()
    time.sleep(0.2)          # the drainer holds "first" in predict_batch
    more = [threading.Thread(target=lambda q=q, t=t: out.append(
        batcher.submit(dep, q, None, t, 1.0, 3)))
        for q, t in [("a1", "a"), ("a2", "a"), ("a3", "a"), ("b1", "b")]]
    for th in more:
        th.start()
    time.sleep(0.2)
    with pytest.raises(OverloadedError):
        batcher.submit(dep, "a4", None, "a", 1.0, 3)
    assert batcher._queue.depth("a") == 3 and batcher._queue.depth("b") == 1
    release.set()
    for th in threads + more:
        th.join(timeout=30)
    assert sorted(out) == ["a1", "a2", "a3", "b1", "first"]
    assert order[0] == "first" and "b1" in order[1:5]
