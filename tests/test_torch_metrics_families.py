"""The port's /metrics families against the JAX package's, on the CPU.

Every `"pio_..."` family name in the JAX package's sources is published
by the port too, or stands on `EXEMPT` with the reason the port has no
such family. Then the families behave as the JAX ones: a port server
and a JAX server deploy the same integer-valued model and answer the
same requests, one at a time, with equal `pio_topk_dispatch_total`
counts; both publish `pio_serve_warmup_seconds`; a tiered plan's
`pio_tier_*` families equal the JAX pager's after the same traffic and
one page pass; the ingest pipeline's stage, cache and scan-rate
families, PEVLOG's pool spawns and the router's member count appear
where the JAX package publishes them.

Every test has its own SIGALRM limit."""

import json
import re
import signal
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.obs import get_registry as jget_registry
from predictionio_tpu.obs import MetricsRegistry as JMetrics
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import topk_tiered as jtt
from predictionio_tpu.serving import paging as jpaging
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import topk_tiered as ptt
from predictionio_tpu_torch.serving import paging as ppaging

pytestmark = pytest.mark.torch

LIMIT_S = 120
REPO = Path(__file__).resolve().parents[1]
FAMILY = re.compile(r'"(pio_[a-z0-9_]+)"')

# JAX families the port does not publish, each with its reason
EXEMPT = {
    "pio_jax_backend_compiles_total":
        "XLA's backend compiles; the port compiles no XLA program, and "
        "its kernel library builds count in pio_kernel_builds_total",
    "pio_jax_backend_compile_seconds":
        "XLA's backend compile seconds; the port's kernel library build "
        "seconds are pio_kernel_build_seconds",
    "pio_serve_warmup_compiles_total":
        "the executables XLA compiles at a deploy's warmup; the port's "
        "warmup launches the built kernel and compiles nothing "
        "(pio_kernel_builds_total counts the one build per process)",
    "pio_jax_backend_compile":
        "the JAX dashboard's Serving-panel prefix of the two XLA "
        "families above; the port's panel shows pio_kernel_build",
}


@pytest.fixture(autouse=True)
def _limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _families(package: str) -> dict:
    """Family name -> the first source file of `package` naming it."""
    out = {}
    for path in sorted((REPO / package).rglob("*.py")):
        for name in FAMILY.findall(path.read_text()):
            out.setdefault(name, path.relative_to(REPO).as_posix())
    return out


def test_every_jax_family_is_published_by_the_port():
    jax_families = _families("predictionio_tpu")
    port_source = "\n".join(
        p.read_text()
        for p in sorted((REPO / "predictionio_tpu_torch").rglob("*.py")))
    assert len(jax_families) > 100
    missing = {name: where for name, where in jax_families.items()
               if name not in port_source and name not in EXEMPT}
    assert not missing, missing
    # an exemption names a JAX family the port really lacks
    for name, reason in EXEMPT.items():
        assert name in jax_families and reason
        assert f'"{name}"' not in port_source, name


# -- the families' behaviour ---------------------------------------------------

N_USERS, N_ITEMS, RANK = 24, 200, 8
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _factors():
    rng = np.random.default_rng(31)
    return (rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
            rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32))


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's PredictionServer over the integer-valued
    factors: an instance whose train returns them, in a MEM store."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import EngineParams as JParams
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.event import DataMap as JMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import App as JApp
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.serving import PredictionServer as JServer
    from predictionio_tpu.serving import ServerConfig

    reg = JReg({"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app = reg.get_meta_data_apps().insert(JApp(0, "families"))
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
                app_name="families")),
            algorithm_params_list=(("als", jrec.ALSAlgorithmParams()),)),
            JCtx(registry=reg))
    finally:
        jrec.ALSAlgorithm.train = train
    srv = JServer(ServerConfig(ip="127.0.0.1", port=0), registry=reg,
                  engine=jrec.engine(), metrics=JMetrics())
    srv.start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def port_server():
    x, y = _factors()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=64,
                        metrics=MetricsRegistry())
    yield server
    server.stop()


def _dispatches(registry) -> dict:
    fam = registry.snapshot().get("pio_topk_dispatch_total")
    return {} if fam is None else {
        s["labels"]["path"]: s["value"] for s in fam["series"]}


def test_dispatch_counts_and_warmup_equal_the_jax_servers(jax_server,
                                                          port_server):
    """Both packages' process-default registries count one dispatch per
    answered query, sent one at a time (a batch of one each). The one
    difference the JAX package names itself: its `BucketedTopK` labels a
    bucket outside its fused sizes `device`, while every bucket of the
    port's plan goes through the fused kernel, `fused`; so the port's
    counts are all `fused` and their sum is the JAX sum."""
    jreg, preg = jget_registry(), get_registry()
    j0, p0 = _dispatches(jreg), _dispatches(preg)
    rng = np.random.default_rng(3)
    for n in range(24):
        q = {"user": USERS[n % N_USERS], "num": int(1 + n % 10)}
        if n % 4 == 1:
            q["blackList"] = [ITEMS[int(j)] for j in
                              rng.choice(N_ITEMS, 12, replace=False)]
        mine, theirs = _post(port_server.port, q), _post(jax_server.port, q)
        assert mine == theirs
    j1, p1 = _dispatches(jreg), _dispatches(preg)
    jd = {k: v - j0.get(k, 0.0) for k, v in j1.items()
          if v - j0.get(k, 0.0)}
    pd = {k: v - p0.get(k, 0.0) for k, v in p1.items()
          if v - p0.get(k, 0.0)}
    assert set(jd) <= {"fused", "device"} and sum(jd.values()) == 24.0
    assert pd == {"fused": 24.0}
    # the counter is the JAX family: one name, type, help and label
    jfam = jreg.snapshot()["pio_topk_dispatch_total"]
    pfam = preg.snapshot()["pio_topk_dispatch_total"]
    assert (pfam["type"], pfam["help"]) == (jfam["type"], jfam["help"])
    # the last deploy's warmup, in each process-default registry
    for reg in (jreg, preg):
        fam = reg.snapshot()["pio_serve_warmup_seconds"]
        assert fam["type"] == "gauge" and fam["series"][0]["value"] > 0
    assert (preg.snapshot()["pio_serve_warmup_seconds"]["help"]
            == jreg.snapshot()["pio_serve_warmup_seconds"]["help"])


def _tier_view(registry) -> dict:
    out = {}
    for name, fam in registry.snapshot().items():
        if not name.startswith("pio_tier_"):
            continue
        for s in fam["series"]:
            key = (name, fam["type"], fam["help"],
                   tuple(sorted(s["labels"].items())))
            # a page pass's seconds differ; its count does not
            out[key] = s["count"] if fam["type"] == "histogram" \
                else s["value"]
    return out


def test_tier_families_equal_the_jax_pagers_after_one_page_pass():
    rng = np.random.default_rng(8)
    f = rng.integers(-2, 3, (300, RANK)).astype(np.float32)
    f[150:200, 0] += np.float32(9.0)
    kw = dict(k=5, buckets=(1, 2, 4), banned_width=8, hot_items=40)
    j, p = jtt.TieredTopK(f, **kw), ptt.TieredTopK(f, device="cpu", **kw)
    j.warm(), p.warm()
    jm, pm = JMetrics(), MetricsRegistry()
    jmgr = jpaging.PageManager(interval_s=60.0, metrics=jm)
    pmgr = ppaging.PageManager(interval_s=60.0, metrics=pm)
    jmgr.bind([j])
    pmgr.bind([p])
    # registered at construction, before any pass
    assert set(pm.snapshot()) == set(jm.snapshot())
    vecs = np.zeros((4, RANK), np.float32)
    vecs[:, 0] = 2.0
    for _ in range(3):
        np.testing.assert_array_equal(p(vecs, [()] * 4)[1],
                                      np.asarray(j(vecs, [()] * 4)[1]))
    assert pmgr.tick() == jmgr.tick() > 0
    view = _tier_view(pm)
    assert view == _tier_view(jm)
    names = {k[0] for k in view}
    assert names == {"pio_tier_hot_items", "pio_tier_hit_ratio",
                     "pio_tier_promotions_total", "pio_tier_page_seconds"}


def test_a_tiered_server_publishes_the_tier_families(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_TIER", "on")
    monkeypatch.setenv("PIO_TIER_HOT_FRAC", "0.25")
    monkeypatch.setenv("PIO_TIER_PAGE_INTERVAL_S", "60")
    x, y = _factors()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    server = cli.deploy(model, port=0, batch_max=8,
                        metrics=MetricsRegistry())
    try:
        for n in range(6):
            assert _post(server.port, {"user": USERS[n], "num": 5})[0] == 200
        server._pager.tick()
        snap = server.metrics.snapshot()
        for name in ("pio_tier_hot_items", "pio_tier_hit_ratio",
                     "pio_tier_promotions_total", "pio_tier_page_seconds"):
            assert name in snap, name
        hot = snap["pio_tier_hot_items"]["series"]
        assert [s["value"] for s in hot] == [50.0]
    finally:
        server.stop()


def test_ingest_and_pool_families_are_the_jax_ones(tmp_path, monkeypatch):
    """The ingest pipeline's stage, cache and scan-rate families on a
    scan, a cache hit and an eviction; PEVLOG's pool spawn counter; each
    with the JAX family's type and help."""
    from predictionio_tpu.data.storage import pevlog as jpev
    from predictionio_tpu.ingest import pipeline as jpipe
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import App, StorageRegistry
    from predictionio_tpu_torch.data.storage import pevlog as ppev
    from predictionio_tpu_torch.ingest import pipeline as ppipe
    reg = StorageRegistry({
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")})
    app_id = reg.get_meta_data_apps().insert(App(0, "fam"))
    events = reg.get_events()
    events.init(app_id)
    for n in range(30):
        events.insert(Event(
            event="rate", entity_type="user", entity_id=f"u{n % 7}",
            target_entity_type="item", target_entity_id=f"i{n % 11}",
            properties=DataMap({"rating": float(1 + n % 5)})), app_id)
    monkeypatch.setenv("PIO_INGEST_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("PIO_INGEST_CACHE_MAX", "1")
    preg = get_registry()

    def value(name, **labels):
        fam = preg.snapshot().get(name)
        if fam is None:
            return 0.0
        for s in fam["series"]:
            if s["labels"] == labels:
                return s["count"] if fam["type"] == "histogram" \
                    else s["value"]
        return 0.0

    before = {n: value(n) for n in ("pio_ingest_cache_hits_total",
                                    "pio_ingest_cache_misses_total",
                                    "pio_ingest_cache_evictions_total")}
    scans = value("pio_ingest_stage_seconds", stage="scan")
    spec = {"rate": ("prop", "rating")}
    for names in (["rate"], ["rate"], ["rate", "buy"]):
        ppipe.rating_columns_from_store(events, app_id, event_names=names,
                                        value_spec=spec)
    assert value("pio_ingest_cache_misses_total") == \
        before["pio_ingest_cache_misses_total"] + 2
    assert value("pio_ingest_cache_hits_total") == \
        before["pio_ingest_cache_hits_total"] + 1
    assert value("pio_ingest_cache_evictions_total") == \
        before["pio_ingest_cache_evictions_total"] + 1
    assert value("pio_ingest_stage_seconds", stage="scan") == scans + 2
    assert value("pio_ingest_stage_seconds", stage="build") >= 2
    assert value("pio_ingest_scan_events_per_s") > 0
    # PEVLOG's pool spawn, counted where POOL_SPAWNS is
    spawns = value("pio_ingest_pool_spawns_total")
    ppev._count_pool_spawn()
    assert value("pio_ingest_pool_spawns_total") == spawns + 1
    # each family is the JAX one: its type and help
    jreg = JMetrics()
    monkeypatch.setattr(jpipe.obs_metrics, "get_registry", lambda: jreg)
    jpipe._record_stage("scan", 0.5)
    jpipe._record_cache(True)
    jpipe._record_cache(False)
    jpipe._record_scan_rate(10, 0.5)
    jreg.counter("pio_ingest_cache_evictions_total",
                 "Prepared-data cache entries evicted by the newest-N "
                 "retention bound")
    from predictionio_tpu.obs import metrics as jobs_metrics
    monkeypatch.setattr(jobs_metrics, "get_registry", lambda: jreg)
    jpev._count_pool_spawn()
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    for name in jsnap:
        assert (psnap[name]["type"], psnap[name]["help"]) == \
            (jsnap[name]["type"], jsnap[name]["help"]), name
    assert set(jsnap) == {
        "pio_ingest_stage_seconds", "pio_ingest_cache_hits_total",
        "pio_ingest_cache_misses_total", "pio_ingest_cache_evictions_total",
        "pio_ingest_scan_events_per_s", "pio_ingest_pool_spawns_total"}


def test_router_publishes_its_member_count():
    from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer

    def factory(i, *, mesh=None, tenancy=None):
        x, y = _factors()
        model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
        return cli.deploy(model, port=0, batch_max=4, mesh=mesh,
                          tenancy=tenancy, metrics=MetricsRegistry())

    metrics = MetricsRegistry()
    srv = FleetServer(factory, fleet=FleetConfig(replicas=2,
                                                 health_interval_s=0.2),
                      port=0, metrics=metrics)
    srv.start()
    try:
        srv._update_gauges()
        snap = metrics.snapshot()
        assert snap["pio_fleet_replicas_total"]["series"][0]["value"] == 2
        assert snap["pio_fleet_replicas_total"]["help"] == \
            "Members managed by the fleet"
        assert snap["pio_fleet_members"]["series"][0]["value"] == 2
    finally:
        srv.stop()
