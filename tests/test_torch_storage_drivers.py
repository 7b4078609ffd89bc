"""The port's storage drivers beyond MEM and SQLITE: the event and
metadata DAO contract of `tests/test_storage.py` on its POSTGRES (over
`tests/fakepg.py`), its LOCALFS and REPLICATED model stores and their
leases; blobs and lease rows one package writes in a shared LOCALFS
directory read by the other; the port's restricted unpickler still
refusing a JAX blob from such a store; OBJECTSTORE over fsspec's
`memory://`; and REPLICATED's quorum writes, read repair and divergence
sweep against the JAX driver's on the same damage."""

import signal
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.data import integrity as jint
from predictionio_tpu.data.storage import base as jbase
from predictionio_tpu.data.storage import registry as jreg
from predictionio_tpu_torch.data import integrity as pint
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (AccessKey, App, Channel,
                                                 EngineInstance, Model,
                                                 StorageError,
                                                 StorageWriteError)
from predictionio_tpu_torch.data.storage import registry as preg
from predictionio_tpu_torch.resilience import faults
from tests.fakepg import FakePgServer

pytestmark = pytest.mark.torch

T0 = datetime(2020, 1, 1, tzinfo=timezone.utc)


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


def replicated(tmp: Path, quorum: str = "2") -> dict:
    cfg = {"PIO_STORAGE_SOURCES_REP_TYPE": "REPLICATED",
           "PIO_STORAGE_SOURCES_REP_REPLICAS": "FS1,FS2,FS3",
           "PIO_STORAGE_SOURCES_REP_QUORUM": quorum,
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "REP"}
    for t in ("FS1", "FS2", "FS3"):
        cfg[f"PIO_STORAGE_SOURCES_{t}_TYPE"] = "LOCALFS"
        cfg[f"PIO_STORAGE_SOURCES_{t}_PATH"] = str(tmp / t.lower())
    return cfg


SQLITE = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
          "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
          "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB"}


@pytest.fixture(params=["POSTGRES", "SQLITE+LOCALFS", "SQLITE+REPLICATED"])
def registry(request, tmp_path):
    kind = request.param
    if kind == "POSTGRES":
        with FakePgServer() as url:
            reg = preg.StorageRegistry({
                "PIO_STORAGE_SOURCES_PG_TYPE": "POSTGRES",
                "PIO_STORAGE_SOURCES_PG_URL": url})
            yield reg
            reg.close()
        return
    cfg = {**SQLITE, "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")}
    if kind == "SQLITE+LOCALFS":
        cfg.update({"PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
                    "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "models"),
                    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"})
    else:
        cfg.update(replicated(tmp_path))
    reg = preg.StorageRegistry(cfg)
    yield reg
    reg.close()


def ev(event="view", eid="u1", etype="user", t=0, props=None, target=None,
       **kw):
    return Event(event=event, entity_type=etype, entity_id=eid,
                 target_entity_type=target[0] if target else None,
                 target_entity_id=target[1] if target else None,
                 properties=DataMap(props or {}),
                 event_time=T0 + timedelta(minutes=t), **kw)


# -- the contract of tests/test_storage.py, on the port's drivers ----------------

def test_insert_get_delete(registry):
    es = registry.get_events()
    es.init(1)
    eid = es.insert(ev(), 1)
    assert es.get(eid, 1).event == "view"
    assert es.delete(eid, 1) is True
    assert es.get(eid, 1) is None and es.delete(eid, 1) is False


def test_find_filters_order_and_channels(registry):
    es = registry.get_events()
    es.init(2)
    es.init(2, 7)
    es.insert(ev(event="view", eid="u1", t=0), 2)
    es.insert(ev(event="buy", eid="u1", t=10, target=("item", "i1")), 2)
    es.insert(ev(event="view", eid="u2", t=20), 2)
    es.insert(ev(event="rate", eid="u1", etype="customer", t=30), 2)
    es.insert(ev(eid="b"), 2, 7)
    assert len(list(es.find(2))) == 4
    assert [e.entity_id for e in es.find(2, 7)] == ["b"]
    assert len(list(es.find(2, event_names=["view"]))) == 2
    assert [e.event for e in es.find(2, entity_type="user",
                                     entity_id="u1")] == ["view", "buy"]
    got = list(es.find(2, start_time=T0 + timedelta(minutes=10),
                       until_time=T0 + timedelta(minutes=30)))
    assert [e.event for e in got] == ["buy", "view"]
    assert [e.event for e in es.find(2, target_entity_type="item")] == [
        "buy"]
    assert len(list(es.find(2, target_entity_type=None))) == 3
    assert [e.event for e in es.find(2, limit=2)] == ["view", "buy"]
    assert [e.event for e in es.find(2, entity_type="user", entity_id="u1",
                                     reversed=True, limit=1)] == ["buy"]


def test_property_filters_batch_and_aggregate(registry):
    es = registry.get_events()
    es.init(3)
    ids = es.insert_batch([
        ev(event="$set", eid="i1", etype="item",
           props={"category": "books", "price": 10}),
        ev(event="$set", eid="i2", etype="item",
           props={"category": "tools", "price": 10}),
        ev(event="$set", eid="u1", t=1, props={"a": 1, "plan": "x"}),
        ev(event="$unset", eid="u1", t=6, props={"plan": None})], 3)
    assert len(ids) == 4
    assert [e.entity_id for e in es.find(
        3, properties={"category": "books"})] == ["i1"]
    assert sorted(e.entity_id for e in es.find(
        3, properties={"price": 10})) == ["i1", "i2"]
    agg = es.aggregate_properties(3, entity_type="user")
    assert agg["u1"].fields == DataMap({"a": 1})


def test_validation_duplicates_and_remove(registry):
    es = registry.get_events()
    es.init(8)
    with pytest.raises(ValueError):
        es.insert(ev(event="$unset"), 8)
    e = ev().with_id("dup")
    es.insert(e, 8)
    with pytest.raises(StorageWriteError):
        es.insert(e, 8)
    with pytest.raises(StorageWriteError):     # a batch is all or nothing
        es.insert_batch([ev(eid="new").with_id("fresh"), e], 8)
    assert es.get("fresh", 8) is None
    assert list(es.find(404)) == []
    es.remove(8)
    es.init(8)
    assert list(es.find(8)) == []


def test_metadata_daos(registry):
    apps = registry.get_meta_data_apps()
    aid = apps.insert(App(0, "myapp", "desc"))
    assert apps.get_by_name("myapp").id == aid
    with pytest.raises(StorageWriteError):
        apps.insert(App(0, "myapp", None))
    keys = registry.get_meta_data_access_keys()
    key = keys.insert(AccessKey("", aid, ()))
    assert keys.get(key).appid == aid
    keys.delete(key)
    assert keys.get(key) is None
    chans = registry.get_meta_data_channels()
    cid = chans.insert(Channel(0, "mobile", aid))
    assert [c.name for c in chans.get_by_appid(aid)] == ["mobile"]
    chans.delete(cid)
    eis = registry.get_meta_data_engine_instances()
    row = EngineInstance(status="INIT", engine_id="rec", engine_version="1",
                         engine_variant="default", env={"K": "V"})
    iid = eis.insert(row)
    eis.update(eis.get(iid).with_(status="COMPLETED"))
    iid2 = eis.insert(row.with_(status="COMPLETED",
                                start_time=row.start_time
                                + timedelta(hours=1)))
    assert eis.get_latest_completed("rec", "1", "default").id == iid2
    eis.record_heartbeat(iid)
    assert eis.get(iid).heartbeat is not None


def test_models(registry):
    models = registry.get_model_data_models()
    # REPLICATED acknowledges at its quorum and reads the first intact
    # copy, so a read waits for the write's stragglers here
    drain = getattr(models, "_drain", lambda: None)
    models.insert(Model("m1", b"\x00\x01binary"))
    models.insert(Model("m1", b"\x00\x02binary"))     # an upsert
    drain()
    assert models.get("m1").models == b"\x00\x02binary"
    assert models.list_model_ids() == ["m1"]
    models.delete("m1")
    drain()
    assert models.get("m1") is None and models.list_model_ids() == []


# -- leases ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["LOCALFS", "REPLICATED"])
def test_leases(tmp_path, kind):
    cfg = (replicated(tmp_path) if kind == "REPLICATED" else {
        "PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs")})
    reg = preg.StorageRegistry(cfg)
    leases = reg.get_leases()
    a = leases.acquire("leader", "a", 30.0, journal="j1")
    assert a is not None and a.holder == "a" and a.journal == "j1"
    assert leases.acquire("leader", "b", 30.0) is None
    assert leases.acquire("leader", "a", 30.0).journal == "j1"   # renewal
    assert leases.get("leader").holder == "a"
    assert leases.release("leader", "b") is False
    assert leases.release("leader", "a") is True
    assert leases.get("leader") is None
    expired = leases.acquire("leader", "a", 0.0, journal="roll")
    assert expired is not None
    took = leases.acquire("leader", "b", 30.0)
    assert took.holder == "b" and took.journal == "roll"
    reg.close()


def test_postgres_keeps_no_lease_table():
    with FakePgServer() as url:
        reg = preg.StorageRegistry({"PIO_STORAGE_SOURCES_PG_TYPE": "PGSQL",
                                    "PIO_STORAGE_SOURCES_PG_URL": url})
        with pytest.raises(StorageError, match="does not support"):
            reg.get_leases()
        reg.close()


def test_the_drivers_registered():
    assert {"MEM", "SQLITE", "EVLOG", "PEVLOG", "POSTGRES", "PGSQL",
            "LOCALFS", "OBJECTSTORE", "S3", "HDFS",
            "REPLICATED"} <= set(preg.DRIVERS)
    for name in ("POSTGRES", "PGSQL", "LOCALFS", "OBJECTSTORE", "S3",
                 "HDFS", "REPLICATED"):
        assert set(preg.DRIVERS[name]["daos"]) == set(
            jreg.DRIVERS[name]["daos"])


# -- across packages ------------------------------------------------------------------

def test_localfs_blobs_and_leases_cross_packages(tmp_path):
    cfg = {"PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs")}
    pr, jr = preg.StorageRegistry(cfg), jreg.StorageRegistry(cfg)
    rng = np.random.default_rng(5)
    blob = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    pr.get_model_data_models().insert(Model("p1", blob))
    jr.get_model_data_models().insert(jbase.Model("j1", blob[::-1]))
    f_p = tmp_path / "fs" / "pio_model_p1"
    f_j = tmp_path / "fs" / "pio_model_j1"
    # one envelope: the port's file is the JAX package's byte for byte
    assert f_p.read_bytes() == jint.wrap(blob) == pint.wrap(blob)
    assert jr.get_model_data_models().get("p1").models == blob
    assert pr.get_model_data_models().get("j1").models == blob[::-1]
    assert f_j.read_bytes() == pint.wrap(blob[::-1])
    assert pr.get_model_data_models().list_model_ids() == \
        jr.get_model_data_models().list_model_ids() == ["j1", "p1"]
    pr.get_leases().acquire("L", "port", 30.0, journal="x")
    assert jr.get_leases().get("L").holder == "port"
    assert jr.get_leases().acquire("L", "jax", 30.0) is None
    pr.close(), jr.close()


def test_a_jax_blob_in_a_shared_store_is_refused(tmp_path):
    from predictionio_tpu.core import persistence as jpers
    from predictionio_tpu.ingest import BiMap as JBiMap
    from predictionio_tpu.ops import als as jals
    from predictionio_tpu_torch.core import persistence as pers

    class Algo:
        params = None
        persist_model = True

    jmodel = jals.ALSModel(np.ones((2, 3), np.float32),
                           np.ones((4, 3), np.float32),
                           JBiMap.from_keys(["a", "b"]),
                           JBiMap.from_keys(["w", "x", "y", "z"]))
    cfg = {"PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs")}
    jr = jreg.StorageRegistry(cfg)
    jr.get_model_data_models().insert(jbase.Model(
        "iid", jpers.serialize_models("iid", [Algo()], [jmodel], None)))
    blob = preg.StorageRegistry(cfg).get_model_data_models().get("iid")
    with pytest.raises(pers.ForeignModelError, match="predictionio_tpu"):
        pers.deserialize_models(blob.models, "iid", [Algo()], None, None)


def test_objectstore_over_memory_urls(tmp_path):
    pytest.importorskip("fsspec")
    url = f"memory://torch-os-{tmp_path.name}"
    cfg = {"PIO_STORAGE_SOURCES_OS_TYPE": "OBJECTSTORE",
           "PIO_STORAGE_SOURCES_OS_URL": url}
    pr, jr = preg.StorageRegistry(cfg), jreg.StorageRegistry(cfg)
    pm, jm = pr.get_model_data_models(), jr.get_model_data_models()
    pm.insert(Model("a/b c", b"payload"))
    assert jm.get("a/b c").models == b"payload"
    jm.insert(jbase.Model("j", b"theirs"))
    assert pm.get("j").models == b"theirs"
    import fsspec
    fs, root = fsspec.core.url_to_fs(url)
    key = f"{root.rstrip('/')}/pio_model_j"
    with fs.open(key, "wb") as f:
        f.write(pint.wrap(b"theirs")[:-2])
    with pytest.raises(pint.CorruptBlobError):
        pm.get("j")
    found = pm.fsck(repair=False)
    assert [(f["kind"], f["action"]) for f in found] == [
        ("corrupt_blob", "none")]
    assert [f["kind"] for f in jm.fsck(repair=False)] == ["corrupt_blob"]
    repaired = pm.fsck(repair=True)
    assert repaired[0]["action"].startswith("quarantined")
    assert fs.exists(f"{root.rstrip('/')}/.quarantine/pio_model_j.reason")
    assert pm.get("j") is None and pm.fsck() == []
    pm.delete("a/b c")
    assert pm.get("a/b c") is None


def test_objectstore_config_forms():
    from predictionio_tpu_torch.data.storage import objectstore as pos
    from predictionio_tpu.data.storage import objectstore as jos
    for cfg in ({"URL": "s3://b/p"}, {"BUCKET_NAME": "b", "BASE_PATH": "x/"},
                {"BUCKET_NAME": "b"}, {"PATH": "hdfs://nn/models"}):
        assert pos.ObjectStoreStorageClient._url(cfg) \
            == jos.ObjectStoreStorageClient._url(cfg)
    with pytest.raises(StorageError, match="needs"):
        pos.ObjectStoreStorageClient._url({})


# -- REPLICATED against the JAX driver -------------------------------------------------

def _both(tmp_path, quorum="2"):
    cfg = replicated(tmp_path, quorum)
    return preg.StorageRegistry(cfg), jreg.StorageRegistry(cfg)


def test_replicated_quorum_write_with_a_target_down(tmp_path):
    pr, _ = _both(tmp_path)
    rule = faults().arm("storage.FS3.Models.insert", error=OSError)
    models = pr.get_model_data_models()
    models.insert(Model("m", b"quorum"))
    models._drain()
    assert rule.hits == 3                # FS3's retries, then it gave up
    faults().clear()
    assert [(tmp_path / t / "pio_model_m").exists()
            for t in ("fs1", "fs2", "fs3")] == [True, True, False]
    faults().arm("storage.FS2.Models.insert", error=OSError)
    faults().arm("storage.FS3.Models.insert", error=OSError)
    with pytest.raises(StorageError, match="quorum not met"):
        models.insert(Model("n", b"lost"))
    models._drain()


def test_replicated_read_repair_equals_the_jax_drivers(tmp_path):
    rng = np.random.default_rng(9)
    blob = bytes(rng.integers(0, 256, 2048, dtype=np.uint8))
    out = []
    for mod, base in ((preg, Model), (jreg, jbase.Model)):
        root = tmp_path / mod.__name__.split(".")[0]
        reg = mod.StorageRegistry(replicated(root))
        models = reg.get_model_data_models()
        models.insert(base("m", blob))
        models._drain()
        f1 = root / "fs1" / "pio_model_m"
        raw = bytearray(f1.read_bytes())
        raw[100] ^= 0xFF
        f1.write_bytes(bytes(raw))
        (root / "fs2" / "pio_model_m").unlink()
        assert models.get("m").models == blob
        out.append(sorted(p.read_bytes() == pint.wrap(blob)
                          for p in root.glob("fs*/pio_model_m")))
    assert out[0] == out[1] == [True, True, True]


def test_replicated_divergence_sweep_equals_the_jax_drivers(tmp_path):
    findings = []
    for mod, base in ((preg, Model), (jreg, jbase.Model)):
        root = tmp_path / mod.__name__.split(".")[0]
        reg = mod.StorageRegistry(replicated(root))
        models = reg.get_model_data_models()
        models.insert(base("m", b"majority"))
        models._drain()
        # FS1 holds another intact payload: the majority wins
        pint.atomic_write_bytes(root / "fs1" / "pio_model_m",
                                pint.wrap(b"minority"))
        got = models.check_divergence(["m"], repair=True)
        findings.append([(f["kind"], sorted(f["replicas"]), f["action"])
                         for f in got])
        assert models.get("m").models == b"majority"
        assert models.check_divergence(["m"]) == []
    assert findings[0] == findings[1]
    assert findings[0][0][2].startswith("rewrote FS1")
