"""The port's storage layer: the DAO contract on its MEM and SQLITE
drivers, then one sqlite file shared with the JAX package. A `pio.db`
the JAX package wrote (apps, channels, access keys, events, engine
instances, a model blob) gives the same answers through the port: every
`find` below (time range, names, entity, the three-state target filter,
property values, `limit`, `reversed`, per channel) returns the same
events in the same order. The reverse holds for a file the port wrote,
read by the JAX package."""

from dataclasses import replace
from datetime import datetime, timedelta, timezone

import pytest

from predictionio_tpu.data import event as jev
from predictionio_tpu.data import storage as jst
from predictionio_tpu.data.storage import registry as jreg
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data import storage as pst
from predictionio_tpu_torch.data.storage import registry as preg

pytestmark = pytest.mark.torch

T0 = datetime(2021, 3, 4, 5, 6, 7, 890000, tzinfo=timezone.utc)


def _config(kind, tmp_path):
    if kind == "MEM":
        return {"PIO_STORAGE_SOURCES_S_TYPE": "MEM"}
    return {"PIO_STORAGE_SOURCES_S_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "pio.db")}


@pytest.fixture(params=["MEM", "SQLITE"])
def reg(request, tmp_path):
    r = preg.StorageRegistry(_config(request.param, tmp_path))
    yield r
    r.close()


# -- the DAO contract ------------------------------------------------------------

def test_apps(reg):
    apps = reg.get_meta_data_apps()
    a = apps.insert(pst.App(0, "a", "d"))
    b = apps.insert(pst.App(0, "b"))
    assert a != b and apps.get(a) == pst.App(a, "a", "d")
    assert apps.get_by_name("b").id == b and apps.get_by_name("z") is None
    with pytest.raises(pst.StorageWriteError):
        apps.insert(pst.App(0, "a"))
    assert apps.insert(pst.App(42, "c")) == 42
    assert [x.id for x in apps.get_all()] == sorted([a, b, 42])
    apps.update(pst.App(a, "a2", None))
    assert apps.get(a).name == "a2"
    apps.delete(a)
    assert apps.get(a) is None


def test_access_keys(reg):
    keys = reg.get_meta_data_access_keys()
    k = keys.insert(pst.AccessKey("", 1, ("rate",)))
    assert len(k) > 40 and not k.startswith("-")
    assert keys.get(k) == pst.AccessKey(k, 1, ("rate",))
    assert keys.insert(pst.AccessKey("mine", 2)) == "mine"
    with pytest.raises(pst.StorageWriteError):
        keys.insert(pst.AccessKey("mine", 3))
    assert [x.key for x in keys.get_by_appid(2)] == ["mine"]
    keys.update(pst.AccessKey("mine", 2, ("buy",)))
    assert keys.get("mine").events == ("buy",)
    keys.delete(k)
    assert {x.key for x in keys.get_all()} == {"mine"}


def test_channels(reg):
    chans = reg.get_meta_data_channels()
    c1 = chans.insert(pst.Channel(0, "web", 1))
    c2 = chans.insert(pst.Channel(0, "mob-1", 1))
    chans.insert(pst.Channel(0, "web", 2))
    assert [c.name for c in chans.get_by_appid(1)] == ["web", "mob-1"]
    assert chans.get(c2) == pst.Channel(c2, "mob-1", 1)
    with pytest.raises(ValueError, match="Invalid channel name"):
        pst.Channel(0, "bad/name", 1)
    chans.delete(c1)
    assert [c.id for c in chans.get_by_appid(1)] == [c2]


def test_engine_instances(reg):
    dao = reg.get_meta_data_engine_instances()
    S = pst.EngineInstanceStatus
    rows = {}
    for n, status in enumerate([S.COMPLETED, S.FAILED, S.COMPLETED,
                                S.TRAINING]):
        rows[n] = dao.insert(pst.EngineInstance(
            status=status, start_time=T0 + timedelta(seconds=n),
            end_time=T0 + timedelta(seconds=n + 1), engine_id="default",
            engine_version="default", engine_variant="v",
            runtime_conf={"phase_timings": {"read_s": 0.5}},
            algorithms_params='[{"name": "als"}]'))
    got = dao.get(rows[0])
    assert got.start_time == T0 and got.runtime_conf == {
        "phase_timings": {"read_s": 0.5}}
    assert [i.id for i in dao.get_completed("default", "default", "v")] \
        == [rows[2], rows[0]]
    assert dao.get_latest_completed("default", "default", "v").id == rows[2]
    assert dao.get_latest_completed("default", "default", "w") is None
    dao.record_heartbeat(rows[3], T0)
    assert dao.get(rows[3]).heartbeat == T0
    dao.update(dao.get(rows[3]).with_(status=S.COMPLETED,
                                      start_time=T0 + timedelta(hours=1)))
    assert dao.get_latest_completed("default", "default", "v").id == rows[3]
    dao.delete(rows[3])
    assert dao.get(rows[3]) is None and len(dao.get_all()) == 3


def test_models(reg):
    dao = reg.get_model_data_models()
    dao.insert(pst.Model("m1", b"\x00blob"))
    assert dao.get("m1") == pst.Model("m1", b"\x00blob")
    dao.insert(pst.Model("m1", b"other"))
    assert dao.get("m1").models == b"other"
    dao.delete("m1")
    assert dao.get("m1") is None


def test_events(reg):
    store = reg.get_events()
    store.init(1)
    e = pev.Event(event="rate", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i1",
                  properties=pev.DataMap({"rating": 3}), event_time=T0)
    eid = store.insert(e, 1)
    got = store.get(eid, 1)
    assert got.to_api_json() == e.with_id(eid).to_api_json()
    with pytest.raises(ValueError, match="reserved"):
        store.insert(pev.Event(event="$bad", entity_type="u",
                               entity_id="1"), 1)
    with pytest.raises(pst.StorageWriteError):
        store.insert(e.with_id(eid), 1)
    ids = store.insert_batch([e, e], 1, 7)
    assert len(set(ids)) == 2 and eid not in ids
    assert [x.event_id for x in store.find(1, 7)] == sorted(ids)
    assert [x.event_id for x in store.find(1)] == [eid]
    assert store.delete(eid, 1) and not store.delete(eid, 1)
    store.remove(1, 7)
    assert list(store.find(1, 7)) == []


def test_sqlite_models_carry_the_integrity_envelope(tmp_path):
    r = preg.StorageRegistry(_config("SQLITE", tmp_path))
    r.get_model_data_models().insert(pst.Model("m", b"payload"))
    client = r._client("S")
    raw = client.conn.execute("SELECT models FROM models").fetchone()[0]
    assert bytes(raw).startswith(b"PIOB") and integrity.unwrap(
        bytes(raw)) == b"payload"
    with client.conn:
        client.conn.execute("UPDATE models SET models=?",
                            (bytes(raw)[:-1] + b"X",))
    with pytest.raises(integrity.CorruptBlobError):
        r.get_model_data_models().get("m")
    # the JAX package's envelope, either digest, unwraps in the port
    from predictionio_tpu.data import integrity as jintegrity
    assert jintegrity.wrap(b"payload") == integrity.wrap(b"payload")
    for algo in (jintegrity.ALGO_CRC32, jintegrity.ALGO_SHA256):
        assert integrity.unwrap(jintegrity.wrap(b"payload", algo)) == b"payload"


def test_registry_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for k in [k for k in __import__("os").environ if k.startswith("PIO_")]:
        monkeypatch.delenv(k)
    r = preg.StorageRegistry()
    assert r.sources == {"PIO": {"TYPE": "SQLITE",
                                 "PATH": "./.pio_store/pio.db"}}
    r.get_meta_data_apps()
    assert (tmp_path / ".pio_store" / "pio.db").is_file()
    (tmp_path / "pio-env").write_text(
        "# comment\nPIO_STORAGE_SOURCES_M_TYPE=MEM\n")
    assert preg.StorageRegistry().sources == {"M": {"TYPE": "MEM"}}
    with pytest.raises(pst.StorageError, match="unknown TYPE"):
        preg.StorageRegistry({"PIO_STORAGE_SOURCES_X_TYPE": "NOPE"})
    preg.set_default(r)
    assert preg.storage() is r
    preg.set_default(None)


# -- one file, two packages ----------------------------------------------------

def _events(mod):
    """Events with ties in time, no targets, specials and properties."""
    E, D = mod.Event, mod.DataMap
    out = []
    for n in range(24):
        t = T0 + timedelta(milliseconds=(n // 3) * 250)
        kind = n % 6
        if kind == 0:
            e = E("rate", "user", f"u{n % 4}", "item", f"i{n % 5}",
                  D({"rating": float(n % 5 + 1)}), t)
        elif kind == 1:
            e = E("buy", "user", f"u{n % 4}", "item", f"i{n % 3}",
                  D({}), t)
        elif kind == 2:
            e = E("view", "user", f"u{n % 4}", event_time=t,
                  properties=D({"page": n}))
        elif kind == 3:
            e = E("$set", "item", f"i{n % 5}", event_time=t,
                  properties=D({"cat": ["a", "b"][n % 2]}))
        elif kind == 4:
            e = E("rate", "user", f"u{n % 4}", "movie", f"m{n % 2}",
                  D({"rating": 5.0}), t, tags=("x",), pr_id="p")
        else:
            e = E("like", "customer", f"c{n % 2}", "item", f"i{n % 5}",
                  D({"rating": 5.0}), t)
        e = replace(e, creation_time=T0)
        out.append(e.with_id(f"{n:04d}") if n % 2 else e)
    return out


_T1 = T0 + timedelta(milliseconds=500)
_T2 = T0 + timedelta(milliseconds=1500)
FIND_CASES = [
    {}, {"event_names": ["rate"]}, {"event_names": ["rate", "buy"]},
    {"entity_type": "user"}, {"entity_type": "user", "entity_id": "u1"},
    {"target_entity_type": None}, {"target_entity_type": "item"},
    {"target_entity_id": "i2"}, {"target_entity_id": None},
    {"start_time": _T1}, {"until_time": _T2},
    {"start_time": _T1, "until_time": _T2}, {"limit": 3}, {"limit": 0},
    {"reversed": True},
    {"reversed": True, "limit": 2, "entity_type": "user", "entity_id": "u1"},
    {"properties": {"rating": 5.0}}, {"properties": {"rating": 5.0},
                                      "limit": 1},
    {"event_names": ["rate"], "target_entity_type": "item",
     "start_time": _T1},
]


def _fill(mod_storage, event_mod, config):
    """Apps, a channel, keys, events in both channels, instances and a
    model blob, written through one package's registry."""
    r = mod_storage.StorageRegistry(config)
    app = r.get_meta_data_apps().insert(mod_storage.App(0, "shop", "d"))
    r.get_meta_data_apps().insert(mod_storage.App(0, "other"))
    ch = r.get_meta_data_channels().insert(mod_storage.Channel(0, "web", app))
    r.get_meta_data_access_keys().insert(
        mod_storage.AccessKey("k1", app, ("rate",)))
    events = _events(event_mod)
    store = r.get_events()
    store.insert_batch(events[:12], app)
    for e in events[12:]:
        store.insert(e, app)
    store.insert_batch(events[::2], app, ch)
    S = mod_storage.EngineInstanceStatus
    for n, status in enumerate([S.COMPLETED, S.FAILED]):
        r.get_meta_data_engine_instances().insert(mod_storage.EngineInstance(
            id=f"inst{n}", status=status, start_time=T0, end_time=_T1,
            engine_id="default", engine_version="default",
            engine_variant="default", engine_factory="recommendation",
            runtime_conf={"phase_timings": {"read_s": 1.25}},
            algorithms_params='[{"name": "als", "params": {"rank": 4}}]'))
    r.get_model_data_models().insert(mod_storage.Model("inst0", b"\x01" * 99))
    return r, app, ch


def _answers(r, app, ch):
    """Everything the lifecycle reads back, as plain data."""
    out = {
        "apps": [(a.id, a.name, a.description)
                 for a in r.get_meta_data_apps().get_all()],
        "channels": [(c.id, c.name, c.appid)
                     for c in r.get_meta_data_channels().get_by_appid(app)],
        "keys": [(k.key, k.appid, tuple(k.events))
                 for k in r.get_meta_data_access_keys().get_by_appid(app)],
        "instances": sorted(
            (i.id, i.status, i.start_time, i.end_time, i.engine_factory,
             dict(i.runtime_conf), i.algorithms_params)
            for i in r.get_meta_data_engine_instances().get_all()),
        "latest": r.get_meta_data_engine_instances().get_latest_completed(
            "default", "default", "default").id,
        "blob": r.get_model_data_models().get("inst0").models,
    }
    store = r.get_events()
    for n, case in enumerate(FIND_CASES):
        for c in (None, ch):
            out[(n, c)] = [e.to_api_json() for e in store.find(app, c, **case)]
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same content written once by each package, each in its own
    sqlite file: {writer: (config, app id, channel id)}."""
    out = {}
    for name, mod_storage, event_mod in (("jax", jst, jev),
                                         ("port", pst, pev)):
        path = tmp_path_factory.mktemp(name) / "pio.db"
        config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
                  "PIO_STORAGE_SOURCES_PIO_PATH": str(path)}
        r, app, ch = _fill(mod_storage, event_mod, config)
        r.close()
        out[name] = (config, app, ch)
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", range(len(FIND_CASES)))
def test_find_agrees_across_packages(written, writer, case):
    """One package wrote the file; both read it: the same events, in
    the same order, in both channels."""
    config, app, ch = written[writer]
    readers = [jreg.StorageRegistry(config), preg.StorageRegistry(config)]
    for c in (None, ch):
        got = [[e.to_api_json() for e in r.get_events().find(
            app, c, **FIND_CASES[case])] for r in readers]
        assert got[0] == got[1]
    for r in readers:
        r.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metadata_agrees_across_packages(written, writer):
    config, app, ch = written[writer]
    jr, pr = jreg.StorageRegistry(config), preg.StorageRegistry(config)
    want, got = _answers(jr, app, ch), _answers(pr, app, ch)
    assert got == want
    assert got["latest"] == "inst0" and got["blob"] == b"\x01" * 99
    # the port's writes move the store's ingest watermark, which the JAX
    # package's prepared-data cache keys on (app "other" holds no events
    # the other tests read)
    other = app + 1
    before = jr.get_events().ingest_watermark(other)
    pr.get_events().insert(pev.Event("view", "user", "u9", event_time=T0),
                           other)
    assert jr.get_events().ingest_watermark(other)["gen"] \
        == before["gen"] + 1
    jr.close()
    pr.close()


def test_both_writers_give_the_same_store(written):
    """The two files, each read by the port, answer alike (event ids
    drawn at insert aside)."""
    def strip(a):
        return {k: ([{f: v for f, v in e.items() if f != "eventId"}
                     for e in x] if isinstance(k, tuple) else x)
                for k, x in a.items()}

    answers = [strip(_answers(preg.StorageRegistry(written[w][0]),
                              *written[w][1:])) for w in ("jax", "port")]
    assert answers[0] == answers[1]


# -- watermarks and the file-backed event drivers -------------------------------

EVENT_DRIVERS = {
    "MEM": lambda tmp: {"PIO_STORAGE_SOURCES_S_TYPE": "MEM"},
    "SQLITE": lambda tmp: _config("SQLITE", tmp),
    "EVLOG": lambda tmp: {"PIO_STORAGE_SOURCES_S_TYPE": "EVLOG",
                          "PIO_STORAGE_SOURCES_S_PATH": str(tmp / "ev")},
    "PEVLOG": lambda tmp: {"PIO_STORAGE_SOURCES_S_TYPE": "PEVLOG",
                           "PIO_STORAGE_SOURCES_S_PATH": str(tmp / "pev"),
                           "PIO_STORAGE_SOURCES_S_BUCKET_HOURS": "1"},
}


@pytest.mark.parametrize("kind", sorted(EVENT_DRIVERS))
def test_ingest_watermark_moves_on_every_write(kind, tmp_path):
    """SQLITE's generation counter and PEVLOG's journal byte offsets
    change with every insert and delete (PEVLOG: a delete grows only
    tombstones.log); MEM and EVLOG have none (no cache, no delta), as
    in the JAX package. The cache directory follows the driver."""
    r = preg.StorageRegistry(EVENT_DRIVERS[kind](tmp_path))
    store = r.get_events()
    store.init(1)
    marks = [store.ingest_watermark(1)]
    e = pev.Event("rate", "user", "u1", "item", "i1",
                  pev.DataMap({"rating": 2.0}), event_time=T0)
    eid = store.insert(e, 1)
    marks.append(store.ingest_watermark(1))
    store.insert_batch([e, replace(e, event_time=T0 + timedelta(hours=3))],
                       1)
    marks.append(store.ingest_watermark(1))
    assert store.delete(eid, 1)
    marks.append(store.ingest_watermark(1))
    cache_dir = store.ingest_cache_dir(1)
    if kind in ("MEM", "EVLOG"):
        assert marks == [None] * 4 and cache_dir is None
    elif kind == "SQLITE":
        assert [m["gen"] for m in marks] == [0, 1, 2, 3]
        assert str(cache_dir) == str(tmp_path / "ingest_cache" / "events_1")
    else:
        assert len(set(map(str, marks))) == 4
        segs = sorted(k for k in marks[2] if k.startswith("seg_"))
        assert len(segs) == 2 and marks[0]["tombstones.log"] == 0
        assert {k: v for k, v in marks[3].items()
                if k != "tombstones.log"} == {
            k: v for k, v in marks[2].items() if k != "tombstones.log"}
        assert marks[3]["tombstones.log"] > 0
        assert cache_dir == tmp_path / "pev" / "app_1" / "_prepared"
    if kind != "PEVLOG":
        with pytest.raises(pst.base.DeltaInvalidated):
            store.scan_columns(1, since=marks[0] or {}, upto=marks[1])
    r.close()


def test_pevlog_fsck_finds_and_repairs_a_torn_tail(tmp_path):
    r = preg.StorageRegistry(EVENT_DRIVERS["PEVLOG"](tmp_path))
    store = r.get_events()
    store.insert(pev.Event("view", "user", "u1", event_time=T0), 1)
    store.close()
    seg, = (tmp_path / "pev" / "app_1").glob("seg_*.log")
    with open(seg, "ab") as f:
        f.write(b"PIOE\x05")
    found = store.fsck()
    assert [x["kind"] for x in found] == ["torn_tail", "stale_index"]
    # the truncation brings the journal back to what the sidecar covers
    assert [x["kind"] for x in store.fsck(repair=True)] == ["torn_tail"]
    assert store.fsck() == []
    assert [e.entity_id for e in store.find(1)] == ["u1"]
