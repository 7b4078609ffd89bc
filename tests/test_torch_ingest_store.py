"""The port's columnar training read (`data.store.rating_columns` ->
`ingest.pipeline.rating_columns_from_store`) against the JAX package's:
bit-identical arrays and id maps on the cases that decide the factor
rows: the template's `rate` + `buy` value spec, duplicate pairs (the
last by event time wins, then the last inserted), events without a
target, other event names, channels, entity and target types, time
ranges and fixed `BiMap`s. Both packages read one sqlite file the JAX
package wrote, one PEVLOG directory it wrote (serially and on the scan
worker pool), and each its own MEM store holding the same events. Then
the prepared-data cache: a blob either package wrote is a hit in the
other, and its knobs (off, a directory, the newest-N bound) and a
corrupt blob behave as in the JAX package."""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.data import event as jev
from predictionio_tpu.data import storage as jst
from predictionio_tpu.data import store as jstore
from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.ingest.arrays import RatingColumns as JRatingColumns
from predictionio_tpu_torch.data import event as pev
from predictionio_tpu_torch.data import storage as pst
from predictionio_tpu_torch.data.storage import base as pbase
from predictionio_tpu_torch.data import store as pstore
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap

pytestmark = pytest.mark.torch

T0 = datetime(2022, 1, 1, tzinfo=timezone.utc)
TEMPLATE = dict(event_names=["rate", "buy"],
                value_spec={"rate": ("prop", "rating"), "buy": 4.0},
                dedup_last_wins=True)


def _events(mod, seed=0, n=600):
    """Random user/item events: rate (some without a rating), buy,
    view (no target), like; ties in time; repeated pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        u, i = int(rng.integers(0, 30)), int(rng.integers(0, 40))
        t = T0 + timedelta(milliseconds=int(rng.integers(0, 200)) * 7)
        kind = int(rng.integers(0, 10))
        props = {}
        if kind < 6:
            name = "rate"
            if k % 13:
                props = {"rating": float(rng.integers(1, 11)) / 2}
        elif kind < 8:
            name = "buy"
        elif kind < 9:
            out.append(mod.Event("view", "user", f"u{u}", event_time=t,
                                 creation_time=T0))
            continue
        else:
            name = "like"
        target = ("item", f"i{i}") if k % 17 else ("movie", f"m{i}")
        etype = "user" if k % 19 else "customer"
        out.append(mod.Event(name, etype, f"u{u}", *target,
                             mod.DataMap(props), t, creation_time=T0))
    return out


def _fill(storage_mod, event_mod, config):
    r = storage_mod.StorageRegistry(config)
    app = r.get_meta_data_apps().insert(storage_mod.App(0, "shop"))
    ch = r.get_meta_data_channels().insert(storage_mod.Channel(0, "web", app))
    store = r.get_events()
    events = _events(event_mod)
    store.insert_batch(events[:300], app)
    for e in events[300:]:
        store.insert(e, app)
    store.insert_batch(_events(event_mod, seed=1, n=200), app, ch)
    return r


USERS = ["u3", "u1", "u7", "zz", "u0"]
ITEMS = ["i5", "i0", "i9", "nope", "i11", "i2"]
CASES = {
    "template": dict(TEMPLATE),
    "template_channel": dict(TEMPLATE, channel="web"),
    "rate_keep_duplicates": dict(event_names=["rate"],
                                 value_spec={"rate": ("prop", "rating")}),
    "every_event_counts_one": dict(),
    "prop_or_default": dict(value_spec={"*": ("prop_or", "rating", 2.5)},
                            dedup_last_wins=True),
    "types": dict(TEMPLATE, entity_type="user", target_entity_type="item"),
    "time_range": dict(TEMPLATE, start_time=T0 + timedelta(milliseconds=350),
                       until_time=T0 + timedelta(milliseconds=1050)),
    "fixed_users": dict(TEMPLATE, users=USERS),
    "fixed_both": dict(event_names=["rate", "like"],
                       value_spec={"rate": ("prop", "rating"), "like": 1.0},
                       users=USERS, items=ITEMS, dedup_last_wins=True),
}


def _read(pkg, registry, case):
    kw = dict(CASES[case])
    channel = kw.pop("channel", None)
    bimap = JBiMap if pkg == "jax" else BiMap
    for side in ("users", "items"):
        if side in kw:
            kw[side] = bimap.from_keys(kw[side])
    read = (jstore if pkg == "jax" else pstore).rating_columns
    return read(registry, "shop", channel, **kw)


def _same(a, b):
    for f in ("user_ix", "item_ix", "rating", "t_millis"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.users.keys() == b.users.keys()
    assert a.items.keys() == b.items.keys()


@pytest.fixture(scope="module")
def sqlite_config(tmp_path_factory):
    config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_PIO_PATH": str(
                  tmp_path_factory.mktemp("ingest") / "pio.db"),
              "PIO_INGEST_CACHE": "off"}
    _fill(jst, jev, config).close()
    return config


@pytest.mark.parametrize("case", sorted(CASES))
def test_sqlite_rating_columns_are_bit_identical(sqlite_config, case,
                                                 monkeypatch):
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    got = _read("port", pst.StorageRegistry(sqlite_config), case)
    want = _read("jax", jst.StorageRegistry(sqlite_config), case)
    _same(got, want)
    assert got.n > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_mem_rating_columns_are_bit_identical(case):
    mem = {"PIO_STORAGE_SOURCES_M_TYPE": "MEM"}
    got = _read("port", _fill(pst, pev, mem), case)
    want = _read("jax", _fill(jst, jev, mem), case)
    _same(got, want)


def test_template_dedup_keeps_the_last_rating():
    """A pair rated three times, twice in the same millisecond: the
    last inserted of the latest time wins, at the pair's first row."""
    mem = {"PIO_STORAGE_SOURCES_M_TYPE": "MEM"}
    out = []
    for storage_mod, event_mod, read in ((pst, pev, pstore),
                                         (jst, jev, jstore)):
        r = storage_mod.StorageRegistry(mem)
        app = r.get_meta_data_apps().insert(storage_mod.App(0, "shop"))
        E, D = event_mod.Event, event_mod.DataMap
        t1 = T0 + timedelta(seconds=1)
        r.get_events().insert_batch([
            E("rate", "user", "a", "item", "x", D({"rating": 1.0}), T0),
            E("rate", "user", "b", "item", "x", D({"rating": 2.0}), T0),
            E("rate", "user", "a", "item", "x", D({"rating": 3.0}), t1),
            E("buy", "user", "a", "item", "x", D({}), t1),
            E("rate", "user", "a", "item", "x", D({"rating": 5.0}),
              T0 + timedelta(milliseconds=500)),
        ], app)
        out.append(read.rating_columns(r, "shop", **TEMPLATE))
    _same(*out)
    got = out[0]
    assert got.users.keys() == ["a", "b"] and got.rating.tolist() == [4.0,
                                                                      2.0]


@pytest.mark.parametrize("case", ["template", "types", "fixed_both"])
def test_columnar_read_equals_the_event_path(sqlite_config, case):
    """`from_store` equals `from_events` over `find` with the matching
    `rating_of`, in the port as in the JAX package."""
    kw = dict(CASES[case])
    registry = pst.StorageRegistry(sqlite_config)
    spec = kw.pop("value_spec")
    names = kw.pop("event_names")
    fixed = {s: BiMap.from_keys(kw.pop(s)) for s in ("users", "items")
             if s in kw}
    dedup = kw.pop("dedup_last_wins")

    def rating_of(e):
        ent = spec.get(e.event)
        if ent is None:
            return None
        if isinstance(ent, float):
            return ent
        v = e.properties.get_opt("rating")
        return None if v is None else float(v)

    found = pstore.find_events(registry, "shop", event_names=names, **kw)
    by_events = RatingColumns.from_events(found, rating_of=rating_of,
                                          dedup_last_wins=dedup, **fixed)
    got = _read("port", registry, case)
    _same(got, by_events)
    jfound = jstore.find_events(jst.StorageRegistry(sqlite_config), "shop",
                                event_names=names, **kw)
    jfixed = {s: JBiMap.from_keys(b.keys()) for s, b in fixed.items()}
    _same(by_events, JRatingColumns.from_events(
        jfound, rating_of=rating_of, dedup_last_wins=dedup, **jfixed))


SCANS = {
    "every_event": dict(require_target=False),
    "every_event_with_target": dict(),
    "template": dict(event_names=["rate", "buy"],
                     value_spec=TEMPLATE["value_spec"]),
    "template_channel": dict(channel=True, event_names=["rate", "buy"],
                             value_spec=TEMPLATE["value_spec"]),
    "prop_or_no_target": dict(require_target=False,
                              value_spec={"*": ("prop_or", "rating", 2.5)}),
    "only_without_target": dict(target_entity_type=None,
                                target_entity_id=None, require_target=False),
    "types_and_time": dict(entity_type="user", target_entity_type="item",
                           start_time=T0 + timedelta(milliseconds=350),
                           until_time=T0 + timedelta(milliseconds=1050),
                           value_spec={"rate": ("prop", "rating")}),
    "one_entity": dict(entity_id="u3", require_target=False),
    "one_target": dict(target_entity_type="item", target_entity_id="i5"),
    "properties": dict(properties={"rating": 2.5},
                       value_spec={"rate": ("prop", "rating")}),
}


@pytest.mark.parametrize("case", sorted(SCANS))
def test_sqlite_scan_equals_the_base_adapter(sqlite_config, case):
    """The sqlite driver's SQL scan gives the base adapter's columns
    over `find()`, in row order and table order."""
    r = pst.StorageRegistry(sqlite_config)
    app = r.get_meta_data_apps().get_by_name("shop").id
    kw = dict(SCANS[case])
    channel = (r.get_meta_data_channels().get_by_appid(app)[0].id
               if kw.pop("channel", False) else None)
    events = r.get_events()
    got = events.scan_columns(app, channel, **kw)
    want = pbase.EventStore.scan_columns(events, app, channel, **kw)
    for f in ("entity_ix", "target_ix", "value", "t_us"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (got.entities, got.targets) == (want.entities, want.targets)
    assert got.n > 0
    with pytest.raises(pbase.DeltaInvalidated):
        events.scan_columns(app, channel, since={"gen": 0}, **kw)
    r.close()


def test_unknown_app_and_channel_raise():
    r = pst.StorageRegistry({"PIO_STORAGE_SOURCES_M_TYPE": "MEM"})
    with pytest.raises(pstore.AppNotFoundError, match="nope"):
        pstore.rating_columns(r, "nope")
    r.get_meta_data_apps().insert(pst.App(0, "shop"))
    with pytest.raises(pstore.AppNotFoundError, match="Channel"):
        pstore.rating_columns(r, "shop", "web")
    empty = pstore.rating_columns(r, "shop", **TEMPLATE)
    assert empty.n == 0 and len(empty.users) == 0


# -- PEVLOG ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pevlog_config(tmp_path_factory):
    """SQLITE metadata and PEVLOG events, written by the JAX package."""
    root = tmp_path_factory.mktemp("pevlog")
    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.db"),
              "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
              "PIO_STORAGE_SOURCES_PEV_PATH": str(root / "pevlog"),
              "PIO_STORAGE_SOURCES_PEV_BUCKET_HOURS": "1",
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV"}
    _fill(jst, jev, config).close()
    return config


@pytest.mark.parametrize("case", sorted(CASES))
def test_pevlog_rating_columns_are_bit_identical(pevlog_config, case,
                                                 monkeypatch):
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    got = _read("port", pst.StorageRegistry(pevlog_config), case)
    want = _read("jax", jst.StorageRegistry(pevlog_config), case)
    _same(got, want)


@pytest.mark.parametrize("case", sorted(SCANS))
def test_pevlog_scan_equals_the_event_path_and_the_jax_scan(pevlog_config,
                                                            case):
    """PEVLOG's raw-frame scan gives the base adapter's columns over
    `find()` and the JAX package's PEVLOG scan, row for row."""
    kw = dict(SCANS[case])
    want_channel = kw.pop("channel", False)
    out = []
    for mod in (pst, jst):
        r = mod.StorageRegistry(pevlog_config)
        app = r.get_meta_data_apps().get_by_name("shop").id
        channel = (r.get_meta_data_channels().get_by_appid(app)[0].id
                   if want_channel else None)
        out.append((r.get_events(), app, channel))
    (events, app, channel), (jevents, _, _) = out
    got = events.scan_columns(app, channel, **kw)
    for want in (pbase.EventStore.scan_columns(events, app, channel, **kw),
                 jevents.scan_columns(app, channel, **kw)):
        for f in ("entity_ix", "target_ix", "value", "t_us"):
            x, y = getattr(got, f), getattr(want, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (got.entities, got.targets) == (want.entities, want.targets)
    assert got.n > 0


def test_pevlog_scan_on_the_worker_pool_is_reused(pevlog_config,
                                                  monkeypatch):
    """`workers=2` decodes on a spawn-started pool: the same columns as
    the serial scan, and one pool for both scans."""
    from predictionio_tpu_torch.data.storage import pevlog as ppev
    monkeypatch.setattr(ppev, "_SCAN_POOL", None)
    monkeypatch.setattr(ppev, "_SCAN_POOL_PROCS", 0)
    monkeypatch.setattr(ppev, "POOL_SPAWNS", 0)
    r = pst.StorageRegistry(pevlog_config)
    app = r.get_meta_data_apps().get_by_name("shop").id
    try:
        for _ in range(2):
            events = pst.StorageRegistry(pevlog_config).get_events()
            pooled = events.scan_columns(app, workers=2,
                                         **SCANS["template"])
            serial = events.scan_columns(app, workers=1,
                                         **SCANS["template"])
            for f in ("entity_ix", "target_ix", "value", "t_us"):
                assert np.array_equal(getattr(pooled, f),
                                      getattr(serial, f))
        assert ppev.POOL_SPAWNS == 1 and ppev._SCAN_POOL_PROCS == 2
    finally:
        if ppev._SCAN_POOL is not None:
            ppev._SCAN_POOL.shutdown(wait=True)


# -- the prepared-data cache ----------------------------------------------------

@pytest.fixture()
def cached_sqlite(tmp_path, monkeypatch):
    """A sqlite store the JAX package filled, caching on (default
    directory: `ingest_cache/<table>` beside the database)."""
    monkeypatch.delenv("PIO_INGEST_CACHE", raising=False)
    monkeypatch.delenv("PIO_INGEST_CACHE_MAX", raising=False)
    config = {"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db")}
    _fill(jst, jev, config).close()
    from predictionio_tpu.ingest import pipeline as jpipe
    from predictionio_tpu_torch.ingest import pipeline as ppipe
    jpipe.take_phase_timings()
    ppipe.take_phase_timings()
    return config, tmp_path, {"jax": jpipe, "port": ppipe}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_prepared_cache_is_shared_by_the_packages(cached_sqlite,
                                                         writer):
    config, root, pipes = cached_sqlite
    other = "port" if writer == "jax" else "jax"
    mods = {"jax": jst, "port": pst}
    first = _read(writer, mods[writer].StorageRegistry(config), "template")
    assert pipes[writer].take_phase_timings()["ingest_cache_misses"] == 1
    assert len(list((root / "ingest_cache").rglob("*.pioc"))) == 1
    r = mods[other].StorageRegistry(config)
    second = _read(other, r, "template")
    tm = pipes[other].take_phase_timings()
    assert tm.get("ingest_cache_hits") == 1 and "ingest_scan_s" not in tm
    _same(first, second)
    ev = jev if other == "jax" else pev
    app = r.get_meta_data_apps().get_by_name("shop").id
    r.get_events().insert(ev.Event("rate", "user", "u1", "item", "i1",
                                   ev.DataMap({"rating": 1.0}), T0), app)
    third = _read(other, r, "template")
    assert pipes[other].take_phase_timings()["ingest_cache_misses"] == 1
    assert third.rating.tolist() != first.rating.tolist()


@pytest.mark.parametrize("knob", ["off", "directory", "max_entries",
                                  "corrupt_blob", "mem_store"])
def test_prepared_cache_knobs(cached_sqlite, knob, monkeypatch, tmp_path):
    config, root, pipes = cached_sqlite
    ppipe = pipes["port"]
    registry = pst.StorageRegistry(config)
    want = _read("port", registry, "template")   # a miss: the blob
    ppipe.take_phase_timings()
    blobs = list((root / "ingest_cache").rglob("*.pioc"))
    assert len(blobs) == 1
    if knob == "off":
        monkeypatch.setenv("PIO_INGEST_CACHE", "off")
        _same(_read("port", registry, "template"), want)
        tm = ppipe.take_phase_timings()
        assert "ingest_cache_hits" not in tm and "ingest_scan_s" in tm
    elif knob == "directory":
        where = tmp_path / "elsewhere"
        monkeypatch.setenv("PIO_INGEST_CACHE", str(where))
        _same(_read("port", registry, "template"), want)
        assert len(list(where.glob("*.pioc"))) == 1
        _same(_read("port", registry, "template"), want)
        tm = ppipe.take_phase_timings()
        assert (tm["ingest_cache_misses"], tm["ingest_cache_hits"]) == (1, 1)
    elif knob == "max_entries":
        monkeypatch.setenv("PIO_INGEST_CACHE_MAX", "2")
        for case in ("rate_keep_duplicates", "every_event_counts_one",
                     "types"):
            _read("port", registry, case)
        assert len(list((root / "ingest_cache").rglob("*.pioc"))) == 2
    elif knob == "corrupt_blob":
        raw = blobs[0].read_bytes()
        blobs[0].write_bytes(raw[:-3] + b"XYZ")
        _same(_read("port", registry, "template"), want)
        assert ppipe.take_phase_timings()["ingest_cache_misses"] == 1
        _same(_read("port", registry, "template"), want)
        assert ppipe.take_phase_timings()["ingest_cache_hits"] == 1
    else:
        mem = {"PIO_STORAGE_SOURCES_M_TYPE": "MEM"}
        _read("port", _fill(pst, pev, mem), "template")
        tm = ppipe.take_phase_timings()
        assert "ingest_cache_misses" not in tm and "ingest_scan_s" in tm
