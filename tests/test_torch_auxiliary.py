"""The port's data and core modules that read the columnar path, held to
the JAX package's on the same events, on the CPU:

  - `core/selfclean.py` (`parse_duration`, `EventWindow`,
    `SelfCleaningDataSource.cleaned_events`, `clean_persisted_events`):
    the cleaned events equal the JAX ones as API-JSON;
  - `core/fakeworkflow.py` (`fake_run`): the same evaluation instance
    rows;
  - `PairColumns`, `ingest.pipeline.pair_columns_from_store` and
    `data.store.pair_columns`: arrays and tables bit-identical to the
    JAX ones over one PEVLOG store;
  - `data/entitymap.py` (`EntityIdIxMap`, `EntityMap`,
    `entity_map_from_properties`);
  - `data/view.py` (`DataView`): its parquet cache reused within the
    TTL, rematerialized past it, read back by both packages' `import`;
  - `cli run` of a dotted function and `cli shell` fed on stdin, each
    printing what the JAX command prints.

It mirrors `tests/test_auxiliary.py` (self-cleaning, FakeWorkflow),
`tests/test_ingest.py::TestPairColumns` and `TestEntityMap`,
`tests/test_ingest_pipeline.py::test_pair_columns_match` and
`tests/test_view.py`.
"""

import io
import json
import os
import signal
import sys
from contextlib import redirect_stdout
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from predictionio_tpu.cli import main as jmain
from predictionio_tpu.cli.ops import import_events as jimport_events
from predictionio_tpu.core import RuntimeContext as JContext
from predictionio_tpu.core.fakeworkflow import fake_run as jfake_run
from predictionio_tpu.core.selfclean import EventWindow as JEventWindow
from predictionio_tpu.core.selfclean import \
    SelfCleaningDataSource as JSelfCleaning
from predictionio_tpu.data import DataMap as JDataMap
from predictionio_tpu.data import Event as JEvent
from predictionio_tpu.data.entitymap import EntityMap as JEntityMap
from predictionio_tpu.data.entitymap import \
    entity_map_from_properties as jentity_map_from_properties
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.data.storage import set_default as jset_default
from predictionio_tpu.data.storage.pevlog import (
    PevlogEvents as JPevlogEvents, PevlogStorageClient as JPevlogClient)
from predictionio_tpu.data.view import DataView as JDataView
from predictionio_tpu.ingest.arrays import PairColumns as JPairColumns
from predictionio_tpu.ingest.pipeline import \
    pair_columns_from_store as jpair_columns_from_store
from predictionio_tpu_torch.cli import main as pmain
from predictionio_tpu_torch.cli.ops import import_events
from predictionio_tpu_torch.core.fakeworkflow import fake_run
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.selfclean import (EventWindow,
                                                   SelfCleaningDataSource,
                                                   parse_duration)
from predictionio_tpu_torch.data import DataView
from predictionio_tpu_torch.data import store as pstore
from predictionio_tpu_torch.data.entitymap import (EntityMap,
                                                   entity_map_from_properties)
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import App, StorageRegistry
from predictionio_tpu_torch.data.storage import set_default
from predictionio_tpu_torch.data.storage.base import EvaluationInstanceStatus
from predictionio_tpu_torch.data.storage.pevlog import (PevlogEvents,
                                                        PevlogStorageClient)
from predictionio_tpu_torch.ingest import PairColumns
from predictionio_tpu_torch.ingest.pipeline import pair_columns_from_store

pytestmark = pytest.mark.torch

T0 = datetime(2023, 5, 1, tzinfo=timezone.utc)
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError("test exceeded its 60-s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(60)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    set_default(None)
    jset_default(None)


def both(event, eid, props=None, t=None, event_id=None, tid=None,
         etype="user"):
    """One event in each package, from the same fields."""
    kw = dict(event=event, entity_type=etype, entity_id=eid,
              target_entity_type="item" if tid else None,
              target_entity_id=tid, event_time=t or T0, event_id=event_id,
              creation_time=T0)
    return (Event(properties=DataMap(props or {}), **kw),
            JEvent(properties=JDataMap(props or {}), **kw))


def api(events) -> list:
    """API-JSON of events; a new event's (a compressed `$set`) creation
    time is the wall clock's, so it is left out."""
    out = []
    for e in events:
        d = e.to_api_json()
        if not e.event_id:
            d.pop("creationTime", None)
        out.append(d)
    return out


def registries():
    """A port MEM registry and a JAX one."""
    return StorageRegistry(MEM), JRegistry(MEM)


# -- self-cleaning (test_auxiliary.py) -------------------------------------------

class Cleaner(SelfCleaningDataSource):
    def __init__(self, app_name, window):
        self.app_name = app_name
        self.event_window = window


class JCleaner(JSelfCleaning):
    def __init__(self, app_name, window):
        self.app_name = app_name
        self.event_window = window


def clean_both(window: dict, pairs, now):
    ours = Cleaner("x", EventWindow(**window)).cleaned_events(
        [p for p, _ in pairs], now=now)
    theirs = JCleaner("x", JEventWindow(**window)).cleaned_events(
        [j for _, j in pairs], now=now)
    assert api(ours) == api(theirs)
    return ours


def test_parse_duration_formats():
    from predictionio_tpu.core.selfclean import parse_duration as jparse
    for s in ("3 days", "12h", 90, "1 week", "45 minutes", "7s"):
        assert parse_duration(s) == jparse(s)
    assert parse_duration("3 days") == timedelta(days=3)
    assert parse_duration(90) == timedelta(seconds=90)
    with pytest.raises(ValueError):
        parse_duration("three days")


def test_window_filter_exempts_set_events():
    now = T0 + timedelta(days=20)
    old = now - timedelta(days=10)
    pairs = [both("view", "u1", t=old), both("$set", "u1", {"a": 1}, t=old),
             both("view", "u2", t=now)]
    out = clean_both({"duration": "1 day"}, pairs, now)
    assert {e.event for e in out} == {"$set", "view"} and len(out) == 2


def test_compress_set_unset_chain():
    pairs = [both("$set", "u1", {"a": 1, "b": 2}, t=T0),
             both("$unset", "u1", {"b": None}, t=T0 + timedelta(seconds=1)),
             both("$set", "u1", {"c": 3}, t=T0 + timedelta(seconds=2)),
             both("view", "u1", t=T0)]
    out = clean_both({"compress_properties": True}, pairs, T0)
    sets = [e for e in out if e.event == "$set"]
    assert len(sets) == 1
    assert dict(sets[0].properties.items()) == {"a": 1, "c": 3}


def test_remove_duplicates_keeps_first():
    pairs = [both("view", "u1", t=T0, event_id="e1"),
             both("view", "u1", t=T0 + timedelta(seconds=5), event_id="e2"),
             both("view", "u2", t=T0, event_id="e3")]
    out = clean_both({"remove_duplicates": True}, pairs, T0)
    assert {e.event_id for e in out} == {"e1", "e3"}


def test_all_three_at_once_and_no_window():
    rng = np.random.default_rng(4)
    pairs = []
    for k in range(60):
        name = ("view", "$set", "buy", "$unset")[int(rng.integers(4))]
        props = ({f"p{int(rng.integers(3))}": int(rng.integers(9))}
                 if name.startswith("$") else {})
        pairs.append(both(name, f"u{int(rng.integers(5))}", props,
                          t=T0 + timedelta(hours=int(rng.integers(96))),
                          event_id=f"e{k}",
                          tid=None if name.startswith("$") else
                          f"i{int(rng.integers(4))}"))
    clean_both({"duration": "2 days", "remove_duplicates": True,
                "compress_properties": True}, pairs,
               T0 + timedelta(days=4))
    events = [p for p, _ in pairs]
    assert Cleaner("x", None).cleaned_events(events) == events


def test_clean_persisted_events():
    now = T0 + timedelta(days=60)
    rows = []
    for (reg, app_cls, ev_i) in zip(registries(), (App, JApp), (0, 1)):
        app_id = reg.get_meta_data_apps().insert(app_cls(0, "cleanapp"))
        events = reg.get_events()
        events.init(app_id)
        for args in (("view", "u1", None, now - timedelta(days=30)),
                     ("view", "u1", None, now),
                     ("$set", "u1", {"a": 1}, now - timedelta(days=30)),
                     ("$set", "u1", {"b": 2}, now)):
            events.insert(both(args[0], args[1], args[2], t=args[3])[ev_i],
                          app_id)
        cleaner = (Cleaner if ev_i == 0 else JCleaner)(
            "cleanapp", (EventWindow if ev_i == 0 else JEventWindow)(
                duration="7 days", compress_properties=True))
        ctx = (RuntimeContext if ev_i == 0 else JContext)(registry=reg)
        removed = cleaner.clean_persisted_events(ctx, now=now)
        left = sorted(({k: v for k, v in d.items()
                        if k not in ("eventId", "creationTime")}
                       for d in (e.to_api_json()
                                 for e in events.find(app_id))),
                      key=json.dumps)
        rows.append((removed, left))
    assert rows[0] == rows[1]
    removed, left = rows[0]
    assert removed >= 2
    assert [d["properties"] for d in left if d["event"] == "$set"] == [
        {"a": 1, "b": 2}]


# -- FakeWorkflow (test_auxiliary.py) -------------------------------------------

def test_fake_run_records_instances_as_the_jax_package():
    out = []
    for (reg, run, ctx_cls) in zip(registries(), (fake_run, jfake_run),
                                   (RuntimeContext, JContext)):
        ctx = ctx_cls(registry=reg)
        assert run(lambda c: 41 + 1, ctx, label="MyFake") == 42

        def boom(c):
            raise RuntimeError("nope")

        with pytest.raises(RuntimeError):
            run(boom, ctx)
        dao = reg.get_meta_data_evaluation_instances()
        out.append(sorted((r.evaluation_class, r.status,
                           r.evaluator_results) for r in dao.get_all()))
        done, = dao.get_completed()
        assert done.evaluation_class == "MyFake"
        assert done.evaluator_results == "42"
    assert out[0] == out[1]
    assert sum(s == EvaluationInstanceStatus.COMPLETED
               for _, s, _ in out[0]) == 1


# -- PairColumns (test_ingest.py, test_ingest_pipeline.py) ----------------------

def assert_pairs_equal(ours, theirs):
    for name in ("left_ix", "right_ix", "weight"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ours.left.keys() == theirs.left.keys()
    assert ours.right.keys() == theirs.right.keys()
    assert ours.n == theirs.n


def test_pairs_from_events():
    pairs = [both("view", "u1", tid="i1"), both("view", "u1", tid="i2"),
             both("view", "u2", tid="i1"), both("view", "u3")]
    pc = PairColumns.from_events([p for p, _ in pairs])
    assert pc.n == 3 and pc.weight.tolist() == [1.0, 1.0, 1.0]
    assert_pairs_equal(pc, JPairColumns.from_events([j for _, j in pairs]))
    w = (lambda e: None if e.entity_id == "u2" else 2.5)
    assert_pairs_equal(
        PairColumns.from_events([p for p, _ in pairs], weight_of=w),
        JPairColumns.from_events([j for _, j in pairs], weight_of=w))


def _seed_pevlog(tmp_path):
    """Views, rates and buys over six days in a PEVLOG directory (the
    JAX test's `_seed`), written by the port."""
    ev = PevlogEvents(PevlogStorageClient(
        {"PATH": str(tmp_path), "BUCKET_HOURS": 24}))
    ev.init(1)
    rng = np.random.RandomState(3)
    evs = []
    for k in range(240):
        name = ("rate", "buy", "view")[k % 3]
        evs.append(Event(
            event=name, entity_type="user",
            entity_id=f"u{rng.randint(12)}", target_entity_type="item",
            target_entity_id=f"i{rng.randint(9)}",
            properties=DataMap({"rating": float(1 + k % 5)}
                               if name == "rate" else {}),
            event_time=T0 + timedelta(days=k // 40, seconds=k)))
    ev.insert_batch(evs, 1)
    return ev, JPevlogEvents(JPevlogClient(
        {"PATH": str(tmp_path), "BUCKET_HOURS": 24}))


@pytest.mark.parametrize("kw", [
    dict(event_names=["view"]),
    dict(event_names=["view", "buy"], value_spec={"buy": 2.0, "*": 1.0}),
    dict(value_spec={"rate": ("prop", "rating")},
         start_time=T0 + timedelta(days=1),
         until_time=T0 + timedelta(days=4))],
    ids=["views", "weighted", "window"])
def test_pair_columns_match(tmp_path, monkeypatch, kw):
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    ev, jev = _seed_pevlog(tmp_path)
    ours = pair_columns_from_store(ev, 1, **kw)
    theirs = jpair_columns_from_store(jev, 1, cache=False, **kw)
    assert ours.n > 0
    assert_pairs_equal(ours, theirs)
    if list(kw) == ["event_names"]:
        assert_pairs_equal(ours, PairColumns.from_events(
            ev.find(1, event_names=["view"])))
    fixed = pair_columns_from_store(ev, 1, left=ours.left,
                                    right=theirs.right, **kw)
    assert_pairs_equal(fixed, ours)


def test_store_pair_columns_facade(tmp_path, monkeypatch):
    from predictionio_tpu.data import store as jstore
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    config = {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
    reg = StorageRegistry(config)
    app_id = reg.get_meta_data_apps().insert(App(0, "shop"))
    reg.get_events().init(app_id)
    reg.get_events().insert_batch(
        [both("view", f"u{k % 5}", t=T0 + timedelta(minutes=k),
              tid=f"i{k % 7}")[0] for k in range(50)], app_id)
    jreg = JRegistry(config)
    assert_pairs_equal(pstore.pair_columns(reg, "shop"),
                       jstore.pair_columns(jreg, "shop", cache=False))
    reg.close()
    jreg.close()


# -- EntityMap (test_ingest.py) -------------------------------------------------

def test_entity_map_apply_get_contains_ix():
    data = {"a": 1, "b": 2, "c": 3}
    em, jem = EntityMap(data), JEntityMap(data)
    assert em("b") == jem("b") == 2
    assert em.get("zz") is None and em.get("zz", 9) == 9
    assert "c" in em and "zz" not in em and len(em) == len(jem) == 3
    with pytest.raises(KeyError):
        em("zz")
    assert [em.id_to_ix(k) for k in data] == [jem.id_to_ix(k) for k in data]
    assert em.id_to_ix.ix_to_id(2) == jem.id_to_ix.ix_to_id(2) == "c"
    assert em.by_ix(1) == jem.by_ix(1) == 2
    assert list(em) == list(jem) and dict(em.items()) == data
    assert em.id_to_ix.bimap.keys() == jem.id_to_ix.bimap.keys()


def test_entity_map_values_share_the_index():
    em = EntityMap({"x": 2, "y": 5})
    doubled = em.map_values(lambda v: v * 10)
    assert doubled("y") == 50 and doubled.id_to_ix is em.id_to_ix


def test_entity_map_from_aggregated_properties():
    maps = []
    for reg, app_cls, ev_i, build in zip(
            registries(), (App, JApp), (0, 1),
            (entity_map_from_properties, jentity_map_from_properties)):
        app_id = reg.get_meta_data_apps().insert(app_cls(0, "emapp"))
        store = reg.get_events()
        store.init(app_id)
        for k, (uid, age) in enumerate((("u1", 20), ("u2", 30),
                                         ("u1", 21))):
            store.insert(both("$set", uid, {"age": age},
                              t=T0 + timedelta(seconds=k))[ev_i], app_id)
        maps.append(build(reg, "emapp", entity_type="user",
                          extract=lambda pm: pm.get("age")))
    em, jem = maps
    assert dict(em.items()) == dict(jem.items()) == {"u1": 21, "u2": 30}
    assert em.id_to_ix.bimap.keys() == jem.id_to_ix.bimap.keys()


# -- DataView (test_view.py) ----------------------------------------------------

def view_app(app_name: str = "viewapp"):
    """The same app in a port and a JAX MEM registry."""
    out = []
    for reg, app_cls, ev_i in zip(registries(), (App, JApp), (0, 1)):
        app_id = reg.get_meta_data_apps().insert(app_cls(0, app_name))
        events = reg.get_events()
        events.init(app_id)
        events.insert_batch(
            [both("view", f"u{n % 3}", t=T0 + timedelta(hours=n),
                  tid=f"i{n % 5}")[ev_i] for n in range(20)]
            + [both("$set", "i1", {"price": 9.5}, t=T0,
                    etype="item")[ev_i]], app_id)
        out.append(reg)
    return out


def rows_of(events) -> list:
    return sorted((json.dumps({k: v for k, v in e.to_api_json().items()
                               if k not in ("eventId", "creationTime")},
                              sort_keys=True) for e in events))


def test_view_cache_reused_within_the_ttl(tmp_path):
    reg, _ = view_app()
    view = DataView(reg, "viewapp", cache_dir=str(tmp_path))
    assert view.events().num_rows == 21
    [f] = tmp_path.glob("view_*.parquet")
    mtime = f.stat().st_mtime
    assert view.events().num_rows == 21
    assert f.stat().st_mtime == mtime


def test_view_windows_key_separate_caches_with_the_jax_names(tmp_path):
    reg, jreg = view_app()
    kw = dict(start_time=T0 + timedelta(hours=5),
              until_time=T0 + timedelta(hours=10))
    assert DataView(reg, "viewapp", cache_dir=str(tmp_path / "p")).events(
        **kw).num_rows == 5
    JDataView(jreg, "viewapp", cache_dir=str(tmp_path / "j")).events(**kw)
    names = [sorted(p.name for p in (tmp_path / d).glob("view_*.parquet"))
             for d in ("p", "j")]
    assert names[0] == names[1] and len(names[0]) == 1
    DataView(reg, "viewapp", cache_dir=str(tmp_path / "p")).events()
    assert len(list((tmp_path / "p").glob("view_*.parquet"))) == 2


def test_view_refresh_and_ttl_expiry_rematerialize(tmp_path):
    reg, _ = view_app()
    view = DataView(reg, "viewapp", cache_dir=str(tmp_path))
    view.events()
    [f] = tmp_path.glob("view_*.parquet")
    old = f.stat().st_mtime - 10_000
    os.utime(f, (old, old))          # older than any TTL
    reg.get_events().insert(both("view", "u9", t=T0)[0], 1)
    assert view.events(ttl_seconds=3600).num_rows == 22
    reg.get_events().insert(both("view", "u8", t=T0)[0], 1)
    assert view.events(refresh=True).num_rows == 23


def test_view_event_batch_and_properties_as_the_jax_view(tmp_path):
    reg, jreg = view_app()
    view = DataView(reg, "viewapp", cache_dir=str(tmp_path / "p"))
    jview = JDataView(jreg, "viewapp", cache_dir=str(tmp_path / "j"))
    evs = list(view.event_batch())
    assert len(evs) == 21 and all(isinstance(e, Event) for e in evs)
    assert rows_of(evs) == rows_of(jview.event_batch())
    assert view.aggregate_properties("item")["i1"].get("price") == 9.5
    assert jview.aggregate_properties("item")["i1"].get("price") == 9.5


def test_view_parquet_read_back_by_both_imports(tmp_path):
    """The view's cache is in the export schema: the port's and the JAX
    package's `import --format parquet` read it back, and the port reads
    the JAX view's."""
    reg, jreg = view_app()
    DataView(reg, "viewapp", cache_dir=str(tmp_path / "p")).events()
    JDataView(jreg, "viewapp", cache_dir=str(tmp_path / "j")).events()
    [ours] = (tmp_path / "p").glob("view_*.parquet")
    [theirs] = (tmp_path / "j").glob("view_*.parquet")
    want = rows_of(reg.get_events().find(1))
    for path in (ours, theirs):
        app2 = reg.get_meta_data_apps().insert(App(0, f"copy{path.parent.name}"))
        assert import_events(reg, app_id=app2, input_path=str(path),
                             format="parquet")["imported"] == 21
        assert rows_of(reg.get_events().find(app2)) == want
    japp2 = jreg.get_meta_data_apps().insert(JApp(0, "jcopy"))
    assert jimport_events(jreg, app_id=japp2, input_path=str(ours),
                          format="parquet") == 21
    assert rows_of(jreg.get_events().find(japp2)) == want


# -- cli run and cli shell ------------------------------------------------------

RUN_MODULE = """
from {pkg}.data import store
from {pkg}.data.storage import storage


def digest():
    pc = store.pair_columns(storage(), "shop", event_names=["view"])
    return {{"n": int(pc.n), "left": pc.left.keys(),
             "right": pc.right.keys(),
             "left_ix": pc.left_ix.tolist(),
             "right_ix": pc.right_ix.tolist(),
             "weight": pc.weight.tolist()}}


def nothing():
    return None
"""


def cli_store(tmp_path):
    """A sqlite store with an app and views, as both CLIs' default (the
    process defaults are reset, so that each CLI builds its own from the
    environment)."""
    set_default(None)
    jset_default(None)
    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
              "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
              "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
              "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}
    reg = StorageRegistry(config)
    app_id = reg.get_meta_data_apps().insert(App(0, "shop"))
    reg.get_events().init(app_id)
    reg.get_events().insert_batch(
        [both("view", f"u{k % 4}", t=T0 + timedelta(minutes=k),
              tid=f"i{(k * 3) % 5}")[0] for k in range(30)], app_id)
    reg.close()
    return config


def run_main(main, argv, stdin: str = "") -> str:
    out = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with redirect_stdout(out):
            assert main(argv) == 0
    finally:
        sys.stdin = old
    return out.getvalue()


def test_cli_run_prints_what_the_jax_command_prints(tmp_path, monkeypatch):
    config = cli_store(tmp_path)
    for k, v in config.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    (tmp_path / "probe_torch.py").write_text(
        RUN_MODULE.format(pkg="predictionio_tpu_torch"))
    (tmp_path / "probe_jax.py").write_text(
        RUN_MODULE.format(pkg="predictionio_tpu"))
    monkeypatch.syspath_prepend(str(tmp_path))
    ours = run_main(pmain.main, ["run", "probe_torch.digest"])
    theirs = run_main(jmain.main, ["run", "probe_jax.digest"])
    assert ours == theirs
    got = json.loads(ours)
    assert got["n"] == 30 and got["left"] == ["u0", "u1", "u2", "u3"]
    assert run_main(pmain.main, ["run", "probe_torch.nothing"]) == \
        run_main(jmain.main, ["run", "probe_jax.nothing"]) == ""


def test_cli_shell_fed_on_stdin_prints_what_the_jax_shell_prints(
        tmp_path, monkeypatch):
    config = cli_store(tmp_path)
    for k, v in config.items():
        monkeypatch.setenv(k, v)
    script = ("app = registry.get_meta_data_apps().get_by_name('shop')\n"
              "print(app.id, app.name)\n"
              "print(sorted({e.entity_id for e in events.find(app.id)}))\n"
              "len(list(events.find(app.id, event_names=['view'])))\n"
              "[k for k in ('core', 'data', 'models', 'ops') "
              "if k in globals()]\n")
    ours = run_main(pmain.main, ["shell"], stdin=script)
    theirs = run_main(jmain.main, ["shell"], stdin=script)
    assert ours == theirs
    assert "1 shop" in ours and "30" in ours
    assert "['core', 'data', 'models', 'ops']" in ours
