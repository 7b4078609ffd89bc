"""The port's data commands against the JAX package's, on copies of one
sqlite store: `export` (JSON, and parquet through pyarrow) parses to the
same events, `import --format parquet` round-trips them, `app
data-delete` (app, channel, --all), `app channel-new|channel-delete` and
`accesskey delete` leave the same rows; `doctor` through the CLI with
its exit codes; and `deploy`'s resolution passing over an instance
whose blob `doctor --repair` quarantined."""

import io
import json
import shutil
import signal
import sqlite3
from contextlib import redirect_stdout
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.cli import main as jmain
from predictionio_tpu.cli import ops as jops
from predictionio_tpu.data.storage import registry as jreg
from predictionio_tpu_torch.cli import main as pmain
from predictionio_tpu_torch.cli import ops as pops
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (EngineInstance, Model,
                                                 set_default)
from predictionio_tpu_torch.data.storage import registry as preg

pytestmark = pytest.mark.torch

T0 = datetime(2022, 5, 6, 7, 8, 9, 123000, tzinfo=timezone.utc)


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


def _cfg(root: Path) -> dict:
    return {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.db")}


def _store(root: Path) -> dict:
    """An app with two channels and seeded events, made by the port."""
    reg = preg.StorageRegistry(_cfg(root))
    app = pops.app_new(reg, "shop")
    rng = np.random.default_rng(21)
    events = reg.get_events()
    for ch in (None, "web", "mob"):
        cid = None if ch is None else pops.channel_new(reg, "shop", ch)["id"]
        evs = []
        for n in range(40):
            kind = int(rng.integers(3))
            if kind == 0:
                evs.append(Event("rate", "user", f"u{rng.integers(9)}",
                                 target_entity_type="item",
                                 target_entity_id=f"i{rng.integers(30)}",
                                 properties=DataMap({"rating": float(
                                     rng.integers(1, 6))}),
                                 event_time=T0 + timedelta(seconds=n),
                                 tags=("a", "b")))
            elif kind == 1:
                evs.append(Event("$set", "item", f"i{rng.integers(30)}",
                                 properties=DataMap({"cats": ["x", "y"],
                                                     "price": 1.5}),
                                 event_time=T0 + timedelta(seconds=n),
                                 pr_id="p7"))
            else:
                evs.append(Event("view", "user", f"u{rng.integers(9)}",
                                 target_entity_type="item",
                                 target_entity_id=f"i{rng.integers(30)}",
                                 event_time=T0 + timedelta(seconds=n)))
        events.insert_batch(evs, app["id"], cid)
    pops.accesskey_new(reg, "shop", key="extra-key", events=["rate"])
    reg.close()
    return app


def _copies(tmp_path):
    src = tmp_path / "src"
    app = _store(src)
    for name in ("jax", "port"):
        shutil.copytree(src, tmp_path / name)
    return (app, jreg.StorageRegistry(_cfg(tmp_path / "jax")),
            preg.StorageRegistry(_cfg(tmp_path / "port")))


def _rows(root: Path) -> dict:
    conn = sqlite3.connect(root / "pio.db")
    tables = [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table' AND name NOT "
        "LIKE 'sqlite_%' AND name != 'events_ingest_gen' ORDER BY name")]
    out = {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                     key=repr) for t in tables}
    conn.close()
    return out


def test_export_json_equals_the_jax_export(tmp_path):
    app, jr, pr = _copies(tmp_path)
    for cid in (None, 1, 2):
        n = jops.export_events(jr, app_id=app["id"], channel_id=cid,
                               output_path=str(tmp_path / "j.jsonl"))
        got = pops.export_events(pr, app_id=app["id"], channel_id=cid,
                                 output_path=str(tmp_path / "p.jsonl"))
        assert got["exported"] == n == 40
        parse = [json.loads(x) for x in
                 (tmp_path / "p.jsonl").read_text().splitlines()]
        assert parse == [json.loads(x) for x in
                         (tmp_path / "j.jsonl").read_text().splitlines()]
    # the JAX package imports the port's export as its own
    jops.import_events(jr, app_id=9, input_path=str(tmp_path / "p.jsonl"))
    assert sorted(e.event_id for e in jr.get_events().find(9)) == sorted(
        x["eventId"] for x in parse)


def test_parquet_round_trip_and_the_jax_reader(tmp_path):
    pytest.importorskip("pyarrow")
    app, jr, pr = _copies(tmp_path)
    out = pops.export_events(pr, app_id=app["id"], format="parquet",
                             output_path=str(tmp_path / "p.parquet"))
    assert out["exported"] == 40
    jops.export_events(jr, app_id=app["id"], format="parquet",
                       output_path=str(tmp_path / "j.parquet"))
    import pyarrow.parquet as pq
    assert pq.read_table(tmp_path / "p.parquet").to_pylist() == \
        pq.read_table(tmp_path / "j.parquet").to_pylist()
    back = pops.import_events(pr, app_id=5, format="parquet",
                              input_path=str(tmp_path / "j.parquet"))
    assert back["imported"] == 40
    want = [e.to_api_json() for e in pr.get_events().find(app["id"])]
    assert [e.to_api_json() for e in pr.get_events().find(5)] == want
    empty = pops.export_events(pr, app_id=77, format="parquet",
                               output_path=str(tmp_path / "e.parquet"))
    assert empty["exported"] == 0 and pq.read_table(
        tmp_path / "e.parquet").num_rows == 0


def test_unknown_format_and_missing_pyarrow(tmp_path, monkeypatch):
    reg = preg.StorageRegistry(_cfg(tmp_path))
    with pytest.raises(ValueError, match="Unknown export format"):
        pops.export_events(reg, app_id=1, output_path="x", format="csv")
    with pytest.raises(ValueError, match="Unknown import format"):
        pops.import_events(reg, app_id=1, input_path="x", format="csv")
    import builtins
    real = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name.startswith("pyarrow"):
            raise ImportError("no pyarrow")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ValueError, match="requires pyarrow"):
        pops.export_events(reg, app_id=1, output_path=str(tmp_path / "x"),
                           format="parquet")


@pytest.mark.parametrize("command", [
    ("data-delete", {}), ("data-delete", {"channel": "web"}),
    ("data-delete", {"all_channels": True}), ("channel-new", {}),
    ("channel-delete", {}), ("accesskey-delete", {})])
def test_data_commands_leave_the_jax_rows(tmp_path, command):
    name, kw = command
    app, jr, pr = _copies(tmp_path)
    for ops, reg in ((jops, jr), (pops, pr)):
        if name == "data-delete":
            with pytest.raises(ValueError, match="force"):
                ops.app_data_delete(reg, "shop", **kw)
            ops.app_data_delete(reg, "shop", force=True, **kw)
        elif name == "channel-new":
            out = ops.channel_new(reg, "shop", "tv")
            assert out["id"] == 3
            with pytest.raises(ValueError, match="already exists"):
                ops.channel_new(reg, "shop", "tv")
        elif name == "channel-delete":
            ops.channel_delete(reg, "shop", "web", force=True)
            with pytest.raises(ValueError, match="does not exist"):
                ops.channel_delete(reg, "shop", "web", force=True)
        else:
            ops.accesskey_delete(reg, "extra-key")
            with pytest.raises(ValueError, match="does not exist"):
                ops.accesskey_delete(reg, "extra-key")
        reg.close()
    assert _rows(tmp_path / "port") == _rows(tmp_path / "jax")


def _run(main, *argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


def test_cli_flags_and_doctor(tmp_path):
    reg = preg.StorageRegistry({
        **_cfg(tmp_path), "PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"})
    set_default(reg)
    rc, out = _run(pmain.main, "app", "new", "shop")
    app = json.loads(out)
    rc, out = _run(pmain.main, "app", "channel-new", "shop", "web")
    assert rc == 0 and json.loads(out)["id"] == 1
    rc, _ = _run(pmain.main, "app", "data-delete", "shop", "--channel",
                 "web", "--all", "--force")
    assert rc == 0
    rc, _ = _run(pmain.main, "app", "channel-delete", "shop", "web", "-f")
    assert rc == 0 and reg.get_meta_data_channels().get_by_appid(
        app["id"]) == []
    rc, _ = _run(pmain.main, "accesskey", "delete", app["accessKey"])
    assert rc == 0 and reg.get_meta_data_access_keys().get(
        app["accessKey"]) is None
    rc, out = _run(pmain.main, "export", "--appid", str(app["id"]),
                   "--output", str(tmp_path / "x.jsonl"))
    assert rc == 0 and json.loads(out)["exported"] == 0
    rc, out = _run(pmain.main, "doctor")
    assert rc == 0 and json.loads(out)["unrepaired"] == 0
    reg.get_model_data_models().insert(Model("m", b"payload"))
    f = tmp_path / "fs" / "pio_model_m"
    f.write_bytes(f.read_bytes()[:-1])
    old = datetime.now(timezone.utc) - timedelta(seconds=300)
    reg.get_meta_data_engine_instances().insert(EngineInstance(
        id="ghost", status="TRAINING", start_time=old))
    rc, out = _run(pmain.main, "doctor")
    report = json.loads(out)
    assert rc == 1 and [f["kind"] for f in report["fsck"]] == [
        "corrupt_blob"] and report["janitor"] == []
    rc, out = _run(pmain.main, "doctor", "--repair", "--stale-after", "60")
    report = json.loads(out)
    assert rc == 0 and report["repair"] is True
    assert [f["id"] for f in report["janitor"]] == ["ghost"]
    # the same flags as the JAX parser
    jp, pp = jmain.build_parser(), pmain.build_parser()
    for argv in (["doctor", "--repair", "--stale-after", "5"],
                 ["app", "data-delete", "a", "--channel", "c", "--all",
                  "-f"],
                 ["app", "channel-new", "a", "c"],
                 ["app", "channel-delete", "a", "c", "--force"],
                 ["accesskey", "delete", "k"],
                 ["export", "--appid", "1", "--channel", "2", "--output",
                  "o", "--format", "parquet"],
                 ["import", "--appid", "1", "--input", "i", "--format",
                  "parquet"]):
        assert vars(pp.parse_args(argv)) == {
            k: v for k, v in vars(jp.parse_args(argv)).items()
            if k in vars(pp.parse_args(argv))}


def test_deploy_resolves_a_quarantined_instance_as_the_jax_package(tmp_path):
    """After `doctor --repair` quarantined the newest instance's blob,
    deploy, /reload and status still resolve the newest COMPLETED
    instance, as the JAX package does: its blob reads as missing, and
    the intact one before it is deployed by id."""
    from predictionio_tpu_torch.data import fsck
    cfg = {**_cfg(tmp_path), "PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS"}
    reg = preg.StorageRegistry(cfg)
    eis = reg.get_meta_data_engine_instances()
    for n, iid in enumerate(("old", "new")):
        eis.insert(EngineInstance(
            id=iid, status="COMPLETED", engine_id="default",
            engine_version="default", engine_variant="default",
            engine_factory="recommendation",
            start_time=T0 + timedelta(hours=n)))
        reg.get_model_data_models().insert(Model(iid, b"blob " + iid.encode()))
    assert pops.latest_completed(reg, "default").id == "new"
    f = tmp_path / "fs" / "pio_model_new"
    f.write_bytes(f.read_bytes()[:-2])
    fsck.doctor(reg, repair=True)
    jr = jreg.StorageRegistry(cfg)
    try:
        assert pops.latest_completed(reg, "default").id == \
            jops._latest_completed(jr, "default").id == "new"
    finally:
        jr.close()
    assert reg.get_model_data_models().get("new") is None
    _, inst = pops.deploy_target(reg, engine_instance_id="old")
    assert inst.id == "old"
    assert reg.get_model_data_models().get("old").models == b"blob old"
    for iid in ("new", "old"):
        eis.update(eis.get(iid).with_(status="FAILED"))
    with pytest.raises(ValueError, match="No valid engine instance"):
        pops.latest_completed(reg, "default")
    reg.close()


