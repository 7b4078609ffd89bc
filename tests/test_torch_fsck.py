"""The port's recovery pass (`data/fsck.py`) against the JAX package's:
the same damage made on two copies of one store (a LOCALFS model store
with a torn blob and a leftover tmp file, a SQLITE model row cut short,
an EVLOG journal and a PEVLOG segment with a torn tail and a stale
sidecar, diverging REPLICATED copies), then `fsck_registry` reporting
and repairing on each copy: the findings equal as (kind, action) with
the paths left out. The janitor fails the same stale rows; `doctor`,
quarantine GC, the scheduled pass and the servers' startup sweep; a
sidecar the port rebuilt is read by the JAX package."""

import os
import shutil
import signal
import sqlite3
import struct
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.data import fsck as jfsck
from predictionio_tpu.data.storage import base as jbase
from predictionio_tpu.data.storage import registry as jreg
from predictionio_tpu_torch.data import fsck as pfsck
from predictionio_tpu_torch.data import integrity as pint
from predictionio_tpu_torch.data.event import DataMap, Event, utcnow
from predictionio_tpu_torch.data.storage import EngineInstance, Model
from predictionio_tpu_torch.data.storage import registry as preg
from predictionio_tpu_torch.native.eventlog import MAGIC
from predictionio_tpu_torch.obs import get_registry

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


def config(root: Path, events: str = "DB", models: str = "DB") -> dict:
    cfg = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_DB_PATH": str(root / "pio.db"),
           "PIO_STORAGE_SOURCES_FS_TYPE": "LOCALFS",
           "PIO_STORAGE_SOURCES_FS_PATH": str(root / "fs"),
           "PIO_STORAGE_SOURCES_EV_TYPE": "EVLOG",
           "PIO_STORAGE_SOURCES_EV_PATH": str(root / "ev"),
           "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
           "PIO_STORAGE_SOURCES_PEV_PATH": str(root / "pev"),
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": events,
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": models}
    for t in ("R1", "R2", "R3"):
        cfg[f"PIO_STORAGE_SOURCES_{t}_TYPE"] = "LOCALFS"
        cfg[f"PIO_STORAGE_SOURCES_{t}_PATH"] = str(root / t.lower())
    cfg.update({"PIO_STORAGE_SOURCES_REP_TYPE": "REPLICATED",
                "PIO_STORAGE_SOURCES_REP_REPLICAS": "R1,R2,R3"})
    return cfg


def _events(n: int, seed: int):
    rng = np.random.default_rng(seed)
    t0 = utcnow() - timedelta(days=3)
    return [Event("rate", "user", f"u{int(u)}", target_entity_type="item",
                  target_entity_id=f"i{int(i)}",
                  properties=DataMap({"rating": float(r)}),
                  event_time=t0 + timedelta(minutes=int(m)))
            for u, i, r, m in zip(rng.integers(0, 50, n),
                                  rng.integers(0, 40, n),
                                  rng.integers(1, 6, n),
                                  rng.integers(0, 3 * 1440, n))]


def _torn(path: Path) -> None:
    with open(path, "ab") as f:
        f.write(struct.pack("<III", MAGIC, 500, 0) + b"partial")


def _damage(kind: str, root: Path) -> dict:
    """Write a store with the port, then damage it; returns its config."""
    rng = np.random.default_rng(3)
    blob = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    if kind == "LOCALFS":
        cfg = config(root, models="FS")
        reg = preg.StorageRegistry(cfg)
        models = reg.get_model_data_models()
        for mid in ("ok", "bad"):
            models.insert(Model(mid, blob))
        bad = root / "fs" / "pio_model_bad"
        bad.write_bytes(bad.read_bytes()[:-9])
        (root / "fs" / "pio_model_ok.77.cafe.tmp").write_bytes(b"torn")
    elif kind == "SQLITE":
        cfg = config(root)
        reg = preg.StorageRegistry(cfg)
        for mid in ("a", "b", "c"):
            reg.get_model_data_models().insert(Model(mid, blob))
        reg.close()
        conn = sqlite3.connect(root / "pio.db")
        with conn:
            conn.execute("UPDATE models SET models=? WHERE id=?",
                         (pint.wrap(blob)[:-3], "b"))
        conn.close()
        return cfg
    elif kind == "EVLOG":
        cfg = config(root, events="EV")
        reg = preg.StorageRegistry(cfg)
        reg.get_events().insert_batch(_events(300, 1), 1)
        reg.get_events().insert_batch(_events(50, 2), 1, 4)
        _torn(root / "ev" / "events_1.log")
    elif kind == "PEVLOG":
        cfg = config(root, events="PEV")
        reg = preg.StorageRegistry(cfg)
        store = reg.get_events()
        store.insert_batch(_events(2000, 4), 1)
        store.close()
        segs = sorted((root / "pev" / "app_1").glob("seg_*.log"))
        _torn(segs[0])
        segs[-1].with_suffix(".idx").unlink()
    else:                                  # REPLICATED
        cfg = config(root, models="REP")
        reg = preg.StorageRegistry(cfg)
        models = reg.get_model_data_models()
        models.insert(Model("m", blob))
        models.insert(Model("n", blob[::-1]))
        models._drain()
        pint.atomic_write_bytes(root / "r2" / "pio_model_m",
                                pint.wrap(b"other"))
        raw = (root / "r3" / "pio_model_n").read_bytes()
        (root / "r3" / "pio_model_n").write_bytes(raw[:-1] + b"\x00")
    reg.close()
    return cfg


def _norm(findings):
    return sorted((f["kind"], f.get("target", ""), f["repo"],
                   f["action"].split(" -> ")[0]) for f in findings)


@pytest.mark.parametrize("kind", ["EVLOG", "PEVLOG"])
def test_an_unreadable_journal_is_reported_not_truncated(kind, tmp_path,
                                                         monkeypatch):
    """A journal the sweep cannot open (no file descriptor left while its
    frames are read) is an `fsck_error`: `--repair` leaves every byte of
    it, where reading it as empty would truncate it to 0 as a torn
    tail."""
    import resource
    from predictionio_tpu_torch.native import eventlog as pel
    cfg = config(tmp_path, events="EV" if kind == "EVLOG" else "PEV")
    reg = preg.StorageRegistry(cfg)
    reg.get_events().insert_batch(_events(300, 1), 1)
    reg.close()
    logs = sorted(p for p in tmp_path.rglob("*.log")
                  if p.parent.name in ("ev", "app_1"))
    sizes = {p: p.stat().st_size for p in logs}
    assert logs and sum(sizes.values()) > 0
    real = pel.EventLog.valid_end

    def starved(self):
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (0, hard))
        try:
            return real(self)
        finally:
            resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))

    with pytest.raises(OSError):
        starved(pel.EventLog(str(logs[0])))
    monkeypatch.setattr(pel.EventLog, "valid_end", starved)
    reg = preg.StorageRegistry(cfg)
    try:
        found = pfsck.fsck_registry(reg, repair=True)
    finally:
        reg.close()
    assert [f["kind"] for f in found] == ["fsck_error"]
    assert {p: p.stat().st_size for p in logs} == sizes



@pytest.mark.parametrize("kind", ["LOCALFS", "SQLITE", "EVLOG", "PEVLOG",
                                  "REPLICATED"])
def test_fsck_findings_equal_the_jax_packages(kind, tmp_path):
    src = tmp_path / "src"
    cfg = _damage(kind, src)
    runs = {}
    for name, mod_reg, mod_fsck in (("jax", jreg, jfsck),
                                    ("port", preg, pfsck)):
        root = tmp_path / name
        shutil.copytree(src, root)
        cfg_copy = {k: v.replace(str(src), str(root)) for k, v in
                    cfg.items()}
        reg = mod_reg.StorageRegistry(cfg_copy)
        report = mod_fsck.fsck_registry(reg, repair=False)
        repair = mod_fsck.fsck_registry(reg, repair=True)
        after = mod_fsck.fsck_registry(reg, repair=False)
        runs[name] = (_norm(report), _norm(repair), _norm(after))
        reg.close()
    assert runs["port"] == runs["jax"]
    report, repair, after = runs["port"]
    assert report and all(a == "none" for *_, a in report)
    assert all(a != "none" for *_, a in repair) and after == []


def test_repaired_stores_read_back_in_both_packages(tmp_path):
    cfg = _damage("PEVLOG", tmp_path)
    reg = preg.StorageRegistry(cfg)
    pfsck.fsck_registry(reg, repair=True)
    store = reg.get_events()
    late = _events(1, 9)[0].with_id()
    store.insert(late, 1)
    mine = sorted(e.event_id for e in store.find(1))
    reg.close()
    # the JAX package loads the sidecars the port rebuilt as covering
    # their journals, and reads the same events
    jr = jreg.StorageRegistry(cfg)
    assert jfsck.fsck_registry(jr, repair=False) == []
    assert sorted(e.event_id for e in jr.get_events().find(1)) == mine
    assert late.event_id in mine


def _rows(ts):
    hour = timedelta(hours=1)
    return [("INIT", ts - 2 * hour, None), ("TRAINING", ts - 3 * hour,
                                            ts - 2 * hour),
            ("TRAINING", ts - 5 * hour, ts - timedelta(seconds=5)),
            ("COMPLETED", ts - 9 * hour, None), ("FAILED", ts - 9 * hour,
                                                  None),
            ("TRAINING", ts - timedelta(seconds=10), None)]


def test_janitor_fails_the_same_rows(tmp_path):
    ts = utcnow()
    failed = {}
    for name, mod_reg, mod_fsck, row_cls in (
            ("jax", jreg, jfsck, jbase.EngineInstance),
            ("port", preg, pfsck, EngineInstance)):
        reg = mod_reg.StorageRegistry(config(tmp_path / name))
        eis = reg.get_meta_data_engine_instances()
        for n, (status, start, beat) in enumerate(_rows(ts)):
            eis.insert(row_cls(id=f"r{n}", status=status, start_time=start,
                               heartbeat=beat, engine_id="e"))
        report = mod_fsck.janitor_stale_instances(reg, 1800.0, repair=False)
        done = mod_fsck.janitor_stale_instances(reg, 1800.0, repair=True)
        failed[name] = ([(f["id"], f["status"], f["action"])
                         for f in report],
                        [(f["id"], f["action"]) for f in done],
                        sorted((r.id, r.status) for r in eis.get_all()))
        reg.close()
    assert failed["port"] == failed["jax"]
    assert [i for i, _ in failed["port"][1]] == ["r0", "r1"]


def test_doctor_report_and_metrics(tmp_path):
    cfg = _damage("LOCALFS", tmp_path)
    reg = preg.StorageRegistry(cfg)
    m = get_registry()
    before = m.counter("pio_fsck_quarantined_total").value
    report = pfsck.doctor(reg, repair=False, stale_after_s=60.0)
    assert set(report) == {"fsck", "janitor", "breakers", "repair",
                           "unrepaired"}
    assert report["unrepaired"] == 2 and report["breakers"] == {
        "DB": "closed", "FS": "closed"}
    fixed = pfsck.doctor(reg, repair=True)
    assert fixed["unrepaired"] == 0
    assert m.counter("pio_fsck_quarantined_total").value == before + 1
    assert m.gauge("pio_quarantine_count").value == 1.0
    assert m.gauge("pio_quarantine_bytes").value > 0
    assert m.gauge("pio_fsck_last_run_ts").value > time.time() - 60
    reg.close()


@pytest.mark.parametrize("kind", ["FS", "DB"])
def test_quarantine_gc_equals_the_jax_packages(tmp_path, kind):
    out = {}
    for name, mod_reg, mod_fsck in (("jax", jreg, jfsck),
                                    ("port", preg, pfsck)):
        root = tmp_path / name
        reg = mod_reg.StorageRegistry(config(root, models=kind))
        models = reg.get_model_data_models()
        models.insert((jbase.Model if name == "jax" else Model)(
            "x", b"payload"))
        if kind == "FS":
            f = root / "fs" / "pio_model_x"
            f.write_bytes(f.read_bytes()[:-2])
        else:
            with sqlite3.connect(root / "pio.db") as conn:
                conn.execute("UPDATE models SET models=? WHERE id='x'",
                             (pint.wrap(b"payload")[:-2],))
        mod_fsck.fsck_registry(reg, repair=True)
        kept = mod_fsck.quarantine_gc(reg, retention_s=3600.0)
        if kind == "FS":
            old = time.time() - 7200
            for q in (root / "fs" / ".quarantine").iterdir():
                os.utime(q, (old, old))
        else:
            with sqlite3.connect(root / "pio.db") as conn:
                conn.execute("UPDATE models_quarantine SET quarantined_at=1")
        gone = mod_fsck.quarantine_gc(reg, retention_s=3600.0)
        out[name] = (kept, [(f["kind"], f["action"]) for f in gone],
                     models.quarantine_stats())
        reg.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] == [("quarantine_expired", "deleted")]


def test_scheduled_pass_runs_and_stops(tmp_path):
    cfg = {**_damage("EVLOG", tmp_path), "PIO_FSCK_INTERVAL_S": "0.05",
           "PIO_QUARANTINE_RETENTION_S": "3600"}
    reg = preg.StorageRegistry(cfg)
    runs = get_registry().counter("pio_fsck_runs_total",
                                  labels=("mode",)).labels(mode="report")
    before = runs.value
    sched = pfsck.start_scheduled_fsck(reg)
    assert sched is not None and sched.retention_s == 3600.0
    t0 = time.monotonic()
    while runs.value < before + 2:
        assert time.monotonic() - t0 < 10.0
        time.sleep(0.02)
    sched.stop()
    once = sched.run_once()
    assert [f["kind"] for f in once["fsck"]] == ["torn_tail"]
    assert once["gc"] == []
    reg.close()
    off = preg.StorageRegistry(config(tmp_path / "off"))
    assert pfsck.start_scheduled_fsck(off) is None


def test_servers_sweep_at_startup(tmp_path):
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                         EventServerConfig)
    from predictionio_tpu_torch.models.recommendation import \
        RecommendationEngine
    from predictionio_tpu_torch.ops import als as pals
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.serving.server import (PredictionServer,
                                                       _Deployment)
    cfg = _damage("EVLOG", tmp_path)
    reg = preg.StorageRegistry(cfg)
    eis = reg.get_meta_data_engine_instances()
    ghost = eis.insert(EngineInstance(status="TRAINING",
                                      start_time=utcnow() - timedelta(
                                          days=1)))
    runs = get_registry().counter("pio_fsck_runs_total",
                                  labels=("mode",)).labels(mode="report")
    n0 = runs.value
    server = EventServer(EventServerConfig(ip="127.0.0.1", port=0), reg)
    assert runs.value == n0 + 1
    assert eis.get(ghost).status == "FAILED"     # the janitor acted
    # report only: the torn tail is still there
    assert [f["kind"] for f in pfsck.fsck_registry(reg)] == ["torn_tail"]
    del server
    rng = np.random.default_rng(0)
    model = pals.als_model_from_numpy(
        rng.standard_normal((4, 3)).astype(np.float32),
        rng.standard_normal((6, 3)).astype(np.float32),
        [f"u{n}" for n in range(4)], [f"i{n}" for n in range(6)],
        device="cpu")
    algos, models, serving = prepare_deploy(RecommendationEngine.apply(),
                                            [model], warm_batch_max=2)
    n1 = runs.value
    ctx = RuntimeContext(registry=reg, device="cpu")
    swept = PredictionServer(_Deployment(algos, models, serving), port=0,
                             ctx=ctx)
    assert runs.value == n1 + 1
    # GET /'s deploy_timings carry the sweep's seconds
    assert swept.deployment.timings["sweep_s"] >= 0.0
    # a fleet member skips it; a model in hand names no store
    member = PredictionServer(_Deployment(algos, models, serving), port=0,
                              ctx=ctx, startup_check=False)
    PredictionServer(_Deployment(algos, models, serving), port=0)
    assert runs.value == n1 + 1
    assert "sweep_s" not in member.deployment.timings
    reg.close()


def test_startup_check_never_raises():
    class Broken:
        config = {}

        def get_model_data_models(self):
            raise OSError("disk gone")

        def get_events(self):
            raise OSError("disk gone")

        def get_meta_data_engine_instances(self):
            raise OSError("disk gone")

    seen = []
    assert pfsck.startup_check(Broken(), log=lambda *a, **k: seen.append(
        (a, k))) is None
    assert seen and seen[0][0][0] == "fsck.startup.error"
