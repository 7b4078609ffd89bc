"""SQLite storage driver ("SQLITE" type), the default persistent backend.

The port of `predictionio_tpu/data/storage/sqlite.py` for the DAOs the
lifecycle and eval use: apps, access keys, channels, engine and
evaluation instances, models and events (the reference's JDBC driver role, JDBC{LEvents,Models,...}
.scala); and for the serving fleet's and tenancy's: leases (a
compare-and-swap row under `BEGIN IMMEDIATE`, which WAL makes atomic
across the processes sharing the file), tenant quotas and SLO
objectives. The on-disk schema is the JAX package's, table for table and
column for column: events live in `events_<appId>[_<channelId>]`
(JDBCUtils.eventTableName), times are epoch milliseconds, model blobs
carry the integrity envelope, and every event write bumps the table's
row in `events_ingest_gen`. A `pio.db` either package wrote is read by
the other.

One connection per client, opened with `check_same_thread=False` and
used under an RLock, so the prediction server's threads can share it;
WAL mode keeps readers unblocked. Several processes may open one new
file at once (`cli` commands started together): the WAL switch is
skipped when the file already reads `wal`, and the switch and the
schema are retried while another opener holds the lock, with backoff
under a bounded deadline (`OPEN_DEADLINE_S`). The JAX package's client
runs the switch once and raises `database is locked` there.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from datetime import datetime
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.resilience import (Deadline, RetryPolicy,
                                               call_with_retry,
                                               deadline_scope)
from predictionio_tpu_torch.data.event import (DataMap, Event,
                                               _gen_event_id, from_millis,
                                               to_millis, utcnow)
from predictionio_tpu_torch.data.storage import base, columns
from predictionio_tpu_torch.data.storage.base import (
    AccessKey, App, Channel, EngineInstance, EvaluationInstance, Model,
    SLOObjective, TenantQuota, _UNSET, match_properties)

# The JAX package's metadata tables, verbatim: a store either package
# creates has the same schema, whichever opens it first.
META_DDL = (
    """CREATE TABLE IF NOT EXISTS apps (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        name TEXT NOT NULL UNIQUE,
        description TEXT)""",
    """CREATE TABLE IF NOT EXISTS access_keys (
        accesskey TEXT PRIMARY KEY,
        appid INTEGER NOT NULL,
        events TEXT NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS channels (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        name TEXT NOT NULL,
        appid INTEGER NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS engine_instances (
        id TEXT PRIMARY KEY, status TEXT, starttime INTEGER,
        endtime INTEGER, engineid TEXT, engineversion TEXT,
        enginevariant TEXT, enginefactory TEXT, batch TEXT,
        env TEXT, runtimeconf TEXT, datasourceparams TEXT,
        preparatorparams TEXT, algorithmsparams TEXT,
        servingparams TEXT, heartbeat INTEGER)""",
    """CREATE TABLE IF NOT EXISTS evaluation_instances (
        id TEXT PRIMARY KEY, status TEXT, starttime INTEGER,
        endtime INTEGER, evaluationclass TEXT,
        engineparamsgeneratorclass TEXT, batch TEXT, env TEXT,
        runtimeconf TEXT, evaluatorresults TEXT,
        evaluatorresultshtml TEXT, evaluatorresultsjson TEXT)""",
    """CREATE TABLE IF NOT EXISTS models (
        id TEXT PRIMARY KEY, models BLOB)""",
    """CREATE TABLE IF NOT EXISTS models_quarantine (
        id TEXT PRIMARY KEY, models BLOB, reason TEXT,
        quarantined_at INTEGER)""",
    """CREATE TABLE IF NOT EXISTS leases (
        name TEXT PRIMARY KEY, holder TEXT NOT NULL,
        expires_ms INTEGER NOT NULL, journal TEXT NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS tenant_quotas (
        appid INTEGER, rate REAL, burst REAL,
        concurrency INTEGER, queue_max INTEGER, weight REAL,
        channel TEXT NOT NULL DEFAULT '',
        PRIMARY KEY (appid, channel))""",
    """CREATE TABLE IF NOT EXISTS slo_objectives (
        appid INTEGER PRIMARY KEY, latency_ms REAL, target REAL)""",
    """CREATE TABLE IF NOT EXISTS events_ingest_gen (
        tbl TEXT PRIMARY KEY, gen INTEGER NOT NULL)""",
)


# additive migrations of stores made before a column existed, each
# applied best-effort (a duplicate column is swallowed); the POSTGRES
# driver runs them through its dialect translation
META_MIGRATIONS = (
    "ALTER TABLE engine_instances ADD COLUMN heartbeat INTEGER",
    "ALTER TABLE models_quarantine ADD COLUMN quarantined_at INTEGER",
)

# how long an open waits out other processes opening the same new file
OPEN_DEADLINE_S = 30.0
# the page cache of each connection, KiB (grown only as pages are read)
CACHE_KIB = 262_144


class _StoreBusy(Exception):
    """Another connection holds the lock the open needs (retried)."""


def _busy(e: sqlite3.OperationalError) -> bool:
    msg = str(e).lower()
    return "locked" in msg or "busy" in msg


class SQLiteStorageClient:
    """Owns the sqlite connection; all DAOs of a source share one client."""

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        path = self.config.get("PATH", self.config.get("path", ":memory:"))
        if path != ":memory:":
            path = str(Path(path).expanduser())
        self.path = path
        self.lock = threading.RLock()
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        policy = RetryPolicy(attempts=64, base_delay=0.01, max_delay=0.5,
                             retryable=(_StoreBusy,))
        try:
            with deadline_scope(Deadline.after_s(OPEN_DEADLINE_S)):
                call_with_retry(self._init_schema, policy=policy)
        except _StoreBusy as e:
            raise e.__cause__ from None

    def _init_schema(self) -> None:
        """WAL (unless the file already reads it), then the tables; a
        lock held by another opener raises `_StoreBusy`."""
        try:
            mode = self.conn.execute("PRAGMA journal_mode").fetchone()[0]
            if str(mode).lower() != "wal":
                self.conn.execute("PRAGMA journal_mode=WAL")
            self.conn.execute("PRAGMA synchronous=NORMAL")
            # a connection's page cache (sqlite's default is 2 MiB): a
            # bulk import's index inserts land on random pages, which a
            # million-event table spreads past the default
            self.conn.execute(f"PRAGMA cache_size=-{CACHE_KIB}")
            with self.lock, self.conn:
                for ddl in META_DDL:
                    self.conn.execute(ddl)
        except sqlite3.OperationalError as e:
            if _busy(e):
                raise _StoreBusy(str(e)) from e
            raise
        for mig in META_MIGRATIONS:
            try:
                with self.lock, self.conn:
                    self.conn.execute(mig)
            except sqlite3.OperationalError as e:
                if _busy(e):
                    raise _StoreBusy(str(e)) from e

    def close(self) -> None:
        with self.lock:
            self.conn.close()


def event_table_name(app_id: int, channel_id: Optional[int]) -> str:
    """`events_<appId>[_<channelId>]` (JDBCUtils.eventTableName)."""
    return f"events_{app_id}" + (
        f"_{channel_id}" if channel_id is not None else "")


class SQLiteApps(base.Apps):
    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def insert(self, app: App) -> Optional[int]:
        try:
            with self.c.lock, self.c.conn:
                if app.id:
                    self.c.conn.execute(
                        "INSERT INTO apps (id, name, description) "
                        "VALUES (?,?,?)", (app.id, app.name, app.description))
                    return app.id
                cur = self.c.conn.execute(
                    "INSERT INTO apps (name, description) VALUES (?,?)",
                    (app.name, app.description))
                return cur.lastrowid
        except sqlite3.IntegrityError as ex:
            raise base.StorageWriteError(
                f"App id or name already exists ({ex})") from ex

    def get(self, app_id: int) -> Optional[App]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, description FROM apps WHERE id=?",
                (app_id,)).fetchone()
        return App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[App]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, description FROM apps WHERE name=?",
                (name,)).fetchone()
        return App(*row) if row else None

    def get_all(self) -> List[App]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, name, description FROM apps ORDER BY id"
            ).fetchall()
        return [App(*r) for r in rows]

    def update(self, app: App) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "UPDATE apps SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id))

    def delete(self, app_id: int) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute("DELETE FROM apps WHERE id=?", (app_id,))


class SQLiteAccessKeys(base.AccessKeys):
    _SELECT = "SELECT accesskey, appid, events FROM access_keys"

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    @staticmethod
    def _from_row(r) -> AccessKey:
        return AccessKey(r[0], r[1], tuple(json.loads(r[2])))

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or self.generate_key()
        try:
            with self.c.lock, self.c.conn:
                self.c.conn.execute(
                    "INSERT INTO access_keys (accesskey, appid, events) "
                    "VALUES (?,?,?)", (key, k.appid, json.dumps(list(k.events))))
        except sqlite3.IntegrityError as ex:
            raise base.StorageWriteError(
                f"Access key {key!r} already exists") from ex
        return key

    def get(self, key: str) -> Optional[AccessKey]:
        with self.c.lock:
            row = self.c.conn.execute(
                f"{self._SELECT} WHERE accesskey=?", (key,)).fetchone()
        return self._from_row(row) if row else None

    def get_all(self) -> List[AccessKey]:
        with self.c.lock:
            rows = self.c.conn.execute(self._SELECT).fetchall()
        return [self._from_row(r) for r in rows]

    def get_by_appid(self, appid: int) -> List[AccessKey]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"{self._SELECT} WHERE appid=?", (appid,)).fetchall()
        return [self._from_row(r) for r in rows]

    def update(self, k: AccessKey) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "UPDATE access_keys SET appid=?, events=? WHERE accesskey=?",
                (k.appid, json.dumps(list(k.events)), k.key))

    def delete(self, key: str) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "DELETE FROM access_keys WHERE accesskey=?", (key,))


class SQLiteChannels(base.Channels):
    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def insert(self, channel: Channel) -> Optional[int]:
        try:
            with self.c.lock, self.c.conn:
                if channel.id:
                    self.c.conn.execute(
                        "INSERT INTO channels (id, name, appid) VALUES (?,?,?)",
                        (channel.id, channel.name, channel.appid))
                    return channel.id
                cur = self.c.conn.execute(
                    "INSERT INTO channels (name, appid) VALUES (?,?)",
                    (channel.name, channel.appid))
                return cur.lastrowid
        except sqlite3.IntegrityError as ex:
            raise base.StorageWriteError(
                f"Channel id {channel.id} already exists") from ex

    def get(self, channel_id: int) -> Optional[Channel]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, appid FROM channels WHERE id=?",
                (channel_id,)).fetchone()
        return Channel(*row) if row else None

    def get_by_appid(self, appid: int) -> List[Channel]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, name, appid FROM channels WHERE appid=? "
                "ORDER BY id", (appid,)).fetchall()
        return [Channel(*r) for r in rows]

    def delete(self, channel_id: int) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute("DELETE FROM channels WHERE id=?",
                                (channel_id,))


class SQLiteEngineInstances(base.EngineInstances):
    COLS = ("id, status, starttime, endtime, engineid, engineversion, "
            "enginevariant, enginefactory, batch, env, runtimeconf, "
            "datasourceparams, preparatorparams, algorithmsparams, "
            "servingparams, heartbeat")

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    @staticmethod
    def _to_row(i: EngineInstance):
        return (i.id, i.status, to_millis(i.start_time), to_millis(i.end_time),
                i.engine_id, i.engine_version, i.engine_variant,
                i.engine_factory, i.batch, json.dumps(dict(i.env)),
                json.dumps(dict(i.runtime_conf)), i.data_source_params,
                i.preparator_params, i.algorithms_params, i.serving_params,
                to_millis(i.heartbeat) if i.heartbeat is not None else None)

    @staticmethod
    def _from_row(r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=from_millis(r[2]),
            end_time=from_millis(r[3]), engine_id=r[4], engine_version=r[5],
            engine_variant=r[6], engine_factory=r[7], batch=r[8],
            env=json.loads(r[9]), runtime_conf=json.loads(r[10]),
            data_source_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14],
            heartbeat=from_millis(r[15]) if r[15] is not None else None)

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                f"INSERT INTO engine_instances ({self.COLS}) VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                self._to_row(i.with_(id=iid)))
        return iid

    def get(self, iid: str) -> Optional[EngineInstance]:
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT {self.COLS} FROM engine_instances WHERE id=?",
                (iid,)).fetchone()
        return self._from_row(row) if row else None

    def get_all(self) -> List[EngineInstance]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self.COLS} FROM engine_instances").fetchall()
        return [self._from_row(r) for r in rows]

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self.COLS} FROM engine_instances WHERE status=? AND "
                "engineid=? AND engineversion=? AND enginevariant=? "
                "ORDER BY starttime DESC",
                (base.EngineInstanceStatus.COMPLETED, engine_id,
                 engine_version, engine_variant)).fetchall()
        return [self._from_row(r) for r in rows]

    def update(self, i: EngineInstance) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "UPDATE engine_instances SET status=?, starttime=?, endtime=?, "
                "engineid=?, engineversion=?, enginevariant=?, enginefactory=?, "
                "batch=?, env=?, runtimeconf=?, datasourceparams=?, "
                "preparatorparams=?, algorithmsparams=?, servingparams=?, "
                "heartbeat=? WHERE id=?", self._to_row(i)[1:] + (i.id,))

    def delete(self, iid: str) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute("DELETE FROM engine_instances WHERE id=?",
                                (iid,))


class SQLiteEvaluationInstances(base.EvaluationInstances):
    """Rows of the JAX package's `evaluation_instances` table, column for
    column (its DAO, `sqlite.py:380-445`)."""
    COLS = ("id, status, starttime, endtime, evaluationclass, "
            "engineparamsgeneratorclass, batch, env, runtimeconf, "
            "evaluatorresults, evaluatorresultshtml, evaluatorresultsjson")

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    @staticmethod
    def _to_row(i: EvaluationInstance):
        return (i.id, i.status, to_millis(i.start_time),
                to_millis(i.end_time), i.evaluation_class,
                i.engine_params_generator_class, i.batch,
                json.dumps(dict(i.env)), json.dumps(dict(i.runtime_conf)),
                i.evaluator_results, i.evaluator_results_html,
                i.evaluator_results_json)

    @staticmethod
    def _from_row(r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=from_millis(r[2]),
            end_time=from_millis(r[3]), evaluation_class=r[4],
            engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7]), runtime_conf=json.loads(r[8]),
            evaluator_results=r[9], evaluator_results_html=r[10],
            evaluator_results_json=r[11])

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or uuid.uuid4().hex
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                f"INSERT INTO evaluation_instances ({self.COLS}) VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?)", self._to_row(i.with_(id=iid)))
        return iid

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT {self.COLS} FROM evaluation_instances WHERE id=?",
                (iid,)).fetchone()
        return self._from_row(row) if row else None

    def get_all(self) -> List[EvaluationInstance]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self.COLS} FROM evaluation_instances").fetchall()
        return [self._from_row(r) for r in rows]

    def get_completed(self) -> List[EvaluationInstance]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self.COLS} FROM evaluation_instances WHERE "
                "status=? ORDER BY starttime DESC",
                (base.EvaluationInstanceStatus.COMPLETED,)).fetchall()
        return [self._from_row(r) for r in rows]

    def update(self, i: EvaluationInstance) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "UPDATE evaluation_instances SET status=?, starttime=?, "
                "endtime=?, evaluationclass=?, engineparamsgeneratorclass=?, "
                "batch=?, env=?, runtimeconf=?, evaluatorresults=?, "
                "evaluatorresultshtml=?, evaluatorresultsjson=? WHERE id=?",
                self._to_row(i)[1:] + (i.id,))

    def delete(self, iid: str) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "DELETE FROM evaluation_instances WHERE id=?", (iid,))


class SQLiteModels(base.Models):
    """Model blobs, stored in the integrity envelope; `get` verifies the
    digest (`integrity.CorruptBlobError` on a mismatch), `fsck` moves a
    corrupt row into `models_quarantine` with its reason."""

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def insert(self, m: Model) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "INSERT OR REPLACE INTO models (id, models) VALUES (?,?)",
                (m.id, integrity.wrap(m.models)))

    def get(self, mid: str) -> Optional[Model]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, models FROM models WHERE id=?", (mid,)).fetchone()
        return Model(row[0], integrity.unwrap(bytes(row[1]))) if row else None

    def delete(self, mid: str) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute("DELETE FROM models WHERE id=?", (mid,))

    def list_model_ids(self) -> List[str]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id FROM models ORDER BY id").fetchall()
        return [r[0] for r in rows]

    def fsck(self, repair: bool = False) -> List[dict]:
        """Verify every row's envelope; with `repair`, move a corrupt
        row into `models_quarantine` (its reason and time beside it)."""
        findings: List[dict] = []
        for mid in self.list_model_ids():
            with self.c.lock:
                row = self.c.conn.execute(
                    "SELECT models FROM models WHERE id=?", (mid,)
                ).fetchone()
            if row is None:
                continue
            blob = bytes(row[0])
            ok, reason = integrity.verify(blob)
            if ok:
                continue
            finding = {"kind": "corrupt_blob", "id": mid,
                       "reason": reason, "action": "none"}
            if repair:
                with self.c.lock, self.c.conn:
                    self.c.conn.execute(
                        "INSERT OR REPLACE INTO models_quarantine "
                        "(id, models, reason, quarantined_at) "
                        "VALUES (?,?,?,?)",
                        (mid, blob, reason, to_millis(utcnow())))
                    self.c.conn.execute(
                        "DELETE FROM models WHERE id=?", (mid,))
                finding["action"] = "quarantined -> models_quarantine"
            findings.append(finding)
        return findings

    def quarantine_stats(self) -> dict:
        """Footprint of `models_quarantine` (`pio_quarantine_bytes`)."""
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT COUNT(*), COALESCE(SUM(LENGTH(models)), 0) "
                "FROM models_quarantine").fetchone()
        return {"bytes": float(row[1]), "count": float(row[0])}

    def quarantine_gc(self, retention_s: float) -> List[dict]:
        """Drop quarantined rows past the retention window (a row
        without `quarantined_at` predates the column: expired)."""
        cutoff_ms = to_millis(utcnow()) - int(retention_s * 1000)
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, LENGTH(models) FROM models_quarantine "
                "WHERE quarantined_at IS NULL OR quarantined_at <= ?",
                (cutoff_ms,)).fetchall()
        findings: List[dict] = []
        for mid, size in rows:
            with self.c.lock, self.c.conn:
                self.c.conn.execute(
                    "DELETE FROM models_quarantine WHERE id=?", (mid,))
            findings.append({
                "kind": "quarantine_expired", "id": mid,
                "reason": f"quarantined row ({size or 0}B) past "
                          f"{retention_s:.0f}s retention",
                "action": "deleted"})
        return findings


class SQLiteTenantQuotas(base.TenantQuotas):
    """Per-app admission overrides; NULL columns inherit the server's
    defaults."""

    _COLS = "appid, rate, burst, concurrency, queue_max, weight, channel"

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def upsert(self, quota: TenantQuota) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                f"INSERT OR REPLACE INTO tenant_quotas ({self._COLS}) "
                "VALUES (?,?,?,?,?,?,?)",
                (quota.appid, quota.rate, quota.burst, quota.concurrency,
                 quota.queue_max, quota.weight, quota.channel))

    def get(self, appid: int, channel: str = "") -> Optional[TenantQuota]:
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT {self._COLS} FROM tenant_quotas "
                "WHERE appid=? AND channel=?", (appid, channel)).fetchone()
        return TenantQuota(*row) if row else None

    def get_all(self) -> List[TenantQuota]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self._COLS} FROM tenant_quotas "
                "ORDER BY appid, channel").fetchall()
        return [TenantQuota(*r) for r in rows]

    def delete(self, appid: int, channel: str = "") -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "DELETE FROM tenant_quotas WHERE appid=? AND channel=?",
                (appid, channel))


class SQLiteSLOObjectives(base.SLOObjectives):
    """Per-app SLO overrides; NULL columns inherit the server-wide
    objective."""

    _COLS = "appid, latency_ms, target"

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def upsert(self, slo: SLOObjective) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                f"INSERT OR REPLACE INTO slo_objectives ({self._COLS}) "
                "VALUES (?,?,?)", (slo.appid, slo.latency_ms, slo.target))

    def get(self, appid: int) -> Optional[SLOObjective]:
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT {self._COLS} FROM slo_objectives WHERE appid=?",
                (appid,)).fetchone()
        return SLOObjective(*row) if row else None

    def get_all(self) -> List[SLOObjective]:
        with self.c.lock:
            rows = self.c.conn.execute(
                f"SELECT {self._COLS} FROM slo_objectives "
                "ORDER BY appid").fetchall()
        return [SLOObjective(*r) for r in rows]

    def delete(self, appid: int) -> None:
        with self.c.lock, self.c.conn:
            self.c.conn.execute(
                "DELETE FROM slo_objectives WHERE appid=?", (appid,))


class SQLiteLeases(base.Leases):
    """A compare-and-swap lease over one row: the client's lock and an
    immediate transaction make read-check-write atomic in this process,
    WAL's single writer across the processes sharing the file."""

    def __init__(self, client: SQLiteStorageClient):
        self.c = client

    def acquire(self, name: str, holder: str, ttl_s: float,
                journal: Optional[str] = None) -> Optional[base.Lease]:
        now_ms = to_millis(utcnow())
        exp_ms = now_ms + int(ttl_s * 1000)
        with self.c.lock, self.c.conn:
            self.c.conn.execute("BEGIN IMMEDIATE")
            row = self.c.conn.execute(
                "SELECT name, holder, expires_ms, journal FROM leases "
                "WHERE name=?", (name,)).fetchone()
            if row is not None and row[1] != holder and row[2] > now_ms:
                return None
            keep = (row[3] if row is not None else "") \
                if journal is None else journal
            self.c.conn.execute(
                "INSERT OR REPLACE INTO leases (name, holder, expires_ms, "
                "journal) VALUES (?,?,?,?)", (name, holder, exp_ms, keep))
        return base.Lease(name, holder, from_millis(exp_ms), keep or "")

    def get(self, name: str) -> Optional[base.Lease]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT name, holder, expires_ms, journal FROM leases "
                "WHERE name=?", (name,)).fetchone()
        return (base.Lease(row[0], row[1], from_millis(row[2]), row[3] or "")
                if row else None)

    def release(self, name: str, holder: str) -> bool:
        with self.c.lock, self.c.conn:
            cur = self.c.conn.execute(
                "DELETE FROM leases WHERE name=? AND holder=?",
                (name, holder))
            return cur.rowcount > 0


def _event_row(e: Event, event_id: str) -> tuple:
    return (event_id, e.event, e.entity_type, e.entity_id,
            e.target_entity_type, e.target_entity_id,
            e.properties.to_json(), to_millis(e.event_time),
            json.dumps(list(e.tags)) if e.tags else "[]", e.pr_id,
            to_millis(e.creation_time))


def _where(start_time, until_time, entity_type, entity_id, event_names,
           target_entity_type, target_entity_id):
    """The SQL filter of `find` and `scan_columns`: (clauses, params)."""
    clauses, params = [], []
    if start_time is not None:
        clauses.append("eventtime >= ?")
        params.append(to_millis(start_time))
    if until_time is not None:
        clauses.append("eventtime < ?")
        params.append(to_millis(until_time))
    if entity_type is not None:
        clauses.append("entitytype = ?")
        params.append(entity_type)
    if entity_id is not None:
        clauses.append("entityid = ?")
        params.append(entity_id)
    if event_names is not None:
        names = list(event_names)
        clauses.append("event IN (" + ",".join("?" * len(names)) + ")")
        params.extend(names)
    for col, v in (("targetentitytype", target_entity_type),
                   ("targetentityid", target_entity_id)):
        if v is _UNSET:
            continue
        if v is None:
            clauses.append(f"{col} IS NULL")
        else:
            clauses.append(f"{col} = ?")
            params.append(v)
    return clauses, params


class SQLiteEvents(base.EventStore):
    """Event store over per-(app, channel) tables (JDBCLEvents.scala),
    created on first access."""

    def __init__(self, client: SQLiteStorageClient):
        self.c = client
        self._known: set = set()

    def _ensure(self, app_id: int, channel_id: Optional[int]) -> str:
        if (app_id, channel_id) not in self._known:
            self.init(app_id, channel_id)
        return event_table_name(app_id, channel_id)

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = event_table_name(app_id, channel_id)
        self._known.add((app_id, channel_id))
        with self.c.lock, self.c.conn:
            self.c.conn.execute(f"""CREATE TABLE IF NOT EXISTS {t} (
                id TEXT PRIMARY KEY,
                event TEXT NOT NULL,
                entitytype TEXT NOT NULL,
                entityid TEXT NOT NULL,
                targetentitytype TEXT,
                targetentityid TEXT,
                properties TEXT,
                eventtime INTEGER NOT NULL,
                tags TEXT,
                prid TEXT,
                creationtime INTEGER NOT NULL)""")
            self.c.conn.execute(
                f"CREATE INDEX IF NOT EXISTS {t}_entity ON {t} "
                "(entitytype, entityid)")
            self.c.conn.execute(
                f"CREATE INDEX IF NOT EXISTS {t}_time ON {t} (eventtime)")
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        t = event_table_name(app_id, channel_id)
        with self.c.lock, self.c.conn:
            self.c.conn.execute(f"DROP TABLE IF EXISTS {t}")
            self._bump_gen(t)
        self._known.discard((app_id, channel_id))
        return True

    def close(self) -> None:
        pass

    def _bump_gen(self, table: str) -> None:
        # the caller holds the lock and the write's transaction
        self.c.conn.execute(
            "INSERT INTO events_ingest_gen (tbl, gen) VALUES (?, 1) "
            "ON CONFLICT(tbl) DO UPDATE SET gen = gen + 1", (table,))

    def ingest_watermark(self, app_id: int,
                         channel_id: Optional[int] = None
                         ) -> Optional[Dict[str, int]]:
        """The table's generation counter, bumped inside every write
        transaction (either package's): the prepared-data cache's key.
        It carries no offsets, so a delta scan raises
        `DeltaInvalidated`."""
        t = event_table_name(app_id, channel_id)
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT gen FROM events_ingest_gen WHERE tbl=?",
                (t,)).fetchone()
        return {"gen": int(row[0]) if row else 0}

    def ingest_cache_dir(self, app_id: int,
                         channel_id: Optional[int] = None):
        """`ingest_cache/<table>` beside a file-backed database (the JAX
        package's place); None for an in-memory one."""
        path = getattr(self.c, "path", None)
        if not path or path == ":memory:":
            return None
        return str(Path(path).parent / "ingest_cache"
                   / event_table_name(app_id, channel_id))

    def _insert(self, event: Event, app_id: int,
                channel_id: Optional[int] = None) -> str:
        return self._insert_batch([event], app_id, channel_id)[0]

    def _insert_batch(self, events: Sequence[Event], app_id: int,
                      channel_id: Optional[int] = None) -> List[str]:
        t = self._ensure(app_id, channel_id)
        # the id made here, not by `with_id`, which copies the event:
        # a bulk import's rows cost a fifth less (phase lifecycle's)
        rows = [_event_row(e, e.event_id or _gen_event_id())
                for e in events]
        try:
            with self.c.lock, self.c.conn:
                self.c.conn.executemany(
                    f"INSERT INTO {t} VALUES (?,?,?,?,?,?,?,?,?,?,?)", rows)
                self._bump_gen(t)
        except sqlite3.IntegrityError as ex:
            raise base.StorageWriteError(str(ex)) from ex
        return [r[0] for r in rows]

    @staticmethod
    def _row_to_event(r) -> Event:
        return Event(
            event_id=r[0], event=r[1], entity_type=r[2], entity_id=r[3],
            target_entity_type=r[4], target_entity_id=r[5],
            properties=DataMap.from_json(r[6] or "{}"),
            event_time=from_millis(r[7]),
            tags=tuple(json.loads(r[8] or "[]")), pr_id=r[9],
            creation_time=from_millis(r[10]))

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        t = self._ensure(app_id, channel_id)
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT * FROM {t} WHERE id=?", (event_id,)).fetchone()
        return self._row_to_event(row) if row else None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        t = self._ensure(app_id, channel_id)
        with self.c.lock, self.c.conn:
            cur = self.c.conn.execute(f"DELETE FROM {t} WHERE id=?",
                                      (event_id,))
            if cur.rowcount > 0:
                self._bump_gen(t)
            return cur.rowcount > 0

    def find(self, app_id: int, channel_id: Optional[int] = None, *,
             start_time: Optional[datetime] = None,
             until_time: Optional[datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type: object = _UNSET,
             target_entity_id: object = _UNSET,
             properties=None,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        t = self._ensure(app_id, channel_id)
        clauses, params = _where(start_time, until_time, entity_type,
                                 entity_id, event_names, target_entity_type,
                                 target_entity_id)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        order = (" ORDER BY eventtime DESC, id DESC" if reversed
                 else " ORDER BY eventtime ASC, id ASC")
        # a property filter runs after the SQL (the column is a JSON
        # text), so LIMIT moves after it
        lim = (f" LIMIT {int(limit)}"
               if limit is not None and limit > 0 and not properties else "")
        with self.c.lock:
            cur = self.c.conn.execute(
                f"SELECT * FROM {t}{where}{order}{lim}", params)
            if not properties:
                events = [self._row_to_event(r) for r in cur.fetchall()]
            else:
                events = []
                for r in cur:
                    e = self._row_to_event(r)
                    if match_properties(e, properties):
                        events.append(e)
                        if limit is not None and 0 < limit <= len(events):
                            break
        return iter(events)

    def scan_columns(self, app_id: int, channel_id: Optional[int] = None, *,
                     start_time: Optional[datetime] = None,
                     until_time: Optional[datetime] = None,
                     entity_type: Optional[str] = None,
                     entity_id: Optional[str] = None,
                     event_names: Optional[Sequence[str]] = None,
                     target_entity_type: object = _UNSET,
                     target_entity_id: object = _UNSET,
                     properties=None,
                     value_spec=None, require_target: bool = True,
                     workers: Optional[int] = None,
                     since=None, upto=None):
        """Columnar scan in SQL: a projection of the five columns the
        row stream needs, with `find()`'s filter, in `find()`'s order
        (eventtime, id), so the first-seen interning gives the tables
        of the base adapter, which builds an `Event` per row and takes
        about three times as long at MovieLens-1M's shape on an H100's
        host (PERF.md §6). A property filter or a delta (`since`) goes
        to the base adapter; `workers` is ignored (one cursor)."""
        del workers
        filt = dict(start_time=start_time, until_time=until_time,
                    entity_type=entity_type, entity_id=entity_id,
                    event_names=event_names,
                    target_entity_type=target_entity_type,
                    target_entity_id=target_entity_id)
        if properties or since is not None:
            return super().scan_columns(
                app_id, channel_id, properties=properties,
                value_spec=value_spec, require_target=require_target,
                since=since, upto=upto, **filt)
        t = self._ensure(app_id, channel_id)
        clauses, params = _where(**filt)
        if require_target:
            clauses.append("targetentityid IS NOT NULL")
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        spec = columns.normalize_value_spec(value_spec)
        # the properties JSON is parsed only when a value rule reads it
        need_props = any(ent[0] != "const" for ent in spec.values())
        b = columns.BlockBuilder()
        with self.c.lock:
            cur = self.c.conn.execute(
                "SELECT event, entityid, targetentityid, properties, "
                f"eventtime FROM {t}{where} ORDER BY eventtime ASC, id ASC",
                params)
            for name, eid, tei, props_json, ms in cur:
                props = (json.loads(props_json)
                         if need_props and props_json else None)
                v = columns.eval_value(spec, name, props)
                if v is not None:
                    b.add(eid, tei, float(v), ms * 1000)
        return columns.merge_blocks([b.block()])
