"""Store-wide recovery pass (fsck), stale-instance janitor and doctor.

The port of `predictionio_tpu/data/fsck.py`. After a crash a server must
come back clean, so its startup (and `pio doctor` on demand) sweeps the
bound stores for what a crash leaves behind:

  - corrupt model blobs (torn writes, bit rot): quarantined with a
    reason, so that deploy resolves to the newest intact COMPLETED
    instance instead of failing on the blob
  - torn event-journal tails (EVLOG, PEVLOG): truncated to the last
    valid frame (a torn tail hides every later append from scans)
  - stale PEVLOG segment sidecars: rebuilt from the journal
  - replicas of one model that disagree (REPLICATED): the majority copy
    rewritten to the others
  - INIT/TRAINING instance rows whose heartbeat went stale (a `train`
    killed mid-run): marked FAILED

A driver takes part by exposing `fsck(repair) -> [finding]`; each
finding carries `kind`, `reason` and `action`. The pass is counted in
`pio_fsck_runs_total{mode}`, `pio_fsck_findings_total{kind}`,
`pio_fsck_quarantined_total`, `pio_fsck_repaired_total`,
`pio_fsck_last_run_ts`, `pio_janitor_failed_total`,
`pio_quarantine_bytes` and `pio_quarantine_count`.

The startup sweep reports without repairing and runs the janitor; a
scheduled pass (`ScheduledFsck`) runs every `PIO_FSCK_INTERVAL_S`
seconds when that is set, and GCs quarantined blobs older than
`PIO_QUARANTINE_RETENTION_S` (default 7 days). The JAX package's
`PIO_FSCK_ON_STARTUP`, `PIO_JANITOR` and `PIO_JANITOR_STALE_S` are
constants here (on, on, `DEFAULT_STALE_S`).
"""

from __future__ import annotations

import threading
from datetime import timedelta
from typing import Dict, List, Optional

from predictionio_tpu_torch.data.event import utcnow
from predictionio_tpu_torch.data.storage.base import (EngineInstanceStatus,
                                                      StorageError, _aware)
from predictionio_tpu_torch.obs import get_registry

DEFAULT_STALE_S = 900.0
DEFAULT_RETENTION_S = 7 * 24 * 3600.0


def _metrics():
    reg = get_registry()
    return {
        "runs": reg.counter(
            "pio_fsck_runs_total", "fsck passes executed",
            labels=("mode",)),
        "findings": reg.counter(
            "pio_fsck_findings_total", "fsck findings by kind",
            labels=("kind",)),
        "quarantined": reg.counter(
            "pio_fsck_quarantined_total",
            "Corrupt model blobs moved to quarantine"),
        "repaired": reg.counter(
            "pio_fsck_repaired_total", "fsck findings repaired"),
        "janitor": reg.counter(
            "pio_janitor_failed_total",
            "Stale INIT/TRAINING instances transitioned to FAILED"),
        "last_run": reg.gauge(
            "pio_fsck_last_run_ts",
            "Unix timestamp of the last completed fsck pass"),
        "qbytes": reg.gauge(
            "pio_quarantine_bytes",
            "Bytes currently held in model-blob quarantine"),
        "qcount": reg.gauge(
            "pio_quarantine_count",
            "Blobs currently held in model-blob quarantine"),
    }


def fsck_registry(registry, repair: bool = False) -> List[dict]:
    """Run every bound repository DAO's fsck; returns all findings.

    Scans the MODELDATA Models DAO and the EVENTDATA Events DAO (the
    two stores a crash can tear); DAOs without an fsck method (e.g.
    MEM) contribute nothing. Never raises on a per-DAO failure — a
    broken store must not prevent the rest from being checked.
    """
    m = _metrics()
    m["runs"].labels(mode="repair" if repair else "report").inc()
    findings: List[dict] = []
    daos = []
    try:
        daos.append(("models", registry.get_model_data_models()))
    except StorageError:
        pass
    try:
        daos.append(("events", registry.get_events()))
    except StorageError:
        pass
    for repo, dao in daos:
        run = getattr(dao, "fsck", None)
        if run is None:
            continue
        try:
            found = run(repair=repair)
        except (StorageError, OSError) as exc:
            found = [{"kind": "fsck_error", "repo": repo,
                      "reason": str(exc), "action": "none"}]
        if repo == "models":
            found.extend(_check_divergence(registry, dao, repair))
        for f in found:
            f.setdefault("repo", repo)
            m["findings"].labels(kind=f.get("kind", "unknown")).inc()
            acted = f.get("action", "none") != "none"
            if acted:
                m["repaired"].inc()
            if f.get("kind") == "corrupt_blob" and acted:
                m["quarantined"].inc()
        findings.extend(found)
        if repo == "models":
            _update_quarantine_gauges(dao, m)
    m["last_run"].set(utcnow().timestamp())
    return findings


def _check_divergence(registry, models_dao, repair: bool) -> List[dict]:
    """Replica-divergence sweep (REPLICATED model source only). The id
    universe is metadata-derived instance ids UNION the store's own
    enumerable ids (`Models.list_model_ids`) — a blob whose instance
    row was deleted, or that only a subset of replicas holds, is
    invisible to the metadata store yet is exactly the divergence the
    sweep exists to catch. Instance ids are alphanumeric, so the lossy
    localfs filename escape is the identity for every id the system
    writes."""
    check = getattr(models_dao, "check_divergence", None)
    if check is None:
        return []
    try:
        ids = {row.id for row in
               registry.get_meta_data_engine_instances().get_all()}
        lister = getattr(models_dao, "list_model_ids", None)
        if lister is not None:
            ids.update(lister())
        return check(sorted(ids), repair=repair) if ids else []
    except (StorageError, OSError) as exc:
        return [{"kind": "fsck_error", "repo": "models",
                 "reason": f"divergence check failed: {exc}",
                 "action": "none"}]


def _update_quarantine_gauges(models_dao, m) -> None:
    stats = getattr(models_dao, "quarantine_stats", None)
    if stats is None:
        return
    try:
        s = stats()
    except (StorageError, OSError):
        return
    m["qbytes"].set(s.get("bytes", 0.0))
    m["qcount"].set(s.get("count", 0.0))


def quarantine_gc(registry,
                  retention_s: float = DEFAULT_RETENTION_S) -> List[dict]:
    """Purge quarantined blobs past the retention window on the bound
    models store — quarantine is forensic evidence, not an archive, and
    unbounded quarantine growth is its own disk-full incident."""
    try:
        dao = registry.get_model_data_models()
    except StorageError:
        return []
    gc = getattr(dao, "quarantine_gc", None)
    if gc is None:
        return []
    m = _metrics()
    try:
        findings = gc(retention_s)
    except (StorageError, OSError) as exc:
        findings = [{"kind": "quarantine_gc_error", "reason": str(exc),
                     "action": "none"}]
    for f in findings:
        f.setdefault("repo", "models")
        m["findings"].labels(kind=f.get("kind", "unknown")).inc()
    _update_quarantine_gauges(dao, m)
    return findings


def janitor_stale_instances(registry, stale_after_s: float = DEFAULT_STALE_S,
                            repair: bool = True) -> List[dict]:
    """Fail INIT/TRAINING rows whose liveness signal went stale.

    A row is stale when its heartbeat — or, if the trainer died before
    the first beat, its start_time — is older than `stale_after_s`.
    With `repair`, stale rows become FAILED so deploy's
    `get_latest_completed` resolution can't pick up a ghost.
    """
    m = _metrics()
    findings: List[dict] = []
    instances = registry.get_meta_data_engine_instances()
    cutoff = utcnow() - timedelta(seconds=stale_after_s)
    live = (EngineInstanceStatus.INIT, EngineInstanceStatus.TRAINING)
    for row in instances.get_all():
        if row.status not in live:
            continue
        last = row.heartbeat or row.start_time
        if _aware(last) >= cutoff:
            continue
        age = (utcnow() - _aware(last)).total_seconds()
        finding = {"kind": "stale_instance", "id": row.id,
                   "status": row.status,
                   "reason": f"no heartbeat for {age:.0f}s",
                   "action": "none"}
        if repair:
            instances.update(row.with_(
                status=EngineInstanceStatus.FAILED, end_time=utcnow()))
            m["janitor"].inc()
            finding["action"] = "marked FAILED"
        findings.append(finding)
    return findings


def doctor(registry, repair: bool = False,
           stale_after_s: float = DEFAULT_STALE_S) -> Dict[str, object]:
    """The `pio doctor` report: fsck + janitor + breaker states."""
    store_findings = fsck_registry(registry, repair=repair)
    janitor_findings = janitor_stale_instances(
        registry, stale_after_s=stale_after_s, repair=repair)
    unrepaired = [
        f for f in store_findings + janitor_findings
        if f.get("action", "none") == "none"]
    return {
        "fsck": store_findings,
        "janitor": janitor_findings,
        "breakers": registry.breaker_states(),
        "repair": repair,
        "unrepaired": len(unrepaired),
    }


def startup_check(registry, log=None) -> Optional[Dict[str, object]]:
    """A server's recovery pass at boot: fsck reporting only (repairs
    are the operator's `pio doctor --repair`), the janitor acting (a
    stale row is unambiguous). Never raises: a damaged store must not
    stop a server that can still serve."""
    try:
        report = {
            "fsck": fsck_registry(registry, repair=False),
            "janitor": janitor_stale_instances(registry, DEFAULT_STALE_S,
                                               True),
        }
    except (StorageError, OSError) as exc:
        if log is not None:
            log("fsck.startup.error", error=str(exc))
        return None
    if log is not None and (report["fsck"] or report["janitor"]):
        log("fsck.startup",
            findings=len(report["fsck"]), janitor=len(report["janitor"]))
    return report


class ScheduledFsck:
    """Background fsck on an interval (PIO_FSCK_INTERVAL_S; off by
    default). Each tick runs the report-only fsck pass (repairs remain
    an explicit operator action via `pio doctor --repair`) plus
    quarantine GC past PIO_QUARANTINE_RETENTION_S, refreshing
    `pio_fsck_last_run_ts` / `pio_quarantine_bytes`. One instance per
    process (the fleet control plane runs it, not every replica)."""

    def __init__(self, registry, interval_s: float,
                 retention_s: float = DEFAULT_RETENTION_S, log=None):
        self.registry = registry
        self.interval_s = interval_s
        self.retention_s = retention_s
        self.log = log
        self._stop = threading.Event()
        self._thread = None
        self.beat = None                # watchdog liveness stamp

    def start(self) -> "ScheduledFsck":
        if self.beat is None:
            from predictionio_tpu_torch.resilience.watchdog import watchdog
            self.beat = watchdog().register(
                "fsck", budget_s=self.interval_s * 3.0 + 10.0,
                restart=self._spawn)
        self._spawn()
        return self

    def _spawn(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-fsck-sched", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def run_once(self) -> Dict[str, List[dict]]:
        """One tick, callable synchronously (tests, forced sweeps)."""
        report = {"fsck": fsck_registry(self.registry, repair=False),
                  "gc": quarantine_gc(self.registry, self.retention_s)}
        if self.log is not None and (report["fsck"] or report["gc"]):
            self.log("fsck.scheduled", findings=len(report["fsck"]),
                     gc=len(report["gc"]))
        return report

    def _loop(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._loop_body)
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        beat = self.beat
        while not self._stop.wait(self.interval_s):
            if beat is not None:
                beat.tick()
            try:
                self.run_once()
            except Exception as exc:
                # a broken store must not kill the scheduler thread —
                # the next tick retries and /metrics shows the stall
                if self.log is not None:
                    self.log("fsck.scheduled.error", error=str(exc))


def start_scheduled_fsck(registry, log=None) -> Optional[ScheduledFsck]:
    """Start the background fsck scheduler if PIO_FSCK_INTERVAL_S is
    configured (>0); returns the handle, or None when disabled."""
    cfg = getattr(registry, "config", {}) or {}
    raw = str(cfg.get("PIO_FSCK_INTERVAL_S", "")).lower()
    if raw in ("", "off", "0", "false", "no", "none"):
        return None
    interval = float(raw)
    retention = float(cfg.get("PIO_QUARANTINE_RETENTION_S",
                              DEFAULT_RETENTION_S))
    return ScheduledFsck(registry, interval, retention, log=log).start()
