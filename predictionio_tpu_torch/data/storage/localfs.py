"""Local-filesystem model store ("LOCALFS" type).

The port of `predictionio_tpu/data/storage/localfs.py` (reference
`storage/localfs/.../LocalFSModels.scala:62`): model blobs as files
`pio_model_<id>` under the source's `PATH`, and fleet leases as JSON
files `pio_lease_<name>` beside them.

Durability: every blob is wrapped in the integrity envelope
(`data/integrity.py`) and written atomically (tmp → fsync → rename), so
a crash mid-insert can never leave a torn file under the final name.
`get` verifies the checksum and raises `CorruptBlobError` on mismatch;
`fsck` sweeps the directory, quarantining corrupt blobs into
`.quarantine/` (with a `.reason` sidecar) and clearing orphaned `*.tmp`
files from interrupted writes.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from pathlib import Path
from typing import List, Optional

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.event import from_millis, to_millis, utcnow
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import Lease, Model
from predictionio_tpu_torch.resilience import FaultError, faults


class LocalFSStorageClient:
    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        path = self.config.get("PATH", self.config.get("path", "~/.pio_store/models"))
        self.path = Path(os.path.expanduser(path))
        self.path.mkdir(parents=True, exist_ok=True)
        self.source_name = self.config.get("SOURCE_NAME", "LOCALFS")


class LocalFSLeases(base.Leases):
    """Lease row as a JSON file (`pio_lease_<name>`), CAS'd under an
    O_EXCL lockfile — the only cross-process mutual exclusion a plain
    filesystem offers. A lockfile left behind by a crashed holder is
    broken after `_STALE_LOCK_S` (the CAS critical section is a few
    syscalls; anything holding it for seconds is dead)."""

    _STALE_LOCK_S = 5.0

    def __init__(self, client: LocalFSStorageClient):
        self.c = client

    def _file(self, name: str) -> Path:
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "_"
                       for ch in name)
        return self.c.path / f"pio_lease_{safe}"

    @contextlib.contextmanager
    def _cas_lock(self, name: str, timeout_s: float = 2.0):
        lock = self._file(name).with_name(self._file(name).name + ".lock")
        pause = threading.Event()
        waited = 0.0
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                break
            except FileExistsError:
                try:
                    age = utcnow().timestamp() - lock.stat().st_mtime
                    if age > self._STALE_LOCK_S:
                        lock.unlink(missing_ok=True)
                        continue
                except OSError:
                    continue    # lock vanished between open and stat
                if waited >= timeout_s:
                    raise base.StorageUnavailableError(
                        f"lease lockfile {lock} held for {waited:.1f}s")
                pause.wait(0.005)
                waited += 0.005
        try:
            yield
        finally:
            lock.unlink(missing_ok=True)

    def _read(self, name: str) -> Optional[Lease]:
        try:
            data = json.loads(self._file(name).read_bytes())
        except (OSError, ValueError):
            return None
        return Lease(data["name"], data["holder"],
                     from_millis(data["expires_ms"]),
                     data.get("journal", ""))

    def acquire(self, name: str, holder: str, ttl_s: float,
                journal: Optional[str] = None) -> Optional[Lease]:
        with self._cas_lock(name):
            cur = self._read(name)
            now = utcnow()
            if cur is not None and cur.holder != holder \
                    and not cur.expired(now):
                return None
            keep = (cur.journal if cur is not None else "") \
                if journal is None else journal
            exp_ms = to_millis(now) + int(ttl_s * 1000)
            lease = Lease(name, holder, from_millis(exp_ms), keep)
            integrity.atomic_write_bytes(self._file(name), json.dumps({
                "name": name, "holder": holder, "expires_ms": exp_ms,
                "journal": keep}).encode())
            return lease

    def get(self, name: str) -> Optional[Lease]:
        # atomic rename on write: an unlocked read never sees a torn row
        return self._read(name)

    def release(self, name: str, holder: str) -> bool:
        with self._cas_lock(name):
            cur = self._read(name)
            if cur is None or cur.holder != holder:
                return False
            self._file(name).unlink(missing_ok=True)
            return True


class LocalFSModels(base.Models):
    def __init__(self, client: LocalFSStorageClient):
        self.c = client

    def _file(self, mid: str) -> Path:
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "_" for ch in mid)
        return self.c.path / f"pio_model_{safe}"

    def insert(self, m: Model) -> None:
        wrapped = integrity.wrap(m.models)
        path = self._file(m.id)
        # crash-consistency seam: when a torn-write fault is armed, only
        # a fraction of the bytes reach the final path (simulating a
        # crash mid-write on a non-atomic store) and the "process dies"
        seam = f"storage.{self.c.source_name}.models.insert.torn"
        frac = faults().torn_fraction(seam)
        if frac is not None:
            path.write_bytes(wrapped[:int(len(wrapped) * frac)])
            raise FaultError(f"injected torn write at {seam}")
        integrity.atomic_write_bytes(path, wrapped)

    def get(self, mid: str) -> Optional[Model]:
        f = self._file(mid)
        if not f.exists():
            return None
        return Model(mid, integrity.unwrap(f.read_bytes()))

    def delete(self, mid: str) -> None:
        f = self._file(mid)
        if f.exists():
            f.unlink()
        integrity.purge_tmp_siblings(f)

    def list_model_ids(self) -> List[str]:
        """Ids derived from the `pio_model_*` filenames (the escape in
        `_file` is lossy for non-alnum ids — see base.Models)."""
        return sorted(
            f.name[len("pio_model_"):] for f in self.c.path.glob("pio_model_*")
            if not f.name.endswith(".tmp"))

    def fsck(self, repair: bool = False) -> List[dict]:
        """Scan all blobs; quarantine corrupt ones and purge orphaned
        tmp files when `repair` is set. Returns finding dicts."""
        findings: List[dict] = []
        for f in sorted(self.c.path.glob("pio_model_*")):
            if f.name.endswith(".tmp"):
                finding = {"kind": "tmp_orphan", "path": str(f),
                           "reason": "leftover tmp from interrupted write",
                           "action": "none"}
                if repair:
                    try:
                        f.unlink()
                        finding["action"] = "removed"
                    except OSError as exc:
                        finding["action"] = f"remove failed: {exc}"
                findings.append(finding)
                continue
            try:
                ok, reason = integrity.verify(f.read_bytes())
            except OSError as exc:
                ok, reason = False, f"unreadable: {exc}"
            if ok:
                continue
            finding = {"kind": "corrupt_blob", "path": str(f),
                       "reason": reason, "action": "none"}
            if repair:
                dest = integrity.quarantine_file(f, reason)
                finding["action"] = f"quarantined -> {dest}"
            findings.append(finding)
        return findings

    def quarantine_stats(self) -> dict:
        """Footprint of `.quarantine/` (feeds pio_quarantine_bytes)."""
        qdir = self.c.path / ".quarantine"
        total, count = 0, 0
        if qdir.is_dir():
            for f in qdir.iterdir():
                if f.name.endswith(".reason") or not f.is_file():
                    continue
                total += f.stat().st_size
                count += 1
        return {"bytes": float(total), "count": float(count)}

    def quarantine_gc(self, retention_s: float) -> List[dict]:
        """Delete quarantined blobs (and their reason sidecars) older
        than the retention window — quarantine is a forensic holding
        area, not an archive. Age is measured from the `.reason`
        sidecar's mtime (stamped at quarantine time; os.replace
        preserves the blob's own, possibly ancient, mtime), falling
        back to the blob's mtime when the sidecar is gone."""
        qdir = self.c.path / ".quarantine"
        if not qdir.is_dir():
            return []
        now = utcnow().timestamp()
        cutoff = now - retention_s
        findings: List[dict] = []
        for f in sorted(qdir.iterdir()):
            if f.name.endswith(".reason") or not f.is_file():
                continue
            try:
                sidecar = f.with_name(f.name + ".reason")
                mtime = (sidecar.stat().st_mtime if sidecar.exists()
                         else f.stat().st_mtime)
            except OSError:
                continue
            if mtime > cutoff:
                continue
            age = now - mtime
            finding = {"kind": "quarantine_expired", "path": str(f),
                       "reason": f"quarantined {age:.0f}s ago "
                                 f"(retention {retention_s:.0f}s)",
                       "action": "none"}
            try:
                f.unlink()
                f.with_name(f.name + ".reason").unlink(missing_ok=True)
                finding["action"] = "deleted"
            except OSError as exc:
                finding["action"] = f"delete failed: {exc}"
            findings.append(finding)
        return findings
