"""EVLOG storage driver: events on the native append-only journal.

The port of `predictionio_tpu/data/storage/evlog.py` (the role of the
reference's HBase event store, `storage/hbase/HBEventsUtil.scala`: one
table per app/channel; here one CRC-framed journal per app/channel,
appended through `native/eventlog.cpp`, flock-safe across processes).
Deletes append tombstone frames; readers replay the journal, cached per
file until it grows. It also holds the time and payload helpers PEVLOG
shares (`_us`, `_from_us`, `_payload_to_event`).

Config: PIO_STORAGE_SOURCES_<NAME>_TYPE=EVLOG, ..._PATH=<dir>.
"""

from __future__ import annotations

import json
import threading
from dataclasses import replace
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.native.eventlog import EventLog


class EvlogStorageClient:
    def __init__(self, config):
        self.base_dir = Path(config.get("PATH", "./.pio_store/evlog"))
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.lock = threading.RLock()
        # path -> (journal size when replayed, {event_id: Event})
        self.cache: Dict[str, Tuple[int, Dict[str, Event]]] = {}

    def close(self) -> None:
        pass


def _event_to_payload(e: Event) -> bytes:
    obj = e.to_api_json()
    # microsecond times survive the journal exactly
    obj["eventTimeUs"] = _us(e.event_time)
    obj["creationTimeUs"] = _us(e.creation_time)
    return json.dumps(obj, separators=(",", ":")).encode()


def _us(t: datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return int(t.timestamp() * 1_000_000)


def _from_us(us: int) -> datetime:
    return datetime.fromtimestamp(us / 1_000_000, tz=timezone.utc)


def _payload_to_event(obj: dict) -> Event:
    e = Event.from_api_json(obj)
    if "eventTimeUs" in obj:
        e = replace(e, event_time=_from_us(obj["eventTimeUs"]),
                    creation_time=_from_us(obj["creationTimeUs"]))
    return e


class EvlogEvents(base.EventStore):
    def __init__(self, client: EvlogStorageClient):
        self.c = client

    def _path(self, app_id: int, channel_id: Optional[int]) -> Path:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return self.c.base_dir / f"events_{app_id}{suffix}.log"

    def _replay(self, app_id: int,
                channel_id: Optional[int]) -> Dict[str, Event]:
        """Journal -> {event_id: Event}, cached until the file grows."""
        path = self._path(app_id, channel_id)
        size = path.stat().st_size if path.exists() else 0
        with self.c.lock:
            cached = self.c.cache.get(str(path))
            if cached is not None and cached[0] == size:
                return cached[1]
            table: Dict[str, Event] = {}
            for payload in EventLog(str(path)).payloads():
                obj = json.loads(payload)
                if "$tombstone" in obj:
                    table.pop(obj["$tombstone"], None)
                else:
                    e = _payload_to_event(obj)
                    table[e.event_id] = e
            self.c.cache[str(path)] = (size, table)
            return table

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        if not path.exists():
            path.touch()
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        path = self._path(app_id, channel_id)
        with self.c.lock:
            if path.exists():
                EventLog(str(path)).truncate()
            self.c.cache.pop(str(path), None)
        return True

    def close(self) -> None:
        pass

    def _insert(self, event: Event, app_id: int,
                channel_id: Optional[int] = None) -> str:
        e = event if event.event_id else event.with_id()
        with self.c.lock:
            if e.event_id in self._replay(app_id, channel_id):
                raise base.StorageWriteError(
                    f"Duplicate event id {e.event_id}")
            EventLog(str(self._path(app_id, channel_id))).append(
                _event_to_payload(e))
        return e.event_id

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        return self._replay(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            if event_id not in self._replay(app_id, channel_id):
                return False
            EventLog(str(self._path(app_id, channel_id))).append(
                json.dumps({"$tombstone": event_id}).encode())
        return True

    def find(self, app_id: int, channel_id: Optional[int] = None, *,
             start_time=None, until_time=None, entity_type=None,
             entity_id=None, event_names=None,
             target_entity_type=base._UNSET,
             target_entity_id=base._UNSET,
             properties=None,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        events = [
            e for e in self._replay(app_id, channel_id).values()
            if base.match_event(
                e, start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                properties=properties)]
        events.sort(key=lambda e: e.event_time, reverse=reversed)
        if limit is not None and limit > 0:
            events = events[:limit]
        return iter(events)
