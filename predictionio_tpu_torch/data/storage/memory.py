"""In-memory storage driver ("MEM" type): the tests' backend.

The port of the DAOs of `predictionio_tpu/data/storage/memory.py` that
the lifecycle and eval use (apps, access keys, channels, engine and
evaluation instances, models, events). Thread-safe through one lock per client.
"""

from __future__ import annotations

import itertools
import threading
import uuid
from datetime import datetime
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey, App, Channel, EngineInstance, EvaluationInstance, Model,
    _UNSET, match_event)


class MemStorageClient:
    """Holds all tables of one source; its DAOs share it."""

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self.lock = threading.RLock()
        self.apps: Dict[int, App] = {}
        self.access_keys: Dict[str, AccessKey] = {}
        self.channels: Dict[int, Channel] = {}
        self.engine_instances: Dict[str, EngineInstance] = {}
        self.evaluation_instances: Dict[str, EvaluationInstance] = {}
        self.models: Dict[str, Model] = {}
        # (app_id, channel_id) -> event_id -> Event
        self.events: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        self._app_seq = itertools.count(1)
        self._channel_seq = itertools.count(1)


class MemApps(base.Apps):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, app: App) -> Optional[int]:
        with self.c.lock:
            if any(a.name == app.name for a in self.c.apps.values()):
                raise base.StorageWriteError(
                    f"App name {app.name!r} already exists")
            if app.id and app.id in self.c.apps:
                raise base.StorageWriteError(f"App id {app.id} already exists")
            app_id = app.id or next(self.c._app_seq)
            while app.id == 0 and app_id in self.c.apps:
                app_id = next(self.c._app_seq)
            self.c.apps[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self.c.apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        with self.c.lock:
            for app in self.c.apps.values():
                if app.name == name:
                    return app
        return None

    def get_all(self) -> List[App]:
        return sorted(self.c.apps.values(), key=lambda a: a.id)

    def update(self, app: App) -> None:
        with self.c.lock:
            self.c.apps[app.id] = app

    def delete(self, app_id: int) -> None:
        with self.c.lock:
            self.c.apps.pop(app_id, None)


class MemAccessKeys(base.AccessKeys):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, k: AccessKey) -> Optional[str]:
        with self.c.lock:
            key = k.key or self.generate_key()
            if key in self.c.access_keys:
                raise base.StorageWriteError(
                    f"Access key {key!r} already exists")
            self.c.access_keys[key] = AccessKey(key, k.appid, tuple(k.events))
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        return self.c.access_keys.get(key)

    def get_all(self) -> List[AccessKey]:
        return list(self.c.access_keys.values())

    def get_by_appid(self, appid: int) -> List[AccessKey]:
        return [k for k in self.c.access_keys.values() if k.appid == appid]

    def update(self, k: AccessKey) -> None:
        with self.c.lock:
            self.c.access_keys[k.key] = k

    def delete(self, key: str) -> None:
        with self.c.lock:
            self.c.access_keys.pop(key, None)


class MemChannels(base.Channels):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, channel: Channel) -> Optional[int]:
        with self.c.lock:
            if channel.id and channel.id in self.c.channels:
                raise base.StorageWriteError(
                    f"Channel id {channel.id} already exists")
            cid = channel.id or next(self.c._channel_seq)
            while channel.id == 0 and cid in self.c.channels:
                cid = next(self.c._channel_seq)
            self.c.channels[cid] = Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return self.c.channels.get(channel_id)

    def get_by_appid(self, appid: int) -> List[Channel]:
        return sorted((c for c in self.c.channels.values() if c.appid == appid),
                      key=lambda c: c.id)

    def delete(self, channel_id: int) -> None:
        with self.c.lock:
            self.c.channels.pop(channel_id, None)


class MemEngineInstances(base.EngineInstances):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, i: EngineInstance) -> str:
        with self.c.lock:
            iid = i.id or uuid.uuid4().hex
            self.c.engine_instances[iid] = i.with_(id=iid)
            return iid

    def get(self, iid: str) -> Optional[EngineInstance]:
        return self.c.engine_instances.get(iid)

    def get_all(self) -> List[EngineInstance]:
        return list(self.c.engine_instances.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        with self.c.lock:
            rows = [i for i in self.c.engine_instances.values()
                    if i.status == base.EngineInstanceStatus.COMPLETED
                    and i.engine_id == engine_id
                    and i.engine_version == engine_version
                    and i.engine_variant == engine_variant]
        return sorted(rows, key=lambda i: i.start_time, reverse=True)

    def update(self, i: EngineInstance) -> None:
        with self.c.lock:
            self.c.engine_instances[i.id] = i

    def delete(self, iid: str) -> None:
        with self.c.lock:
            self.c.engine_instances.pop(iid, None)


class MemEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, i: EvaluationInstance) -> str:
        with self.c.lock:
            iid = i.id or uuid.uuid4().hex
            self.c.evaluation_instances[iid] = i.with_(id=iid)
            return iid

    def get(self, iid: str) -> Optional[EvaluationInstance]:
        return self.c.evaluation_instances.get(iid)

    def get_all(self) -> List[EvaluationInstance]:
        return list(self.c.evaluation_instances.values())

    def get_completed(self) -> List[EvaluationInstance]:
        with self.c.lock:
            rows = [i for i in self.c.evaluation_instances.values()
                    if i.status == base.EvaluationInstanceStatus.COMPLETED]
        return sorted(rows, key=lambda i: i.start_time, reverse=True)

    def update(self, i: EvaluationInstance) -> None:
        with self.c.lock:
            self.c.evaluation_instances[i.id] = i

    def delete(self, iid: str) -> None:
        with self.c.lock:
            self.c.evaluation_instances.pop(iid, None)


class MemModels(base.Models):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def insert(self, m: Model) -> None:
        with self.c.lock:
            self.c.models[m.id] = m

    def get(self, mid: str) -> Optional[Model]:
        return self.c.models.get(mid)

    def delete(self, mid: str) -> None:
        with self.c.lock:
            self.c.models.pop(mid, None)


class MemEvents(base.EventStore):
    def __init__(self, client: MemStorageClient):
        self.c = client

    def _table(self, app_id: int, channel_id: Optional[int]
               ) -> Dict[str, Event]:
        return self.c.events.setdefault((app_id, channel_id), {})

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            self._table(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            self.c.events.pop((app_id, channel_id), None)
        return True

    def close(self) -> None:
        pass

    def _insert(self, event: Event, app_id: int,
                channel_id: Optional[int] = None) -> str:
        with self.c.lock:
            e = event if event.event_id else event.with_id()
            table = self._table(app_id, channel_id)
            if e.event_id in table:
                raise base.StorageWriteError(
                    f"Duplicate event id {e.event_id}")
            table[e.event_id] = e
            return e.event_id

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        return self._table(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            return self._table(app_id, channel_id).pop(
                event_id, None) is not None

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
        with self.c.lock:
            events = list(self._table(app_id, channel_id).values())
        events = [e for e in events if match_event(
            e, start_time=start_time, until_time=until_time,
            entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, properties=properties)]
        events.sort(key=lambda e: (e.event_time_millis, e.event_id or ""),
                    reverse=reversed)
        if limit is not None and limit > 0:
            events = events[:limit]
        return iter(events)
