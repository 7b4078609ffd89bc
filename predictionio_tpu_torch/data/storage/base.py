"""Storage SPI: metadata records and the DAO interfaces.

The port of the part of `predictionio_tpu/data/storage/base.py` that the
`pio` lifecycle runs (app new -> import -> train -> deploy):

  - the records `App`, `AccessKey`, `Channel`, `EngineInstance` (with
    `EngineInstanceStatus`), `EvaluationInstance` (with
    `EvaluationInstanceStatus`) and `Model` (Apps, AccessKeys, Channels,
    EngineInstances, EvaluationInstances, Models.scala);
  - the DAO bases `Apps`, `AccessKeys`, `Channels`, `EngineInstances`,
    `EvaluationInstances`, `Models` and `EventStore` (LEvents.scala:
    40-520): `insert` and
    `insert_batch` validate first, `find` has the three-state target
    filter, `scan_columns` adapts `find`, and `ingest_watermark` /
    `ingest_cache_dir` are None (no prepared-data cache, no delta).

Leases, tenant quotas, SLO objectives and `aggregate_properties` come
with the slices that use them. Drivers
(`memory.py`, `sqlite.py`, `evlog.py`, `pevlog.py`) implement these
bases and are found by the registry (`registry.py`).
"""

from __future__ import annotations

import abc
import base64
import re
import secrets
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

from predictionio_tpu_torch.data.event import (Event, EventValidation,
                                               utcnow)


class StorageError(Exception):
    """(StorageException, Storage.scala:88)"""


class StorageWriteError(StorageError):
    """A write rejected by the backend (duplicate key, constraint)."""


@dataclass(frozen=True)
class App:
    """An application namespace for events (Apps.scala:25-35)."""
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    """An API access key; an empty `events` list allows every event
    (AccessKeys.scala:25-38)."""
    key: str
    appid: int
    events: Sequence[str] = ()


CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")
CHANNEL_NAME_CONSTRAINT = (
    "Only alphanumeric and - characters are allowed and max length is 16.")


@dataclass(frozen=True)
class Channel:
    """A named event channel within an app (Channels.scala:25-62)."""
    id: int
    name: str
    appid: int

    def __post_init__(self):
        if not self.is_valid_name(self.name):
            raise ValueError(
                f"Invalid channel name: {self.name}. {CHANNEL_NAME_CONSTRAINT}")

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(CHANNEL_NAME_RE.match(s))


class EngineInstanceStatus:
    INIT = "INIT"
    TRAINING = "TRAINING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"


@dataclass(frozen=True)
class EngineInstance:
    """Metadata row of one train run (EngineInstances.scala:25-60).
    `runtime_conf` stands where the reference kept `sparkConf`; the
    workflow stores the run's `phase_timings` there."""
    id: str = ""
    status: str = ""
    start_time: datetime = field(default_factory=utcnow)
    end_time: datetime = field(default_factory=utcnow)
    engine_id: str = ""
    engine_version: str = ""
    engine_variant: str = ""
    engine_factory: str = ""
    batch: str = ""
    env: Mapping[str, str] = field(default_factory=dict)
    runtime_conf: Mapping[str, Any] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""
    # last liveness beat of the training process
    heartbeat: Optional[datetime] = None

    def with_(self, **kw) -> "EngineInstance":
        return replace(self, **kw)


class EvaluationInstanceStatus:
    INIT = "EVALINIT"
    RUNNING = "EVALRUNNING"
    COMPLETED = "EVALCOMPLETED"


@dataclass(frozen=True)
class EvaluationInstance:
    """Metadata row of one eval run (EvaluationInstances.scala:25-56)."""
    id: str = ""
    status: str = ""
    start_time: datetime = field(default_factory=utcnow)
    end_time: datetime = field(default_factory=utcnow)
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Mapping[str, str] = field(default_factory=dict)
    runtime_conf: Mapping[str, Any] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""

    def with_(self, **kw) -> "EvaluationInstance":
        return replace(self, **kw)


@dataclass(frozen=True)
class Model:
    """Serialized model blob keyed by engine instance id (Models.scala)."""
    id: str
    models: bytes


class Apps(abc.ABC):
    """App CRUD (Apps.scala:43-61)."""

    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; a 0 id means 'generate one'. Returns the effective id."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> None: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeys(abc.ABC):
    """Access key CRUD and generation (AccessKeys.scala:46-77)."""

    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert; an empty key means 'generate one'. Returns the key."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> None: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    def generate_key(self) -> str:
        """URL-safe 48-byte random key, never starting with '-'
        (AccessKeys.scala:68-77)."""
        while True:
            key = base64.urlsafe_b64encode(
                secrets.token_bytes(48)).decode().rstrip("=")
            if not key.startswith("-"):
                return key


class Channels(abc.ABC):
    """Channel CRUD (Channels.scala:64-81)."""

    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]:
        """Insert; a 0 id means 'generate one'. Returns the effective id."""

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_appid(self, appid: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


class EngineInstances(abc.ABC):
    """Engine instance registry (EngineInstances.scala:62-100)."""

    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        """COMPLETED instances of (id, version, variant), newest start
        first."""

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str
                             ) -> Optional[EngineInstance]:
        """The newest COMPLETED instance of (id, version, variant): the
        row `deploy` resolves (getLatestCompleted)."""
        rows = self.get_completed(engine_id, engine_version, engine_variant)
        return rows[0] if rows else None

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, iid: str) -> None: ...

    def record_heartbeat(self, iid: str,
                         ts: Optional[datetime] = None) -> None:
        """Refresh the liveness beat on a row (get + update)."""
        row = self.get(iid)
        if row is not None:
            self.update(row.with_(heartbeat=ts or utcnow()))


class EvaluationInstances(abc.ABC):
    """Evaluation instance registry (EvaluationInstances.scala:58-84)."""

    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, iid: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]:
        """COMPLETED instances, newest start first."""

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> None: ...

    @abc.abstractmethod
    def delete(self, iid: str) -> None: ...


class Models(abc.ABC):
    """Model blob store (Models.scala:36-45)."""

    @abc.abstractmethod
    def insert(self, m: Model) -> None: ...

    @abc.abstractmethod
    def get(self, mid: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, mid: str) -> None: ...


# "no filter", as distinct from "filter == None"
_UNSET = object()


class DeltaInvalidated(Exception):
    """A `scan_columns(since=...)` delta cannot be decoded exactly (a
    delete or an external id between the watermarks, a rewritten
    journal, a span past the budget, or a driver with no delta path):
    the caller falls back to a full scan."""


def match_properties(e: Event, properties: Dict[str, object]) -> bool:
    """True iff every (name, value) filter pair appears verbatim in the
    event's properties."""
    pm = e.properties
    for k, v in properties.items():
        if k not in pm or pm[k] != v:
            return False
    return True


class EventStore(abc.ABC):
    """Event DAO, the analog of the reference's `LEvents`
    (LEvents.scala:40-520). Every operation is scoped to an (app,
    channel); channel_id None is the app's default channel.

    `find` filters as `LEvents.futureFind` does:
      - start_time inclusive, until_time exclusive;
      - event_names: any of;
      - target_entity_type/id in three states: the default is no filter,
        None matches events WITHOUT a target, a string matches exactly
        (the reference's Option[Option[String]]).
    """

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize storage for an (app, channel); idempotent."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Drop all events of an (app, channel)."""

    @abc.abstractmethod
    def close(self) -> None: ...

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event (validated first); returns its id."""
        EventValidation.validate(event)
        return self._insert(event, app_id, channel_id)

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Insert events (all validated first); returns their ids."""
        for e in events:
            EventValidation.validate(e)
        return self._insert_batch(events, app_id, channel_id)

    @abc.abstractmethod
    def _insert(self, event: Event, app_id: int,
                channel_id: Optional[int] = None) -> str: ...

    def _insert_batch(self, events: Sequence[Event], app_id: int,
                      channel_id: Optional[int] = None) -> List[str]:
        return [self._insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: Optional[int] = None, *,
             start_time: Optional[datetime] = None,
             until_time: Optional[datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type: object = _UNSET,
             target_entity_id: object = _UNSET,
             properties: Optional[Dict[str, object]] = None,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        """Events in (event time, id) order, descending when `reversed`;
        `limit` None or <= 0 is unlimited. `properties` keeps events
        whose properties hold every (name, value) pair."""

    def scan_columns(self, app_id: int, channel_id: Optional[int] = None, *,
                     start_time: Optional[datetime] = None,
                     until_time: Optional[datetime] = None,
                     entity_type: Optional[str] = None,
                     entity_id: Optional[str] = None,
                     event_names: Optional[Sequence[str]] = None,
                     target_entity_type: object = _UNSET,
                     target_entity_id: object = _UNSET,
                     properties: Optional[Dict[str, object]] = None,
                     value_spec=None, require_target: bool = True,
                     since: Optional[Dict[str, int]] = None,
                     upto: Optional[Dict[str, int]] = None):
        """Columnar training scan with `find`'s filters: an
        `EventColumns` (interned int32 entity ids, float32 values per
        `value_spec`, int64 event times) instead of Events. With
        `since` (an `ingest_watermark` snapshot) only the events
        appended after it, up to the snapshot `upto`: the streaming
        delta. This base adapts `find()` and raises `DeltaInvalidated`
        for a delta."""
        del upto
        if since is not None:
            raise DeltaInvalidated(
                f"{type(self).__name__} has no delta scan path")
        from predictionio_tpu_torch.data.storage.columns import (
            columns_from_events)
        return columns_from_events(
            self.find(app_id, channel_id, start_time=start_time,
                      until_time=until_time, entity_type=entity_type,
                      entity_id=entity_id, event_names=event_names,
                      target_entity_type=target_entity_type,
                      target_entity_id=target_entity_id,
                      properties=properties),
            value_spec, require_target)

    def ingest_watermark(self, app_id: int,
                         channel_id: Optional[int] = None
                         ) -> Optional[Dict[str, int]]:
        """A content fingerprint of the (app, channel) events that any
        insert or delete changes: the prepared-data cache's key and the
        refresher's change test. None (this base) means no cache and
        no streaming fold."""
        return None

    def ingest_cache_dir(self, app_id: int,
                         channel_id: Optional[int] = None):
        """Directory of the prepared-data cache's blobs, or None when the
        driver has no on-disk home for them."""
        return None


def match_event(e: Event, *,
                start_time: Optional[datetime] = None,
                until_time: Optional[datetime] = None,
                entity_type: Optional[str] = None,
                entity_id: Optional[str] = None,
                event_names: Optional[Sequence[str]] = None,
                target_entity_type: object = _UNSET,
                target_entity_id: object = _UNSET,
                properties: Optional[Dict[str, object]] = None) -> bool:
    """The in-memory filter predicate with `find` semantics."""
    if properties and not match_properties(e, properties):
        return False
    if start_time is not None and e.event_time < _aware(start_time):
        return False
    if until_time is not None and e.event_time >= _aware(until_time):
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in set(event_names):
        return False
    if target_entity_type is not _UNSET \
            and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not _UNSET \
            and e.target_entity_id != target_entity_id:
        return False
    return True


def _aware(t: datetime) -> datetime:
    return t if t.tzinfo else t.replace(tzinfo=timezone.utc)
