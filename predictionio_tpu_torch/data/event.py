"""Canonical event model, property bag, and validation rules.

A copy of `predictionio_tpu/data/event.py` (the port imports nothing of
the JAX package). Behavioral parity with the reference's event data model:
  - Event record: reference `data/.../storage/Event.scala:42-60`
  - validation rules: reference `data/.../storage/Event.scala:68-166`
  - DataMap typed property bag: reference `data/.../storage/DataMap.scala:45-245`
  - PropertyMap with first/last updated: reference `data/.../storage/PropertyMap.scala`

Values in a DataMap are plain JSON values (None, bool, int, float, str,
list, dict). Times are timezone-aware UTC datetimes; ordering comparisons
throughout the framework use epoch milliseconds, matching the reference's
joda-time millisecond ordering.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import uuid
from dataclasses import dataclass, field, replace
from datetime import datetime, timezone
# Mapping from the abc, not typing: isinstance against typing.Mapping
# routes through typing's __instancecheck__ (~5 us per miss), and the
# JSON-validation path runs it once per value
from collections.abc import Mapping
from typing import Any, Iterator, Optional, Sequence  # noqa: F401


def utcnow() -> datetime:
    return datetime.now(timezone.utc)


def to_millis(t: datetime) -> int:
    """Epoch milliseconds; naive datetimes are interpreted as UTC."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return int(t.timestamp() * 1000)


def from_millis(ms: int) -> datetime:
    return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


def parse_time(value: Any) -> datetime:
    """Parse an ISO8601 string (or epoch millis) into an aware UTC datetime."""
    if isinstance(value, datetime):
        return value if value.tzinfo else value.replace(tzinfo=timezone.utc)
    if isinstance(value, (int, float)):
        return from_millis(int(value))
    if isinstance(value, str):
        s = value.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        dt = datetime.fromisoformat(s)
        return dt if dt.tzinfo else dt.replace(tzinfo=timezone.utc)
    raise ValueError(f"Cannot parse time from {value!r}")


def format_time(t: datetime) -> str:
    """ISO8601 with millisecond precision and explicit offset."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    t = t.astimezone(timezone.utc)
    return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{t.microsecond // 1000:03d}Z"


_event_id_seq = itertools.count()
_event_id_lock = threading.Lock()
_event_id_last_ns = 0


def _gen_event_id() -> str:
    """Time-ordered 32-hex event id (UUIDv7-style): ns timestamp +
    process-monotonic counter + randomness. The timestamp is latched to
    never decrease (wall clock may step backwards), and the counter breaks
    same-ns ties, so within a process string sort order == insertion
    order; the stores' (eventTime, id) tie-break is therefore
    deterministic even when two events land in the same millisecond (the
    reference relies on backend rowkey ordering for the same property,
    HBEventsUtil rowkeys)."""
    global _event_id_last_ns
    with _event_id_lock:
        _event_id_last_ns = max(_event_id_last_ns, time.time_ns())
        ns = _event_id_last_ns
        seq = next(_event_id_seq)
    return f"{ns:016x}{seq & 0xFFFFFFFF:08x}{uuid.uuid4().hex[:8]}"


_JSON_SCALARS = (type(None), bool, int, float, str)


def _check_json_value(v: Any, path: str) -> None:
    if isinstance(v, _JSON_SCALARS):
        return
    if isinstance(v, (list, tuple)):
        for i, item in enumerate(v):
            _check_json_value(item, f"{path}[{i}]")
        return
    if isinstance(v, Mapping):
        for k, item in v.items():
            if not isinstance(k, str):
                raise ValueError(f"Non-string key {k!r} at {path}")
            _check_json_value(item, f"{path}.{k}")
        return
    raise ValueError(f"Value at {path} is not a JSON value: {type(v).__name__}")


class DataMap:
    """Immutable schemaless property bag with typed accessors.

    Parity: reference `data/.../storage/DataMap.scala:45-245` — typed
    `get[T]` raising on missing/null required fields, `get_opt`,
    `get_or_else`, merge (`++`), key removal (`--`), and JSON round-trip.

    Deliberately NOT a `collections.abc.Mapping`: `get` here follows the
    reference's mandatory-typed-get contract (raises on missing/null,
    second argument is a type), which is incompatible with `Mapping.get`'s
    default-value contract. Iteration/len/`in` still work dict-like.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        fields = dict(fields or {})
        _check_json_value(fields, "$")
        self._fields = fields

    @classmethod
    def _trusted(cls, fields: Optional[dict]) -> "DataMap":
        """Wrap an already validated dict the caller owns, without a copy
        or a check: a journal replay's frames were validated at insert
        and CRC-checked at read, and each `json.loads` hands over a fresh
        dict. A non-dict (a foreign frame with a scalar "p") goes
        through the checking constructor and fails where it is decoded."""
        if fields is None:
            fields = {}
        elif not isinstance(fields, dict):
            return cls(fields)
        dm = object.__new__(cls)
        dm._fields = fields
        return dm

    # -- dict-like protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    def items(self):
        return self._fields.items()

    def values(self):
        return self._fields.values()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed accessors ----------------------------------------------------
    @property
    def fields(self) -> Mapping[str, Any]:
        return dict(self._fields)

    def keySet(self) -> set:
        return set(self._fields)

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise KeyError(f"The field {name} is required.")

    def get(self, name: str, cls: Optional[type] = None) -> Any:
        """Mandatory typed get: raises if missing or null (DataMap.scala:69-90)."""
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise ValueError(f"The required field {name} cannot be null.")
        return _coerce(value, cls) if cls is not None else value

    def get_opt(self, name: str, cls: Optional[type] = None) -> Optional[Any]:
        if name not in self._fields or self._fields[name] is None:
            return None
        value = self._fields[name]
        return _coerce(value, cls) if cls is not None else value

    def get_or_else(self, name: str, default: Any) -> Any:
        v = self.get_opt(name)
        return default if v is None else v

    # -- algebra ------------------------------------------------------------
    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """`++`: right-biased union (DataMap.scala:170)."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def remove(self, keys) -> "DataMap":
        """`--`: remove keys (DataMap.scala:177)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    @property
    def is_empty(self) -> bool:
        return not self._fields

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "DataMap":
        obj = json.loads(s)
        if not isinstance(obj, dict):
            raise ValueError("DataMap JSON must be an object")
        return DataMap(obj)


def _coerce(value: Any, cls: type) -> Any:
    if cls is float and isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    if cls is int and isinstance(value, int) and not isinstance(value, bool):
        return value
    if cls is datetime:
        return parse_time(value)
    if cls is list and isinstance(value, (list, tuple)):
        return list(value)
    if not isinstance(value, cls) or (cls is not bool and isinstance(value, bool)):
        raise TypeError(f"Field value {value!r} is not of type {cls.__name__}")
    return value


@dataclass(frozen=True)
class PropertyMap:
    """Aggregated entity properties with update-time metadata.

    Parity: reference `data/.../storage/PropertyMap.scala`.
    """

    fields: DataMap
    first_updated: datetime
    last_updated: datetime

    def get(self, name: str, cls: Optional[type] = None) -> Any:
        return self.fields.get(name, cls)

    def get_opt(self, name: str, cls: Optional[type] = None) -> Optional[Any]:
        return self.fields.get_opt(name, cls)

    def get_or_else(self, name: str, default: Any) -> Any:
        return self.fields.get_or_else(name, default)


@dataclass(frozen=True)
class Event:
    """The canonical event record (reference `storage/Event.scala:42-60`)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: datetime = field(default_factory=utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: datetime = field(default_factory=utcnow)
    event_id: Optional[str] = None

    def with_id(self, event_id: Optional[str] = None) -> "Event":
        return replace(self, event_id=event_id or _gen_event_id())

    @property
    def event_time_millis(self) -> int:
        return to_millis(self.event_time)

    # -- JSON (wire format parity with EventJson4sSupport) -------------------
    def to_api_json(self) -> dict:
        """Serialize in the Event Server API shape (EventJson4sSupport.scala)."""
        out = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "targetEntityType": self.target_entity_type,
            "targetEntityId": self.target_entity_id,
            "properties": dict(self.properties.fields),
            "eventTime": format_time(self.event_time),
            "tags": list(self.tags),
            "prId": self.pr_id,
            "creationTime": format_time(self.creation_time),
        }
        return {k: v for k, v in out.items() if v is not None}

    @staticmethod
    def from_api_json(obj: Mapping[str, Any]) -> "Event":
        if not isinstance(obj, Mapping):
            raise ValueError("event JSON must be an object")
        try:
            event = obj["event"]
            entity_type = obj["entityType"]
            entity_id = obj["entityId"]
        except KeyError as e:
            raise ValueError(f"field {e.args[0]} is required") from None
        for name, v in (("event", event), ("entityType", entity_type),
                        ("entityId", entity_id)):
            if not isinstance(v, str):
                raise ValueError(f"field {name} must be a string")
        props = obj.get("properties") or {}
        if not isinstance(props, Mapping):
            raise ValueError("properties must be an object")
        for name in ("targetEntityType", "targetEntityId", "prId", "eventId"):
            if obj.get(name) is not None and not isinstance(obj[name], str):
                raise ValueError(f"field {name} must be a string")
        tags = obj.get("tags")
        if tags is None:
            tags = ()
        if not isinstance(tags, (list, tuple)) or not all(
                isinstance(t, str) for t in tags):
            raise ValueError("field tags must be an array of strings")
        event_time = (parse_time(obj["eventTime"]) if "eventTime" in obj
                      and obj["eventTime"] is not None else utcnow())
        e = Event(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=obj.get("targetEntityType"),
            target_entity_id=obj.get("targetEntityId"),
            properties=DataMap(props),
            event_time=event_time,
            tags=tuple(tags),
            pr_id=obj.get("prId"),
            creation_time=(parse_time(obj["creationTime"])
                           if obj.get("creationTime") else utcnow()),
            event_id=obj.get("eventId"),
        )
        EventValidation.validate(e)
        return e


class EventValidation:
    """Validation rules, matching reference `storage/Event.scala:68-166`."""

    DEFAULT_TIME_ZONE = timezone.utc
    SPECIAL_EVENTS = {"$set", "$unset", "$delete"}
    BUILTIN_ENTITY_TYPES = {"pio_pr"}
    BUILTIN_PROPERTIES: set = set()

    @classmethod
    def is_reserved_prefix(cls, name: str) -> bool:
        return name.startswith("$") or name.startswith("pio_")

    @classmethod
    def is_special_event(cls, name: str) -> bool:
        return name in cls.SPECIAL_EVENTS

    @classmethod
    def is_builtin_entity_type(cls, name: str) -> bool:
        return name in cls.BUILTIN_ENTITY_TYPES

    @classmethod
    def validate(cls, e: Event) -> None:
        # plain if-chains, no per-call closure and no eager f-string
        # formatting: this runs once per event on the bulk-ingest hot
        # path (millions of calls), where the closure + message
        # construction were a measured double-digit % of wall-clock
        if not e.event:
            raise ValueError("event must not be empty.")
        if not e.entity_type:
            raise ValueError("entityType must not be empty string.")
        if not e.entity_id:
            raise ValueError("entityId must not be empty string.")
        tet, tei = e.target_entity_type, e.target_entity_id
        if tet is not None or tei is not None:
            if tet == "":
                raise ValueError("targetEntityType must not be empty string")
            if tei == "":
                raise ValueError("targetEntityId must not be empty string.")
            if tet is None or tei is None:
                raise ValueError("targetEntityType and targetEntityId "
                                 "must be specified together.")
        ev0 = e.event[0]
        if ev0 == "$" or e.event.startswith("pio_"):
            if not cls.is_special_event(e.event):
                raise ValueError(
                    f"{e.event} is not a supported reserved event name.")
            if e.event == "$unset" and e.properties.is_empty:
                raise ValueError(
                    "properties cannot be empty for $unset event")
            if tet is not None or tei is not None:
                raise ValueError(
                    f"Reserved event {e.event} cannot have targetEntity")
        if (e.entity_type[0] == "$" or e.entity_type.startswith("pio_")) \
                and not cls.is_builtin_entity_type(e.entity_type):
            raise ValueError(
                f"The entityType {e.entity_type} is not allowed. "
                "'pio_' is a reserved name prefix.")
        if tet is not None and cls.is_reserved_prefix(tet) \
                and not cls.is_builtin_entity_type(tet):
            raise ValueError(
                f"The targetEntityType {tet} is not allowed. "
                "'pio_' is a reserved name prefix.")
        if not e.properties.is_empty:
            cls.validate_properties(e)

    @classmethod
    def validate_properties(cls, e: Event) -> None:
        for k in e.properties.keySet():
            if cls.is_reserved_prefix(k) and k not in cls.BUILTIN_PROPERTIES:
                raise ValueError(
                    f"The property {k} is not allowed. "
                    "'pio_' is a reserved name prefix.")
