"""Self-cleaning data source: event-store pruning at train time.

The port of `predictionio_tpu/core/selfclean.py`
(SelfCleaningDataSource.scala:42-326): a mixin that, given an
`EventWindow(duration, remove_duplicates, compress_properties)`,
  - drops the events other than `$set` / `$unset` older than `duration`,
  - compresses each entity's `$set` / `$unset` chain into ONE `$set`
    carrying the final aggregated properties,
  - removes duplicate events (equal but for eventId and creationTime),
and replaces the store's contents with the result
(`clean_persisted_events`, cleanPersistedPEvents).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterable, List, Optional, Tuple

from predictionio_tpu_torch.data import store as store_facade
from predictionio_tpu_torch.data.aggregate import aggregate_properties
from predictionio_tpu_torch.data.event import Event, utcnow

_DURATION_RE = re.compile(
    r"^\s*(\d+)\s*(seconds?|minutes?|hours?|days?|weeks?|s|m|h|d|w)\s*$")

_UNIT_SECONDS = {"s": 1, "second": 1, "seconds": 1,
                 "m": 60, "minute": 60, "minutes": 60,
                 "h": 3600, "hour": 3600, "hours": 3600,
                 "d": 86400, "day": 86400, "days": 86400,
                 "w": 604800, "week": 604800, "weeks": 604800}


def parse_duration(s: "str | int | float") -> timedelta:
    """'3 days', '12h' or a number of seconds -> timedelta (Scala's
    `Duration(...)`)."""
    if isinstance(s, (int, float)):
        return timedelta(seconds=float(s))
    m = _DURATION_RE.match(s)
    if not m:
        raise ValueError(f"Cannot parse duration {s!r}")
    return timedelta(seconds=int(m.group(1)) * _UNIT_SECONDS[m.group(2)])


@dataclass(frozen=True)
class EventWindow:
    """(EventWindow, SelfCleaningDataSource.scala:322)"""
    duration: Optional[str] = None
    remove_duplicates: bool = False
    compress_properties: bool = False


def _is_set_event(e: Event) -> bool:
    return e.event in ("$set", "$unset")


def _dedup_key(e: Event) -> Tuple:
    props = tuple(sorted((k, repr(v)) for k, v in e.properties.items()))
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, props, e.pr_id)


class SelfCleaningDataSource:
    """A mixin for data sources: set `app_name` and `event_window`."""

    app_name: str = ""
    event_window: Optional[EventWindow] = None

    def cleaned_events(self, events: Iterable[Event],
                       now=None) -> List[Event]:
        """The cleaning pass alone: window, compress, dedup
        (getCleanedLEvents, compressLProperties, removeLDuplicates)."""
        ew = self.event_window
        events = list(events)
        if ew is None:
            return events
        now = now or utcnow()
        if ew.duration is not None:
            cutoff = now - parse_duration(ew.duration)
            # property events are exempt: dropping an old $set would
            # lose an entity's current state
            events = [e for e in events
                      if _is_set_event(e) or e.event_time >= cutoff]
        if ew.compress_properties:
            set_events = [e for e in events if _is_set_event(e)]
            others = [e for e in events if not _is_set_event(e)]
            compressed: List[Event] = []
            by_entity = {}
            for e in set_events:
                by_entity.setdefault((e.entity_type, e.entity_id),
                                     []).append(e)
            for (etype, eid), chain in by_entity.items():
                final = aggregate_properties(chain).get(eid)
                if final is None or final.fields.is_empty:
                    continue
                compressed.append(Event(
                    event="$set", entity_type=etype, entity_id=eid,
                    properties=final.fields,
                    event_time=max(e.event_time for e in chain)))
            events = compressed + others
        if ew.remove_duplicates:
            seen = {}
            for e in sorted(events, key=lambda e: e.event_time_millis):
                key = _dedup_key(e)
                if key not in seen:
                    seen[key] = e
            events = list(seen.values())
        return events

    def clean_persisted_events(self, ctx, channel: Optional[str] = None,
                               now=None) -> int:
        """Replace the store's events with the cleaned set
        (cleanPersistedPEvents); returns how many events it removed."""
        if self.event_window is None:
            return 0
        registry = ctx.registry
        app_id, channel_id = store_facade.app_name_to_id(
            registry, self.app_name, channel)
        events_dao = registry.get_events()
        original = list(events_dao.find(app_id, channel_id))
        cleaned = self.cleaned_events(original, now=now)
        kept_ids = {e.event_id for e in cleaned if e.event_id}
        removed = 0
        for e in original:
            if e.event_id and e.event_id not in kept_ids:
                events_dao.delete(e.event_id, app_id, channel_id)
                removed += 1
        for e in cleaned:
            if not e.event_id:   # the compressed events are new
                events_dao.insert(e, app_id, channel_id)
        return removed
