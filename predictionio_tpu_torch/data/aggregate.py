"""Property aggregation: replay $set/$unset/$delete into entity properties.

The port of `predictionio_tpu/data/aggregate.py` (no device code; a copy
of its own, as the port imports nothing of the JAX package). Behavioral
parity with the reference's two aggregators:
  - `data/.../storage/PEventAggregator.scala:60-212` — the `EventOp`
    commutative monoid (order-independent combine, last-write-wins by event
    time), used for parallel aggregation.
  - `data/.../storage/LEventAggregator.scala:30-148` — sequential foldLeft
    over time-sorted events.

Both produce identical results; the monoid form lets event shards
aggregate in any order (a tree-reduce over shards) without a Spark-style
shuffle. Tie-breaking matches the reference exactly:
  - between two $set of the same key at the same timestamp, the right
    combine operand wins (reference SetProp.++ keeps `that` on ties), so a
    fold in time-sorted order equals sequential replay
  - $unset wins over $set at the same timestamp (`v >= set.fields(k).t`)
  - $delete wins over $set at the same timestamp (`delete.t >= set.t`)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Tuple

from predictionio_tpu_torch.data.event import (
    DataMap, Event, PropertyMap, from_millis, to_millis,
)


@dataclass(frozen=True)
class EventOp:
    """Commutative monoid summarizing a set of property events for one entity.

    Parity: `PEventAggregator.scala:91-170` (EventOp ++ / toPropertyMap).

    Attributes:
      set_fields:   key -> (value, set_time_millis); latest set per key.
      set_t:        latest $set event time seen (millis), or None.
      unset_fields: key -> latest unset_time_millis.
      delete_t:     latest $delete event time (millis), or None.
      first/last:   min/max event time over all contributing special events.
    """

    set_fields: Mapping[str, Tuple[object, int]] = field(default_factory=dict)
    set_t: Optional[int] = None
    unset_fields: Mapping[str, int] = field(default_factory=dict)
    delete_t: Optional[int] = None
    first_updated: Optional[int] = None
    last_updated: Optional[int] = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        return op_from_parts(e.event, e.properties.fields,
                             to_millis(e.event_time))

    def combine(self, other: "EventOp") -> "EventOp":
        """Associative combine (`EventOp.++`); commutative up to equal-time
        ties, which are resolved right-biased exactly like the reference's
        `SetProp.++` (`if (thisData.t > thatData.t) thisData else thatData`,
        PEventAggregator.scala) — so a left-to-right fold matches the
        sequential time-sorted replay."""
        set_fields: Dict[str, Tuple[object, int]] = dict(self.set_fields)
        for k, (v, t) in other.set_fields.items():
            if k not in set_fields or t >= set_fields[k][1]:
                set_fields[k] = (v, t)
        unset_fields: Dict[str, int] = dict(self.unset_fields)
        for k, t in other.unset_fields.items():
            if k not in unset_fields or t > unset_fields[k]:
                unset_fields[k] = t
        return EventOp(
            set_fields=set_fields,
            set_t=_max_opt(self.set_t, other.set_t),
            unset_fields=unset_fields,
            delete_t=_max_opt(self.delete_t, other.delete_t),
            first_updated=_min_opt(self.first_updated, other.first_updated),
            last_updated=_max_opt(self.last_updated, other.last_updated),
        )

    __add__ = combine

    def to_property_map(self) -> Optional[PropertyMap]:
        """Resolve the monoid to final properties (`EventOp.toPropertyMap`).

        Returns None when the entity has no surviving $set (never set, or
        deleted after the latest set).
        """
        if self.set_t is None:
            return None
        # unset wins ties: key removed when unset_t >= its set time
        dropped = {k for k, ut in self.unset_fields.items()
                   if k in self.set_fields and ut >= self.set_fields[k][1]}
        if self.delete_t is not None:
            if self.delete_t >= self.set_t:
                return None
            dropped |= {k for k, (_, st) in self.set_fields.items()
                        if self.delete_t >= st}
        fields = {k: v for k, (v, _) in self.set_fields.items() if k not in dropped}
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(
            fields=DataMap(fields),
            first_updated=from_millis(self.first_updated),
            last_updated=from_millis(self.last_updated),
        )


def op_from_parts(name: str, fields: Optional[Mapping[str, object]],
                  t: int) -> EventOp:
    """EventOp from raw frame parts (event name, property dict,
    event-time millis) — the zero-Event aggregation path PEVLOG's
    columnar `aggregate_properties` uses; `EventOp.from_event` is the
    Event-object adapter over it."""
    if name == "$set":
        return EventOp(
            set_fields={k: (v, t) for k, v in (fields or {}).items()},
            set_t=t, first_updated=t, last_updated=t)
    if name == "$unset":
        return EventOp(
            unset_fields={k: t for k in (fields or {})},
            first_updated=t, last_updated=t)
    if name == "$delete":
        return EventOp(delete_t=t, first_updated=t, last_updated=t)
    return EventOp()


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Aggregate events grouped by entityId into final property maps.

    Parity: `LEventAggregator.aggregateProperties` /
    `PEventAggregator.aggregateProperties` — entities whose properties
    resolve to None (deleted / never set) are omitted.
    """
    ops: Dict[str, EventOp] = {}
    for e in events:
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = op if prev is None else prev.combine(op)
    out: Dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def aggregate_properties_single(events: Iterable[Event]) -> Optional[PropertyMap]:
    """Aggregate events of a single entity (`aggregatePropertiesSingle`)."""
    acc = EventOp()
    for e in events:
        acc = acc.combine(EventOp.from_event(e))
    return acc.to_property_map()
