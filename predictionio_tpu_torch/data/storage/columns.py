"""Columnar event scan: event rows -> numpy column batches.

A copy of `predictionio_tpu/data/storage/columns.py`. The
training-ingest currency: `scan_columns` decodes matching events or
journal frames straight into dense numpy columns with locally interned
string tables, so a training read builds no `Event` per row. The module
imports the standard library and numpy only: PEVLOG's spawn-started
scan workers (`_scanworker.py`) import it.

Value specs, the declarative form of a template's `rating_of`:

    {"rate": ("prop", "rating"),   # float(properties["rating"]), drop if absent
     "buy": 4.0,                   # constant
     "*": ("prop_or", "rating", 1.0)}  # property if present else default

A row is dropped when its spec entry resolves to None (mirroring
`rating_of(e) -> None`), when no entry matches its event name, or,
with `require_target=True`, when the event has no target entity.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta, timezone as _tz
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_UTC = _tz.utc
_EPOCH = datetime(1970, 1, 1, tzinfo=_UTC)
_ONE_US = timedelta(microseconds=1)

# the three-state target filter (`base._UNSET`, None, a string) in a
# form that crosses a process boundary
TGT_UNSET = ("unset",)
TGT_NONE = ("none",)


def encode_target(v, unset_sentinel) -> tuple:
    if v is unset_sentinel:
        return TGT_UNSET
    if v is None:
        return TGT_NONE
    return ("str", str(v))


def normalize_value_spec(spec) -> Dict[str, tuple]:
    """Canonical form: name -> ("const", f) | ("prop", key) |
    ("prop_or", key, f). `spec=None` means every matching event counts
    as 1.0 (the `weight_of` default)."""
    if spec is None:
        return {"*": ("const", 1.0)}
    out: Dict[str, tuple] = {}
    for name, ent in spec.items():
        if isinstance(ent, (int, float)):
            out[name] = ("const", float(ent))
        elif isinstance(ent, tuple) and ent and ent[0] == "const" and len(ent) == 2:
            out[name] = ("const", float(ent[1]))   # idempotent re-normalize
        elif isinstance(ent, tuple) and ent and ent[0] == "prop" and len(ent) == 2:
            out[name] = ("prop", ent[1])
        elif isinstance(ent, tuple) and ent and ent[0] == "prop_or" and len(ent) == 3:
            out[name] = ("prop_or", ent[1], float(ent[2]))
        else:
            raise ValueError(f"bad value_spec entry for {name!r}: {ent!r}")
    return out


def eval_value(spec: Dict[str, tuple], name: str,
               props: Optional[dict]) -> Optional[float]:
    """Resolve one frame's value; None = drop the row."""
    ent = spec.get(name)
    if ent is None:
        ent = spec.get("*")
        if ent is None:
            return None
    kind = ent[0]
    if kind == "const":
        return ent[1]
    v = None if props is None else props.get(ent[1])
    if kind == "prop":
        return None if v is None else float(v)
    return ent[2] if v is None else float(v)   # prop_or


def t_millis_from_us(t_us: np.ndarray) -> np.ndarray:
    """Epoch-ms replication of `to_millis(_from_us(us))` BIT-FOR-BIT:
    the oracle computes `int(timedelta_total_seconds(us) * 1000)` where
    total_seconds is one correctly-rounded us/1e6 division (us < 2^53,
    so the float64 of us is exact) — the same two IEEE ops as below.
    Plain `us // 1000` would disagree by 1 near some ms boundaries."""
    return (t_us.astype(np.float64) / 1e6 * 1000.0).astype(np.int64)


@dataclass
class EventColumns:
    """Dense scan result, sorted by event time (stable w.r.t. journal
    order — the exact permutation `find()` yields). String tables are
    in first-seen order over the sorted, post-filter row stream, so
    `BiMap.from_keys(entities)` equals the Event-oracle BiMap."""
    entity_ix: np.ndarray    # int32 [n] -> entities
    target_ix: np.ndarray    # int32 [n] -> targets; -1 = no target
    value: np.ndarray        # float32 [n] per value_spec
    t_us: np.ndarray         # int64 [n] event time, epoch µs
    entities: List[str]
    targets: List[str]

    @property
    def n(self) -> int:
        return int(self.entity_ix.shape[0])

    @property
    def t_millis(self) -> np.ndarray:
        return t_millis_from_us(self.t_us)


# A block is one journal chunk's decoded rows, still in journal order
# with chunk-local intern tables:
#   (ent_ix i32, tgt_ix i32, value f32, t_us i64, ent_table, tgt_table)
Block = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
              List[str], List[str]]


def empty_block() -> Block:
    return (np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, np.float32), np.zeros(0, np.int64), [], [])


class BlockBuilder:
    """Row accumulator of the sqlite scan and the Event-object scan;
    interns strings block-locally."""

    __slots__ = ("ent", "tgt", "val", "tus", "ent_map", "tgt_map")

    def __init__(self) -> None:
        self.ent: List[int] = []
        self.tgt: List[int] = []
        self.val: List[float] = []
        self.tus: List[int] = []
        self.ent_map: Dict[str, int] = {}
        self.tgt_map: Dict[str, int] = {}

    def add(self, entity_id: str, target_id: Optional[str],
            value: float, t_us: int) -> None:
        em = self.ent_map
        e = em.get(entity_id)
        if e is None:
            e = em[entity_id] = len(em)
        if target_id is None:
            t = -1
        else:
            tm = self.tgt_map
            t = tm.get(target_id)
            if t is None:
                t = tm[target_id] = len(tm)
        self.ent.append(e)
        self.tgt.append(t)
        self.val.append(value)
        self.tus.append(t_us)

    def block(self) -> Block:
        return (np.array(self.ent, np.int32),
                np.array(self.tgt, np.int32),
                np.array(self.val, np.float32),
                np.array(self.tus, np.int64),
                list(self.ent_map), list(self.tgt_map))


def _first_seen_reindex(ix: np.ndarray,
                        table: List[str]) -> Tuple[np.ndarray, List[str]]:
    """Renumber ids so the output table is in first-occurrence order of
    `ix` (rows already in final sorted order); -1 rows pass through."""
    valid = ix >= 0
    vals = ix[valid]
    if vals.size == 0:
        return np.full(ix.shape, -1, np.int32), []
    uniq, first = np.unique(vals, return_index=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(uniq.size, np.int64)
    rank[order] = np.arange(uniq.size)
    out = np.full(ix.shape, -1, np.int64)
    out[valid] = rank[np.searchsorted(uniq, vals)]
    return out.astype(np.int32), [table[uniq[j]] for j in order]


def merge_blocks(blocks: Sequence[Block]) -> EventColumns:
    """Deterministic merge: blocks concatenated in journal order (so the
    result is independent of chunking/worker count), chunk-local interns
    remapped to a global table, then one stable time sort + first-seen
    renumbering to match the Event oracle's BiMap order."""
    g_ent: Dict[str, int] = {}
    g_tgt: Dict[str, int] = {}
    ents, tgts, vals, ts = [], [], [], []
    for ent_ix, tgt_ix, val, tus, ent_tab, tgt_tab in blocks:
        if ent_ix.size == 0:
            continue
        trans_e = np.array(
            [g_ent.setdefault(k, len(g_ent)) for k in ent_tab], np.int64)
        ents.append(trans_e[ent_ix] if trans_e.size else
                    ent_ix.astype(np.int64))
        if tgt_tab:
            trans_t = np.array(
                [g_tgt.setdefault(k, len(g_tgt)) for k in tgt_tab], np.int64)
            # -1 (no target) must survive the remap
            t = np.where(tgt_ix >= 0, trans_t[np.maximum(tgt_ix, 0)], -1)
        else:
            t = np.full(tgt_ix.shape, -1, np.int64)
        tgts.append(t)
        vals.append(val)
        ts.append(tus)
    if not ents:
        return EventColumns(*empty_block())
    ent = np.concatenate(ents)
    tgt = np.concatenate(tgts)
    val = np.concatenate(vals)
    tus = np.concatenate(ts)
    order = np.argsort(tus, kind="stable")
    ent, tgt, val, tus = ent[order], tgt[order], val[order], tus[order]
    ent_table = list(g_ent)
    tgt_table = list(g_tgt)
    ent_ix, ent_table = _first_seen_reindex(ent, ent_table)
    tgt_ix, tgt_table = _first_seen_reindex(tgt, tgt_table)
    return EventColumns(ent_ix, tgt_ix, val.astype(np.float32),
                        tus.astype(np.int64), ent_table, tgt_table)


def block_from_events(events: Iterable, spec: Dict[str, tuple],
                      require_target: bool) -> Block:
    """One block from `find()`'s Event objects, per `spec`."""
    b = BlockBuilder()
    for e in events:
        v = eval_value(spec, e.event,
                       e.properties._fields if e.properties is not None
                       else None)
        if v is None:
            continue
        tei = e.target_entity_id
        if require_target and tei is None:
            continue
        b.add(e.entity_id, tei, float(v), _event_us(e))
    return b.block()


def _event_us(e) -> int:
    # exact integer µs (timedelta floordiv), not a float product: the
    # merged sort key must order rows exactly like find()'s datetime
    # sort, and a ±1µs float error can flip adjacent rows
    t = e.event_time
    if t.tzinfo is None:
        t = t.replace(tzinfo=_UTC)
    return (t - _EPOCH) // _ONE_US


def columns_from_events(events: Iterable, value_spec=None,
                        require_target: bool = True) -> EventColumns:
    """`scan_columns` on top of an already-sorted `find()` iterator:
    the base `EventStore` implementation."""
    spec = normalize_value_spec(value_spec)
    return merge_blocks([block_from_events(events, spec, require_target)])
