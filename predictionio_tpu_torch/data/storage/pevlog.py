"""PEVLOG storage driver: the scalable INDEXED event store (HBase role).

The port of `predictionio_tpu/data/storage/pevlog.py`. Journals,
sidecar indexes, tombstones and external-id logs are the same files in
the same formats, so a PEVLOG directory either package wrote reads back
through the other, its sidecar indexes loaded, not rebuilt.

The reference's "scalable" event tier is HBase with a designed rowkey —
MD5(entityType-entityId)[16B] ++ millis[8B] ++ uuid[8B] — so entity and
time-range finds become prefix/range scans with filter pushdown
(`storage/hbase/src/main/scala/.../HBEventsUtil.scala:54,77-110`). The
flat EVLOG journal answers every find with a full scan; PEVLOG is the
design that scales: events partition into TIME-BUCKETED segment journals
(one CRC-framed native journal per bucket, `native/eventlog.cpp`), and
each segment carries a sidecar index with

  - min/max event time  -> time-range finds prune whole segments
  - a Bloom filter over (entityType, entityId)  -> entity finds skip
    segments that never saw the entity (the role of HBase's MD5-prefix
    rowkey locality)
  - an exact event-name set + a (targetEntityType, targetEntityId)
    Bloom + a (property-name, value) Bloom -> event-name,
    target-entity, and exact property-value finds prune too: the
    field-query pushdown the reference fills with Elasticsearch's
    query DSL (`storage/elasticsearch/.../ESLEvents.scala:308`), at
    segment (skip-index) granularity

Event ids encode their segment bucket (`<bucket_us_hex>-<uuid>`, the
analog of HBase's rowkey-as-eventId, HBEventsUtil.scala:112-135), so
get/delete/duplicate-checks touch exactly one segment. Externally
supplied ids without the prefix still work via full scan.

Sidecar indexes are rebuildable caches: each records the journal byte
size it summarizes ("synced"); a mismatch (crash between append and
index flush, or external appends) triggers a rebuild from the journal —
the journal is always the source of truth. Coverage is computed from the
append's returned byte offsets, never a post-append stat(), so a
concurrent flock'd writer interleaving between index snapshot and append
forces a rebuild instead of silently under-indexed coverage.

Deletes append timed tombstone frames to a per-partition
`tombstones.log` that is always replayed (deletes are rare; segment
immutability is what buys the pruning). An event frame is dead iff a
tombstone for its id carries a deletion time >= the frame's creation
time — so delete-then-reinsert resurrects the id (EVLOG parity) and the
stale frame in the original segment stays dead.

Externally supplied ids are recorded in a per-partition
`external_ids.log` (id -> bucket), giving cross-bucket duplicate
detection and targeted get() without full scans; generated ids are
uuid-fresh and live in their prefix segment, so a fast-path miss on a
generated-shape id is authoritative.

Config: PIO_STORAGE_SOURCES_<N>_TYPE=PEVLOG, ..._PATH=<dir>,
..._BUCKET_HOURS=<int, default 24>.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import threading
from base64 import b64decode, b64encode
from dataclasses import replace
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import base, columns
from predictionio_tpu_torch.data.storage._scanworker import scan_chunk
from predictionio_tpu_torch.data.storage.evlog import (
    _from_us, _payload_to_event, _us,
)
from predictionio_tpu_torch.native.eventlog import (
    EventLog, MAGIC, _HEADER, framed_size,
)


def _compact_payload(e: Event) -> bytes:
    """PEVLOG's journal codec: microsecond ints instead of ISO-8601
    strings (the evlog codec spends most of its time formatting and
    parsing datetimes). `_decode_payload` still reads the evlog JSON form, so
    journals are migratable between the two drivers."""
    return _payload_for(e, e.event_id, _us(e.event_time))


# printable ASCII minus '"' and '\' — strings whose JSON literal is just
# quotes around the raw bytes, needing no escape pass
_JSON_SIMPLE = re.compile(r'^[ -!#-\[\]-~]*$')
_ESC_CACHE: Dict[str, str] = {}


def _jstr(s: str) -> str:
    # fullmatch, not match: '$' would also match before a trailing
    # newline, embedding the raw control character in the frame and
    # corrupting the segment for every future replay
    if _JSON_SIMPLE.fullmatch(s):
        return f'"{s}"'
    return json.dumps(s)


def _jstr_cached(s: str) -> str:
    """Escaped JSON literal for low-cardinality strings (event names,
    entity types): computed once, reused across the whole ingest."""
    r = _ESC_CACHE.get(s)
    if r is None:
        if len(_ESC_CACHE) > 4096:
            _ESC_CACHE.clear()
        r = _ESC_CACHE[s] = json.dumps(s)
    return r


def _payload_for(e: Event, eid: str, t_us: int,
                 eid_safe: bool = False) -> bytes:
    """Journal frame payload with the id/time supplied by the caller —
    the bulk-ingest hot path builds the common frame shape (no target,
    no properties, no tags) by string assembly instead of dict +
    json.dumps, which costs several times as much.
    `eid_safe` skips the JSON-escape check for ids this driver just
    generated (hex + dash, always literal-safe)."""
    if (e.target_entity_type is None and e.properties.is_empty
            and not e.tags and e.pr_id is None):
        idj = f'"{eid}"' if eid_safe else _jstr(eid)
        ct = e.creation_time
        if ct.tzinfo is None:            # _us inlined: ingest hot path
            ct = ct.replace(tzinfo=timezone.utc)
        return (f'{{"id":{idj},"e":{_jstr_cached(e.event)},'
                f'"et":{_jstr_cached(e.entity_type)},'
                f'"ei":{_jstr(e.entity_id)},'
                f'"tus":{t_us},'
                f'"cus":{int(ct.timestamp() * 1_000_000)}}}').encode()
    obj = {"id": eid, "e": e.event, "et": e.entity_type,
           "ei": e.entity_id, "tus": t_us,
           "cus": _us(e.creation_time)}
    if e.target_entity_type:
        obj["tet"] = e.target_entity_type
        obj["tei"] = e.target_entity_id
    if not e.properties.is_empty:
        obj["p"] = dict(e.properties.fields)
    if e.tags:
        obj["g"] = list(e.tags)
    if e.pr_id:
        obj["pr"] = e.pr_id
    return json.dumps(obj, separators=(",", ":")).encode()


def _decode_payload(obj: dict) -> Event:
    if "tus" not in obj:               # evlog-format frame
        return _payload_to_event(obj)
    # trusted construction: frames were validated at insert and
    # CRC-checked at read, and each json.loads dict is owned by this
    # frame — skip the dataclass __init__ and DataMap copy/re-check
    # (a large share of a segment replay)
    e = object.__new__(Event)
    e.__dict__.update(
        event=obj["e"], entity_type=obj["et"], entity_id=obj["ei"],
        target_entity_type=obj.get("tet"),
        target_entity_id=obj.get("tei"),
        properties=DataMap._trusted(obj.get("p")),
        event_time=_from_us(obj["tus"]),
        creation_time=_from_us(obj["cus"]),
        event_id=obj["id"], tags=tuple(obj.get("g", ())),
        pr_id=obj.get("pr"))
    return e

_BLOOM_BITS = 1 << 16          # initial size: 8 KiB per segment
_BLOOM_HASHES = 4
# grow the filter when more than 1/_BLOOM_MAX_FILL of its bits are set
# (fp rate at 1/3 fill with 4 hashes ~ 1.2%); a fixed 64k-bit filter
# saturates around ~20k entities per segment, silently disabling the
# pruning that is this driver's whole point
_BLOOM_MAX_FILL = 3
# ~16 bits per expected entity keeps fill ~ 0.22 after sizing
_BLOOM_BITS_PER_ENTITY = 16
# sidecar persist cadence: flush when at least this many appends AND at
# least 1/_IDX_FLUSH_FRACTION of the segment is unpersisted. The
# proportional rule bounds a cold reader's catch-up work (the stale
# tail `_extend_index` decodes) to ~12% of any segment while keeping the
# persist count per segment O(log growth); the absolute floor keeps
# singleton-insert workloads from persisting every event.
_IDX_FLUSH_MIN = 1024
_IDX_FLUSH_FRACTION = 8


def _bloom_bits_for(n: int) -> int:
    bits = _BLOOM_BITS
    while bits < _BLOOM_BITS_PER_ENTITY * max(1, n):
        bits *= 2
    return bits


_DIGEST_CACHE: Dict[tuple, bytes] = {}


def _bloom_digest(key_type: str, key_id: str) -> bytes:
    # entities recur across events (a user has many events): memoize
    # the md5, bounded
    k = (key_type, key_id)
    d = _DIGEST_CACHE.get(k)
    if d is None:
        if len(_DIGEST_CACHE) > (1 << 18):
            _DIGEST_CACHE.clear()
        d = _DIGEST_CACHE[k] = hashlib.md5(
            f"{key_type}\x00{key_id}".encode()).digest()
    return d


def _positions_from(digest: bytes, bits: int) -> List[int]:
    return [int.from_bytes(digest[i * 4:i * 4 + 4], "little") % bits
            for i in range(_BLOOM_HASHES)]


def _bloom_positions(entity_type: str, entity_id: str,
                     bits: int) -> List[int]:
    return _positions_from(_bloom_digest(entity_type, entity_id), bits)


# per-stream cap on remembered digests: beyond this, an index stops
# tracking (and regrows fall back to a journal replay). 1M digests =
# 16 MB — the bound on per-segment tracking memory.
_DIGEST_TRACK_MAX = 1 << 20


def _norm_value(v):
    """Collapse ==-equal values onto one representative: the post-filter
    compares with Python ==, where 10 == 10.0 == True's 1, so the Bloom
    key must not distinguish them (a typed key would falsely PRUNE a
    segment whose event matches; mapping distinct-but-float-colliding
    ints together only adds a false positive, which is just a scan)."""
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, list):
        return [_norm_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm_value(x) for k, x in v.items()}
    return v


def _value_key(value) -> str:
    """Canonical string form of a property value for the property Bloom
    (dict key order and numeric type must not change the hash)."""
    return json.dumps(_norm_value(value), sort_keys=True,
                      separators=(",", ":"))


class _SegmentIndex:
    """Per-segment sidecar: min/max event time, entity Bloom, exact
    event-name set, target-entity Bloom, and a (property-name, value)
    Bloom. The field indexes give `find` pushdown on event names,
    target entities, and exact property values — the role the reference
    fills with Elasticsearch's query DSL (`ESLEvents.scala:308`), at
    segment (skip-index) granularity, like HBase filter pushdown for
    the entity/time axes."""

    def __init__(self, bits: int = _BLOOM_BITS):
        self.min_us = None
        self.max_us = None
        self.count = 0
        self.synced = 0          # journal bytes the PERSISTED idx covers
        self.bits = bits
        self.filled = 0          # set bits (saturation tracking)
        self.bloom = bytearray(bits // 8)
        # target-entity and property Blooms share bits/growth with the
        # entity Bloom
        self.tbloom = bytearray(bits // 8)
        self.tfilled = 0
        self.pbloom = bytearray(bits // 8)
        self.pfilled = 0
        self.event_names: Set[str] = set()   # exact: low cardinality
        # True while event_names is known NOT to cover every frame (a
        # legacy sidecar loaded without an 'events' key, then appended
        # to): pruning must be disabled and the partial set must never
        # be persisted, or queries naming only pre-upgrade events would
        # silently skip this segment
        self.names_incomplete = False
        # md5 digests added to each Bloom (entity/target/property) since
        # this object was built. While complete, a saturation regrow
        # re-mods the remembered digests against the bigger filter — no
        # journal replay, no re-hash (a replay per regrow was the
        # largest bulk-ingest cost in the JAX package's profile). An index loaded
        # from a sidecar does not know its keys, so it starts incomplete
        # and regrows the slow way once (becoming complete after).
        self.digests: Tuple[list, list, list] = ([], [], [])
        self.digests_complete = True
        self.dirty = 0           # appends since last persist
        self.mem_size = 0        # journal bytes the in-memory state covers

    def _bits_add(self, buf: bytearray, key_type: str, key_id: str,
                  stream: int) -> int:
        d = _bloom_digest(key_type, key_id)
        if self.digests_complete:
            dg = self.digests[stream]
            if len(dg) < _DIGEST_TRACK_MAX:
                dg.append(d)
            else:                      # cap hit: stop tracking, free
                self.digests_complete = False
                self.digests = ([], [], [])
        return self._bits_add_digest(buf, d)

    def _bits_add_digest(self, buf: bytearray, d: bytes) -> int:
        # bits is always a power of two, so `% bits` == `& (bits-1)` of
        # the same little-endian 32-bit word — one 128-bit from_bytes +
        # shifts is bit-compatible with _positions_from and measurably
        # cheaper than four 4-byte reads on the ingest hot path
        v = int.from_bytes(d, "little")
        m = self.bits - 1
        new = 0
        for sh in (0, 32, 64, 96):
            pos = (v >> sh) & m
            byte, bit = pos >> 3, 1 << (pos & 7)
            if not buf[byte] & bit:
                buf[byte] |= bit
                new += 1
        return new

    def _bloom_add(self, entity_type: str, entity_id: str) -> None:
        self.filled += self._bits_add(self.bloom, entity_type, entity_id, 0)

    def add_parts(self, t_us: int, entity_type: str, entity_id: str,
                  event_name: str, tet, tei, props) -> None:
        """Ingest-hot-path add: the caller has already split the event
        into parts (and computed t_us ONCE: datetime conversions are a
        large share of a bulk ingest)."""
        if self.min_us is None:
            self.min_us = self.max_us = t_us
        else:
            if t_us < self.min_us:
                self.min_us = t_us
            if t_us > self.max_us:
                self.max_us = t_us
        self.count += 1
        self.filled += self._bits_add(self.bloom, entity_type, entity_id,
                                      0)
        self.event_names.add(event_name)
        if tet and tei:
            self.tfilled += self._bits_add(self.tbloom, tet, tei, 1)
        if props:
            for k, v in props.items():
                self.pfilled += self._bits_add(self.pbloom, k,
                                               _value_key(v), 2)

    def add(self, ev: Event) -> None:
        self.add_parts(_us(ev.event_time), ev.entity_type, ev.entity_id,
                       ev.event, ev.target_entity_type,
                       ev.target_entity_id,
                       None if ev.properties.is_empty
                       else ev.properties.fields)

    def _bits_contain(self, buf: bytearray, key_type: str,
                      key_id: str) -> bool:
        return all(buf[p // 8] & (1 << (p % 8))
                   for p in _bloom_positions(key_type, key_id, self.bits))

    def may_contain(self, entity_type: str, entity_id: str) -> bool:
        return self._bits_contain(self.bloom, entity_type, entity_id)

    def may_contain_target(self, tet: str, tei: str) -> bool:
        return self._bits_contain(self.tbloom, tet, tei)

    def may_contain_property(self, name: str, value) -> bool:
        return self._bits_contain(self.pbloom, name, _value_key(value))

    def may_contain_event(self, names) -> bool:
        # empty or incomplete set = a legacy sidecar that never (fully)
        # recorded names: no pruning evidence, must scan
        if self.names_incomplete or not self.event_names:
            return True
        return any(n in self.event_names for n in names)

    @property
    def bloom_saturated(self) -> bool:
        return max(self.filled, self.tfilled,
                   self.pfilled) * _BLOOM_MAX_FILL > self.bits

    def with_grown_bloom(self, events) -> "_SegmentIndex":
        """A NEW index with a filter resized for `events` (this object
        is never mutated: concurrent lock-free readers keep seeing the
        old filter, which is monotonic — saturated-but-correct. The
        caller swaps the new object into the index cache, an atomic
        dict assignment)."""
        events = list(events)
        ix = _SegmentIndex(
            bits=max(_bloom_bits_for(len(events)), self.bits * 2))
        ix.min_us, ix.max_us = self.min_us, self.max_us
        ix.count, ix.synced = self.count, self.synced
        ix.mem_size, ix.dirty = self.mem_size, self.dirty
        # `events` is the full segment: rebuild the name set from it, so
        # a names_incomplete legacy index heals here instead of carrying
        # the flag forward
        ix.event_names = {ev.event for ev in events}
        for ev in events:
            ix._bloom_add(ev.entity_type, ev.entity_id)
            if ev.target_entity_type and ev.target_entity_id:
                ix.tfilled += ix._bits_add(
                    ix.tbloom, ev.target_entity_type, ev.target_entity_id,
                    1)
            if not ev.properties.is_empty:
                for k, v in ev.properties.fields.items():
                    ix.pfilled += ix._bits_add(ix.pbloom, k, _value_key(v),
                                               2)
        return ix

    def regrow_from_digests(self) -> "Optional[_SegmentIndex]":
        """A NEW index with doubled-or-resized filters rebuilt from the
        remembered digests — the cheap regrow (no journal replay, no
        re-hash). None when this index does not know all its keys (it
        was loaded from a sidecar, or tracking hit its cap); the caller
        then falls back to `with_grown_bloom` over a full replay.
        Same immutability contract as with_grown_bloom: this object is
        never mutated, concurrent readers keep a valid filter."""
        if not self.digests_complete:
            return None
        # a digest is remembered per key OCCURRENCE (an entity with many
        # events repeats its digest): size by the distinct keys, and hand
        # on the lists without the repeats
        distinct = tuple(list(dict.fromkeys(dg)) for dg in self.digests)
        biggest = max(len(dg) for dg in distinct)
        # size one doubling AHEAD of the current key count: bulk ingest
        # keeps appending to the segment, and regrowing once per batch
        # re-adds every digest each time
        ix = _SegmentIndex(
            bits=max(_bloom_bits_for(biggest * 2), self.bits * 2))
        ix.min_us, ix.max_us = self.min_us, self.max_us
        ix.count, ix.synced = self.count, self.synced
        ix.mem_size, ix.dirty = self.mem_size, self.dirty
        ix.names_incomplete = self.names_incomplete
        ix.event_names = set(self.event_names)
        # the (deduplicated) digest lists transfer: writers are
        # lock-serialized, and the abandoned old object never appends
        ix.digests = distinct
        for buf, attr, dg in ((ix.bloom, "filled", distinct[0]),
                              (ix.tbloom, "tfilled", distinct[1]),
                              (ix.pbloom, "pfilled", distinct[2])):
            n = 0
            for d in dg:
                n += ix._bits_add_digest(buf, d)
            setattr(ix, attr, n)
        return ix

    def overlaps(self, start_us: Optional[int],
                 until_us: Optional[int]) -> bool:
        if self.min_us is None:
            return False
        if start_us is not None and self.max_us < start_us:
            return False
        if until_us is not None and self.min_us >= until_us:
            return False
        return True

    def dump(self) -> dict:
        # zlib-compressed filters under NEW key names — pre-sized
        # megabit Blooms are mostly zeros, and persisting them raw is
        # a slice of bulk ingest. The rename (zbloom, not
        # bloom+flag) is deliberate: an older reader sharing the store
        # hits KeyError on the missing "bloom", which its loader
        # already treats as a corrupt sidecar and rebuilds from the
        # journal — instead of misreading compressed bytes as a raw
        # filter
        import zlib as _zlib
        enc = lambda b: b64encode(_zlib.compress(bytes(b), 1)).decode()  # noqa: E731
        out = {"min_us": self.min_us, "max_us": self.max_us,
               "count": self.count, "synced": self.synced,
               "bits": self.bits,
               "zbloom": enc(self.bloom),
               "ztbloom": enc(self.tbloom),
               "zpbloom": enc(self.pbloom)}
        # an incomplete name set must not be persisted as if exhaustive:
        # omitting the key keeps the sidecar in legacy (never-prune)
        # form until a full rebuild supplies a complete set
        if not self.names_incomplete:
            out["events"] = sorted(self.event_names)
        return out

    @classmethod
    def load(cls, obj: dict) -> "_SegmentIndex":
        import zlib as _zlib
        ix = cls()
        ix.min_us = obj["min_us"]
        ix.max_us = obj["max_us"]
        ix.count = obj["count"]
        ix.synced = obj["synced"]
        if "zbloom" in obj:              # current compressed form
            dec = lambda s: bytearray(_zlib.decompress(b64decode(s)))  # noqa: E731
            ix.bloom = dec(obj["zbloom"])
            ix.bits = obj.get("bits", len(ix.bloom) * 8)
            ix.tbloom = dec(obj["ztbloom"])
            ix.pbloom = dec(obj["zpbloom"])
        else:                            # legacy raw sidecars
            ix.bloom = bytearray(b64decode(obj["bloom"]))
            ix.bits = obj.get("bits", len(ix.bloom) * 8)
            if "tbloom" in obj:
                ix.tbloom = bytearray(b64decode(obj["tbloom"]))
            else:      # no pruning evidence: never prune
                ix.tbloom = bytearray(b"\xff" * (ix.bits // 8))
            if "pbloom" in obj:
                ix.pbloom = bytearray(b64decode(obj["pbloom"]))
            else:      # pre-property-Bloom sidecar: never prune (the
                # all-ones filter also reads as saturated, so the first
                # append regrows it from a full replay — the heal path)
                ix.pbloom = bytearray(b"\xff" * (ix.bits // 8))
        ix.filled = int.from_bytes(bytes(ix.bloom), "little").bit_count()
        ix.tfilled = int.from_bytes(bytes(ix.tbloom),
                                    "little").bit_count()
        ix.pfilled = int.from_bytes(bytes(ix.pbloom),
                                    "little").bit_count()
        ix.event_names = set(obj.get("events", ()))
        # a legacy sidecar (pre-'events') covers frames whose names were
        # never recorded: appends may NOT flip the set to "non-empty and
        # trusted" — that would prune queries naming only legacy events
        ix.names_incomplete = "events" not in obj
        # a loaded index does not know the keys behind its persisted
        # bits: saturation regrows must replay the journal once
        ix.digests_complete = False
        return ix


class PevlogStorageClient:
    def __init__(self, config):
        self.base_dir = Path(config.get("PATH", "./.pio_store/pevlog"))
        self.base_dir.mkdir(parents=True, exist_ok=True)
        self.bucket_us = int(config.get("BUCKET_HOURS", 24)) * 3600 * 1_000_000
        self.lock = threading.RLock()
        # journal path -> (watermark size, consumed frame-boundary
        # offset, state) where state is an {event_id: Event} table for
        # segments, {id: tomb_us} for tombstones.log, or {id: [buckets]}
        # for external_ids.log (see _scan_journal)
        self.replay_cache: Dict[str, Tuple[int, int, dict]] = {}
        self.index_cache: Dict[str, _SegmentIndex] = {}
        # segment journal path -> (replay state, {(entityType, entityId):
        # [Event]}) for entity finds (see PevlogEvents._entity_rows)
        self.entity_cache: Dict[str, Tuple[dict, dict]] = {}
        # observability + the sublinearity contract's test hook
        self.stats = {"segments_pruned": 0, "segments_scanned": 0}

    def close(self) -> None:
        with self.lock:
            for seg, ix in self.index_cache.items():
                if ix.dirty:
                    _persist_index(Path(seg), ix)
                    ix.dirty = 0


def _persist_index(seg_path: Path, ix: _SegmentIndex) -> None:
    # synced = the bytes the in-memory state is KNOWN to cover (append
    # offsets, not stat(): a concurrent writer may have grown the file
    # past what this index has seen)
    ix.synced = ix.mem_size
    integrity.atomic_write_bytes(seg_path.with_suffix(".idx"),
                                 json.dumps(ix.dump()).encode())


# generated ids are <16-hex bucket>-<32-hex uuid4>; anything else is an
# externally supplied id (evlog's 32-hex ids don't match: no dash)
_GEN_ID = re.compile(r"^[0-9a-f]{16}-[0-9a-f]{32}$")


def _now_us() -> int:
    return _us(datetime.now(timezone.utc))


# deletion time assigned to tombstone frames written before tombstones
# carried times: far enough in the future to always cover the frame
# (the old semantics), and recognizably out of the valid range so the
# reinsert path can refuse instead of minting an absurd creation time
_LEGACY_TOMB_US = 1 << 62


class PevlogEvents(base.EventStore):
    def __init__(self, client: PevlogStorageClient):
        self.c = client

    # -- layout --------------------------------------------------------------
    def _part_dir(self, app_id: int, channel_id: Optional[int]) -> Path:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return self.c.base_dir / f"app_{app_id}{suffix}"

    def _segment_path(self, part: Path, bucket_us: int) -> Path:
        return part / f"seg_{bucket_us:016x}.log"

    def _bucket_of(self, ev: Event) -> int:
        return (_us(ev.event_time) // self.c.bucket_us) * self.c.bucket_us

    @staticmethod
    def _bucket_from_id(event_id: str) -> Optional[int]:
        if not _GEN_ID.match(event_id):
            return None
        return int(event_id[:16], 16)

    def _segments(self, part: Path) -> List[Path]:
        if not part.exists():
            return []
        return sorted(part.glob("seg_*.log"))

    # -- index ---------------------------------------------------------------
    def _index(self, seg: Path) -> _SegmentIndex:
        """In-memory index if it covers the journal exactly; else the
        persisted sidecar — EXTENDED over the journal's append-only tail
        when it covers a prefix (`_extend_index`: a cold reader after a
        crash or an unflushed writer decodes only the few-% stale tail,
        never the whole segment); else rebuild from the journal (source
        of truth — covers shrunk journals and corrupt sidecars)."""
        key = str(seg)
        size = seg.stat().st_size if seg.exists() else 0
        ix = self.c.index_cache.get(key)
        if ix is not None and ix.mem_size == size:
            return ix
        idx_path = seg.with_suffix(".idx")
        ix = None
        if idx_path.exists():
            try:
                ix = _SegmentIndex.load(json.loads(idx_path.read_text()))
            except (ValueError, KeyError):
                ix = None
        if ix is not None and ix.synced == size:
            ix.mem_size = ix.synced
        elif ix is not None and 0 < ix.synced < size:
            self._extend_index(seg, ix, size)
        else:
            table = self._replay_segment(seg)
            ix = _SegmentIndex(bits=_bloom_bits_for(len(table)))
            # coverage = the size snapshot the replay was keyed on (the
            # replay may have read past it if a writer raced — the index
            # then over-covers, which can only disable pruning, never
            # cause a false prune)
            snap = self.c.replay_cache[str(seg)][0]
            for ev in table.values():
                ix.add(ev)
            ix.mem_size = snap
            _persist_index(seg, ix)
        self.c.index_cache[key] = ix
        return ix

    def _extend_index(self, seg: Path, ix: _SegmentIndex,
                      size: int) -> None:
        """Catch a prefix-covering sidecar up over the journal tail —
        indexes are add-only, so decoding frames from `synced` onward
        and adding their parts is equivalent to a full rebuild at a
        fraction of the cost (no Event construction, no re-decode of
        covered frames). Migrated-evlog tombstone frames are skipped:
        they only remove table entries, and Bloom bits are monotonic."""
        consumed = ix.synced
        added = 0
        for payload, end in EventLog(str(seg)).scan_from(ix.synced):
            # str input: json.loads on bytes runs detect_encoding
            # per frame
            obj = json.loads(payload.decode())
            if "$tombstone" not in obj:
                if "tus" in obj:
                    ix.add_parts(obj["tus"], obj["et"], obj["ei"],
                                 obj["e"], obj.get("tet"),
                                 obj.get("tei"), obj.get("p"))
                else:               # evlog-format frame
                    ix.add(_payload_to_event(obj))
                added += 1
            consumed = end
        ix.mem_size = consumed
        ix.dirty += added
        if added:
            try:
                _persist_index(seg, ix)
                ix.dirty = 0
            except OSError:         # read-only mount: stay in-memory
                pass

    # -- replay --------------------------------------------------------------
    def _scan_journal(self, path: Path, apply_frame) -> dict:
        """Incremental size-keyed journal decode. Cache entries are
        (watermark_size, consumed_offset, state): growth past the
        watermark decodes only the tail from `consumed` (append-only
        journals), with copy-on-write state so lock-free concurrent
        readers keep a consistent snapshot."""
        size = path.stat().st_size if path.exists() else 0
        key = str(path)
        cached = self.c.replay_cache.get(key)
        if cached is not None and cached[1] > size:
            cached = None   # journal shrank (remove/rollback): rescan
        if cached is not None and cached[0] == size:
            return cached[2]
        if cached is not None:
            consumed, state = cached[1], dict(cached[2])
        else:
            consumed, state = 0, {}
        for payload, end in EventLog(key).scan_from(consumed):
            # str input: json.loads on bytes runs detect_encoding
            # per frame
            apply_frame(state, json.loads(payload.decode()))
            consumed = end
        self.c.replay_cache[key] = (size, consumed, state)
        return state

    @staticmethod
    def _apply_event_frame(table: dict, obj: dict) -> None:
        if "$tombstone" in obj:          # migrated evlog journals
            table.pop(obj["$tombstone"], None)
            return
        e = _decode_payload(obj)
        table[e.event_id] = e

    def _replay_segment(self, seg: Path) -> Dict[str, Event]:
        return self._scan_journal(seg, self._apply_event_frame)

    @staticmethod
    def _apply_tombstone_frame(dead: dict, obj: dict) -> None:
        tus = obj.get("tus", _LEGACY_TOMB_US)
        key = obj["$tombstone"]
        dead[key] = max(dead.get(key, -1), tus)

    def _tombstones(self, part: Path) -> Dict[str, int]:
        """id -> latest deletion time (us). A frame is dead iff its
        creation time <= that. Legacy untimed tombstones read as
        +inf-ish (always dead, no resurrect)."""
        return self._scan_journal(part / "tombstones.log",
                                  self._apply_tombstone_frame)

    @staticmethod
    def _live(e: Event, dead: Dict[str, int]) -> bool:
        return dead.get(e.event_id, -1) < _us(e.creation_time)

    @staticmethod
    def _apply_ext_frame(ext: dict, obj: dict) -> None:
        # copy-on-write for the inner lists too: concurrent readers may
        # hold the previous snapshot's list objects
        buckets = list(ext.get(obj["x"], ()))
        if obj["b"] not in buckets:
            buckets.append(obj["b"])
        ext[obj["x"]] = buckets

    def _ext_index(self, part: Path) -> Dict[str, List[int]]:
        """id -> buckets an externally supplied id was appended to."""
        return self._scan_journal(part / "external_ids.log",
                                  self._apply_ext_frame)

    # -- contract ------------------------------------------------------------
    def _ensure_ext_log(self, part: Path) -> None:
        """The ext log's existence marks a partition whose external ids
        are all recorded (get()'s generated-shape fast-path miss is then
        authoritative). Upgrading a legacy partition must BACKFILL
        entries for every frame living outside its id's prefix bucket
        before the marker appears — atomically (tmp + rename), so a
        crash mid-backfill doesn't leave a marker that hides data."""
        import fcntl
        path = part / "external_ids.log"
        if path.exists():      # cheap no-lock fast path: the marker is
            return             # never removed once present
        with self.c.lock:   # serialize vs concurrent inserts in THIS
            # process; the flock below extends the exclusion across
            # processes — journal appends are flock'd per-frame, so two
            # processes first-touching a legacy partition could
            # otherwise interleave check/backfill/rename and the loser's
            # rename would clobber frames the winner just appended.
            # The lock file lives OUTSIDE the partition dir: remove()
            # unlinks everything inside it, and an unlinked lock file
            # would let a later process flock a fresh inode concurrently
            # with a holder of the old one
            lockf = (part.parent / f"{part.name}.lock").open("a")
            try:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
                if path.exists():
                    return
                frames = []
                for seg in self._segments(part):
                    seg_bucket = int(seg.name[4:20], 16)
                    for eid in self._replay_segment(seg):
                        if self._bucket_from_id(eid) != seg_bucket:
                            frames.append(json.dumps(
                                {"x": eid, "b": seg_bucket}).encode())
                tmp = part / "external_ids.log.tmp"
                if tmp.exists():
                    tmp.unlink()
                if frames:
                    EventLog(str(tmp)).append_many(frames)
                else:
                    tmp.touch()
                tmp.replace(path)
                # file identity changed: any cached scan state is stale
                self.c.replay_cache.pop(str(path), None)
            finally:
                lockf.close()   # releases the flock

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        part = self._part_dir(app_id, channel_id)
        part.mkdir(parents=True, exist_ok=True)
        self._ensure_ext_log(part)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        part = self._part_dir(app_id, channel_id)
        with self.c.lock:
            if part.exists():
                for p in part.iterdir():
                    self.c.replay_cache.pop(str(p), None)
                    self.c.index_cache.pop(str(p), None)
                    self.c.entity_cache.pop(str(p), None)
                    if p.is_dir():       # _prepared ingest cache
                        import shutil
                        shutil.rmtree(p, ignore_errors=True)
                    else:
                        p.unlink()
                part.rmdir()
        return True

    def close(self) -> None:
        self.c.close()

    def fsck(self, repair: bool = False) -> List[dict]:
        """Partition-wide consistency sweep: (1) torn tails on every
        CRC-framed journal (segments, tombstones, external ids) — scans
        already ignore them but they hide future appends; (2) stale or
        missing segment sidecar indexes (crash between append and index
        flush). Repair truncates tails and rebuilds indexes from the
        journal (source of truth)."""
        # flush this process's own batched index state first: on a LIVE
        # store, dirty in-memory indexes make sidecars look stale when
        # nothing is actually wrong
        self.c.close()
        findings: List[dict] = []
        for part in sorted(self.c.base_dir.glob("app_*")):
            if not part.is_dir():
                continue
            for jpath in sorted(part.glob("*.log")):
                valid_end = 0
                for _payload, end in EventLog(str(jpath)).scan_from(0):
                    valid_end = end
                try:
                    size = jpath.stat().st_size
                except OSError:
                    continue
                if size > valid_end:
                    finding = {
                        "kind": "torn_tail", "path": str(jpath),
                        "reason": (f"{size - valid_end} trailing bytes "
                                   "fail frame CRC"),
                        "action": "none"}
                    if repair:
                        with self.c.lock:
                            os.truncate(jpath, valid_end)
                            self.c.replay_cache.pop(str(jpath), None)
                            self.c.index_cache.pop(str(jpath), None)
                        finding["action"] = f"truncated to {valid_end}"
                    findings.append(finding)
            for seg in self._segments(part):
                idx_path = seg.with_suffix(".idx")
                size = seg.stat().st_size if seg.exists() else 0
                synced = -1
                if idx_path.exists():
                    try:
                        synced = _SegmentIndex.load(
                            json.loads(idx_path.read_text())).synced
                    except (ValueError, KeyError):
                        synced = -1
                if synced == size:
                    continue
                finding = {
                    "kind": "stale_index", "path": str(idx_path),
                    "reason": (f"sidecar covers {max(synced, 0)} of "
                               f"{size} journal bytes"),
                    "action": "none"}
                if repair:
                    with self.c.lock:
                        self.c.index_cache.pop(str(seg), None)
                        self._index(seg)   # rebuild/extend + persist
                    finding["action"] = "rebuilt"
                findings.append(finding)
        return findings

    def _insert(self, event: Event, app_id: int,
                channel_id: Optional[int] = None) -> str:
        return self._insert_many([event], app_id, channel_id)[0]

    def _insert_many(self, events, app_id, channel_id=None) -> List[str]:
        """Bulk path: group by segment, one blob append + one index
        update per touched segment. The generated-id fast path never
        clones the Event (a dataclass replace and its re-validation per
        event), converts each event
        time to microseconds exactly once, and draws ids from
        os.urandom instead of the slower uuid4 wrapper (same 128 random
        bits)."""
        import os as _os

        part = self._part_dir(app_id, channel_id)
        part.mkdir(parents=True, exist_ok=True)
        self._ensure_ext_log(part)
        bucket_us = self.c.bucket_us
        out_ids: List[str] = []
        # bucket -> list of (event, id, t_us): the event object is the
        # caller's, never cloned; the id travels alongside
        by_seg: Dict[int, List[tuple]] = {}
        batch_ids: Set[str] = set()
        ext_frames: List[bytes] = []
        # one urandom draw for the whole batch, not a syscall per
        # event; 32 hex chars per id
        rand_hex = _os.urandom(16 * len(events)).hex() if events else ""
        rand_pos = 0
        with self.c.lock:
            dead = self._tombstones(part)
            ext = self._ext_index(part)
            for e in events:
                t = e.event_time
                if t.tzinfo is None:     # _us inlined: ingest hot path
                    t = t.replace(tzinfo=timezone.utc)
                t_us = int(t.timestamp() * 1_000_000)
                bucket = (t_us // bucket_us) * bucket_us
                if e.event_id:
                    # only externally supplied ids can collide; generated
                    # ids are 128 random bits (checking them would force
                    # a replay of the segment per batch — O(N^2)
                    # ingest). The ext index pins down every segment an
                    # external id ever landed in, so cross-bucket dups
                    # are caught too.
                    if e.event_id in batch_ids:
                        raise base.StorageWriteError(
                            f"Duplicate event id {e.event_id}")
                    for b in {bucket, *ext.get(e.event_id, ())}:
                        seg = self._segment_path(part, b)
                        prev = self._replay_segment(seg).get(e.event_id)
                        if prev is not None and self._live(prev, dead):
                            raise base.StorageWriteError(
                                f"Duplicate event id {e.event_id}")
                    # delete-then-reinsert: if a tombstone would also
                    # cover the NEW frame (clock tie or skew), nudge its
                    # creation time past the tombstone so it is live
                    tomb = dead.get(e.event_id, -1)
                    if tomb >= _LEGACY_TOMB_US:
                        # an untimed (pre-upgrade) tombstone covers ALL
                        # frames of this id forever; a reinsert would be
                        # silently invisible — refuse instead
                        raise base.StorageWriteError(
                            f"Event id {e.event_id} was deleted by a "
                            "legacy untimed tombstone and cannot be "
                            "reinserted")
                    if tomb >= _us(e.creation_time):
                        e = replace(e, creation_time=_from_us(tomb + 1))
                    batch_ids.add(e.event_id)
                    ext_frames.append(json.dumps(
                        {"x": e.event_id, "b": bucket}).encode())
                    eid = e.event_id
                else:
                    # routing is ALWAYS by event time; an id prefix does
                    # not redirect the event
                    eid = f"{bucket:016x}-{rand_hex[rand_pos:rand_pos + 32]}"
                    rand_pos += 32
                group = by_seg.get(bucket)
                if group is None:
                    group = by_seg[bucket] = []
                group.append((e, eid, t_us))
                out_ids.append(eid)
            # ext records BEFORE the segment appends: a crash in between
            # leaves a harmless unreferenced ext entry, whereas the
            # reverse order would strand a generated-shape external id
            # beyond the reach of get()/delete() (whose targeted miss is
            # authoritative) and of cross-bucket duplicate detection
            if ext_frames:
                EventLog(str(part / "external_ids.log")).append_many(
                    ext_frames)
            for bucket, triples in by_seg.items():
                seg = self._segment_path(part, bucket)
                ix = self._index(seg)
                # pre-size a FRESH segment's Blooms: without this, bulk
                # ingest saturates the default filter repeatedly. The
                # batch is the scale hint (a caller inserting 100k
                # events will insert more), CAPPED at 8x this segment's
                # slice — a batch spread over many segments must not
                # give every segment a whole-batch-sized filter, whose
                # serialization then dominates the sidecar persists
                # (digest-tracked regrows make under-sizing cheap)
                need = _bloom_bits_for(
                    max(ix.count + len(triples),
                        min(len(events), 8 * len(triples))))
                if need > ix.bits and ix.count == 0 and ix.filled == 0 \
                        and ix.tfilled == 0 and ix.pfilled == 0:
                    grown = _SegmentIndex(bits=need)
                    grown.synced = ix.synced
                    grown.mem_size = ix.mem_size
                    grown.dirty = ix.dirty
                    grown.names_incomplete = ix.names_incomplete
                    grown.event_names = set(ix.event_names)
                    ix = grown
                    self.c.index_cache[str(seg)] = ix
                blobs = [_payload_for(e, eid, t_us,
                                      eid_safe=not e.event_id)
                         for e, eid, t_us in triples]
                off, end = EventLog(str(seg)).append_many(blobs)
                if off != ix.mem_size or end - off != framed_size(blobs):
                    # another process appended between our index snapshot
                    # and this append (or interleaved with the legacy
                    # looped fallback): the journal is the source of
                    # truth — rebuild (covers our frames too)
                    self.c.index_cache.pop(str(seg), None)
                    ix = self._index(seg)
                else:
                    add_parts = ix.add_parts
                    for e, eid, t_us in triples:
                        add_parts(t_us, e.entity_type, e.entity_id,
                                  e.event, e.target_entity_type,
                                  e.target_entity_id,
                                  None if e.properties.is_empty
                                  else e.properties.fields)
                    ix.mem_size = end
                    if ix.bloom_saturated:
                        grown = ix.regrow_from_digests()
                        if grown is None:
                            grown = ix.with_grown_bloom(
                                self._replay_segment(seg).values())
                        ix = grown
                        self.c.index_cache[str(seg)] = ix
                ix.dirty += len(triples)
                if ix.dirty >= _IDX_FLUSH_MIN and \
                        ix.dirty * _IDX_FLUSH_FRACTION >= ix.count:
                    _persist_index(seg, ix)
                    ix.dirty = 0
        return out_ids

    def _insert_batch(self, events, app_id, channel_id=None) -> List[str]:
        return self._insert_many(events, app_id, channel_id)

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        part = self._part_dir(app_id, channel_id)
        dead = self._tombstones(part)
        bucket = self._bucket_from_id(event_id)
        targets: List[int] = [] if bucket is None else [bucket]
        for b in self._ext_index(part).get(event_id, ()):
            if b not in targets:
                targets.append(b)
        for b in targets:
            ev = self._replay_segment(
                self._segment_path(part, b)).get(event_id)
            if ev is not None and self._live(ev, dead):
                return ev
        if bucket is not None and (part / "external_ids.log").exists():
            # generated-shape ids are either store-generated (live in
            # their prefix segment) or imported (recorded in the ext
            # index) — the targeted miss is authoritative, no full scan.
            # A partition WITHOUT an ext log predates external-id
            # recording: fall through to the scan
            return None
        for seg in self._segments(part):
            ev = self._replay_segment(seg).get(event_id)
            if ev is not None and self._live(ev, dead):
                return ev
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        with self.c.lock:
            ev = self.get(event_id, app_id, channel_id)
            if ev is None:
                return False
            part = self._part_dir(app_id, channel_id)
            # clamp to the frame's creation time so events stamped in
            # the future (imports) are still covered by the tombstone
            tus = max(_now_us(), _us(ev.creation_time))
            EventLog(str(part / "tombstones.log")).append(
                json.dumps({"$tombstone": event_id,
                            "tus": tus}).encode())
        return True

    @staticmethod
    def _segment_survives(ix: _SegmentIndex, *, start_us, until_us,
                          entity_type, entity_id, event_names,
                          target_entity_type, target_entity_id,
                          properties) -> bool:
        """Index pushdown shared by `find` and `scan_columns`: True iff
        the segment may hold a matching event and must be replayed."""
        if not ix.overlaps(start_us, until_us):
            return False
        if entity_type is not None and entity_id is not None \
                and not ix.may_contain(entity_type, entity_id):
            return False
        if event_names and not ix.may_contain_event(event_names):
            return False
        if isinstance(target_entity_type, str) \
                and isinstance(target_entity_id, str) \
                and not ix.may_contain_target(target_entity_type,
                                              target_entity_id):
            return False
        # a matching event must carry EVERY filter pair, so one pair
        # definitely absent from the segment prunes it (the ES
        # query-DSL pushdown role, at skip-index granularity)
        if properties and any(
                not ix.may_contain_property(k, v)
                for k, v in properties.items()):
            return False
        return True

    def _entity_rows(self, seg: Path, table: dict) -> Dict[tuple, list]:
        """(entityType, entityId) -> the segment's events of that entity,
        in the replay table's order, so that an entity find (a serving
        read) walks its own events, not the whole segment. Built once per
        replay state: `_scan_journal` never changes a state it has cached
        (growth copies it), so the identity check keeps this exact."""
        key = str(seg)
        cached = self.c.entity_cache.get(key)
        if cached is not None and cached[0] is table:
            return cached[1]
        rows: Dict[tuple, list] = {}
        for e in table.values():
            rows.setdefault((e.entity_type, e.entity_id), []).append(e)
        self.c.entity_cache[key] = (table, rows)
        return rows

    def find(self, app_id: int, channel_id: Optional[int] = None, *,
             start_time=None, until_time=None, entity_type=None,
             entity_id=None, event_names=None,
             target_entity_type=base._UNSET,
             target_entity_id=base._UNSET,
             properties=None,
             limit: Optional[int] = None,
             reversed: bool = False) -> Iterator[Event]:
        part = self._part_dir(app_id, channel_id)
        start_us = _us(start_time) if start_time is not None else None
        until_us = _us(until_time) if until_time is not None else None
        dead = self._tombstones(part)
        events: List[Event] = []
        for seg in self._segments(part):
            if not self._segment_survives(
                    self._index(seg), start_us=start_us, until_us=until_us,
                    entity_type=entity_type, entity_id=entity_id,
                    event_names=event_names,
                    target_entity_type=target_entity_type,
                    target_entity_id=target_entity_id,
                    properties=properties):
                self.c.stats["segments_pruned"] += 1
                continue
            self.c.stats["segments_scanned"] += 1
            table = self._replay_segment(seg)
            rows = (self._entity_rows(seg, table).get(
                        (entity_type, entity_id), ())
                    if entity_type is not None and entity_id is not None
                    else table.values())
            for e in rows:
                if not self._live(e, dead):
                    continue
                if base.match_event(
                        e, start_time=start_time, until_time=until_time,
                        entity_type=entity_type, entity_id=entity_id,
                        event_names=event_names,
                        target_entity_type=target_entity_type,
                        target_entity_id=target_entity_id,
                        properties=properties):
                    events.append(e)
        events.sort(key=lambda e: e.event_time, reverse=reversed)
        if limit is not None and limit > 0:
            events = events[:limit]
        return iter(events)

    # -- columnar training scan ---------------------------------------------
    def scan_columns(self, app_id: int, channel_id: Optional[int] = None, *,
                     start_time=None, until_time=None, entity_type=None,
                     entity_id=None, event_names=None,
                     target_entity_type=base._UNSET,
                     target_entity_id=base._UNSET,
                     properties=None, value_spec=None,
                     require_target: bool = True,
                     workers: Optional[int] = None,
                     since: Optional[Dict[str, int]] = None,
                     upto: Optional[Dict[str, int]] = None
                     ) -> "columns.EventColumns":
        """`find()` semantics, columnar output: identical index pushdown
        and post-filters, but matching frames decode straight into numpy
        columns (no Event/datetime/DataMap per frame) on a chunked
        `PIO_INGEST_WORKERS` process pool. Segments whose Event replay
        is already cached at the current journal size reuse it instead
        of re-reading the journal; segments the raw path can't reproduce
        exactly (legacy frames, in-journal tombstones, external ids)
        fall back to the Event replay per segment. Output is invariant
        under worker count and byte-equivalent to
        `columns_from_events(self.find(...))`.

        With `since=<ingest_watermark snapshot>` only the journal bytes
        appended after that watermark are decoded (the streaming delta
        path, see `_scan_delta`); `upto` pins the exclusive upper bound
        to a second watermark the caller snapshotted before calling."""
        if since is not None:
            return self._scan_delta(
                app_id, channel_id, since=since, upto=upto,
                start_time=start_time, until_time=until_time,
                entity_type=entity_type, entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
                properties=properties, value_spec=value_spec,
                require_target=require_target)
        del upto
        procs = ingest_workers(workers)
        part = self._part_dir(app_id, channel_id)
        start_us = _us(start_time) if start_time is not None else None
        until_us = _us(until_time) if until_time is not None else None
        dead = self._tombstones(part)
        spec = columns.normalize_value_spec(value_spec)
        filters = dict(start_time=start_time, until_time=until_time,
                       entity_type=entity_type, entity_id=entity_id,
                       event_names=event_names,
                       target_entity_type=target_entity_type,
                       target_entity_id=target_entity_id,
                       properties=properties)
        if len(dead) > _DEAD_SHIP_MAX:
            # the worker cfg ships the tombstone map with every chunk; a
            # huge one makes the Event path the cheaper option
            return columns.columns_from_events(
                self.find(app_id, channel_id, **filters),
                value_spec, require_target)
        cfg_blob = pickle.dumps(
            {"start_us": start_us, "until_us": until_us,
             "entity_type": entity_type, "entity_id": entity_id,
             "event_names": frozenset(event_names) if event_names else None,
             "tet": columns.encode_target(target_entity_type, base._UNSET),
             "tei": columns.encode_target(target_entity_id, base._UNSET),
             "properties": dict(properties) if properties else None,
             "value_spec": spec, "require_target": require_target,
             "dead": dict(dead)},
            protocol=pickle.HIGHEST_PROTOCOL)
        pool = _scan_pool(procs) if procs > 1 else None
        plan: List[tuple] = []
        for seg in self._segments(part):
            if not self._segment_survives(
                    self._index(seg), start_us=start_us, until_us=until_us,
                    entity_type=entity_type, entity_id=entity_id,
                    event_names=event_names,
                    target_entity_type=target_entity_type,
                    target_entity_id=target_entity_id,
                    properties=properties):
                self.c.stats["segments_pruned"] += 1
                continue
            self.c.stats["segments_scanned"] += 1
            key = str(seg)
            try:
                size = seg.stat().st_size
            except OSError:
                continue
            cached = self.c.replay_cache.get(key)
            if cached is not None and cached[0] == size:
                plan.append(("block", self._event_block(
                    cached[2], dead, filters, spec, require_target)))
                continue
            chunks = (_frame_chunks(seg, size, procs) if pool is not None
                      else [(0, size)])
            futs = [(pool.submit(scan_chunk, key, s, e, cfg_blob)
                     if pool is not None else None, s, e)
                    for s, e in chunks]
            plan.append(("futs", futs, seg))
        blocks: List[tuple] = []
        for entry in plan:
            if entry[0] == "block":
                blocks.append(entry[1])
                continue
            _tag, futs, seg = entry
            seg_blocks: List[tuple] = []
            need_exact = truncated = False
            for fut, s, e in futs:
                if truncated:
                    break
                try:
                    res = (fut.result() if fut is not None
                           else scan_chunk(str(seg), s, e, cfg_blob))
                except Exception:
                    need_exact = True   # pool/worker failure: Event path
                    break
                if res[0] == "exact":
                    need_exact = True
                    break
                _ok, block, consumed = res
                seg_blocks.append(block)
                if consumed < e:
                    # CRC-invalid frame mid-journal: a serial scan stops
                    # there, so later chunks must be dropped too
                    truncated = True
            if need_exact:
                blocks.append(self._event_block(
                    self._replay_segment(seg), dead, filters, spec,
                    require_target))
            else:
                blocks.extend(seg_blocks)
        return columns.merge_blocks(blocks)

    def _scan_delta(self, app_id: int, channel_id: Optional[int], *,
                    since: Dict[str, int],
                    upto: Optional[Dict[str, int]],
                    start_time=None, until_time=None, entity_type=None,
                    entity_id=None, event_names=None,
                    target_entity_type=base._UNSET,
                    target_entity_id=base._UNSET,
                    properties=None, value_spec=None,
                    require_target: bool = True
                    ) -> "columns.EventColumns":
        """Decode ONLY the journal bytes in (since, upto]: per segment,
        frames from the `since` byte offset up to the `upto` size go
        through the exact `scan_chunk` filter/decode path the full scan
        uses, so delta rows are byte-equivalent to the tail of a full
        scan. The result is correct ONLY as an append-delta on top of
        the `since` snapshot, so anything that rewrites history between
        the watermarks raises `DeltaInvalidated` (callers fall back to
        the full scan):

          - tombstones.log grew: a delete may kill rows ALREADY FOLDED
            into the since snapshot;
          - external_ids.log grew: a caller-supplied id can overwrite an
            earlier frame (last-wins), which a pure append-delta would
            double-count;
          - a segment shrank, vanished, or was unreadable (-1): the
            journal was rewritten under us;
          - a delta frame is evlog-legacy / in-journal "$tombstone" /
            externally-identified ("exact" from `scan_chunk`), or a
            torn frame truncates the range;
          - the delta byte span exceeds `PIO_DELTA_MAX_BYTES` (the
            host-memory bound — a full scan is the better tool then).
        """
        part = self._part_dir(app_id, channel_id)
        wm = upto if upto is not None else self.ingest_watermark(
            app_id, channel_id)
        for name in ("tombstones.log", "external_ids.log"):
            if wm.get(name, 0) != since.get(name, 0):
                raise base.DeltaInvalidated(
                    f"{name} changed between watermarks "
                    f"({since.get(name, 0)} -> {wm.get(name, 0)})")
        spans: List[Tuple[str, int, int]] = []   # (seg name, lo, hi)
        for name, lo in since.items():
            if name in ("tombstones.log", "external_ids.log"):
                continue
            hi = wm.get(name)
            if hi is None or hi < lo or lo < 0 or hi < 0:
                raise base.DeltaInvalidated(
                    f"segment {name} rewritten between watermarks "
                    f"({lo} -> {hi})")
        for name, hi in wm.items():
            if name in ("tombstones.log", "external_ids.log"):
                continue
            if hi < 0:
                raise base.DeltaInvalidated(f"segment {name} unreadable")
            lo = since.get(name, 0)
            if hi > lo:
                spans.append((name, lo, hi))
        budget = int(os.environ.get("PIO_DELTA_MAX_BYTES", "")
                     or _DELTA_MAX_BYTES)
        if sum(hi - lo for _, lo, hi in spans) > budget:
            raise base.DeltaInvalidated(
                "delta span exceeds PIO_DELTA_MAX_BYTES "
                f"({sum(h - l for _, l, h in spans)} > {budget})")
        dead = self._tombstones(part)
        if len(dead) > _DEAD_SHIP_MAX:
            raise base.DeltaInvalidated("tombstone map too large for "
                                        "the raw-frame delta decode")
        spec = columns.normalize_value_spec(value_spec)
        start_us = _us(start_time) if start_time is not None else None
        until_us = _us(until_time) if until_time is not None else None
        cfg_blob = pickle.dumps(
            {"start_us": start_us, "until_us": until_us,
             "entity_type": entity_type, "entity_id": entity_id,
             "event_names": frozenset(event_names) if event_names else None,
             "tet": columns.encode_target(target_entity_type, base._UNSET),
             "tei": columns.encode_target(target_entity_id, base._UNSET),
             "properties": dict(properties) if properties else None,
             "value_spec": spec, "require_target": require_target,
             "dead": dict(dead)},
            protocol=pickle.HIGHEST_PROTOCOL)
        blocks: List[tuple] = []
        for name, lo, hi in spans:
            seg = part / name
            # no index pushdown here: the skip-index may not cover the
            # fresh tail yet, and delta spans are small by construction
            status, block, consumed = scan_chunk(str(seg), lo, hi,
                                                 cfg_blob)
            if status != "ok":
                raise base.DeltaInvalidated(
                    f"segment {name} delta needs dict semantics "
                    "(legacy/tombstone/external-id frame)")
            if consumed < hi:
                raise base.DeltaInvalidated(
                    f"segment {name} torn mid-delta at {consumed}")
            self.c.stats["segments_scanned"] += 1
            blocks.append(block)
        return columns.merge_blocks(blocks)

    def _event_block(self, table: Dict[str, Event], dead, filters,
                     spec, require_target: bool) -> tuple:
        """Event-object fallback block for one replayed segment."""
        evs = [e for e in table.values()
               if self._live(e, dead) and base.match_event(e, **filters)]
        return columns.block_from_events(evs, spec, require_target)

    # -- prepared-data cache support -----------------------------------------
    def ingest_watermark(self, app_id: int,
                         channel_id: Optional[int] = None) -> Dict[str, int]:
        """Byte watermarks of every journal feeding a scan. Any append
        grows a segment (or creates one), any delete grows
        tombstones.log, external ids grow external_ids.log — so an
        unchanged watermark proves an unchanged scan result."""
        part = self._part_dir(app_id, channel_id)
        wm: Dict[str, int] = {}
        for seg in self._segments(part):
            try:
                wm[seg.name] = seg.stat().st_size
            except OSError:
                wm[seg.name] = -1
        for name in ("tombstones.log", "external_ids.log"):
            p = part / name
            wm[name] = p.stat().st_size if p.exists() else 0
        return wm

    def ingest_cache_dir(self, app_id: int,
                         channel_id: Optional[int] = None) -> Path:
        return self._part_dir(app_id, channel_id) / "_prepared"

    # -- columnar property aggregation ---------------------------------------
    def aggregate_properties(self, app_id: int,
                             channel_id: Optional[int] = None, *,
                             entity_type: str,
                             start_time=None, until_time=None,
                             required=None):
        """$set/$unset/$delete replay through the index pushdown and a
        raw-frame scan: segments without property events prune by their
        event-name set, and the surviving frames fold into `EventOp`s
        without building Events (the base path decodes every frame into
        an Event and two datetimes first). Equal to the base
        implementation; a journal the raw path cannot reproduce exactly
        (legacy or tombstone frames in it, external ids) goes through
        the base path instead."""
        from predictionio_tpu_torch.data import aggregate as agg
        names = ("$set", "$unset", "$delete")
        name_set = frozenset(names)
        part = self._part_dir(app_id, channel_id)
        start_us = _us(start_time) if start_time is not None else None
        until_us = _us(until_time) if until_time is not None else None
        dead = self._tombstones(part)
        rows: List[tuple] = []   # (tus, seq, name, entity_id, props|None)
        seq = 0
        for seg in self._segments(part):
            if not self._segment_survives(
                    self._index(seg), start_us=start_us, until_us=until_us,
                    entity_type=entity_type, entity_id=None,
                    event_names=names, target_entity_type=base._UNSET,
                    target_entity_id=base._UNSET, properties=None):
                self.c.stats["segments_pruned"] += 1
                continue
            self.c.stats["segments_scanned"] += 1
            key = str(seg)
            try:
                size = seg.stat().st_size
            except OSError:
                continue
            cached = self.c.replay_cache.get(key)
            if cached is not None and cached[0] == size:
                for e in cached[2].values():
                    if e.event not in name_set \
                            or e.entity_type != entity_type \
                            or not self._live(e, dead) \
                            or not base.match_event(
                                e, start_time=start_time,
                                until_time=until_time):
                        continue
                    rows.append((columns._event_us(e), seq, e.event,
                                 e.entity_id, e.properties._fields))
                    seq += 1
                continue
            for payload, _end in EventLog(key).scan_from(0):
                obj = json.loads(payload.decode())
                if "$tombstone" in obj or "tus" not in obj \
                        or not _GEN_ID.match(obj["id"]):
                    # dict-replay semantics needed: the base path
                    return super().aggregate_properties(
                        app_id, channel_id, entity_type=entity_type,
                        start_time=start_time, until_time=until_time,
                        required=required)
                if obj["e"] not in name_set or obj["et"] != entity_type:
                    continue
                tus = obj["tus"]
                if start_us is not None and tus < start_us:
                    continue
                if until_us is not None and tus >= until_us:
                    continue
                if dead and dead.get(obj["id"], -1) >= obj["cus"]:
                    continue
                rows.append((tus, seq, obj["e"], obj["ei"], obj.get("p")))
                seq += 1
        rows.sort(key=lambda r: (r[0], r[1]))   # find()'s stable time sort
        ops: Dict[str, agg.EventOp] = {}
        for tus, _seq, name, ei, p in rows:
            op = agg.op_from_parts(
                name, p, columns.t_millis_from_us_scalar(tus))
            prev = ops.get(ei)
            ops[ei] = op if prev is None else prev.combine(op)
        out = {}
        for ei, op in ops.items():
            pm = op.to_property_map()
            if pm is not None:
                out[ei] = pm
        if required:
            req = list(required)
            out = {k: v for k, v in out.items()
                   if all(r in v.fields for r in req)}
        return out


# -- ingest worker pool ------------------------------------------------------

_CHUNK_MIN_BYTES = 1 << 20      # don't chunk journals under 1 MiB
_DEAD_SHIP_MAX = 50_000         # tombstone-map size cap for worker cfg
_DELTA_MAX_BYTES = 64 * 1024 * 1024   # delta host-memory bound default
_SCAN_POOL = None
_SCAN_POOL_PROCS = 0            # -1 = pools unusable in this process
_SCAN_POOL_LOCK = threading.Lock()
# scan pools this process spawned: flat after the first scan, so the
# pool is reused across refresher ticks; a climbing count means
# something tears it down
POOL_SPAWNS = 0


def ingest_workers(override: Optional[int] = None) -> int:
    """Scan parallelism: explicit override, else PIO_INGEST_WORKERS,
    else 1 (serial in-process decode)."""
    if override is not None:
        return max(1, int(override))
    try:
        return max(1, int(os.environ.get("PIO_INGEST_WORKERS", "1") or "1"))
    except ValueError:
        return 1


def _scan_pool(procs: int):
    """Persistent spawn-start worker pool. Spawn, not fork: the parent
    may hold torch and CUDA runtime threads that a fork would deadlock.
    The start-up is paid once per process and amortized across every
    scan. Returns None when pools can't start (sandboxes, missing
    semaphores) — callers then decode inline."""
    global _SCAN_POOL, _SCAN_POOL_PROCS, POOL_SPAWNS
    with _SCAN_POOL_LOCK:
        if _SCAN_POOL_PROCS == -1:
            return None
        if _SCAN_POOL is not None and _SCAN_POOL_PROCS >= procs:
            return _SCAN_POOL
        try:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            pool = ProcessPoolExecutor(
                max_workers=procs,
                mp_context=multiprocessing.get_context("spawn"))
            pool.submit(int, 0).result(timeout=120)   # fail fast, not mid-scan
            if _SCAN_POOL is not None:
                _SCAN_POOL.shutdown(wait=False)
            _SCAN_POOL, _SCAN_POOL_PROCS = pool, procs
            POOL_SPAWNS += 1
            return pool
        except Exception:
            _SCAN_POOL_PROCS = -1
            return None


def _frame_chunks(path: Path, size: int, procs: int):
    """Frame-aligned byte ranges for chunked decode. Header-only walk
    (lengths, no CRC — workers verify payloads); stops at the first
    torn header exactly where a serial scan would."""
    target = max(size // max(procs, 1), _CHUNK_MIN_BYTES)
    try:
        with open(path, "rb") as f:
            data = f.read(size)
    except OSError:
        return []
    hsz = _HEADER.size
    unpack = _HEADER.unpack_from
    bounds = [0]
    pos = 0
    n = len(data)
    while pos + hsz <= n:
        magic, length, _crc = unpack(data, pos)
        if magic != MAGIC or length > (1 << 30):
            break
        nxt = pos + hsz + length
        if nxt > n:
            break
        pos = nxt
        if pos - bounds[-1] >= target:
            bounds.append(pos)
    if pos > bounds[-1]:
        bounds.append(pos)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
