"""Chunk-scan worker for the columnar ingest pipeline.

The port of `predictionio_tpu/data/storage/_scanworker.py`. It runs in
spawn-started `PIO_INGEST_WORKERS` processes, whose import chain is the
standard library and numpy only (no torch, no device code: keep it so),
and inline in-process when workers <= 1, so serial and parallel scans
share one code path and agree by construction.

A worker decodes one byte range of one PEVLOG segment journal — frame
boundaries were pre-walked by the parent, so ranges start and end on
frame edges — applies the full `find()` post-filter set plus tombstone
liveness on the RAW json dict (no Event / datetime / DataMap
construction), evaluates the value spec, and returns a column block.

Exactness escape: frames the zero-object path cannot reproduce
byte-for-byte — evlog-legacy frames (no "tus"), in-journal
"$tombstone" frames (positional pops), or externally supplied ids
(duplicate-id last-wins needs a cross-chunk table) — abort the chunk
with ("exact", None); the parent redoes that whole segment through the
Event-object replay instead. Generated ids are globally unique, so the
common case never needs the dict semantics.
"""

from __future__ import annotations

import json
import pickle
import re
import struct
import zlib
from typing import Optional, Tuple

_HEADER = struct.Struct("<III")
_MAGIC = 0x50494F45                       # native.eventlog frame magic
_GEN_ID = re.compile(r"^[0-9a-f]{16}-[0-9a-f]{32}$")


def scan_chunk(path: str, start: int, end: int,
               cfg_blob: bytes) -> Tuple[str, Optional[tuple], int]:
    """Decode journal frames in [start, end) -> ("ok", Block, consumed)
    | ("exact", None, 0). `consumed` is the absolute offset reached: a
    CRC-invalid frame stops the chunk early (like `scan_from`), and the
    parent then discards every later chunk of the segment so the
    chunked scan truncates at the same frame a serial scan would.
    `cfg_blob` is a pickled filter/spec dict, pickled once by the
    parent and shared across all chunk submissions."""
    from predictionio_tpu_torch.data.storage.columns import BlockBuilder

    cfg = pickle.loads(cfg_blob)
    start_us = cfg["start_us"]
    until_us = cfg["until_us"]
    entity_type = cfg["entity_type"]
    entity_id = cfg["entity_id"]
    names = cfg["event_names"]            # frozenset or None
    tet = cfg["tet"]                      # ("unset",) | ("none",) | ("str", s)
    tei = cfg["tei"]
    properties = cfg["properties"]        # dict or None
    spec = cfg["value_spec"]
    require_target = cfg["require_target"]
    dead = cfg["dead"]                    # id -> tombstone µs

    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start)

    b = BlockBuilder()
    unpack, crc32, loads = _HEADER.unpack_from, zlib.crc32, json.loads
    hsz = _HEADER.size
    pos, n = 0, len(data)
    while pos + hsz <= n:
        magic, length, crc = unpack(data, pos)
        if magic != _MAGIC or length > (1 << 30):
            break                          # torn frame: stop like scan_from
        body_end = pos + hsz + length
        if body_end > n:
            break
        payload = data[pos + hsz:body_end]
        if crc32(payload) & 0xFFFFFFFF != crc:
            break
        pos = body_end
        obj = loads(payload.decode())
        if "$tombstone" in obj:
            return ("exact", None, 0)      # positional pop: dict semantics
        tus = obj.get("tus")
        if tus is None:
            return ("exact", None, 0)      # evlog-legacy frame
        eid = obj["id"]
        if not _GEN_ID.match(eid):
            return ("exact", None, 0)      # external id: dup overwrite possible
        if dead and dead.get(eid, -1) >= obj["cus"]:
            continue                       # tombstoned (see PevlogEvents._live)
        if start_us is not None and tus < start_us:
            continue
        if until_us is not None and tus >= until_us:
            continue
        if entity_type is not None and obj["et"] != entity_type:
            continue
        if entity_id is not None and obj["ei"] != entity_id:
            continue
        name = obj["e"]
        if names is not None and name not in names:
            continue
        frame_tei = obj.get("tei")
        if tet != ("unset",):
            want = None if tet == ("none",) else tet[1]
            if obj.get("tet") != want:
                continue
        if tei != ("unset",):
            want = None if tei == ("none",) else tei[1]
            if frame_tei != want:
                continue
        if properties is not None:
            p = obj.get("p")
            if p is None:
                continue
            if any(k not in p or p[k] != v for k, v in properties.items()):
                continue
        if require_target and frame_tei is None:
            continue
        v = _value(spec, name, obj.get("p"))
        if v is None:
            continue
        b.add(obj["ei"], frame_tei, v, tus)
    return ("ok", b.block(), start + pos)


def _value(spec, name, props) -> Optional[float]:
    # local copy of columns.eval_value, inlined for the per-frame loop
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
    return ent[2] if v is None else float(v)
