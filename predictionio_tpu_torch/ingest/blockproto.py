"""Column-block wire protocol of the remote ingest service.

The port of `predictionio_tpu/ingest/blockproto.py`, wire-compatible
with it (`PROTO_FORMAT = 1`): a spec or a block either package writes is
read by the other.

The currency between `cli ingestd` and its consumers is the **column
block**: one bounded row range of a finished `EventColumns` (entity and
target int32 indexes, float32 values, int64 event times) plus the
entries of the string tables that first appear inside that range. The
tables are in first-seen order over the time-sorted rows, so slicing
the rows in order makes them grow monotonically: a consumer that
appends each block's `ent_new` / `tgt_new` and fills each row range
rebuilds the service's columns bit for bit, holding at most one block
above the final arrays.

Framing is the CRC32 flavour of the blob envelope (`data.integrity`):
`magic | version | algo | u64 length | digest | payload`, the payload
one JSON header line and the raw little-endian column bytes. A torn or
bit-flipped block fails `integrity.unwrap`, and the consumer fetches the
same sequence number again instead of restarting the scan.

A scan spec is `scan_columns`' keyword arguments as JSON, the target
filters in `columns.encode_target`'s three-state form so that "no
filter" (`_UNSET`) and "no target" (None) stay apart; `spec_key` is the
service's coalescing key, sha256 over (spec, watermark).

numpy and the port's storage modules only: the service, its spawned
scan workers and every consumer import this.
"""

from __future__ import annotations

import hashlib
import json
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.storage import columns as C
from predictionio_tpu_torch.data.storage.base import _UNSET

PROTO_FORMAT = 1

_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_ONE_US = timedelta(microseconds=1)

# (name, numpy dtype) of the four row-aligned columns, in wire order
COLUMN_LAYOUT: Tuple[Tuple[str, str], ...] = (
    ("entity_ix", "<i4"), ("target_ix", "<i4"),
    ("value", "<f4"), ("t_us", "<i8"))


class BlockProtocolError(ValueError):
    """A well-formed blob with impossible contents (a sequence or table
    base out of step, an unknown format): a protocol fault or two scans
    mixed up, not a transport corruption (that is
    `integrity.CorruptBlobError`, which is retried)."""


def us_of(t: Optional[datetime]) -> Optional[int]:
    """Exact epoch microseconds of a datetime (naive = UTC), as the
    storage layer counts them, so that a filter crosses the wire
    exactly."""
    if t is None:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return (t - _EPOCH) // _ONE_US


def dt_of(us: Optional[int]) -> Optional[datetime]:
    if us is None:
        return None
    return _EPOCH + timedelta(microseconds=int(us))


# -- scan spec ----------------------------------------------------------------

def encode_spec(app_id: int, channel_id: Optional[int], *,
                start_time: Optional[datetime] = None,
                until_time: Optional[datetime] = None,
                entity_type: Optional[str] = None,
                entity_id: Optional[str] = None,
                event_names=None,
                target_entity_type: object = _UNSET,
                target_entity_id: object = _UNSET,
                properties: Optional[Dict[str, object]] = None,
                value_spec=None, require_target: bool = True,
                since: Optional[Dict[str, int]] = None,
                upto: Optional[Dict[str, int]] = None) -> dict:
    """`scan_columns` keyword arguments -> the JSON wire spec."""
    spec = C.normalize_value_spec(value_spec)
    return {
        "format": PROTO_FORMAT, "app": int(app_id),
        "channel": None if channel_id is None else int(channel_id),
        "start_us": us_of(start_time), "until_us": us_of(until_time),
        "entity_type": entity_type, "entity_id": entity_id,
        "event_names": sorted(event_names) if event_names else None,
        "tet": list(C.encode_target(target_entity_type, _UNSET)),
        "tei": list(C.encode_target(target_entity_id, _UNSET)),
        "properties": properties if properties else None,
        "value_spec": {k: list(v) for k, v in spec.items()},
        "require_target": bool(require_target),
        "since": since, "upto": upto,
    }


def _decode_target(enc) -> object:
    enc = tuple(enc)
    if enc == C.TGT_UNSET:
        return _UNSET
    if enc == C.TGT_NONE:
        return None
    if len(enc) == 2 and enc[0] == "str":
        return enc[1]
    raise BlockProtocolError(f"bad target filter encoding: {enc!r}")


def decode_spec(spec: dict) -> Tuple[int, Optional[int], dict]:
    """Wire spec -> (app id, channel id, `scan_columns` kwargs)."""
    if spec.get("format") != PROTO_FORMAT:
        raise BlockProtocolError(
            f"unsupported spec format {spec.get('format')!r}")
    vs = {k: tuple(v) for k, v in (spec.get("value_spec") or {}).items()}
    kwargs = dict(
        start_time=dt_of(spec.get("start_us")),
        until_time=dt_of(spec.get("until_us")),
        entity_type=spec.get("entity_type"),
        entity_id=spec.get("entity_id"),
        event_names=spec.get("event_names"),
        target_entity_type=_decode_target(spec.get("tet", C.TGT_UNSET)),
        target_entity_id=_decode_target(spec.get("tei", C.TGT_UNSET)),
        properties=spec.get("properties"),
        value_spec=C.normalize_value_spec(vs) if vs else None,
        require_target=bool(spec.get("require_target", True)),
        since=spec.get("since"), upto=spec.get("upto"),
    )
    channel = spec.get("channel")
    return (int(spec["app"]), None if channel is None else int(channel),
            kwargs)


def spec_key(spec: dict, watermark: Optional[Dict[str, int]]) -> str:
    """The coalescing key: one shared scan per (spec, watermark)."""
    blob = json.dumps({"spec": spec, "wm": watermark}, sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


# -- block codec --------------------------------------------------------------

def encode_block(scan_id: str, seq: int, cols: C.EventColumns,
                 lo: int, hi: int, ent_base: int, ent_hi: int,
                 tgt_base: int, tgt_hi: int) -> bytes:
    """One CRC-framed block of rows [lo, hi): the four column slices and
    the table entries first seen in the range ([ent_base, ent_hi),
    [tgt_base, tgt_hi))."""
    arrays = (cols.entity_ix[lo:hi], cols.target_ix[lo:hi],
              cols.value[lo:hi], cols.t_us[lo:hi])
    header = {
        "format": PROTO_FORMAT, "scan": scan_id, "seq": int(seq),
        "lo": int(lo), "rows": int(hi - lo),
        "ent_base": int(ent_base), "tgt_base": int(tgt_base),
        "ent_new": cols.entities[ent_base:ent_hi],
        "tgt_new": cols.targets[tgt_base:tgt_hi],
        "arrays": [[name, dt, int(a.shape[0])]
                   for (name, dt), a in zip(COLUMN_LAYOUT, arrays)],
    }
    payload = json.dumps(header, separators=(",", ":")).encode() + b"\n" + \
        b"".join(np.ascontiguousarray(a.astype(dt, copy=False)).tobytes()
                 for (_n, dt), a in zip(COLUMN_LAYOUT, arrays))
    return integrity.wrap(payload, algo=integrity.ALGO_CRC32)


def decode_block(blob: bytes) -> Tuple[dict, Dict[str, np.ndarray]]:
    """-> (header, arrays). Raises `integrity.CorruptBlobError` on a torn
    or corrupt frame (fetch the same seq again), `BlockProtocolError`
    on a well-formed frame with impossible contents (do not retry)."""
    payload = integrity.unwrap(blob)
    try:
        nl = payload.index(b"\n")
        header = json.loads(payload[:nl].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise BlockProtocolError(f"unparseable block header: {e}")
    if header.get("format") != PROTO_FORMAT:
        raise BlockProtocolError(
            f"unsupported block format {header.get('format')!r}")
    arrays: Dict[str, np.ndarray] = {}
    off = nl + 1
    for name, dtype, n in header.get("arrays", ()):
        dt = np.dtype(dtype)
        end = off + dt.itemsize * int(n)
        a = np.frombuffer(payload[off:end], dtype=dt)
        if a.shape[0] != n:
            raise BlockProtocolError(f"column {name!r} truncated "
                                     f"({a.shape[0]}/{n} rows)")
        arrays[name] = a
        off = end
    return header, arrays


class BlockAssembler:
    """The consumer's reassembly: the final arrays allocated from the
    announced row count, each block's rows filled in place, the string
    tables extended block by block. Above the finished columns it holds
    one decoded block."""

    def __init__(self, scan_id: str, rows: int):
        self.scan_id = scan_id
        self.rows = int(rows)
        self.next_seq = 0
        self._filled = 0
        self._ent: List[str] = []
        self._tgt: List[str] = []
        self._cols = {name: np.empty(self.rows, np.dtype(dt))
                      for name, dt in COLUMN_LAYOUT}

    def add(self, header: dict, arrays: Dict[str, np.ndarray]) -> None:
        if header.get("scan") != self.scan_id:
            raise BlockProtocolError(
                f"block for scan {header.get('scan')!r}, "
                f"expected {self.scan_id!r}")
        if header.get("seq") != self.next_seq:
            raise BlockProtocolError(
                f"block seq {header.get('seq')} out of order "
                f"(expected {self.next_seq})")
        if header.get("ent_base") != len(self._ent) or \
                header.get("tgt_base") != len(self._tgt):
            raise BlockProtocolError("table base mismatch (blocks of two "
                                     "different scans)")
        lo, n = int(header["lo"]), int(header["rows"])
        if lo != self._filled or lo + n > self.rows:
            raise BlockProtocolError(
                f"row range [{lo},{lo + n}) breaks the stream at "
                f"{self._filled}/{self.rows}")
        for name, _dt in COLUMN_LAYOUT:
            a = arrays.get(name)
            if a is None or a.shape[0] != n:
                raise BlockProtocolError(f"column {name!r} missing")
            self._cols[name][lo:lo + n] = a
        self._ent.extend(header.get("ent_new", ()))
        self._tgt.extend(header.get("tgt_new", ()))
        self._filled += n
        self.next_seq += 1

    @property
    def complete(self) -> bool:
        return self._filled == self.rows

    def columns(self) -> C.EventColumns:
        if not self.complete:
            raise BlockProtocolError(
                f"stream incomplete: {self._filled}/{self.rows} rows")
        return C.EventColumns(
            self._cols["entity_ix"], self._cols["target_ix"],
            self._cols["value"], self._cols["t_us"],
            self._ent, self._tgt)
