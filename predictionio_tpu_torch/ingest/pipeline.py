"""Columnar training ingest: scan -> build -> cache.

The port of `rating_columns_from_store` and its helpers from
`predictionio_tpu/ingest/pipeline.py`:

  1. scan   `EventStore.scan_columns` decodes matching events into
            `EventColumns` (interned ids, values per `value_spec`,
            times) without building `Event` objects (PEVLOG: on the
            `PIO_INGEST_WORKERS` process pool);
  2. build  numpy finalization: the fixed-BiMap remap, the last-wins
            dedup and the epoch-ms conversion, with no Python row loop;
  3. cache  the finalized columns go into a `.pioc` blob (the integrity
            envelope, `data.integrity`) named by the sha256 of the full
            filter signature and keyed by the store's `ingest_watermark`,
            so a retrain over an unchanged store skips the scan; any
            insert or delete moves the watermark and misses. The format,
            the signature and the newest-N eviction are the JAX
            package's: a blob either package wrote in a shared cache
            directory is a hit in the other, with equal columns.

The result equals `RatingColumns.from_events(store.find(...))` array
for array (`pair_columns_from_store`: `PairColumns.from_events`). Cache knobs: `PIO_INGEST_CACHE=off` disables it, unset or
`default` uses the store's `ingest_cache_dir()` (PEVLOG:
`<partition>/_prepared/`, SQLITE: `ingest_cache/<table>` beside the
database), any other value is a cache directory; `PIO_INGEST_CACHE_MAX`
(default 8) entries are kept per directory. Stage seconds accumulate per
process under `ingest_scan_s` and `ingest_build_s`, lookups under
`ingest_cache_hits` / `ingest_cache_misses`; `Engine.train` drains them
(`take_phase_timings`) into the run's phase timings. The process-default
registry gets the JAX package's families: `pio_ingest_stage_seconds
{stage}`, `pio_ingest_cache_{hits,misses,evictions}_total` and
`pio_ingest_scan_events_per_s`. With
`PIO_INGEST_SERVICE` set the scan runs on the remote ingest service
(`ingest.client.maybe_remote`, as the JAX package's `_prepared`); the
cache stays the consumer's. The JAX package's mesh pre-sharding is not
ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.storage import base, columns as C
from predictionio_tpu_torch.ingest.arrays import PairColumns, RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap

CACHE_FORMAT = 1
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_ONE_US = timedelta(microseconds=1)
# newest-N prepared-data cache entries kept per directory
_CACHE_MAX = 8

# the JAX package's buckets of `pio_ingest_stage_seconds`
_STAGE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                  2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_timings_lock = threading.Lock()
_timings: Dict[str, float] = {}


def take_phase_timings() -> Dict[str, float]:
    """Drain the stage seconds and cache counts accumulated since the
    last call."""
    with _timings_lock:
        out = dict(_timings)
        _timings.clear()
    return out


def _record(key: str, amount: float) -> None:
    with _timings_lock:
        _timings[key] = _timings.get(key, 0.0) + amount


def _record_stage(stage: str, seconds: float) -> None:
    """A stage's seconds: `pio_ingest_stage_seconds{stage}` of the
    process-default registry and the phase timings' `ingest_<stage>_s`."""
    from predictionio_tpu_torch.obs import get_registry
    get_registry().histogram(
        "pio_ingest_stage_seconds", "Training ingest stage wall time",
        labels=("stage",),
        buckets=_STAGE_BUCKETS).labels(stage=stage).observe(seconds)
    _record(f"ingest_{stage}_s", seconds)


def _record_cache(hit: bool) -> None:
    from predictionio_tpu_torch.obs import get_registry
    get_registry().counter(
        "pio_ingest_cache_hits_total" if hit
        else "pio_ingest_cache_misses_total",
        "Prepared-data cache lookups").inc()
    _record("ingest_cache_hits" if hit else "ingest_cache_misses", 1)


def _record_scan_rate(n_rows: int, seconds: float) -> None:
    if seconds > 0:
        from predictionio_tpu_torch.obs import get_registry
        get_registry().gauge(
            "pio_ingest_scan_events_per_s",
            "Rows/s decoded by the last columnar scan").set(n_rows / seconds)


# -- cache --------------------------------------------------------------------

def _t_us(t: Optional[datetime]) -> Optional[int]:
    if t is None:
        return None
    if t.tzinfo is None:
        t = t.replace(tzinfo=timezone.utc)
    return (t - _EPOCH) // _ONE_US


def _cache_dir(store, app_id: int,
               channel_id: Optional[int]) -> Optional[Path]:
    """The cache directory per `PIO_INGEST_CACHE`; None when caching is
    off or the store has no watermark or no directory for it."""
    mode = os.environ.get("PIO_INGEST_CACHE", "").strip()
    if mode.lower() == "off":
        return None
    if store.ingest_watermark(app_id, channel_id) is None:
        return None
    if mode and mode.lower() != "default":
        return _track_cache_dir(Path(mode))
    d = store.ingest_cache_dir(app_id, channel_id)
    return _track_cache_dir(Path(d)) if d is not None else None


# every cache directory this process used, so that the memory-pressure
# trim finds the prepared blobs without a store handle
_seen_cache_dirs: set = set()
_seen_lock = threading.Lock()


def _track_cache_dir(d: Path) -> Path:
    with _seen_lock:
        _seen_cache_dirs.add(d)
    return d


def trim_prepared_cache() -> int:
    """The memory-pressure trim: delete every prepared-cache entry in
    every cache directory this process used (the next prepare pays one
    full scan). Returns the bytes released."""
    with _seen_lock:
        dirs = list(_seen_cache_dirs)
    freed = 0
    for d in dirs:
        try:
            entries = list(d.glob("*.pioc"))
        except OSError:
            continue
        for p in entries:
            try:
                size = p.stat().st_size
                p.unlink()
                freed += size
            except OSError:
                pass
    return freed


def _encode_sig(v):
    if isinstance(v, tuple):
        return ["__t__", *[_encode_sig(x) for x in v]]
    if isinstance(v, dict):
        return {str(k): _encode_sig(x) for k, x in sorted(v.items())}
    if isinstance(v, (set, frozenset)):
        return [_encode_sig(x) for x in sorted(v, key=str)]
    if isinstance(v, list):
        return [_encode_sig(x) for x in v]
    return v


def _cache_path(cache_dir: Path, sig: dict) -> Path:
    blob = json.dumps(_encode_sig(sig), sort_keys=True,
                      separators=(",", ":")).encode()
    return cache_dir / (hashlib.sha256(blob).hexdigest() + ".pioc")


def _evict_cache(cache_dir: Path) -> None:
    """Drop the oldest `.pioc` entries past the newest-N bound (mtime
    order; a hit refreshes the mtime). A file that vanished meanwhile is
    another process's eviction, not an error."""
    try:
        keep = int(os.environ.get("PIO_INGEST_CACHE_MAX", _CACHE_MAX))
    except ValueError:
        keep = _CACHE_MAX
    if keep <= 0:
        return
    try:
        entries = sorted(cache_dir.glob("*.pioc"),
                         key=lambda p: p.stat().st_mtime, reverse=True)
    except OSError:
        return
    evicted = 0
    for p in entries[keep:]:
        try:
            p.unlink()
            evicted += 1
        except OSError:
            pass
    if evicted:
        from predictionio_tpu_torch.obs import get_registry
        get_registry().counter(
            "pio_ingest_cache_evictions_total",
            "Prepared-data cache entries evicted by the newest-N "
            "retention bound").inc(evicted)


def _cache_store(path: Path, watermark: Dict[str, int], kind: str,
                 arrays: Dict[str, np.ndarray],
                 tables: Dict[str, List[str]]) -> None:
    header = {
        "format": CACHE_FORMAT, "kind": kind, "watermark": watermark,
        "tables": tables,
        "arrays": [[name, a.dtype.str, int(a.shape[0])]
                   for name, a in arrays.items()],
    }
    payload = json.dumps(header, separators=(",", ":")).encode() + b"\n" + \
        b"".join(np.ascontiguousarray(a).tobytes() for a in arrays.values())
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        integrity.atomic_write_bytes(path, integrity.wrap(payload))
    except OSError:
        pass                             # a cache write failure is no error


def _cache_load(path: Path, watermark: Dict[str, int], kind: str):
    """(arrays, tables) on a fresh hit, else None. Any corruption (a torn
    blob, bad JSON, a wrong length) is a miss: the scan is always a safe
    fallback."""
    try:
        blob = path.read_bytes()
    except OSError:
        return None
    try:
        payload = integrity.unwrap(blob)
        nl = payload.index(b"\n")
        header = json.loads(payload[:nl].decode())
        if header.get("format") != CACHE_FORMAT or header.get("kind") != kind:
            return None
        if header.get("watermark") != watermark:
            return None                  # the journal moved: stale
        arrays: Dict[str, np.ndarray] = {}
        off = nl + 1
        for name, dtype, n in header["arrays"]:
            dt = np.dtype(dtype)
            end = off + dt.itemsize * n
            a = np.frombuffer(payload[off:end], dtype=dt)
            if a.shape[0] != n:
                raise ValueError("truncated column")
            arrays[name] = a
            off = end
        try:
            os.utime(path)               # the eviction's recency signal
        except OSError:
            pass
        return arrays, header["tables"]
    except (integrity.CorruptBlobError, ValueError, KeyError, TypeError):
        return None


# -- build --------------------------------------------------------------------

def _translate(table: List[str], fixed: BiMap) -> np.ndarray:
    """Scan-local intern table -> fixed BiMap ids (-1 = unseen: drop)."""
    return (np.array([fixed.get(k, -1) for k in table], np.int64)
            if table else np.zeros(0, np.int64))


def _dedup_last_wins(u: np.ndarray, i: np.ndarray, r: np.ndarray,
                     t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The `from_events` dict dedup, vectorized: one row per (u, i), at
    the key's FIRST occurrence, carrying the LAST occurrence's value
    (rows arrive time-sorted, so the last occurrence is the `t >= best`
    winner)."""
    if u.size == 0:
        return u, i, r, t
    key = (u.astype(np.int64) << 32) | i.astype(np.int64)
    _, first = np.unique(key, return_index=True)
    _, rev_first = np.unique(key[::-1], return_index=True)
    last = key.size - 1 - rev_first      # np.unique sorts keys: rows align
    sel = last[np.argsort(first, kind="stable")]
    return u[sel], i[sel], r[sel], t[sel]


def _finalize_rating(cols: C.EventColumns, users: Optional[BiMap],
                     items: Optional[BiMap], dedup: bool):
    """EventColumns -> (arrays, id tables) of `RatingColumns`."""
    u, i = cols.entity_ix.astype(np.int64), cols.target_ix.astype(np.int64)
    r, t = cols.value, cols.t_millis
    if users is not None or items is not None:
        tu = _translate(cols.entities, users) if users is not None else None
        ti = _translate(cols.targets, items) if items is not None else None
        u = tu[u] if tu is not None and u.size else u
        i = ti[i] if ti is not None and i.size else i
        keep = (u >= 0) & (i >= 0)
        u, i, r, t = u[keep], i[keep], r[keep], t[keep]
    if dedup:
        u, i, r, t = _dedup_last_wins(u, i, r, t)
    arrays = {"user_ix": u.astype(np.int32), "item_ix": i.astype(np.int32),
              "rating": r.astype(np.float32), "t_millis": t.astype(np.int64)}
    return arrays, {"users": cols.entities, "items": cols.targets}


def _finalize_pair(cols: C.EventColumns, left: Optional[BiMap],
                   right: Optional[BiMap]):
    """EventColumns -> (arrays, id tables) of `PairColumns`."""
    l, r = cols.entity_ix.astype(np.int64), cols.target_ix.astype(np.int64)
    w = cols.value
    if left is not None or right is not None:
        tl = _translate(cols.entities, left) if left is not None else None
        tr = _translate(cols.targets, right) if right is not None else None
        l = tl[l] if tl is not None and l.size else l
        r = tr[r] if tr is not None and r.size else r
        keep = (l >= 0) & (r >= 0)
        l, r, w = l[keep], r[keep], w[keep]
    arrays = {"left_ix": l.astype(np.int32), "right_ix": r.astype(np.int32),
              "weight": w.astype(np.float32)}
    return arrays, {"left": cols.entities, "right": cols.targets}


def _bimap(table: List[str]) -> BiMap:
    # tables are dense first-seen order already: skip from_keys' dedup
    return BiMap({k: ix for ix, k in enumerate(table)})


def rating_columns_from_store(
        store, app_id: int, channel_id: Optional[int] = None, *,
        event_names: Optional[Sequence[str]] = None,
        value_spec=None,
        dedup_last_wins: bool = False,
        users: Optional[BiMap] = None,
        items: Optional[BiMap] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None) -> RatingColumns:
    """`RatingColumns.from_events(store.find(...))` on the columnar path:
    the same arrays and BiMaps, no Event objects. `value_spec` stands
    for the `rating_of` closure (`data.storage.columns.
    normalize_value_spec`); `users` / `items` fix the BiMaps (rows of
    unseen ids drop)."""
    spec = C.normalize_value_spec(value_spec)
    sig = {
        "kind": "rating", "app": app_id, "channel": channel_id,
        "event_names": sorted(event_names) if event_names else None,
        "entity_type": entity_type,
        "target_entity_type": target_entity_type,
        "start_us": _t_us(start_time), "until_us": _t_us(until_time),
        "value_spec": spec, "dedup": bool(dedup_last_wins),
        "fixed_users": users.keys() if users is not None else None,
        "fixed_items": items.keys() if items is not None else None,
    }
    arrays, tables = _prepared(
        store, app_id, channel_id, sig, "rating",
        _filters(event_names, entity_type, target_entity_type, start_time,
                 until_time), spec,
        lambda cols: _finalize_rating(cols, users, items, dedup_last_wins))
    return RatingColumns(
        arrays["user_ix"], arrays["item_ix"], arrays["rating"],
        arrays["t_millis"],
        users if users is not None else _bimap(tables["users"]),
        items if items is not None else _bimap(tables["items"]))


def pair_columns_from_store(
        store, app_id: int, channel_id: Optional[int] = None, *,
        event_names: Optional[Sequence[str]] = None,
        value_spec=None,
        left: Optional[BiMap] = None,
        right: Optional[BiMap] = None,
        entity_type: Optional[str] = None,
        target_entity_type: Optional[str] = None,
        start_time: Optional[datetime] = None,
        until_time: Optional[datetime] = None) -> PairColumns:
    """`PairColumns.from_events(store.find(...))` on the columnar path;
    `value_spec` stands for `weight_of` (default: every match weighs
    1); `left` / `right` fix the BiMaps."""
    spec = C.normalize_value_spec(value_spec)
    sig = {
        "kind": "pair", "app": app_id, "channel": channel_id,
        "event_names": sorted(event_names) if event_names else None,
        "entity_type": entity_type,
        "target_entity_type": target_entity_type,
        "start_us": _t_us(start_time), "until_us": _t_us(until_time),
        "value_spec": spec,
        "fixed_left": left.keys() if left is not None else None,
        "fixed_right": right.keys() if right is not None else None,
    }
    arrays, tables = _prepared(
        store, app_id, channel_id, sig, "pair",
        _filters(event_names, entity_type, target_entity_type, start_time,
                 until_time), spec,
        lambda cols: _finalize_pair(cols, left, right))
    return PairColumns(
        arrays["left_ix"], arrays["right_ix"], arrays["weight"],
        left if left is not None else _bimap(tables["left"]),
        right if right is not None else _bimap(tables["right"]))


def _filters(event_names, entity_type, target_entity_type, start_time,
             until_time) -> dict:
    return dict(start_time=start_time, until_time=until_time,
                entity_type=entity_type, event_names=event_names,
                target_entity_type=(base._UNSET if target_entity_type is None
                                    else target_entity_type))


def _prepared(store, app_id, channel_id, sig, kind, filters, spec,
              finalize):
    """scan -> finalize -> cache, shared by both builders: `finalize`
    maps the `EventColumns` to (arrays, id tables)."""
    from predictionio_tpu_torch.ingest.client import maybe_remote
    store = maybe_remote(store)    # PIO_INGEST_SERVICE scans remotely
    cache_dir = _cache_dir(store, app_id, channel_id)
    path = watermark = None
    if cache_dir is not None:
        watermark = store.ingest_watermark(app_id, channel_id)
        path = _cache_path(cache_dir, sig)
        got = _cache_load(path, watermark, kind)
        _record_cache(got is not None)
        if got is not None:
            return got
    t0 = time.perf_counter()
    cols = store.scan_columns(app_id, channel_id, value_spec=spec,
                              require_target=True, **filters)
    scan_s = time.perf_counter() - t0
    _record_stage("scan", scan_s)
    _record_scan_rate(cols.n, scan_s)
    t0 = time.perf_counter()
    got = finalize(cols)
    _record_stage("build", time.perf_counter() - t0)
    if path is not None:
        _cache_store(path, watermark, kind, *got)
        _evict_cache(cache_dir)
    return got
