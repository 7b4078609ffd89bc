"""Columnar training ingest: scan -> build.

The port of `rating_columns_from_store` and its build helpers from
`predictionio_tpu/ingest/pipeline.py`:

  1. scan   `EventStore.scan_columns` decodes matching events into
            `EventColumns` (interned ids, values per `value_spec`,
            times) without building `Event` objects;
  2. build  numpy finalization: the fixed-BiMap remap, the last-wins
            dedup and the epoch-ms conversion, with no Python row loop.

The result equals `RatingColumns.from_events(store.find(...))` array
for array. The JAX package's prepared-data cache, remote ingest service
and mesh pre-sharding are not ported: every read scans. Stage seconds
accumulate per process under `ingest_scan_s` and `ingest_build_s`;
`Engine.train` drains them (`take_phase_timings`) into the run's phase
timings, where they split `read_s`.
"""

from __future__ import annotations

import threading
import time
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.data.storage import base, columns as C
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap

_timings_lock = threading.Lock()
_timings: Dict[str, float] = {}


def take_phase_timings() -> Dict[str, float]:
    """Drain the stage seconds accumulated since the last call."""
    with _timings_lock:
        out = dict(_timings)
        _timings.clear()
    return out


def _record_stage(stage: str, seconds: float) -> None:
    with _timings_lock:
        key = f"ingest_{stage}_s"
        _timings[key] = _timings.get(key, 0.0) + seconds


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
    t0 = time.perf_counter()
    cols = store.scan_columns(
        app_id, channel_id, value_spec=spec, require_target=True,
        start_time=start_time, until_time=until_time,
        entity_type=entity_type, event_names=event_names,
        target_entity_type=(base._UNSET if target_entity_type is None
                            else target_entity_type))
    _record_stage("scan", time.perf_counter() - t0)
    t0 = time.perf_counter()
    arrays, tables = _finalize_rating(cols, users, items, dedup_last_wins)
    rc = RatingColumns(
        arrays["user_ix"], arrays["item_ix"], arrays["rating"],
        arrays["t_millis"],
        users if users is not None else _bimap(tables["users"]),
        items if items is not None else _bimap(tables["items"]))
    _record_stage("build", time.perf_counter() - t0)
    return rc
