"""Batch views: parquet-cached snapshots of an app's events.

The port of `predictionio_tpu/data/view.py` (DataView.scala:43-100): a
view materializes an app's events in a time window into a parquet file
keyed by (app, channel, start, until) and reuses it while it is younger
than a staleness TTL, so that exploratory and batch work re-reads a
columnar snapshot instead of replaying the event store. The file is in
the `export` schema (`write_events_parquet`, which `cli export --format
parquet` writes too), so `cli import --format parquet` of either
package reads it back. pyarrow is imported when a view is read or
written.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional

from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.event import Event, PropertyMap

# the parquet columns: the API-JSON fields, `properties` as JSON text
# (a property bag has no static arrow schema)
PARQUET_COLUMNS = ("eventId", "event", "entityType", "entityId",
                   "targetEntityType", "targetEntityId", "properties",
                   "eventTime", "tags", "prId", "creationTime")
_CHUNK = 5000


def require_pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401
        return pyarrow
    except ImportError as e:
        raise ValueError(
            "format='parquet' requires pyarrow, which is not installed; "
            "use format='json'") from e


def write_events_parquet(events: Iterable[Event], output_path: str) -> int:
    """`events` -> a parquet file with the API-JSON fields as columns;
    returns the count."""
    pa = require_pyarrow()
    schema = pa.schema(
        [(c, pa.list_(pa.string()) if c == "tags" else pa.string())
         for c in PARQUET_COLUMNS])
    n = 0
    with pa.parquet.ParquetWriter(output_path, schema) as writer:
        chunk: List[dict] = []

        def write() -> None:
            writer.write_table(pa.table(
                {c: [r.get(c) for r in chunk] for c in PARQUET_COLUMNS},
                schema=schema))

        for e in events:
            d = e.to_api_json()
            if "properties" in d:
                d["properties"] = json.dumps(d["properties"])
            chunk.append(d)
            n += 1
            if len(chunk) >= _CHUNK:
                write()
                chunk = []
        if chunk or n == 0:
            write()
    return n


class DataView:
    """A parquet-cached event view of one app and channel
    (DataView.scala:43). `events()` is a pyarrow Table (the DataFrame),
    `event_batch()` the snapshot's `Event`s (LBatchView's role), and
    `aggregate_properties()` PBatchView's role, read live from the
    store's aggregation (one indexed pass, nothing to cache)."""

    def __init__(self, registry, app_name: str,
                 channel: Optional[str] = None,
                 cache_dir: str = ".pio_store/views"):
        self.registry = registry
        self.app_name = app_name
        self.channel = channel
        self.cache_dir = Path(cache_dir)

    def _cache_path(self, start_time, until_time) -> Path:
        key = json.dumps([self.app_name, self.channel,
                          str(start_time), str(until_time)])
        digest = hashlib.sha1(key.encode()).hexdigest()[:16]
        return self.cache_dir / f"view_{digest}.parquet"

    def _materialize(self, path: Path, start_time, until_time) -> None:
        app_id, channel_id = store.app_name_to_id(
            self.registry, self.app_name, self.channel)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        # a temporary file per writer: two materializations never
        # interleave in one file, and the last whole one wins
        tmp = path.with_suffix(f".{os.getpid()}.{time.monotonic_ns()}.tmp")
        write_events_parquet(
            self.registry.get_events().find(
                app_id, channel_id, start_time=start_time,
                until_time=until_time), str(tmp))
        os.replace(tmp, path)

    def events(self, start_time=None, until_time=None, *,
               ttl_seconds: float = 3600.0, refresh: bool = False):
        """The app's events in the window as a pyarrow Table, cached as
        parquet and reused while younger than `ttl_seconds`."""
        import pyarrow.parquet as pq

        path = self._cache_path(start_time, until_time)
        # the file's age on the wall clock against its mtime
        stale = (refresh or not path.exists()
                 or time.time() - path.stat().st_mtime > ttl_seconds)
        if stale:
            self._materialize(path, start_time, until_time)
        return pq.read_table(path)

    def event_batch(self, start_time=None, until_time=None, *,
                    ttl_seconds: float = 3600.0) -> Iterator[Event]:
        """The cached snapshot's `Event`s (LBatchView's role)."""
        table = self.events(start_time, until_time,
                            ttl_seconds=ttl_seconds)
        for row in table.to_pylist():
            payload = {k: v for k, v in row.items() if v is not None}
            if "properties" in payload:
                payload["properties"] = json.loads(payload["properties"])
            yield Event.from_api_json(payload)

    def aggregate_properties(
            self, entity_type: str) -> Dict[str, PropertyMap]:
        """Each entity's latest property map (PBatchView's
        aggregateProperties), from the store."""
        return store.aggregate_properties(
            self.registry, self.app_name, channel_name=self.channel,
            entity_type=entity_type)
