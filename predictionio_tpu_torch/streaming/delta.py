"""Change summary between two ingest-watermark snapshots.

The port of `predictionio_tpu/streaming/delta.py`.

One generic, bytes-bounded delta scan answers three questions for the
refresher: which entities were touched, how many qualifying events
landed, and how old the newest one is (the freshness numerator). The
per-template `fold_in` hooks then re-scan with their OWN value
semantics through `FoldContext.delta_columns` — the storage layer
guarantees both scans decode the same journal frames.

Everything that makes incremental decode unsafe — a tombstone or
external-id overwrite between the snapshots, a rewritten/shrunk
segment, a span larger than `PIO_DELTA_MAX_BYTES`, or a driver with no
delta path at all — surfaces as `DeltaInvalidated`, and the caller
falls back to the full-scan path (which remains ground truth).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

from predictionio_tpu_torch.data.storage.base import DeltaInvalidated

# distinct touched entities per tick past which the closed-form fold-in
# stops being cheaper than a full rebuild (env: PIO_FOLD_MAX_TOUCHED)
_DEFAULT_MAX_TOUCHED = 512


def max_touched() -> int:
    try:
        return int(os.environ.get("PIO_FOLD_MAX_TOUCHED", "")
                   or _DEFAULT_MAX_TOUCHED)
    except ValueError:
        return _DEFAULT_MAX_TOUCHED


@dataclass
class Delta:
    """What changed between `since` and `upto` (both full
    `ingest_watermark` snapshots, `upto` taken BEFORE the scan so a
    concurrent appender can never slip events past the bookkeeping)."""
    since: Dict[str, int]
    upto: Dict[str, int]
    touched_users: Tuple[str, ...]     # distinct entity ids, scan order
    touched_items: Tuple[str, ...]     # distinct target ids, scan order
    n_events: int
    newest_us: int                     # max event time, epoch µs (0 = none)

    @property
    def empty(self) -> bool:
        return self.n_events == 0


def scan_delta(store, app_id: int, channel_id, since: Dict[str, int],
               upto: Dict[str, int]) -> Delta:
    """Generic change-detection scan: user-entity interaction events
    appended in (since, upto]. Raises `DeltaInvalidated` per the
    storage contract, and additionally when the touched-entity count
    exceeds `PIO_FOLD_MAX_TOUCHED` (a full rebuild is cheaper then)."""
    cols = store.scan_columns(
        app_id, channel_id, since=since, upto=upto,
        entity_type="user", value_spec={"*": 1.0}, require_target=True)
    if cols.n == 0:
        return Delta(since, upto, (), (), 0, 0)
    cap = max_touched()
    users = tuple(cols.entities)
    items = tuple(cols.targets)
    if len(users) > cap or len(items) > cap:
        raise DeltaInvalidated(
            f"{len(users)} users / {len(items)} items touched exceeds "
            f"PIO_FOLD_MAX_TOUCHED={cap}; full rebuild is cheaper")
    return Delta(since, upto, users, items, cols.n, int(cols.t_us.max()))
