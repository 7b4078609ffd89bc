"""Event-server statistics: per-app counts in hourly buckets.

The port of `predictionio_tpu/data/stats.py`. Parity: reference
`data/.../api/Stats.scala:30-82` + `StatsActor.scala` —
counts keyed by (event, entityType, status) per app, bucketed by the hour;
`get_stats` returns the previous-hour and current-hour snapshots.
Thread-safe via a lock (the reference serializes through an actor).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from datetime import datetime
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event, utcnow

# (appId, hourBucket, event, entityType, status) -> count
_Key = Tuple[int, int, str, str, int]

# get_stats only ever reads the current and previous hour; anything
# older than this is dead weight that previously accumulated forever
# on a long-lived event server
PRUNE_AFTER_SECONDS = 2 * 3600


def hour_bucket(t: datetime) -> int:
    return int(t.replace(minute=0, second=0, microsecond=0).timestamp())


class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[_Key, int] = defaultdict(int)
        self.start_time = utcnow()
        self._latest_bucket = 0

    def bookkeeping(self, app_id: int, status_code: int, event: Event,
                    now: Optional[datetime] = None) -> None:
        b = hour_bucket(now or utcnow())
        with self._lock:
            self._counts[(app_id, b, event.event, event.entity_type,
                          status_code)] += 1
            # amortized prune: only scan when the clock crosses into a
            # new hour, dropping buckets no snapshot can reach anymore
            if b > self._latest_bucket:
                self._latest_bucket = b
                cutoff = b - PRUNE_AFTER_SECONDS
                for k in [k for k in self._counts if k[1] <= cutoff]:
                    del self._counts[k]

    def _snapshot(self, app_id: int, bucket: int) -> List[dict]:
        return [
            {"event": k[2], "entityType": k[3], "status": k[4], "count": v}
            for k, v in sorted(self._counts.items())
            if k[0] == app_id and k[1] == bucket
        ]

    def get_stats(self, app_id: int, now: Optional[datetime] = None) -> dict:
        now = now or utcnow()
        cur = hour_bucket(now)
        prev = cur - 3600
        with self._lock:
            return {
                "startTime": self.start_time.isoformat(),
                "currentHour": self._snapshot(app_id, cur),
                "previousHour": self._snapshot(app_id, prev),
            }
