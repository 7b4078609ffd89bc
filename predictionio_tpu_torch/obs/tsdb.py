"""In-process time-series history: a bounded delta-encoded ring per
metric series.

The port of `predictionio_tpu/obs/tsdb.py`. `/metrics` answers "what is
the value now"; this module answers "what did it look like ten minutes
ago" without an external Prometheus. A `Scraper` thread
(`pio-torch-tsdb-scraper`) runs its collectors and snapshots its
registry every `PIO_TSDB_INTERVAL_S` seconds (default 5; `0` disables
the loop) into a `TSDB`: each scalar series keeps `DEFAULT_POINTS`
points (720, about 1 h at 5 s) as (delta-ms-from-base, value) pairs,
two small numbers per point instead of a float64 wall-clock timestamp
each.

Semantics per family type:

  - gauges    → raw value per tick;
  - counters  → per-second *rate* between consecutive scrapes (the
    raw monotone total is useless to plot; key suffix ``:rate``);
  - histograms→ ``:p50`` / ``:p99`` quantiles plus an observation
    ``:rate``.

Export: ``GET /tsdb.json?series=<prefix,prefix>&since=<unix-ts>`` on
every `utils.http.HTTPServerBase` returns absolute-timestamped points,
decoded from the deltas at read time, in the JAX package's shape.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.obs.logs import get_logger
from predictionio_tpu_torch.obs.metrics import MetricsRegistry

_log = get_logger("tsdb")

DEFAULT_INTERVAL_S = 5.0
DEFAULT_POINTS = 720
DEFAULT_MAX_SERIES = 1024


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def series_key(name: str, labels: Dict[str, str], suffix: str = "") -> str:
    """Canonical series id: ``name{k=v,...}[:suffix]`` with sorted
    label keys, matching Prometheus selector syntax closely enough to
    paste into a real query."""
    if labels:
        inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        base = f"{name}{{{inner}}}"
    else:
        base = name
    return f"{base}:{suffix}" if suffix else base


class _Series:
    """One bounded ring of (delta_ms, value) points."""

    __slots__ = ("kind", "base_ts", "points")

    def __init__(self, kind: str, points: int):
        self.kind = kind
        self.base_ts = 0.0
        self.points: deque = deque(maxlen=points)

    def append(self, ts: float, value: float) -> None:
        if not self.points:
            self.base_ts = ts
        self.points.append((int((ts - self.base_ts) * 1000.0), value))

    def decoded(self, since: float = 0.0) -> List[Tuple[float, float]]:
        base = self.base_ts
        return [(base + dt / 1000.0, v) for dt, v in self.points
                if base + dt / 1000.0 >= since]


class TSDB:
    """Bounded in-memory store keyed by `series_key`; thread-safe."""

    def __init__(self, points: Optional[int] = None,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.points = max(2, int(DEFAULT_POINTS if points is None
                                 else points))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        # last raw counter totals, for rate derivation across scrapes
        self._last_raw: Dict[str, Tuple[float, float]] = {}
        self.dropped_series = 0
        self.scrapes = 0

    # -- recording -----------------------------------------------------------
    def record_value(self, key: str, kind: str, ts: float,
                     value: float) -> None:
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = self._series[key] = _Series(kind, self.points)
            s.append(ts, value)

    def _rate(self, key: str, ts: float, raw: float) -> Optional[float]:
        """Per-second rate vs the previous raw total; None on the
        first sighting (no interval to divide over) and on counter
        resets (process restart feeding a shared ring)."""
        prev = self._last_raw.get(key)
        self._last_raw[key] = (ts, raw)
        if prev is None:
            return None
        pts, praw = prev
        dt = ts - pts
        if dt <= 0 or raw < praw:
            return None
        return (raw - praw) / dt

    def record_snapshot(self, snap: Dict[str, Dict],
                        now: Optional[float] = None) -> None:
        """Fold one `MetricsRegistry.snapshot()` into the rings."""
        ts = time.time() if now is None else now
        with self._lock:
            self.scrapes += 1
        for name, fam in snap.items():
            ftype = fam.get("type")
            for series in fam.get("series", ()):
                labels = series.get("labels") or {}
                if ftype == "counter":
                    rate = self._rate(series_key(name, labels), ts,
                                      float(series.get("value", 0.0)))
                    if rate is not None:
                        self.record_value(
                            series_key(name, labels, "rate"),
                            "rate", ts, rate)
                elif ftype == "gauge":
                    self.record_value(series_key(name, labels), "gauge",
                                      ts, float(series.get("value", 0.0)))
                elif ftype == "histogram":
                    for q in ("p50", "p99"):
                        if series.get(q) is not None:
                            self.record_value(
                                series_key(name, labels, q), "quantile",
                                ts, float(series[q]))
                    rate = self._rate(
                        series_key(name, labels, "count"), ts,
                        float(series.get("count", 0.0)))
                    if rate is not None:
                        self.record_value(
                            series_key(name, labels, "rate"),
                            "rate", ts, rate)

    # -- export --------------------------------------------------------------
    def to_json(self, series: Optional[str] = None,
                since: Optional[str] = None) -> Dict:
        """Body of /tsdb.json. `series` is a comma-separated list of
        key prefixes (empty = all); `since` a unix timestamp — only
        points at or after it are returned."""
        prefixes = tuple(p for p in (series or "").split(",") if p)
        try:
            since_ts = float(since) if since else 0.0
        except ValueError:
            since_ts = 0.0
        with self._lock:
            keys = list(self._series.items())
            scrapes, dropped = self.scrapes, self.dropped_series
        out: Dict[str, Dict] = {}
        for key, s in keys:
            if prefixes and not any(key.startswith(p) for p in prefixes):
                continue
            pts = s.decoded(since_ts)
            if not pts:
                continue
            out[key] = {
                "kind": s.kind,
                "points": [[round(t, 3), round(v, 6)] for t, v in pts],
            }
        return {"now": time.time(), "scrapes": scrapes,
                "max_points": self.points, "dropped_series": dropped,
                "series": out}

    def latest(self, key: str) -> Optional[float]:
        """Most recent value of one series, None when absent."""
        with self._lock:
            s = self._series.get(key)
            if s is None or not s.points:
                return None
            return s.points[-1][1]

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def forget(self, match: Callable[[str], bool]) -> int:
        """Drop every series whose key `match`es (the history of a
        subject that is gone); returns how many."""
        with self._lock:
            keys = [k for k in self._series if match(k)]
            for k in keys:
                del self._series[k]
            for k in [k for k in self._last_raw if match(k)]:
                del self._last_raw[k]
        return len(keys)

    def trim(self, keep_frac: float = 0.5) -> int:
        """Soft-memory-pressure hook: drop the oldest points of every
        ring down to `keep_frac` of their current length (recent
        history is what operators debug with). Returns the approximate
        bytes released."""
        dropped = 0
        with self._lock:
            for s in self._series.values():
                keep = max(2, int(len(s.points) * keep_frac))
                while len(s.points) > keep:
                    s.points.popleft()
                    dropped += 1
        return dropped * 64      # (delta_ms int, float) tuple estimate


class Scraper:
    """Named background thread driving collectors + a registry scrape
    into a TSDB every `interval_s` seconds (default PIO_TSDB_INTERVAL_S,
    else DEFAULT_INTERVAL_S). `interval_s=0` means start() is a no-op:
    the ring and the endpoint stay, the loop never exists."""

    def __init__(self, tsdb: TSDB, registry: MetricsRegistry,
                 interval_s: Optional[float] = None,
                 collectors: Iterable[Callable[[], None]] = ()):
        self.tsdb = tsdb
        self.registry = registry
        self.interval_s = (_envf("PIO_TSDB_INTERVAL_S", DEFAULT_INTERVAL_S)
                           if interval_s is None else interval_s)
        self.collectors: List[Callable[[], None]] = list(collectors)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beat = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def tick(self, now: Optional[float] = None) -> None:
        """One scrape cycle: collectors first (they freshen gauges the
        snapshot then captures), then the registry fold. Public so
        tests and the fleet router can force a tick."""
        for fn in self.collectors:
            try:
                fn()
            except Exception as e:    # a broken collector must not
                _log.warning("tsdb_collector_failed",   # stop the scrape
                             collector=getattr(fn, "__name__", "?"),
                             error=f"{type(e).__name__}: {e}")
        self.tsdb.record_snapshot(self.registry.snapshot(), now)

    def _run(self) -> None:
        self._beat.guard(self._run_loop)

    def _run_loop(self) -> None:
        beat = self._beat
        while not self._stop.wait(self.interval_s):
            beat.tick()
            try:
                self.tick()
            except Exception as e:
                _log.warning("tsdb_tick_failed",
                             error=f"{type(e).__name__}: {e}")

    def _spawn(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="pio-torch-tsdb-scraper", daemon=True)
        self._thread.start()

    def start(self) -> bool:
        if self.interval_s <= 0 or self.running:
            return False
        self._stop.clear()
        if self._beat is None:
            from predictionio_tpu_torch.resilience.watchdog import watchdog
            self._beat = watchdog().register(
                "scraper", budget_s=self.interval_s * 3.0 + 5.0,
                restart=self._spawn)
        self._spawn()
        return True

    def stop(self) -> None:
        self._stop.set()
        beat, self._beat = self._beat, None
        if beat is not None:
            beat.close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
