"""Prediction quality: score sketches, drift, reward and the reload canary.

The port of `predictionio_tpu/obs/quality.py`, JAX-free and numpy-free:

- `QualityStats` rides the serve path (the fast route, the generic route
  and the micro-batcher's splice) and feeds per-app accumulators: bounded
  mergeable quantile sketches (a KLL-style compactor cascade) of the
  top-1 score and the top-k margin, and minute rings of empty-result and
  unknown-entity ratios. At each successful deploy or reload the live
  sketch is frozen into a reference histogram; later traffic is binned
  against it and exported as drift gauges (`pio_pred_drift{app,metric,
  window}`: PSI and Jensen-Shannon against the reference, over 5 min and
  1 h).
- `QualityJoiner` is a background loop (`pio-torch-quality-join`, watchdog
  role `joiner`) that joins feedback events back to served predictions by
  the `prId` the server stamps on each posted `predict` event, within an
  attribution window: `pio_pred_reward_rate{app}`, the join lag and the
  unjoined ratio.
- `CanaryGate` replays a sample of the kept serve traces (`obs/trace.py`'s
  ring) through the old and the new deployment during a reload (on the
  card, each replay is one `predict_batch`, so K1 calls through both
  plans), reports the top-k overlap and the top-1 score delta
  (`pio_canary_overlap{app}`), and with `PIO_CANARY_MIN_OVERLAP` set
  vetoes the swap (`CanaryVeto`) through the reload's load-failed path.

`/quality.json` serves the snapshot. `observe_result` is one list append
under the interpreter lock; the fold into the sketches runs off the
serve path (every 5 s, on a read, or past `_BUF_MAX` observations).

Knobs (the JAX names and defaults): `PIO_QUALITY` (on), `PIO_QUALITY_
SKETCH_K` (128), `PIO_ATTRIBUTION_S` (300), `PIO_CANARY_SAMPLE` (16),
`PIO_CANARY_MIN_OVERLAP` (0, report-only).
"""

from __future__ import annotations

import bisect
import math
import os
import random
import threading
import time
from collections import OrderedDict
from datetime import datetime, timedelta, timezone
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.obs import trace
from predictionio_tpu_torch.obs.logs import get_logger
from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry

_log = get_logger("quality")

# drift reference histograms: deciles of the frozen sketch
_N_BINS = 10
# multi-window drift, shaped like the SLO burn windows (obs/slo.py)
_WINDOWS = (("5m", 5), ("1h", 60))
_N_BUCKETS = 60                 # minute ring depth == longest window
_REF_MIN_N = 50                 # auto-freeze once this many samples land
_BUF_MAX = 16384                # observation-buffer backstop before a
                                # hot-path fold (gauge sync folds every
                                # 5 s long before this at sane qps)
_DEFAULT_SKETCH_K = 128
_DEFAULT_ATTRIBUTION_S = 300.0
_DEFAULT_CANARY_SAMPLE = 16
_MAX_PENDING = 4096             # joiner's in-flight prId cap


# -- env knobs ----------------------------------------------------------------

def quality_enabled() -> bool:
    v = os.environ.get("PIO_QUALITY", "").strip().lower()
    return v not in ("off", "0", "false", "no")


def sketch_k() -> int:
    try:
        return max(8, int(os.environ.get("PIO_QUALITY_SKETCH_K", "")
                          or _DEFAULT_SKETCH_K))
    except ValueError:
        return _DEFAULT_SKETCH_K


def default_attribution_s() -> float:
    try:
        return float(os.environ.get("PIO_ATTRIBUTION_S", "")
                     or _DEFAULT_ATTRIBUTION_S)
    except ValueError:
        return _DEFAULT_ATTRIBUTION_S


def canary_sample() -> int:
    try:
        return int(os.environ.get("PIO_CANARY_SAMPLE", "")
                   or _DEFAULT_CANARY_SAMPLE)
    except ValueError:
        return _DEFAULT_CANARY_SAMPLE


def canary_min_overlap() -> float:
    try:
        return float(os.environ.get("PIO_CANARY_MIN_OVERLAP", "") or 0.0)
    except ValueError:
        return 0.0


# -- mergeable quantile sketch ------------------------------------------------

class QuantileSketch:
    """Bounded mergeable quantile sketch (KLL-style compactor cascade).

    Level `i` holds values of weight `2**i`; when a level fills to `k`
    items it is sorted and every other item (random offset) is promoted
    to the next level. Odd-length buffers keep their maximum behind as
    a leftover so total weight is preserved exactly. Memory is
    O(k log(n/k)) regardless of the stream length, and two sketches
    merge by concatenating levels and re-compacting — merge order only
    changes which random halves survive, not the error bound.
    """

    __slots__ = ("k", "levels", "n", "vmin", "vmax", "_rng")

    def __init__(self, k: Optional[int] = None,
                 rng: Optional[random.Random] = None):
        self.k = max(8, int(k if k is not None else sketch_k()))
        self.levels: List[List[float]] = [[]]
        self.n = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._rng = rng if rng is not None else random.Random()

    def update(self, v: float) -> None:
        v = float(v)
        self.n += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        buf = self.levels[0]
        buf.append(v)
        if len(buf) >= self.k:
            self._compact(0)

    def _compact(self, lvl: int) -> None:
        while lvl < len(self.levels) and len(self.levels[lvl]) >= self.k:
            buf = self.levels[lvl]
            buf.sort()
            leftover = [buf.pop()] if len(buf) % 2 else []
            promoted = buf[self._rng.randrange(2)::2]
            self.levels[lvl] = leftover
            if lvl + 1 == len(self.levels):
                self.levels.append([])
            self.levels[lvl + 1].extend(promoted)
            lvl += 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        self.n += other.n
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        while len(self.levels) < len(other.levels):
            self.levels.append([])
        for i, buf in enumerate(other.levels):
            self.levels[i].extend(buf)
        for i in range(len(self.levels)):
            if len(self.levels[i]) >= self.k:
                self._compact(i)
        return self

    def _weighted(self) -> List[Tuple[float, int]]:
        pairs: List[Tuple[float, int]] = []
        for lvl, buf in enumerate(self.levels):
            w = 1 << lvl
            for v in buf:
                pairs.append((v, w))
        pairs.sort()
        return pairs

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile; None on an empty sketch. Exact at
        the extremes (vmin/vmax are tracked outside the cascade)."""
        pairs = self._weighted()
        if not pairs:
            return None
        if q <= 0.0:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        total = sum(w for _, w in pairs)
        target = q * total
        acc = 0
        for v, w in pairs:
            acc += w
            if acc >= target:
                return min(max(v, self.vmin), self.vmax)
        return self.vmax

    def cdf(self, x: float) -> float:
        """Approximate P(value <= x); 0.0 on an empty sketch."""
        total = 0
        le = 0
        for lvl, buf in enumerate(self.levels):
            w = 1 << lvl
            for v in buf:
                total += w
                if v <= x:
                    le += w
        return le / total if total else 0.0


# -- drift math ---------------------------------------------------------------

def _probs(counts: Sequence[float], eps: float = 1e-4) -> List[float]:
    """Counts/probs -> probability vector with an epsilon floor (both
    PSI and KL blow up on empty bins) re-normalised to sum to 1. An
    all-zero vector degrades to uniform."""
    n = len(counts)
    if n == 0:
        return []
    total = float(sum(counts))
    if total <= 0.0:
        return [1.0 / n] * n
    p = [max(c / total, eps) for c in counts]
    s = sum(p)
    return [x / s for x in p]


def psi(expected: Sequence[float], actual: Sequence[float]) -> float:
    """Population stability index: sum((a - e) * ln(a / e)). >= 0;
    the classic operating bands are ~0.1 (watch) and ~0.25 (act)."""
    p = _probs(expected)
    q = _probs(actual)
    return sum((b - a) * math.log(b / a) for a, b in zip(p, q))


def js_divergence(p_counts: Sequence[float],
                  q_counts: Sequence[float]) -> float:
    """Jensen-Shannon divergence, base 2: symmetric, bounded [0, 1]."""
    p = _probs(p_counts)
    q = _probs(q_counts)
    m = [(a + b) / 2.0 for a, b in zip(p, q)]

    def _kl(a: List[float], b: List[float]) -> float:
        return sum(x * math.log2(x / y) for x, y in zip(a, b) if x > 0)

    return 0.5 * _kl(p, m) + 0.5 * _kl(q, m)


class _DriftState:
    """A reference histogram frozen from a sketch + a minute ring of
    per-bin live counts. Bin edges are the reference deciles; bin `i`
    is `(edge[i-1], edge[i]]`, matching the sketch's cdf convention
    (`bisect_left` => v lands in the first bin whose edge is >= v)."""

    __slots__ = ("edges", "ref_probs", "frozen_at", "ref_n",
                 "_buckets", "_cursor")

    def __init__(self, sketch: QuantileSketch, now_min: int):
        edges: List[float] = []
        for i in range(1, _N_BINS):
            v = sketch.quantile(i / _N_BINS)
            if v is not None and (not edges or v > edges[-1]):
                edges.append(v)
        if not edges:
            # constant reference: one edge, two bins (<= v, > v)
            v = sketch.quantile(0.5)
            edges = [v if v is not None else 0.0]
        self.edges = edges
        probs: List[float] = []
        prev = 0.0
        for e in edges:
            c = sketch.cdf(e)
            probs.append(max(c - prev, 0.0))
            prev = c
        probs.append(max(1.0 - prev, 0.0))
        self.ref_probs = probs
        self.frozen_at = time.time()
        self.ref_n = sketch.n
        nb = len(edges) + 1
        self._buckets = [[0] * nb for _ in range(_N_BUCKETS)]
        self._cursor = now_min

    def _advance(self, now_min: int) -> None:
        gap = now_min - self._cursor
        if gap <= 0:
            return
        if gap >= _N_BUCKETS:
            for b in self._buckets:
                for i in range(len(b)):
                    b[i] = 0
        else:
            for j in range(1, gap + 1):
                b = self._buckets[(self._cursor + j) % _N_BUCKETS]
                for i in range(len(b)):
                    b[i] = 0
        self._cursor = now_min

    def observe(self, v: float, now_min: int) -> None:
        self._advance(now_min)
        idx = bisect.bisect_left(self.edges, v)
        self._buckets[now_min % _N_BUCKETS][idx] += 1

    def window_counts(self, now_min: int, minutes: int) -> List[int]:
        self._advance(now_min)
        nb = len(self.edges) + 1
        counts = [0] * nb
        for j in range(minutes):
            b = self._buckets[(now_min - j) % _N_BUCKETS]
            for i in range(nb):
                counts[i] += b[i]
        return counts

    def drift(self, now_min: int, minutes: int) -> Tuple[float, float]:
        """(PSI, JS) of the live window vs the reference; (0, 0) when
        the window is empty — no traffic is not drift."""
        counts = self.window_counts(now_min, minutes)
        if sum(counts) == 0:
            return (0.0, 0.0)
        return (psi(self.ref_probs, counts),
                js_divergence(self.ref_probs, counts))


# -- per-app accumulator ------------------------------------------------------

class _AppQuality:
    """All quality state for one app label: live sketches, the frozen
    drift references, and minute rings of result-shape counters."""

    __slots__ = ("sk_top1", "sk_margin", "d_top1", "d_margin",
                 "ring_n", "ring_empty", "ring_unknown", "_cursor",
                 "n_total", "empty_total", "unknown_total",
                 "pending_freeze", "_k")

    def __init__(self, k: int, now_min: int):
        self._k = k
        self.sk_top1 = QuantileSketch(k)
        self.sk_margin = QuantileSketch(k)
        self.d_top1: Optional[_DriftState] = None
        self.d_margin: Optional[_DriftState] = None
        self.ring_n = [0] * _N_BUCKETS
        self.ring_empty = [0] * _N_BUCKETS
        self.ring_unknown = [0] * _N_BUCKETS
        self._cursor = now_min
        self.n_total = 0
        self.empty_total = 0
        self.unknown_total = 0
        # first reference freezes itself once enough samples land, so
        # a server that never reloads still gets drift gauges
        self.pending_freeze = True

    def _advance(self, now_min: int) -> None:
        gap = now_min - self._cursor
        if gap <= 0:
            return
        if gap >= _N_BUCKETS:
            for i in range(_N_BUCKETS):
                self.ring_n[i] = 0
                self.ring_empty[i] = 0
                self.ring_unknown[i] = 0
        else:
            for j in range(1, gap + 1):
                i = (self._cursor + j) % _N_BUCKETS
                self.ring_n[i] = 0
                self.ring_empty[i] = 0
                self.ring_unknown[i] = 0
        self._cursor = now_min

    def observe(self, top1: Optional[float], margin: Optional[float],
                empty: bool, unknown: bool, now_min: int) -> None:
        self._advance(now_min)
        i = now_min % _N_BUCKETS
        self.ring_n[i] += 1
        self.n_total += 1
        if empty:
            self.ring_empty[i] += 1
            self.empty_total += 1
        if unknown:
            self.ring_unknown[i] += 1
            self.unknown_total += 1
        if top1 is not None:
            self.sk_top1.update(top1)
            if self.d_top1 is not None:
                self.d_top1.observe(top1, now_min)
        if margin is not None:
            self.sk_margin.update(margin)
            if self.d_margin is not None:
                self.d_margin.observe(margin, now_min)
        if self.pending_freeze and self.sk_top1.n >= _REF_MIN_N:
            self.freeze(now_min)

    def freeze(self, now_min: int) -> None:
        """Snapshot the live sketches into drift references and start a
        fresh live window (called at each successful deploy/reload). An
        empty live sketch keeps the previous reference — no traffic
        since the last freeze is not a new baseline."""
        if self.sk_top1.n > 0:
            self.d_top1 = _DriftState(self.sk_top1, now_min)
            self.sk_top1 = QuantileSketch(self._k)
        if self.sk_margin.n > 0:
            self.d_margin = _DriftState(self.sk_margin, now_min)
            self.sk_margin = QuantileSketch(self._k)
        self.pending_freeze = False

    def ratios(self, now_min: int, minutes: int) -> Tuple[float, float]:
        self._advance(now_min)
        n = e = u = 0
        for j in range(minutes):
            i = (now_min - j) % _N_BUCKETS
            n += self.ring_n[i]
            e += self.ring_empty[i]
            u += self.ring_unknown[i]
        if n == 0:
            return (0.0, 0.0)
        return (e / n, u / n)


# -- the serve-path accumulator front end -------------------------------------

class QualityStats:
    """Per-app quality accumulators + drift gauges, LRU-bounded.

    `observe_result` is the hot-path entry point: it extracts the scores while the result
    object is still cache-warm and appends ONE tuple to the
    observation buffer — `list.append` is atomic under the GIL, so the
    hot path takes NO lock. (A per-request lock convoys badly on a
    saturated small host: a holder preempted inside even a tiny
    critical section stalls every serve thread for a scheduling
    quantum.) The sketch/ring fold runs under the lock but only from
    the read paths — gauge sync (once per 5 s), snapshots, reference
    freezes, and a `_BUF_MAX` backstop — so the cold walk over the
    accumulator structures is amortised over thousands of requests,
    and nothing contends with a long-held lock. Every read path folds
    first, so snapshots and gauge syncs always see every observation.
    Zero dict literals on the hot path."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 max_apps: int = 64, k: Optional[int] = None):
        reg = metrics if metrics is not None else get_registry()
        self._lock = threading.Lock()
        self._apps: "OrderedDict[str, _AppQuality]" = OrderedDict()
        self._max_apps = max_apps
        # single-entry hot cache over _apps: the single-tenant serve
        # path (the common case) hits it every call and never walks
        # the LRU dict; invalidated on eviction
        self._last_app: Optional[str] = None
        self._last_st: Optional[_AppQuality] = None
        self._buf: List[tuple] = []
        self._k = max(8, int(k if k is not None else sketch_k()))
        self._gauge_synced = 0.0
        self._g_drift = reg.gauge(
            "pio_pred_drift",
            "prediction-score drift vs the deploy-time reference "
            "(PSI / Jensen-Shannon), per window",
            labels=("app", "metric", "window"))
        self._g_ratio = reg.gauge(
            "pio_pred_ratio",
            "result-shape ratios (empty results, unknown entities), "
            "per window", labels=("app", "kind", "window"))

    def observe_result(self, app, result, user, user_maps):
        """Stamp one served result into the app's accumulators. Hot
        path: bounded work, no allocation beyond sketch appends."""
        iss = getattr(result, "itemScores", None)
        if iss is None:
            iss = ()
        n = len(iss)
        top1 = iss[0].score if n else None
        margin = iss[0].score - iss[1].score if n >= 2 else None
        unknown = False
        if user is not None and user_maps:
            unknown = True
            for um in user_maps:
                if um.get(user) is not None:
                    unknown = False
                    break
        now = time.time()
        # lock-free: a single GIL-atomic append; the fold happens off
        # the hot path (gauge sync / snapshot / backstop)
        self._buf.append((app, top1, margin, n == 0, unknown,
                          int(now // 60.0)))
        if len(self._buf) >= _BUF_MAX:
            with self._lock:
                self._fold_locked()
        if now - self._gauge_synced >= 5.0:
            self._sync_gauges(now, int(now // 60.0))

    def _fold_locked(self) -> None:
        """Drain the observation buffer into the per-app accumulators
        (caller holds the lock). One cold walk over the sketch/ring
        structures serves the whole batch. The buffer is drained by
        index — slice, then `del buf[:n]` — both atomic under the GIL,
        so concurrent lock-free appends land behind the drained prefix
        and are never lost."""
        buf = self._buf
        n = len(buf)
        if n == 0:
            return
        items = buf[:n]
        del buf[:n]
        for app, top1, margin, empty, unknown, now_min in items:
            if app == self._last_app:
                st = self._last_st
            else:
                # cache switch: the outgoing app was hot until now —
                # refresh its LRU recency before anything can evict it
                if self._last_app is not None:
                    self._apps.move_to_end(self._last_app)
                st = self._apps.get(app)
                if st is None:
                    if len(self._apps) >= self._max_apps:
                        evicted, _ = self._apps.popitem(last=False)
                        if evicted == self._last_app:
                            self._last_app = None
                            self._last_st = None
                    st = _AppQuality(self._k, now_min)
                    self._apps[app] = st    # LRU-evicted above
                else:
                    self._apps.move_to_end(app)
                self._last_app = app
                self._last_st = st
            st.observe(top1, margin, empty, unknown, now_min)

    def _sync_gauges(self, now: float, now_min: int) -> None:
        drift_rows = []
        ratio_rows = []
        with self._lock:
            if now - self._gauge_synced < 5.0:
                return
            self._gauge_synced = now
            self._fold_locked()
            for app, st in self._apps.items():
                for wname, minutes in _WINDOWS:
                    er, ur = st.ratios(now_min, minutes)
                    ratio_rows.append((app, "empty", wname, er))
                    ratio_rows.append((app, "unknown", wname, ur))
                    for mname, d in (("top1", st.d_top1),
                                     ("margin", st.d_margin)):
                        if d is None:
                            continue
                        p, j = d.drift(now_min, minutes)
                        drift_rows.append(
                            (app, mname + "_psi", wname, p))
                        drift_rows.append(
                            (app, mname + "_js", wname, j))
        # gauges set outside the lock (the SLO tracker discipline)
        for app, kind, wname, v in ratio_rows:
            self._g_ratio.labels(app=app, kind=kind, window=wname).set(v)
        for app, metric, wname, v in drift_rows:
            self._g_drift.labels(app=app, metric=metric,
                                 window=wname).set(v)

    def freeze_reference(self) -> None:
        """Refreeze every app's reference window (successful reload)."""
        now_min = int(time.time() // 60.0)
        with self._lock:
            self._fold_locked()
            for st in self._apps.values():
                st.freeze(now_min)

    def trim(self) -> int:
        """Soft-memory-pressure hook: drop every per-app accumulator
        (sketches, drift references, minute rings) and the pending
        observation buffer; they rebuild from live traffic. Returns
        the approximate bytes released."""
        with self._lock:
            freed = len(self._buf) * 96
            # sketches + rings + drift refs per app: coarse estimate
            freed += len(self._apps) * (self._k * 2 * 8 + _N_BUCKETS * 72)
            self._buf = []
            self._apps.clear()
            self._last_app = None
            self._last_st = None
        return freed

    def snapshot(self) -> Dict:
        """The `/quality.json` app section."""
        now = time.time()
        now_min = int(now // 60.0)
        out: Dict[str, Dict] = {}
        with self._lock:
            self._fold_locked()
            for app, st in self._apps.items():
                windows = {}
                for wname, minutes in _WINDOWS:
                    er, ur = st.ratios(now_min, minutes)
                    w = {"empty_ratio": er, "unknown_ratio": ur}
                    for mname, d in (("top1", st.d_top1),
                                     ("margin", st.d_margin)):
                        if d is None:
                            continue
                        p, j = d.drift(now_min, minutes)
                        w[mname + "_psi"] = p
                        w[mname + "_js"] = j
                    windows[wname] = w
                quant = {}
                for label, sk in (("top1", st.sk_top1),
                                  ("margin", st.sk_margin)):
                    if sk.n == 0:
                        continue
                    quant[label] = {
                        "n": sk.n,
                        "p50": sk.quantile(0.5),
                        "p90": sk.quantile(0.9),
                        "p99": sk.quantile(0.99),
                        "min": sk.vmin,
                        "max": sk.vmax,
                    }
                ref = None
                if st.d_top1 is not None:
                    ref = {"frozen_at": st.d_top1.frozen_at,
                           "n": st.d_top1.ref_n}
                out[app] = {
                    "n": st.n_total,
                    "empty_total": st.empty_total,
                    "unknown_total": st.unknown_total,
                    "quantiles": quant,
                    "windows": windows,
                    "reference": ref,
                }
        return out


# -- feedback join ------------------------------------------------------------

class _JoinStats:
    """Per-app minute rings of joined/unjoined outcomes."""

    __slots__ = ("ring_joined", "ring_unjoined", "_cursor",
                 "joined_total", "unjoined_total", "last_lag_s")

    def __init__(self, now_min: int):
        self.ring_joined = [0] * _N_BUCKETS
        self.ring_unjoined = [0] * _N_BUCKETS
        self._cursor = now_min
        self.joined_total = 0
        self.unjoined_total = 0
        self.last_lag_s: Optional[float] = None

    def _advance(self, now_min: int) -> None:
        gap = now_min - self._cursor
        if gap <= 0:
            return
        if gap >= _N_BUCKETS:
            for i in range(_N_BUCKETS):
                self.ring_joined[i] = 0
                self.ring_unjoined[i] = 0
        else:
            for j in range(1, gap + 1):
                i = (self._cursor + j) % _N_BUCKETS
                self.ring_joined[i] = 0
                self.ring_unjoined[i] = 0
        self._cursor = now_min

    def note(self, joined: bool, now_min: int) -> None:
        self._advance(now_min)
        i = now_min % _N_BUCKETS
        if joined:
            self.ring_joined[i] += 1
            self.joined_total += 1
        else:
            self.ring_unjoined[i] += 1
            self.unjoined_total += 1

    def rates(self, now_min: int) -> Tuple[float, float]:
        """(reward_rate, unjoined_ratio) over the full ring (1h)."""
        self._advance(now_min)
        j = sum(self.ring_joined)
        u = sum(self.ring_unjoined)
        if j + u == 0:
            return (0.0, 0.0)
        return (j / (j + u), u / (j + u))


class QualityJoiner:
    """Joins feedback events back to served predictions by `prId`.

    Rides the same locate/watermark machinery as the streaming
    refresher: each tick snapshots the ingest watermark, scans events
    appended since the last tick, notes `predict` events (entity
    `pio_pr`) as pending, and joins any other event carrying a `prId`
    property within the attribution window. Pending entries that age
    past the window (or are evicted by the bounded-map cap) count as
    unjoined — an unjoined prediction is the signal, not an error.
    """

    def __init__(self, server, attribution_s: Optional[float] = None,
                 interval_s: float = 1.0,
                 metrics: Optional[MetricsRegistry] = None):
        self.server = server
        self.attribution_s = float(
            attribution_s if attribution_s is not None and
            attribution_s > 0 else default_attribution_s())
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # prId -> (predict event epoch s, app label)
        self._pending: "OrderedDict[str, Tuple[float, str]]" = \
            OrderedDict()
        self._stats_by_app: "OrderedDict[str, _JoinStats]" = \
            OrderedDict()
        self._max_apps = 64
        self._since: Optional[datetime] = None
        self._wm = None
        self._lock = threading.Lock()
        self.last_outcome = ""          # test/introspection surface
        self.beat = None                # watchdog liveness stamp
        reg = metrics if metrics is not None else get_registry()
        self._c_join = reg.counter(
            "pio_feedback_join_total",
            "feedback-join outcomes (joined/expired/evicted)",
            labels=("app", "outcome"))
        self._h_lag = reg.histogram(
            "pio_feedback_join_lag_seconds",
            "feedback event time minus predict event time at join")
        self._g_reward = reg.gauge(
            "pio_pred_reward_rate",
            "joined / (joined + unjoined) predictions over the last "
            "hour", labels=("app",))
        self._g_unjoined = reg.gauge(
            "pio_pred_unjoined_ratio",
            "predictions that aged out of the attribution window "
            "unjoined, over the last hour", labels=("app",))

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self.beat is None:
            from predictionio_tpu_torch.resilience.watchdog import watchdog
            self.beat = watchdog().register(
                "joiner", budget_s=self.interval_s * 3.0 + 5.0,
                restart=self._spawn)
        self._spawn()

    def _spawn(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-quality-join", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()
        t = self._thread
        if t is not None:
            t.join(min(10.0, self.interval_s + 5.0))

    def _loop(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._loop_body)
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        beat = self.beat
        while not self._stop.is_set():
            if beat is not None:
                beat.tick()
            try:
                self.tick()
            except Exception:
                self.last_outcome = "failed"
                _log.exception("quality_join_tick_failed")
            if self._stop.wait(self.interval_s):
                return

    # -- one tick ---------------------------------------------------------
    def tick(self) -> str:
        """One join pass; safe to call directly from tests."""
        outcome = self._tick_inner()
        self.last_outcome = outcome
        return outcome

    def _tick_inner(self) -> str:
        from predictionio_tpu_torch.streaming.refresher import (
            locate_event_store)
        server = self.server
        dep = getattr(server, "deployment", None)
        if dep is None:
            return "no_deployment"
        located = locate_event_store(dep, server.ctx.registry)
        if located is None:
            return "no_app"
        events, app_id, channel_id, ds_params = located
        app = ds_params.get("app_name") or ""
        now = time.time()
        if self._since is None:
            # baseline: predictions served before the joiner started
            # are not joinable — start the scan at the first tick
            self._since = datetime.now(timezone.utc)
            return "baseline"
        wm = events.ingest_watermark(app_id, channel_id)
        if wm is not None and wm == self._wm:
            self._expire(now)
            self._sync_gauges(now)
            return "noop"
        self._wm = wm
        newest = self._since
        scanned = 0
        with self._lock:
            for ev in events.find(app_id, channel_id,
                                  start_time=self._since):
                scanned += 1
                et = ev.event_time
                if et > newest:
                    newest = et
                if ev.event == "predict" and \
                        ev.entity_type == "pio_pr":
                    self._note_predict(ev.entity_id, et.timestamp(),
                                       app)
                    continue
                # `get_opt`: most events carry no prId (the JAX joiner's
                # mandatory `get` raises on the first such event)
                pr = ev.properties.get_opt("prId") \
                    if ev.properties is not None else None
                if pr:
                    self._note_join(str(pr), et.timestamp(), now)
        if scanned:
            self._since = newest + timedelta(microseconds=1)
        self._expire(now)
        self._sync_gauges(now)
        return "scanned" if scanned else "noop"

    def _note_predict(self, pr_id: str, ev_epoch: float,
                      app: str) -> None:
        if len(self._pending) >= _MAX_PENDING:
            _, (_, old_app) = self._pending.popitem(last=False)
            self._outcome(old_app, False, "evicted")
        self._pending[pr_id] = (ev_epoch, app)

    def _note_join(self, pr_id: str, ev_epoch: float,
                   now: float) -> None:
        entry = self._pending.pop(pr_id, None)
        if entry is None:
            return                      # duplicate or pre-baseline
        pred_epoch, app = entry
        lag = max(0.0, ev_epoch - pred_epoch)
        if lag > self.attribution_s:
            self._outcome(app, False, "expired")
            return
        self._h_lag.observe(lag)
        self._outcome(app, True, "joined")

    def _expire(self, now: float) -> None:
        with self._lock:
            while self._pending:
                pr_id, (pred_epoch, app) = \
                    next(iter(self._pending.items()))
                if now - pred_epoch <= self.attribution_s:
                    break
                del self._pending[pr_id]
                self._outcome(app, False, "expired")

    def _outcome(self, app: str, joined: bool, label: str) -> None:
        now_min = int(time.time() // 60.0)
        st = self._stats_by_app.get(app)
        if st is None:
            if len(self._stats_by_app) >= self._max_apps:
                self._stats_by_app.popitem(last=False)
            st = _JoinStats(now_min)
            self._stats_by_app[app] = st    # LRU-evicted above
        else:
            self._stats_by_app.move_to_end(app)
        st.note(joined, now_min)
        self._c_join.labels(app=app, outcome=label).inc()

    def _sync_gauges(self, now: float) -> None:
        now_min = int(now // 60.0)
        rows = []
        with self._lock:
            for app, st in self._stats_by_app.items():
                rows.append((app,) + st.rates(now_min))
        for app, reward, unjoined in rows:
            self._g_reward.labels(app=app).set(reward)
            self._g_unjoined.labels(app=app).set(unjoined)

    def snapshot(self) -> Dict:
        now_min = int(time.time() // 60.0)
        apps = {}
        with self._lock:
            pending = len(self._pending)
            for app, st in self._stats_by_app.items():
                reward, unjoined = st.rates(now_min)
                apps[app] = {        # bounded by the map
                    "reward_rate": reward,
                    "unjoined_ratio": unjoined,
                    "joined_total": st.joined_total,
                    "unjoined_total": st.unjoined_total,
                }
        return {
            "attribution_s": self.attribution_s,
            "pending": pending,
            "last_outcome": self.last_outcome,
            "apps": apps,
        }


# -- canary comparison --------------------------------------------------------

class CanaryVeto(RuntimeError):
    """Raised by `CanaryGate.check` when the replayed overlap falls
    below `PIO_CANARY_MIN_OVERLAP`; the server's reload path treats it
    exactly like a load failure (previous deployment keeps serving)."""


class CanaryGate:
    """Replays recently-kept traced queries against old + new plans.

    Per-query overlap is |old ∩ new| / max(|old|, |new|) over the
    returned item ids (two empty results agree perfectly); the score
    delta is |old top-1 - new top-1| where both sides returned items.
    With `min_overlap` at 0 the gate is report-only.
    """

    def __init__(self, sample: int = -1, min_overlap: float = -1.0,
                 metrics: Optional[MetricsRegistry] = None):
        self.sample = sample if sample >= 0 else canary_sample()
        self.min_overlap = (min_overlap if min_overlap >= 0
                            else canary_min_overlap())
        reg = metrics if metrics is not None else get_registry()
        self._g_overlap = reg.gauge(
            "pio_canary_overlap",
            "top-k overlap between the old and the candidate plans "
            "on replayed traced queries, last roll", labels=("app",))
        self._g_delta = reg.gauge(
            "pio_canary_score_delta",
            "mean |top-1 score delta| old vs candidate on replayed "
            "traced queries, last roll", labels=("app",))
        self._c_total = reg.counter(
            "pio_canary_total", "canary checks by outcome",
            labels=("outcome",))
        self.last: Optional[Dict] = None

    def check(self, prev_dep, new_dep,
              replay: Callable[[object, List[Dict]], List]) -> \
            Optional[Dict]:
        """Compare `prev_dep` vs `new_dep` on sampled traced queries.

        `replay(dep, query_dicts)` is supplied by the server (it owns
        query parsing and the predict path) and returns one predicted
        result per query dict. Returns the report (also kept on
        `.last`), or None when there is nothing to compare. Raises
        `CanaryVeto` on breach.
        """
        if self.sample <= 0 or prev_dep is None or new_dep is None:
            self._c_total.labels(outcome="skipped").inc()
            return None
        entries = [e for e in trace.get_recorder().snapshot()
                   if e.get("kind") == "serve"
                   and isinstance(e.get("query"), dict)]
        entries = entries[:self.sample]
        if not entries:
            self._c_total.labels(outcome="skipped").inc()
            return None
        qdicts = [e["query"] for e in entries]
        apps = [e.get("app") or "" for e in entries]
        try:
            old_res = replay(prev_dep, qdicts)
            new_res = replay(new_dep, qdicts)
        except Exception:
            # the candidate failing to serve at all IS a load failure;
            # let the reload error path handle it
            raise
        overlaps: List[float] = []
        deltas: List[float] = []
        per_app: Dict[str, List[float]] = {}
        for app, old, new in zip(apps, old_res, new_res):
            old_ids = [s.item for s in
                       (getattr(old, "itemScores", None) or ())]
            new_ids = [s.item for s in
                       (getattr(new, "itemScores", None) or ())]
            if not old_ids and not new_ids:
                ov = 1.0
            else:
                inter = len(set(old_ids) & set(new_ids))
                ov = inter / max(len(old_ids), len(new_ids))
            overlaps.append(ov)
            per_app.setdefault(app, []).append(ov)  # at most `sample`
            if old_ids and new_ids:
                deltas.append(abs(old.itemScores[0].score
                                  - new.itemScores[0].score))
        overlap = sum(overlaps) / len(overlaps)
        delta = sum(deltas) / len(deltas) if deltas else 0.0
        report = {
            "sampled": len(overlaps),
            "overlap": overlap,
            "score_delta": delta,
            "min_overlap": self.min_overlap,
            "per_app": {a: sum(v) / len(v)
                        for a, v in per_app.items()},
            "ts": time.time(),
        }
        self.last = report
        self._g_overlap.labels(app="").set(overlap)
        self._g_delta.labels(app="").set(delta)
        for a, v in report["per_app"].items():
            if a:
                self._g_overlap.labels(app=a).set(v)
        if self.min_overlap > 0 and overlap < self.min_overlap:
            report["outcome"] = "fail"
            self._c_total.labels(outcome="fail").inc()
            raise CanaryVeto(
                "canary overlap %.3f below PIO_CANARY_MIN_OVERLAP "
                "%.3f on %d replayed queries"
                % (overlap, self.min_overlap, len(overlaps)))
        report["outcome"] = "pass"
        self._c_total.labels(outcome="pass").inc()
        return report
