"""Per-app SLO tracking: multi-window error-budget burn rates.

The port of `predictionio_tpu/obs/slo.py`. Each app gets a latency and
availability objective: a request is good when it succeeded (status
below 500) and finished within the app's latency bound. Defaults come
from `PIO_SLO_LATENCY_MS` (250) and `PIO_SLO_TARGET` (0.999); per-app
overrides from the `SLOObjectives` DAO (`dao_overrides_loader`), read
again after the loader's TTL.

The tracker keeps 60 one-minute (good, bad) buckets per app, the app
map LRU-bounded, and derives burn rates over a fast (5 m) and a slow
(1 h) window:

    burn = bad_fraction(window) / (1 - target)

Burn 1.0 spends the error budget exactly at the objective's horizon; a
fast-window burn past 14.4 (2% of a 30-day budget in one hour) counts
as degraded. Gauges: `pio_slo_burn_rate{app,window}`. The server's
`/ready` shows `snapshot()` as detail without failing readiness.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from predictionio_tpu_torch.obs.logs import get_logger
from predictionio_tpu_torch.obs.metrics import MetricsRegistry, get_registry

_log = get_logger("slo")

# fast-window burn rate above which an app's SLO counts as degraded
FAST_BURN_ALERT = 14.4

_WINDOWS = (("5m", 5), ("1h", 60))       # (label, minutes)
_N_BUCKETS = 60


class _AppSLO:
    """One app's minute-bucket rings + resolved objective."""

    __slots__ = ("good", "bad", "minute", "latency_s", "target")

    def __init__(self, latency_s: float, target: float):
        self.good = [0] * _N_BUCKETS
        self.bad = [0] * _N_BUCKETS
        self.minute = 0                   # absolute minute of the cursor
        self.latency_s = latency_s
        self.target = target

    def _advance(self, now_min: int) -> None:
        gap = now_min - self.minute
        if gap <= 0:
            return
        if gap >= _N_BUCKETS:
            self.good = [0] * _N_BUCKETS
            self.bad = [0] * _N_BUCKETS
        else:
            for i in range(self.minute + 1, now_min + 1):
                self.good[i % _N_BUCKETS] = 0
                self.bad[i % _N_BUCKETS] = 0
        self.minute = now_min

    def record(self, now_min: int, ok: bool) -> None:
        self._advance(now_min)
        idx = now_min % _N_BUCKETS
        if ok:
            self.good[idx] += 1
        else:
            self.bad[idx] += 1

    def burn(self, now_min: int, minutes: int) -> float:
        """bad_fraction over the last `minutes` buckets, scaled by the
        error budget (1 - target). 0.0 when the window is empty."""
        self._advance(now_min)
        g = b = 0
        for i in range(minutes):
            idx = (now_min - i) % _N_BUCKETS
            g += self.good[idx]
            b += self.bad[idx]
        total = g + b
        if total <= 0:
            return 0.0
        budget = max(1.0 - self.target, 1e-9)
        return (b / total) / budget


class SLOTracker:
    """Process-wide per-app SLO state; thread-safe; bounded app map."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 latency_ms: Optional[float] = None,
                 target: Optional[float] = None,
                 loader: Optional[Callable[
                     [], Dict[str, Tuple[Optional[float],
                                         Optional[float]]]]] = None,
                 loader_ttl_s: float = 10.0,
                 max_apps: int = 256):
        env = os.environ

        def _envf(name: str, default: float) -> float:
            try:
                return float(env.get(name, "") or default)
            except ValueError:
                return default

        self.latency_s = (latency_ms if latency_ms is not None
                          else _envf("PIO_SLO_LATENCY_MS", 250.0)) / 1000.0
        self.target = (target if target is not None
                       else _envf("PIO_SLO_TARGET", 0.999))
        self.target = min(max(self.target, 0.0), 0.999999)
        self._loader = loader
        self._loader_ttl_s = loader_ttl_s
        self._overrides: Dict[str, Tuple[Optional[float],
                                         Optional[float]]] = {}
        self._overrides_loaded = 0.0
        metrics = metrics if metrics is not None else get_registry()
        self._burn_gauge = metrics.gauge(
            "pio_slo_burn_rate",
            "Error-budget burn rate per app and window (1.0 = budget "
            "spent exactly at the objective horizon)",
            labels=("app", "window"))
        self._lock = threading.Lock()
        self._apps: "OrderedDict[str, _AppSLO]" = OrderedDict()
        self._max_apps = max(1, int(max_apps))
        self._gauge_synced = 0.0

    # -- objective resolution ------------------------------------------------
    def _refresh_overrides_locked(self, now: float) -> None:
        if self._loader is None:
            return
        if now - self._overrides_loaded < self._loader_ttl_s:
            return
        self._overrides_loaded = now
        try:
            loaded = self._loader()
        except Exception as e:
            _log.warning("slo_overrides_read_failed",
                         error=f"{type(e).__name__}: {e}")
            return
        if loaded is not None:
            self._overrides = dict(loaded)
            for label, (lat_ms, target) in self._overrides.items():
                st = self._apps.get(label)
                if st is not None:
                    st.latency_s = (lat_ms / 1000.0 if lat_ms is not None
                                    else self.latency_s)
                    st.target = (min(max(target, 0.0), 0.999999)
                                 if target is not None else self.target)

    def _app_locked(self, label: str) -> _AppSLO:
        st = self._apps.get(label)
        if st is not None:
            self._apps.move_to_end(label)
            return st
        lat_s, target = self.latency_s, self.target
        ov = self._overrides.get(label)
        if ov is not None:
            if ov[0] is not None:
                lat_s = ov[0] / 1000.0
            if ov[1] is not None:
                target = min(max(ov[1], 0.0), 0.999999)
        st = _AppSLO(lat_s, target)
        self._apps[label] = st
        while len(self._apps) > self._max_apps:
            self._apps.popitem(last=False)
        return st

    # -- recording -----------------------------------------------------------
    def record(self, app: str, duration_s: float, ok: bool,
               now: Optional[float] = None) -> None:
        """Count one request against `app`'s objective. `ok` is the
        availability verdict (False for 5xx/errors); the latency
        threshold is applied here on top."""
        now = time.time() if now is None else now
        now_min = int(now // 60)
        with self._lock:
            self._refresh_overrides_locked(now)
            st = self._app_locked(app or "")
            good = ok and duration_s <= st.latency_s
            st.record(now_min, good)
            sync = now - self._gauge_synced >= 5.0
            if sync:
                self._gauge_synced = now
                rows = [(label, s) for label, s in self._apps.items()]
            else:
                rows = []
        for label, s in rows:
            for wlabel, minutes in _WINDOWS:
                self._burn_gauge.labels(app=label, window=wlabel).set(
                    s.burn(now_min, minutes))

    # -- export --------------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """Per-app objective + burn rates, for `/ready` detail and the
        dashboard."""
        now = time.time() if now is None else now
        now_min = int(now // 60)
        out: Dict[str, Dict] = {}
        with self._lock:
            items = list(self._apps.items())
        for label, st in items:
            b5 = st.burn(now_min, 5)
            b60 = st.burn(now_min, 60)
            out[label or "(default)"] = {
                "latency_ms": round(st.latency_s * 1000.0, 3),
                "target": st.target,
                "burn_5m": round(b5, 3),
                "burn_1h": round(b60, 3),
                "degraded": b5 > FAST_BURN_ALERT,
            }
        return out

    def degraded(self, now: Optional[float] = None) -> bool:
        """True when any app's fast-window burn is past the page
        threshold — surfaced in `/ready` detail, not in readiness."""
        snap = self.snapshot(now=now)
        return any(v["degraded"] for v in snap.values())


def dao_overrides_loader(registry) -> Optional[Callable[
        [], Dict[str, Tuple[Optional[float], Optional[float]]]]]:
    """Build an overrides loader reading the `SLOObjectives` DAO,
    mapping appid rows to app labels via the `Apps` DAO. None when the
    store exposes no SLO DAO (env defaults apply)."""
    if registry is None:
        return None
    try:
        dao = registry.get_meta_data_slo_objectives()
        apps = registry.get_meta_data_apps()
    except Exception as e:
        _log.warning("slo_dao_unavailable",
                     error=f"{type(e).__name__}: {e}",
                     fallback="env defaults")
        return None

    def _load() -> Dict[str, Tuple[Optional[float], Optional[float]]]:
        rows = dao.get_all()
        if not rows:
            return {}
        names = {a.id: a.name for a in apps.get_all()}
        out: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
        for row in rows:
            label = names.get(row.appid) or f"app-{row.appid}"
            out[label] = (row.latency_ms, row.target)
        return out

    return _load
