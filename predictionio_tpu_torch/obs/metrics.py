"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

The port of `predictionio_tpu/obs/metrics.py`, line for line: every
server of the port exposes the process-default registry on `GET
/metrics` in the Prometheus text format (version 0.0.4), and `cli
train` reports its phase timings from it. Histograms keep fixed
cumulative buckets plus p50/p90/p99 estimated by in-bucket linear
interpolation, so latency summaries never store raw samples. One lock
per metric family guards its children and their values.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# latency-oriented defaults, seconds (Prometheus client defaults)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Family:
    """One named metric with a fixed label schema; children per labelset."""

    kind = ""

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {sorted(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def remove(self, **labels) -> bool:
        """Drop one labelset's child (a series whose subject is gone,
        such as a retired fleet member); False when there was none."""
        key = tuple(str(labels.get(n, "")) for n in self.labelnames)
        with self._lock:
            return self._children.pop(key, None) is not None

    def _default(self):
        """The label-less child (only valid when the family has no labels)."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self.labels()

    def _items(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_CounterChild):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class Counter(_Family):
    kind = "counter"

    def _make_child(self) -> _CounterChild:
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "bucket_counts", "sum", "count",
                 "exemplars")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]):
        self._lock = lock
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0
        # bucket index -> (exemplar_id, value, unix ts); allocated on
        # the first exemplar so untraced histograms pay nothing
        self.exemplars: Optional[Dict[int, Tuple[str, float, float]]] = None

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        i = bisect_left(self.bounds, value)   # le-inclusive bucket
        with self._lock:
            self.bucket_counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[i] = (exemplar, value, time.time())

    def exemplar_for_quantile(self, q: float
                              ) -> Optional[Tuple[str, float, float]]:
        """The stored exemplar nearest the bucket holding quantile `q`
        (exact bucket first, then higher, then lower) — how the
        dashboard links the p99 bucket of a latency histogram to a real
        kept trace. None when no exemplar has been recorded."""
        with self._lock:
            if not self.exemplars:
                return None
            counts = list(self.bucket_counts)
            total = self.count
            ex = dict(self.exemplars)
        if total <= 0:
            return None
        target = q * total
        cum = 0
        qi = len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c > 0:
                qi = i
                break
        for i in range(qi, len(counts)):
            if i in ex:
                return ex[i]
        for i in range(qi - 1, -1, -1):
            if i in ex:
                return ex[i]
        return None

    class _Timer:
        __slots__ = ("_child", "_t0")

        def __init__(self, child: "_HistogramChild"):
            self._child = child

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._child.observe(time.perf_counter() - self._t0)
            return False

    def time(self) -> "_HistogramChild._Timer":
        """Context manager observing the enclosed wall time in seconds."""
        return _HistogramChild._Timer(self)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1) by in-bucket linear interpolation
        (the histogram_quantile() model). Values beyond the last finite
        bound clamp to it; an empty histogram reports 0.0."""
        with self._lock:
            counts = list(self.bucket_counts)
            total = self.count
        if total == 0 or not self.bounds:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c > 0:
                if i == len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
        return self.bounds[-1]


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = b

    def _make_child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self._default().observe(value, exemplar=exemplar)

    def time(self):
        return self._default().time()

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    def exemplar_for_quantile(self, q: float):
        return self._default().exemplar_for_quantile(q)


class MetricsRegistry:
    """Named metric families; get-or-create accessors are idempotent so
    every layer can declare the instruments it needs without coordination
    (mismatched type or label schema under one name raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, **kwargs)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(
                f"{name} already registered as {fam.kind}, not {cls.kind}")
        if "labelnames" in kwargs and \
                tuple(kwargs["labelnames"]) != fam.labelnames:
            raise ValueError(
                f"{name} already registered with labels {fam.labelnames}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames=labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames=labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help,
                                   labelnames=labels, buckets=buckets)

    def _families_snapshot(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def value(self, name: str, **labels) -> float:
        """Read one counter/gauge series without creating it: returns 0.0
        when the family or labelset does not exist yet (reading a metric
        must never mutate the registry — chaos tests and /ready assert
        on series that only appear after the first failure)."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None or isinstance(fam, Histogram):
            return 0.0
        key = tuple(str(labels.get(n, "")) for n in fam.labelnames)
        with fam._lock:
            child = fam._children.get(key)
            return child._value if child is not None else 0.0

    # -- exposition ---------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self._families_snapshot():
            if fam.help:
                out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam._items():
                if isinstance(child, _HistogramChild):
                    with child._lock:
                        counts = list(child.bucket_counts)
                        total, s = child.count, child.sum
                    cum = 0
                    for bound, c in zip(fam.buckets, counts):
                        cum += c
                        ls = _label_str(fam.labelnames + ("le",),
                                        key + (_fmt(bound),))
                        out.append(f"{fam.name}_bucket{ls} {cum}")
                    ls = _label_str(fam.labelnames + ("le",), key + ("+Inf",))
                    out.append(f"{fam.name}_bucket{ls} {total}")
                    ls = _label_str(fam.labelnames, key)
                    out.append(f"{fam.name}_sum{ls} {_fmt(s)}")
                    out.append(f"{fam.name}_count{ls} {total}")
                else:
                    ls = _label_str(fam.labelnames, key)
                    out.append(f"{fam.name}{ls} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready view for the dashboard: histograms carry count/sum
        and estimated p50/p90/p99; counters and gauges carry the value."""
        snap: Dict[str, dict] = {}
        for fam in self._families_snapshot():
            series = []
            for key, child in fam._items():
                labels = dict(zip(fam.labelnames, key))
                if isinstance(child, _HistogramChild):
                    row = {
                        "labels": labels, "count": child.count,
                        "sum": child.sum,
                        "p50": child.quantile(0.50),
                        "p90": child.quantile(0.90),
                        "p99": child.quantile(0.99)}
                    with child._lock:
                        ex = (dict(child.exemplars)
                              if child.exemplars else None)
                    if ex:
                        bounds = child.bounds
                        row["exemplars"] = [
                            {"le": (_fmt(bounds[i]) if i < len(bounds)
                                    else "+Inf"),
                             "trace_id": t, "value": v, "ts": ts}
                            for i, (t, v, ts) in sorted(ex.items())]
                    series.append(row)
                else:
                    series.append({"labels": labels, "value": child.value})
            snap[fam.name] = {"type": fam.kind, "help": fam.help,
                              "series": series}
        return snap


_default_lock = threading.Lock()
_default_registry: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-default registry. Servers default to it (so one
    process exposes one coherent /metrics), and the train workflow
    records phase timings into it."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
