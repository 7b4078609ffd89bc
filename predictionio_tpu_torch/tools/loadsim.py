"""Trace-driven traffic harness: Zipf-skewed users, phase-composed
arrival processes, open-loop delivery (`cli loadsim`).

The port of `predictionio_tpu/tools/loadsim.py`. Traffic is a list of
declarative phases per app, each a closed-form rate curve (steady, a
diurnal sinusoid, a flash crowd's step, a hot-key pivot of the key
distribution), composed into one non-homogeneous Poisson process sampled
exactly by thinning.

  - Open loop: every arrival fires on schedule on a thread of its own
    (`pio-torch-loadsim-fire`), however slowly the answers come back, so
    a slow server cannot throttle its own load (coordinated omission).
  - Determinism: `build_schedule(scenario)` is a pure function of the
    scenario and its seed (every instant, user rank, item set and query
    shape decided before the first byte is sent), and it draws the same
    numpy stream as the JAX package's, arrival for arrival.

Query shapes follow the wire mix: fast-path JSON `{"user", "num"}`,
generic JSON with white and black lists, the binary frame
(`application/x-pio-bin`, `utils.wire.encode_bin_query`) and banned-item
heavy queries; users are `u<rank>`, items `i<rank>`. Results are
bench-format JSON lines (`LoadResult.emit`); `--samples FILE` also
writes each arrival's scheduled second, status, latency and the second
it was sent (all from the run's start, at unix second `started`), and
the count of late arrivals. The latency counts from the send, as the
JAX package's does: where arrivals go out late, the client set the
pace, and the scheduled-to-answer time is the sent second less the
scheduled one plus the latency. Scenario files are JSON; the built-ins
`diurnal`, `flash-crowd` and `hot-key` document the format.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.utils.wire import (BIN_CONTENT_TYPE,
                                               encode_bin_query)

# -- phases: closed-form time-varying arrival rates -------------------------

_KINDS = ("steady", "diurnal", "flash", "hotkey")


@dataclass(frozen=True)
class Phase:
    """One segment of an app's offered-rate curve.

    kind='steady'   constant `rps`.
    kind='diurnal'  sinusoid around `rps`: starts at the trough,
                    swings +/- `amplitude` * rps over `period_s`.
    kind='flash'    baseline `rps` with a step to `peak_rps` ramping up
                    over `ramp_s` starting at `at_s`, holding `hold_s`,
                    ramping back down over `ramp_s`.
    kind='hotkey'   constant `rps`, but a `hot_frac` slice of arrivals
                    pivots onto one hot user (rank `hot_user`) — the
                    rate curve is flat; the key distribution is not.
    """
    kind: str
    duration_s: float
    rps: float
    amplitude: float = 0.5       # diurnal swing as a fraction of rps
    period_s: float = 0.0        # diurnal period; 0 means duration_s
    peak_rps: float = 0.0        # flash plateau rate
    at_s: float = 0.0            # flash step start (phase-local)
    ramp_s: float = 1.0          # flash ramp up/down width
    hold_s: float = 0.0          # flash plateau width
    hot_frac: float = 0.0        # hotkey pivot probability
    hot_user: int = 0            # hotkey target rank

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown phase kind {self.kind!r}")
        if self.duration_s <= 0 or self.rps < 0:
            raise ValueError("phase needs duration_s > 0 and rps >= 0")

    def rate_at(self, t: float) -> float:
        """Arrival rate lambda(t) at phase-local time t (seconds)."""
        if self.kind == "diurnal":
            period = self.period_s or self.duration_s
            swing = math.sin(2.0 * math.pi * t / period - math.pi / 2.0)
            return self.rps * (1.0 + self.amplitude * swing)
        if self.kind == "flash":
            ramp = max(self.ramp_s, 1e-9)
            up0, up1 = self.at_s, self.at_s + ramp
            dn0 = up1 + self.hold_s
            dn1 = dn0 + ramp
            if t < up0 or t >= dn1:
                return self.rps
            if t < up1:
                frac = (t - up0) / ramp
            elif t < dn0:
                frac = 1.0
            else:
                frac = 1.0 - (t - dn0) / ramp
            return self.rps + frac * (self.peak_rps - self.rps)
        return self.rps                       # steady / hotkey

    def peak_rate(self) -> float:
        """Upper bound on lambda(t) over the phase (thinning majorant)."""
        if self.kind == "diurnal":
            return self.rps * (1.0 + abs(self.amplitude))
        if self.kind == "flash":
            return max(self.rps, self.peak_rps)
        return self.rps


# -- scenario spec ----------------------------------------------------------

_DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("fast", 0.70), ("generic", 0.15), ("bin", 0.10), ("banned", 0.05))

SHAPES = tuple(name for name, _ in _DEFAULT_MIX)


@dataclass(frozen=True)
class AppSpec:
    """One app's population, skew, query mix and rate curve."""
    key: str                               # access key sent as ?accessKey=
    name: str = "app"
    phases: Tuple[Phase, ...] = ()
    n_users: int = 1_000_000
    n_items: int = 10_000
    zipf_s: float = 1.1
    num: int = 5                           # top-k asked per query
    banned_max: int = 8                    # blackList length ceiling
    mix: Tuple[Tuple[str, float], ...] = _DEFAULT_MIX

    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)


@dataclass(frozen=True)
class Scenario:
    name: str
    apps: Tuple[AppSpec, ...]
    seed: int = 0

    def duration_s(self) -> float:
        return max((a.duration_s() for a in self.apps), default=0.0)


def scenario_from_dict(doc: Dict) -> Scenario:
    """Parse the JSON scenario format (see module docstring)."""
    apps = []
    for adoc in doc.get("apps", ()):
        phases = tuple(Phase(**p) for p in adoc.get("phases", ()))
        mix = tuple((str(k), float(v))
                    for k, v in adoc.get("mix", dict(_DEFAULT_MIX)).items())
        for shape, _ in mix:
            if shape not in SHAPES:
                raise ValueError(f"unknown query shape {shape!r}")
        apps.append(AppSpec(
            key=str(adoc["key"]), name=str(adoc.get("name", "app")),
            phases=phases,
            n_users=int(adoc.get("n_users", 1_000_000)),
            n_items=int(adoc.get("n_items", 10_000)),
            zipf_s=float(adoc.get("zipf_s", 1.1)),
            num=int(adoc.get("num", 5)),
            banned_max=int(adoc.get("banned_max", 8)),
            mix=mix))
    return Scenario(name=str(doc.get("name", "scenario")),
                    apps=tuple(apps), seed=int(doc.get("seed", 0)))


def load_scenario(path: str) -> Scenario:
    with open(path, "r", encoding="utf-8") as f:
        return scenario_from_dict(json.load(f))


def scale_durations(sc: Scenario, factor: float) -> Scenario:
    """Shrink/stretch every phase duration (rates untouched) — how the
    bench fits a long trace into its budget without changing what the
    trace *is*."""
    apps = tuple(
        replace(a, phases=tuple(
            replace(p, duration_s=p.duration_s * factor,
                    period_s=p.period_s * factor,
                    at_s=p.at_s * factor,
                    ramp_s=max(p.ramp_s * factor, 1e-3),
                    hold_s=p.hold_s * factor)
            for p in a.phases))
        for a in sc.apps)
    return replace(sc, apps=apps)


# Built-in scenarios double as format documentation: `cli loadsim --
# --scenario diurnal` works without a file (the JAX package's chaos
# scenarios replay shortened versions of the same traces).
BUILTIN: Dict[str, Dict] = {
    "diurnal": {
        "name": "diurnal", "seed": 7,
        "apps": [{
            "key": "CHAOSKEY", "name": "diurnalapp",
            "n_users": 1_000_000, "n_items": 10_000, "zipf_s": 1.1,
            "phases": [
                {"kind": "diurnal", "duration_s": 60.0, "rps": 120.0,
                 "amplitude": 0.8, "period_s": 60.0},
            ],
        }],
    },
    "flash-crowd": {
        "name": "flash-crowd", "seed": 11,
        "apps": [{
            "key": "CHAOSKEY", "name": "flashapp",
            "n_users": 1_000_000, "n_items": 10_000, "zipf_s": 1.1,
            "phases": [
                {"kind": "flash", "duration_s": 45.0, "rps": 40.0,
                 "peak_rps": 400.0, "at_s": 10.0, "ramp_s": 2.0,
                 "hold_s": 15.0},
            ],
        }],
    },
    "hot-key": {
        "name": "hot-key", "seed": 13,
        "apps": [{
            "key": "CHAOSKEY", "name": "hotapp",
            "n_users": 1_000_000, "n_items": 10_000, "zipf_s": 1.1,
            "phases": [
                {"kind": "steady", "duration_s": 10.0, "rps": 100.0},
                {"kind": "hotkey", "duration_s": 20.0, "rps": 100.0,
                 "hot_frac": 0.7, "hot_user": 3},
                {"kind": "steady", "duration_s": 10.0, "rps": 100.0},
            ],
        }],
    },
}


# -- Zipf population sampler ------------------------------------------------

_HEAD_CAP = 1 << 21


class ZipfRanks:
    """Inverse-CDF Zipf(s) sampler over ranks [0, n).  The head (up to
    2^21 ranks) carries an exact normalised pmf table; for populations
    beyond that the tail mass is integral-approximated and tail draws
    land uniformly — with s > 1 the head holds almost all the mass, so
    'millions of users' costs megabytes, not gigabytes."""

    def __init__(self, n: int, s: float):
        if n < 1:
            raise ValueError("population must be >= 1")
        self.n, self.s = int(n), float(s)
        head = min(self.n, _HEAD_CAP)
        w = 1.0 / np.arange(1, head + 1, dtype=np.float64) ** s
        if self.n > head:
            if abs(s - 1.0) < 1e-9:
                tail = math.log(self.n / head)
            else:
                tail = (self.n ** (1.0 - s) - head ** (1.0 - s)) / (1.0 - s)
            tail = max(tail, 0.0)
        else:
            tail = 0.0
        total = float(w.sum()) + tail
        self._head = head
        self._cdf = np.cumsum(w) / total      # head CDF; tail = remainder

    def sample(self, rng: np.random.RandomState, size: int) -> np.ndarray:
        """Draw `size` ranks; deterministic given the rng state."""
        u = rng.random_sample(size)
        ix = np.searchsorted(self._cdf, u, side="right")
        if self._head < self.n:
            in_tail = ix >= self._head
            k = int(in_tail.sum())
            if k:
                ix[in_tail] = rng.randint(self._head, self.n, size=k)
        else:
            np.clip(ix, 0, self.n - 1, out=ix)
        return ix.astype(np.int64)


# -- schedule ---------------------------------------------------------------

@dataclass(frozen=True)
class Event:
    """One scheduled arrival, fully decided offline."""
    t: float                 # seconds from trace start
    app: int                 # index into Scenario.apps
    shape: str               # fast | generic | bin | banned
    user: int                # user rank
    banned: Tuple[int, ...] = ()   # item ranks for blackList shapes

    def encode(self, spec: AppSpec) -> Tuple[bytes, str]:
        """Wire body + content type — pure function of the event."""
        uid = f"u{self.user}"
        if self.shape == "bin":
            return encode_bin_query(uid, spec.num), BIN_CONTENT_TYPE
        if self.shape == "fast":
            doc: Dict = {"user": uid, "num": spec.num}
        elif self.shape == "generic":
            doc = {"user": uid, "num": spec.num, "whiteList": None,
                   "blackList": [f"i{b}" for b in self.banned]}
        else:                                    # banned-item heavy
            doc = {"user": uid, "num": spec.num,
                   "blackList": [f"i{b}" for b in self.banned]}
        return json.dumps(doc).encode("utf-8"), "application/json"


def _nhpp_times(rng: np.random.RandomState, ph: Phase) -> np.ndarray:
    """Exact non-homogeneous Poisson arrivals over one phase, by
    thinning: candidates at the majorant rate, kept with probability
    lambda(t)/lambda_max."""
    lam = ph.peak_rate()
    if lam <= 0:
        return np.empty(0, dtype=np.float64)
    chunks: List[np.ndarray] = []
    t = 0.0
    while t < ph.duration_s:
        gaps = rng.exponential(1.0 / lam, size=4096)
        cand = t + np.cumsum(gaps)
        chunks.append(cand)
        t = float(cand[-1])
    cand = np.concatenate(chunks)
    cand = cand[cand < ph.duration_s]
    rates = np.fromiter((ph.rate_at(float(x)) for x in cand),
                        dtype=np.float64, count=cand.size)
    keep = rng.random_sample(cand.size) * lam <= rates
    return cand[keep]


def build_schedule(sc: Scenario) -> List[Event]:
    """Materialise every arrival of the trace, sorted by time.  Pure in
    (scenario, seed): byte-identical across builds."""
    rng = np.random.RandomState(sc.seed)
    events: List[Event] = []
    for ai, app in enumerate(sc.apps):
        users = ZipfRanks(app.n_users, app.zipf_s)
        items = ZipfRanks(app.n_items, app.zipf_s)
        mix_names = [m for m, _ in app.mix]
        mix_w = np.asarray([w for _, w in app.mix], dtype=np.float64)
        mix_cdf = np.cumsum(mix_w) / mix_w.sum()
        t0 = 0.0
        for ph in app.phases:
            ts = _nhpp_times(rng, ph)
            n = ts.size
            if n == 0:
                t0 += ph.duration_s
                continue
            shapes_ix = np.searchsorted(mix_cdf, rng.random_sample(n),
                                        side="right")
            np.clip(shapes_ix, 0, len(mix_names) - 1, out=shapes_ix)
            ranks = users.sample(rng, n)
            if ph.kind == "hotkey" and ph.hot_frac > 0:
                pivot = rng.random_sample(n) < ph.hot_frac
                ranks[pivot] = ph.hot_user
            n_banned = rng.randint(1, max(app.banned_max, 1) + 1, size=n)
            for j in range(n):
                shape = mix_names[int(shapes_ix[j])]
                banned: Tuple[int, ...] = ()
                if shape in ("generic", "banned"):
                    banned = tuple(
                        int(b) for b in items.sample(rng, int(n_banned[j])))
                events.append(Event(
                    t=t0 + float(ts[j]), app=ai, shape=shape,
                    user=int(ranks[j]), banned=banned))
            t0 += ph.duration_s
    events.sort(key=lambda e: (e.t, e.app, e.user))
    return events


def expected_arrivals(sc: Scenario) -> float:
    """Analytic expectation of the schedule length: the integral of
    lambda(t) over every app's phases (trapezoid at 1 ms steps for the
    curved kinds) — what tests compare the sampled count against."""
    total = 0.0
    for app in sc.apps:
        for ph in app.phases:
            if ph.kind in ("steady", "hotkey"):
                total += ph.rps * ph.duration_s
            else:
                xs = np.linspace(0.0, ph.duration_s,
                                 max(int(ph.duration_s * 1000), 2))
                ys = [ph.rate_at(float(x)) for x in xs]
                trapezoid = getattr(np, "trapezoid", None) or np.trapz
                total += float(trapezoid(ys, xs))
    return total


# -- open-loop runner -------------------------------------------------------

class LoadResult:
    """Samples collected by one run: status counts and latency
    percentiles per app and overall, with p99.9."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.samples: List[Tuple[int, int, float]] = []  # (app, status, s)
        # (scheduled second, status, s, sent second) per arrival, for a
        # split in time
        self.timeline: List[Tuple[float, int, float, float]] = []
        self.late = 0            # arrivals fired behind schedule > 50 ms

    def add(self, app: int, status: int, dt: float,
            t: Optional[float] = None, sent: float = 0.0) -> None:
        with self._lock:
            self.samples.append((app, status, dt))
            if t is not None:
                self.timeline.append((t, status, dt, sent))

    def by_status(self, app: Optional[int] = None) -> Dict[int, int]:
        with self._lock:
            out: Dict[int, int] = {}
            for a, s, _ in self.samples:
                if app is None or a == app:
                    out[s] = out.get(s, 0) + 1
            return out

    def percentiles(self, app: Optional[int] = None,
                    qs: Sequence[float] = (50.0, 99.0, 99.9),
                    ) -> Dict[float, float]:
        with self._lock:
            lats = [dt for a, s, dt in self.samples
                    if s == 200 and (app is None or a == app)]
        if not lats:
            return {q: float("inf") for q in qs}
        arr = np.asarray(lats)
        return {q: float(np.percentile(arr, q)) for q in qs}

    def emit(self, prefix: str, duration_s: float,
             out=None) -> List[Dict]:
        """Print bench-format JSON lines; returns the records."""
        recs: List[Dict] = []
        by = self.by_status()
        total = sum(by.values())
        pct = self.percentiles()
        recs.append({"metric": f"{prefix}_requests", "value": total,
                     "unit": "count", "vs_baseline": 1.0})
        recs.append({"metric": f"{prefix}_achieved_rps",
                     "value": round(total / max(duration_s, 1e-9), 4),
                     "unit": "req/s", "vs_baseline": 1.0})
        recs.append({"metric": f"{prefix}_ok",
                     "value": by.get(200, 0), "unit": "count",
                     "vs_baseline": 1.0})
        recs.append({"metric": f"{prefix}_shed",
                     "value": by.get(429, 0), "unit": "count",
                     "vs_baseline": 1.0})
        errs = sum(v for s, v in by.items() if s not in (200, 429))
        recs.append({"metric": f"{prefix}_errors", "value": errs,
                     "unit": "count", "vs_baseline": 1.0})
        for q, label in ((50.0, "p50"), (99.0, "p99"), (99.9, "p999")):
            v = pct[q] * 1e3
            recs.append({"metric": f"{prefix}_{label}_ms",
                         "value": round(v, 4) if math.isfinite(v) else -1.0,
                         "unit": "ms", "vs_baseline": 1.0})
        for rec in recs:
            print(json.dumps(rec), flush=True, file=out or sys.stdout)
        return recs


def _post(port: int, key: str, body: bytes, ctype: str,
          timeout: float) -> int:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json?accessKey={key}",
        data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
            return resp.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code
    except OSError:
        return -1


class LoadRunner:
    """Fires a built schedule open-loop at one or more ports (failover
    down the list).  Every arrival gets
    its own daemon thread: a slow response never delays the next
    arrival (coordinated-omission safety)."""

    def __init__(self, sc: Scenario, ports: Sequence[int],
                 timeout_s: float = 10.0):
        self.sc = sc
        self.ports = list(ports)
        self.timeout_s = timeout_s
        self.result = LoadResult()
        self.started = time.time()       # unix second of the run's start
        self._t_start = time.perf_counter()

    def _fire(self, ev: Event) -> None:
        spec = self.sc.apps[ev.app]
        body, ctype = ev.encode(spec)
        t0 = time.perf_counter()
        status = -1
        for port in self.ports:
            status = _post(port, spec.key, body, ctype, self.timeout_s)
            if status != -1:
                break
        self.result.add(ev.app, status, time.perf_counter() - t0, t=ev.t,
                        sent=t0 - self._t_start)

    def run(self, schedule: Optional[List[Event]] = None,
            stop: Optional[threading.Event] = None) -> LoadResult:
        """Blocks for the trace duration, then joins stragglers."""
        events = build_schedule(self.sc) if schedule is None else schedule
        threads: List[threading.Thread] = []
        self.started = time.time()
        self._t_start = t_start = time.perf_counter()
        for ev in events:
            if stop is not None and stop.is_set():
                break
            lag = ev.t - (time.perf_counter() - t_start)
            if lag > 0:
                time.sleep(lag)
            elif lag < -0.05:
                self.result.late += 1
            th = threading.Thread(target=self._fire, args=(ev,),
                                  daemon=True,
                                  name="pio-torch-loadsim-fire")
            th.start()
            threads.append(th)
        for th in threads:
            th.join(self.timeout_s + 5.0)
        return self.result


# -- CLI --------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.cli loadsim",
        description="Trace-driven open-loop traffic harness")
    ap.add_argument("--scenario", required=True,
                    help="built-in name (%s) or a JSON scenario file"
                         % ", ".join(sorted(BUILTIN)))
    ap.add_argument("--port", type=int, action="append", required=True,
                    help="target port; repeat for failover routers")
    ap.add_argument("--key", default="",
                    help="override every app's access key")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario seed")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every phase duration (0.1 = 10x "
                         "shorter trace at the same rates)")
    ap.add_argument("--dry-run", action="store_true",
                    help="build the schedule, print its summary, send "
                         "nothing")
    ap.add_argument("--samples", default="",
                    help="write {started, late, timeline: [[scheduled s, "
                         "status, latency s, sent s], ...]} as JSON to "
                         "this file")
    args = ap.parse_args(argv)

    if args.scenario in BUILTIN:
        sc = scenario_from_dict(BUILTIN[args.scenario])
    else:
        sc = load_scenario(args.scenario)
    if args.seed is not None:
        sc = replace(sc, seed=args.seed)
    if args.key:
        sc = replace(sc, apps=tuple(replace(a, key=args.key)
                                    for a in sc.apps))
    if args.scale != 1.0:
        sc = scale_durations(sc, args.scale)

    schedule = build_schedule(sc)
    if args.dry_run:
        print(json.dumps({
            "metric": f"loadsim_{sc.name}_schedule", "value": len(schedule),
            "unit": "count", "vs_baseline": round(
                len(schedule) / max(expected_arrivals(sc), 1e-9), 2)}))
        return 0
    runner = LoadRunner(sc, args.port)
    runner.run(schedule)
    runner.result.emit(f"loadsim_{sc.name}", sc.duration_s())
    if args.samples:
        with runner.result._lock:
            doc = {"started": runner.started, "late": runner.result.late,
                   "timeline": sorted(runner.result.timeline)}
        with open(args.samples, "w", encoding="utf-8") as f:
            json.dump(doc, f)
    errs = sum(v for s, v in runner.result.by_status().items()
               if s not in (200, 429))
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
