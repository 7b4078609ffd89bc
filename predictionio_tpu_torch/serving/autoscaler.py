"""Autoscaler: a control loop over the fleet router's own tsdb ring.

The port of `predictionio_tpu/serving/autoscaler.py`. The router's tsdb
tick scrapes its members (`serving/fleet.py`: per-member qps, p99, burn
and reactor balance, beside the router's own shed and queue-delay
series) and then calls `Autoscaler.tick`, which reads that ring, decides
up, down or hold, and grows or retires `Supervisor` children
(`serving/supervisor.py`, each a `cli deploy --join` process). No
pipeline outside the router: it scales on the numbers `/fleet.html`
charts.

The discipline (each knob a `PIO_AUTOSCALE*` variable, the JAX names and
defaults):

  - hysteresis: a breach (member p99, batch queue delay, SLO burn or
    shed rate over its threshold) must last `breach_ticks` consecutive
    ticks before a grow, idleness `idle_ticks` before a retire;
  - cooldown: no action for `cooldown_s` after one (a grown child must
    join, warm and show in the signals first);
  - bounds: [min_children, max_children];
  - flap damping: at most `max_flips` actions inside `flap_window_s`.

A retirement is a drain: the router marks the victim `retiring` (out of
rotation, its beats still welcome) and drains it, then
`Supervisor.retire` stops the process without crash-loop accounting,
then the router forgets it; no step feeds the suspicion or eject
counters. It runs on a `pio-torch-supervisor-retire` thread.

`decide` is the pure core (samples and a clock in, a direction out);
`tick` acts on it. Only the lease holder acts: a standby's tick
resets its counters and holds.

Gauges: `pio_autoscale_children` (the target) and
`pio_autoscale_decisions_total{direction}`.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional

from predictionio_tpu_torch.obs import MetricsRegistry, get_logger

_log = get_logger("serving.autoscaler")


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _envi(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds and damping of the loop (PIO_AUTOSCALE*)."""
    enabled: bool = False
    min_children: int = 1
    max_children: int = 4
    p99_up_ms: float = 250.0      # member p99 breach
    delay_up_ms: float = 100.0    # batch queue-delay p99 breach
    burn_up: float = 1.0          # SLO burn-rate breach (1.0 = on budget)
    shed_up_rps: float = 0.5      # sheds/s that count as pressure
    idle_qps_per_child: float = 5.0   # down when the others could take
                                      # the whole load
    breach_ticks: int = 3
    idle_ticks: int = 8
    cooldown_s: float = 10.0
    flap_window_s: float = 120.0
    max_flips: int = 3

    @staticmethod
    def from_env() -> "AutoscaleConfig":
        return AutoscaleConfig(
            enabled=os.environ.get("PIO_AUTOSCALE", "") in
            ("1", "true", "on"),
            min_children=_envi("PIO_AUTOSCALE_MIN", 1),
            max_children=_envi("PIO_AUTOSCALE_MAX", 4),
            p99_up_ms=_envf("PIO_AUTOSCALE_P99_MS", 250.0),
            delay_up_ms=_envf("PIO_AUTOSCALE_DELAY_MS", 100.0),
            burn_up=_envf("PIO_AUTOSCALE_BURN", 1.0),
            shed_up_rps=_envf("PIO_AUTOSCALE_SHED_RPS", 0.5),
            idle_qps_per_child=_envf("PIO_AUTOSCALE_IDLE_QPS", 5.0),
            breach_ticks=_envi("PIO_AUTOSCALE_BREACH_TICKS", 3),
            idle_ticks=_envi("PIO_AUTOSCALE_IDLE_TICKS", 8),
            cooldown_s=_envf("PIO_AUTOSCALE_COOLDOWN_S", 10.0),
            flap_window_s=_envf("PIO_AUTOSCALE_FLAP_WINDOW_S", 120.0),
            max_flips=_envi("PIO_AUTOSCALE_MAX_FLIPS", 3))


@dataclass(frozen=True)
class Signals:
    """One tick's view of the ring."""
    qps: float = 0.0          # sum of pio_fleet_member_qps
    p99_s: float = 0.0        # max member p99
    burn: float = 0.0         # max member SLO burn rate
    delay_s: float = 0.0      # max batch queue-delay p99
    shed_rps: float = 0.0     # sum of the pio_shed_total rates
    balance: float = 0.0      # worst reactor balance (informational)


def ring_signals(tsdb) -> Signals:
    """The router's ring (`TSDB.keys()` / `latest()`) as one Signals
    sample: the series `/fleet.html` charts."""
    qps = shed = 0.0
    p99 = burn = delay = balance = 0.0
    for key in tsdb.keys():
        v = tsdb.latest(key)
        if v is None:
            continue
        if key.startswith("pio_fleet_member_qps{"):
            qps += v
        elif key.startswith("pio_fleet_member_p99_seconds{"):
            p99 = max(p99, v)
        elif key.startswith("pio_fleet_member_burn{"):
            burn = max(burn, v)
        elif key.startswith("pio_fleet_member_reactor_balance{"):
            balance = max(balance, v)
        elif key.startswith("pio_shed_total{") and key.endswith(":rate"):
            shed += v
        elif (key.startswith("pio_queue_delay_seconds")
              and key.endswith(":p99")):
            delay = max(delay, v)
    return Signals(qps=qps, p99_s=p99, burn=burn, delay_s=delay,
                   shed_rps=shed, balance=balance)


class Autoscaler:
    """The decision state machine and the loop that acts on it.

    `decide(sig, children, now)` takes one sample and a clock, updates
    the hysteresis and flap state and returns "up", "down" or "hold".
    `tick()` is what the router's scrape calls: the ring's signals, a
    decision, a grow or a retire through the supervisor.
    `signals_fn` replaces the ring (a scripted level in tests)."""

    def __init__(self, config: AutoscaleConfig,
                 supervisor=None,
                 fleet=None,
                 spec_factory: Optional[Callable[[str], object]] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 signals_fn: Optional[Callable[[], Signals]] = None):
        self.config = config
        self.supervisor = supervisor
        self.fleet = fleet
        self.spec_factory = spec_factory
        self._signals_fn = signals_fn
        self._lock = threading.Lock()
        self._breach = 0
        self._idle = 0
        self._last_action_t = float("-inf")
        self._actions: Deque[float] = deque()
        self._grown: List[str] = []      # LIFO of the children it spawned
        self._seq = 0
        self._retiring: List[str] = []   # names being drained
        base = 0
        if supervisor is not None:
            base = len(supervisor.children())
        self._target = max(config.min_children,
                           min(base or config.min_children,
                               config.max_children))
        m = metrics
        if m is None and fleet is not None:
            m = fleet.metrics
        self._g_children = self._c_decisions = None
        if m is not None:
            self._g_children = m.gauge(
                "pio_autoscale_children",
                "Autoscaler child-count target")
            self._c_decisions = m.counter(
                "pio_autoscale_decisions_total",
                "Autoscaler scale actions", labels=("direction",))
            self._g_children.set(float(self._target))

    # -- the pure decision core ---------------------------------------------
    @property
    def target(self) -> int:
        return self._target

    def decide(self, sig: Signals, children: int, now: float) -> str:
        """One sample in, "up" | "down" | "hold" out; an action stamps
        the cooldown and the flap window (deterministic in the samples
        and the clock)."""
        cfg = self.config
        breach = (sig.p99_s * 1e3 > cfg.p99_up_ms
                  or sig.delay_s * 1e3 > cfg.delay_up_ms
                  or sig.burn > cfg.burn_up
                  or sig.shed_rps > cfg.shed_up_rps)
        survivors = max(children - 1, 0)
        idle = (not breach
                and sig.qps < cfg.idle_qps_per_child * survivors)
        with self._lock:
            self._breach = self._breach + 1 if breach else 0
            self._idle = self._idle + 1 if idle else 0
            if now - self._last_action_t < cfg.cooldown_s:
                return "hold"
            while self._actions and \
                    now - self._actions[0] > cfg.flap_window_s:
                self._actions.popleft()
            if len(self._actions) >= cfg.max_flips:
                return "hold"                      # damped
            if self._breach >= cfg.breach_ticks and \
                    children < cfg.max_children:
                self._breach = self._idle = 0
                self._last_action_t = now
                self._actions.append(now)
                return "up"
            if self._idle >= cfg.idle_ticks and \
                    children > cfg.min_children:
                self._breach = self._idle = 0
                self._last_action_t = now
                self._actions.append(now)
                return "down"
        return "hold"

    # -- acting on a decision ----------------------------------------------
    def signals(self) -> Signals:
        if self._signals_fn is not None:
            return self._signals_fn()
        if self.fleet is not None:
            return ring_signals(self.fleet.tsdb)
        return Signals()

    def tick(self, now: Optional[float] = None) -> str:
        """One control cycle (the router's scrape calls it). A standby
        router observes and never acts, and resets its counters, so that
        a new leader starts with clean hysteresis."""
        if not self.config.enabled:
            return "hold"
        if self.fleet is not None and not self.fleet._is_leader:
            with self._lock:
                self._breach = self._idle = 0
            return "hold"
        t = time.monotonic() if now is None else now
        sig = self.signals()
        direction = self.decide(sig, self._target, t)
        if direction == "up":
            self._grow()
        elif direction == "down":
            self._shrink()
        if self._g_children is not None:
            self._g_children.set(float(self._target))
        return direction

    def _grow(self) -> None:
        if self.supervisor is None or self.spec_factory is None:
            return
        self._seq += 1
        name = f"scale{self._seq}"
        spec = self.spec_factory(name)
        try:
            self.supervisor.grow(spec)
        except Exception as e:  # noqa: BLE001 — the next breach retries
            _log.warning("autoscale_grow_failed", child=name,
                         error=f"{type(e).__name__}: {e}")
            return
        self._grown.append(name)
        self._target += 1
        if self._c_decisions is not None:
            self._c_decisions.labels(direction="up").inc()
        _log.info("autoscale_up", child=name, target=self._target)

    def _victim(self) -> Optional[str]:
        """Its own children first (LIFO), else the highest-named alive
        child: repeated scale-downs walk the fleet in one order."""
        if self._grown:
            return self._grown.pop()
        if self.supervisor is None:
            return None
        alive = sorted(c["name"] for c in self.supervisor.children()
                       if c["alive"] and c["name"] not in self._retiring)
        return alive[-1] if alive else None

    def _shrink(self) -> None:
        if self.supervisor is None:
            return
        name = self._victim()
        if name is None:
            return
        self._target -= 1
        self._retiring.append(name)
        if self._c_decisions is not None:
            self._c_decisions.labels(direction="down").inc()
        _log.info("autoscale_down", child=name, target=self._target)
        threading.Thread(target=self._retire, args=(name,),
                         name="pio-torch-supervisor-retire",
                         daemon=True).start()

    def _retire(self, name: str) -> None:
        """Out of rotation and drained on the router, then the process
        stops, then the router forgets the member."""
        try:
            rep_key = None
            if self.fleet is not None:
                rep = self.fleet.member_by_name(name)
                if rep is not None:
                    rep_key = rep.key
                    self.fleet.retire_member(rep)
            self.supervisor.retire(name)
            if self.fleet is not None and rep_key:
                self.fleet.forget_member(rep_key)
        except Exception as e:  # noqa: BLE001 — logged; the slot is gone
            _log.warning("autoscale_retire_failed", child=name,
                         error=f"{type(e).__name__}: {e}")
        finally:
            with self._lock:
                if name in self._retiring:
                    self._retiring.remove(name)

    def drain_idle(self, timeout_s: float = 15.0) -> bool:
        """Wait for the retirements in flight to end."""
        waiter = threading.Event()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._retiring:
                    return True
            waiter.wait(0.05)
        return False
