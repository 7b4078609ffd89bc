"""Thread-liveness watchdog: beats, stall detection, loop restart.

The port of `predictionio_tpu/resilience/watchdog.py`. Every long-lived
loop thread registers a named `Beat` and stamps it; the `pio-torch-
watchdog` thread sweeps the beats' ages and reacts:

  stall    age past max(the role's budget, `DEFAULT_STALL_S`):
           counted in `pio_watchdog_stalls_total{role}` and logged with
           the thread's stack (`obs.profiler.format_thread_stack`, the
           sampler's own frame walk); a restartable loop is superseded and
           respawned, any other degrades.
  death    the loop body raised (`guard` logs it and counts
           `pio_thread_deaths_total{role}`) or its thread vanished: a
           restartable loop respawns with jittered exponential backoff.
  breaker  BREAKER_K deaths inside BREAKER_WINDOW_S, or the first death
           or stall of a loop that cannot restart (a wire reactor, the
           lease loop): the beat is degraded (`pio_thread_degraded{role}`
           1), and its owner's `/ready` fails.

The roles, with the JAX budgets: `reactor` (10 s, one per selector-wire
reactor, `beat()` only), `drainer` (the micro-batcher's submit timeout,
live while a drainer runs), `feedback` (no stall budget, respawned),
`tier-pager`, `refresher` and `joiner` (from their intervals,
respawned), the router's `health` and `lease`, the replica agent's
`agent`, the supervisor's `supervisor` and the tsdb `scraper`.

`Beat.beat()` is one store of the monotonic clock, safe on a hot path.
`Beat.tick()`, once per background iteration, also honors the fault seams
`thread.<role>.stall` (a latency rule wedges the loop) and
`thread.<role>.die` (an error rule kills it). A long stage inside one
iteration calls `progress()`, which stamps the calling thread's own beat
(a thread outside a `Beat.guard` stamps nothing; a superseded or stopped
one raises `Superseded` and ends its iteration), so that a tick making
progress is never a stall and a wedged one still is.

Guards (`attach_guard`: the memory-pressure guard of
`resilience/pressure.py`) are checked on every sweep, so they need no
thread of their own.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from predictionio_tpu_torch.obs import get_logger, get_registry
from predictionio_tpu_torch.resilience.faults import faults

_log = get_logger("watchdog")

DEFAULT_STALL_S = 10.0
# jittered exponential respawn backoff, and the crash-loop breaker
BACKOFF_BASE_S = 0.2
BACKOFF_MAX_S = 5.0
BREAKER_K = 5
BREAKER_WINDOW_S = 30.0

# the beat of each loop thread inside `Beat.guard`, for `progress()`
_bound = threading.local()


class Superseded(Exception):
    """Raised by `Beat.tick()` in a loop thread the watchdog replaced
    (it stalled and a fresh thread took over): the stale thread exits."""


class Beat:
    """One liveness stamp per long-lived loop thread."""

    __slots__ = ("role", "budget_s", "restart", "restartable", "stamp",
                 "thread_ident", "closed", "dead", "degraded", "reason",
                 "restarts", "stalled", "death_times", "next_restart_at")

    def __init__(self, role: str, budget_s: float = 0.0,
                 restart: Optional[Callable[[], None]] = None):
        self.role = role
        self.budget_s = budget_s
        self.restart = restart
        self.restartable = restart is not None
        self.stamp = time.monotonic()
        self.thread_ident: Optional[int] = None
        self.closed = False
        self.dead = False
        self.degraded = False
        self.reason = ""
        self.restarts = 0
        self.stalled = False
        self.death_times: List[float] = []
        self.next_restart_at: Optional[float] = None

    def beat(self) -> None:
        """Hot-path stamp: one store of the monotonic clock."""
        self.stamp = time.monotonic()

    def tick(self) -> None:
        """The loop's stamp, once per iteration: honors the fault seams
        and ends a superseded thread."""
        ident = threading.get_ident()
        if self.thread_ident is not None and self.thread_ident != ident:
            raise Superseded(self.role)
        f = faults()
        if f.armed:
            f.check(f"thread.{self.role}.stall")
            f.check(f"thread.{self.role}.die")
        self.stamp = time.monotonic()

    def attach(self) -> None:
        """Bind the beat to the calling thread (loop entry, respawn)."""
        self.thread_ident = threading.get_ident()
        self.stamp = time.monotonic()
        self.dead = False
        self.stalled = False

    def close(self) -> None:
        """Clean shutdown: the next sweep drops the beat."""
        self.closed = True
        if self.degraded:
            _degraded_gauge().labels(role=self.role).set(0.0)

    def guard(self, body: Callable[[], None]) -> None:
        """Run the loop body; an escaping exception is logged and counted
        before the thread exits."""
        self.attach()
        _bound.beat = self
        try:
            body()
        except Superseded:
            _log.info("thread_superseded", role=self.role)
        except BaseException as e:  # noqa: BLE001 — counted, then exit
            _deaths().labels(role=self.role).inc()
            self.dead = True
            _log.exception("thread_died", role=self.role,
                           error=f"{type(e).__name__}: {e}")
        finally:
            _bound.beat = None

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.monotonic()) - self.stamp

    def mark_degraded(self, reason: str) -> None:
        self.degraded = True
        self.reason = reason
        _degraded_gauge().labels(role=self.role).set(1.0)


def progress() -> None:
    """Stamp the calling thread's beat from inside a long stage of one
    loop iteration (a scan, a history read, a fold, an epoch): nothing
    for a thread outside a `Beat.guard`. In a thread the watchdog
    superseded, or whose beat was closed (its owner stopped), it raises
    `Superseded`, so that the stale iteration ends at its next stage
    instead of running on beside its replacement."""
    beat = getattr(_bound, "beat", None)
    if beat is None:
        return
    if beat.closed or beat.thread_ident != threading.get_ident():
        raise Superseded(beat.role)
    beat.stamp = time.monotonic()


def _deaths():
    return get_registry().counter(
        "pio_thread_deaths_total",
        "Loop threads that exited on an uncaught exception",
        labels=("role",))


def _degraded_gauge():
    return get_registry().gauge(
        "pio_thread_degraded",
        "1 when the watchdog has given up on this role (crash loop, "
        "or a non-restartable loop died/stalled)", labels=("role",))


class Watchdog:
    """Sweeps the registered beats; one per process (`watchdog()`)."""

    def __init__(self, stall_s: float = DEFAULT_STALL_S,
                 interval_s: Optional[float] = None):
        self.stall_s = max(stall_s, 0.1)
        self.interval_s = interval_s if interval_s is not None \
            else max(min(1.0, self.stall_s / 4.0), 0.05)
        self._lock = threading.Lock()
        self._beats: List[Beat] = []
        self._guards: List = []       # checked on every sweep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._age_gauge = reg.gauge(
            "pio_thread_beat_age_seconds",
            "Seconds since each loop thread last stamped its beat",
            labels=("role",))
        self._stalls = reg.counter(
            "pio_watchdog_stalls_total",
            "Stalls detected (beat age past the role budget)",
            labels=("role",))
        self._restarts = reg.counter(
            "pio_thread_restarts_total",
            "Loop threads respawned by the watchdog", labels=("role",))

    def register(self, role: str, budget_s: float = 0.0,
                 restart: Optional[Callable[[], None]] = None) -> Beat:
        """A new beat for `role`: `budget_s` widens the stall threshold
        past `stall_s` (slow loops pass their interval); `restart`
        makes the loop restartable."""
        beat = Beat(role, budget_s=budget_s, restart=restart)
        with self._lock:
            self._beats.append(beat)
        return beat

    def attach_guard(self, guard) -> None:
        """Check `guard.check()` on every sweep (the memory-pressure
        guard)."""
        with self._lock:
            if guard not in self._guards:
                self._guards.append(guard)

    def detach_guard(self, guard) -> None:
        with self._lock:
            if guard in self._guards:
                self._guards.remove(guard)

    def beats(self) -> List[Beat]:
        with self._lock:
            return list(self._beats)

    def ensure_started(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pio-torch-watchdog", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep()
            except Exception as e:  # noqa: BLE001 — the sweeper survives
                _log.warning("watchdog_sweep_failed",
                             error=f"{type(e).__name__}: {e}")

    def sweep(self) -> None:
        """One pass: export ages, detect stalls and deaths, run due
        restarts. Public so that tests drive it."""
        now = time.monotonic()
        alive = {t.ident for t in threading.enumerate()}
        with self._lock:
            self._beats = [b for b in self._beats if not b.closed]
            beats = list(self._beats)
            guards = list(self._guards)
        for beat in beats:
            self._age_gauge.labels(role=beat.role).set(beat.age(now))
            if beat.degraded:
                continue
            if beat.next_restart_at is not None:
                if now >= beat.next_restart_at:
                    self._respawn(beat)
                continue
            gone = (beat.thread_ident is not None
                    and beat.thread_ident not in alive)
            if beat.dead or gone:
                self._on_death(beat, now, "uncaught exception"
                               if beat.dead else "thread vanished")
                continue
            limit = max(beat.budget_s, self.stall_s)
            if beat.age(now) > limit and not beat.stalled:
                self._on_stall(beat, now)
        for guard in guards:
            try:
                guard.check()
            except Exception as e:  # noqa: BLE001 — a guard never kills
                _log.warning("pressure_check_failed",
                             error=f"{type(e).__name__}: {e}")

    def _on_stall(self, beat: Beat, now: float) -> None:
        beat.stalled = True
        self._stalls.labels(role=beat.role).inc()
        stack = ""
        if beat.thread_ident is not None:
            from predictionio_tpu_torch.obs import profiler
            stack = profiler.format_thread_stack(beat.thread_ident)
        _log.warning("thread_stalled", role=beat.role,
                     age_s=round(beat.age(now), 3),
                     budget_s=max(beat.budget_s, self.stall_s),
                     stack=stack)
        if beat.restartable:
            # a wedged thread cannot be killed: supersede it (its next
            # tick raises Superseded) and respawn a fresh one
            self._on_death(beat, now, "stalled")
        else:
            beat.mark_degraded(f"stalled (age {beat.age(now):.1f}s)")

    def _on_death(self, beat: Beat, now: float, why: str) -> None:
        if not beat.restartable:
            beat.mark_degraded(why)
            _log.warning("thread_degraded", role=beat.role, reason=why)
            return
        beat.death_times = [t for t in beat.death_times
                            if now - t <= BREAKER_WINDOW_S]
        beat.death_times.append(now)
        if len(beat.death_times) >= BREAKER_K:
            beat.mark_degraded(
                f"crash loop: {len(beat.death_times)} deaths in "
                f"{BREAKER_WINDOW_S:.0f}s ({why})")
            _log.warning("thread_crash_loop_giveup", role=beat.role,
                         deaths=len(beat.death_times), reason=why)
            return
        n = len(beat.death_times)
        backoff = min(BACKOFF_BASE_S * (2.0 ** (n - 1)), BACKOFF_MAX_S)
        backoff *= 1.0 + random.random() * 0.25     # jitter
        beat.thread_ident = None      # the stale thread exits
        beat.next_restart_at = now + backoff
        _log.warning("thread_restart_scheduled", role=beat.role,
                     reason=why, backoff_s=round(backoff, 3))

    def _respawn(self, beat: Beat) -> None:
        beat.next_restart_at = None
        beat.restarts += 1
        self._restarts.labels(role=beat.role).inc()
        _log.info("thread_restarting", role=beat.role,
                  restarts=beat.restarts)
        try:
            beat.restart()
        except Exception as e:  # noqa: BLE001 — counted as a death
            _log.warning("thread_restart_failed", role=beat.role,
                         error=f"{type(e).__name__}: {e}")
            beat.dead = True


_default = Watchdog()


def watchdog() -> Watchdog:
    """The process's watchdog, which every loop registers with."""
    return _default
