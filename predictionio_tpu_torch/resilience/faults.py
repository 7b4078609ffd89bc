"""Deterministic fault-injection seams.

The port of `predictionio_tpu/resilience/faults.py`: named seams in the
stack call `faults().check("seam.name")`, a no-op (one list read) until
a test arms a rule. Rules inject, deterministically: latency (a sleep),
exceptions (an instance, or a type made per hit), N-then-succeed
(`times=N`), packet loss (`dropped`) and torn writes (`torn=0.6`: the
seam persists that fraction of its bytes, then raises).

Seams are matched by dotted prefix: a rule armed at ``serve.predict``
hits ``serve.predict.0:ALSAlgorithm``. The port's seams:

  serve.predict.<i>:<AlgoClass>     per-algorithm batch predict
  deploy.prepare                    the model load of a deploy or reload
  storage.<source>.<dao>.<method>   every storage DAO call the registry
                                    wraps (`data/storage/resilient.py`)
  storage.<source>.models.insert.torn   a LOCALFS blob write, torn

Injections are counted per seam in `pio_faults_injected_total`. Tests
arm the process-default injector and clear it in teardown
(`faults().clear()`).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Union

from predictionio_tpu_torch.obs import get_registry


class FaultError(Exception):
    """Generic injected failure. Deliberately NOT an OSError subclass:
    arm `error=OSError` when the scenario should look transient to the
    retry/breaker machinery, `error=FaultError` when it should not."""


class FaultRule:
    """One armed fault; mutable hit counter, guarded by the injector."""

    __slots__ = ("seam", "latency", "error", "times", "hits", "torn")

    def __init__(self, seam: str, latency: float = 0.0,
                 error: Union[BaseException, type, None] = None,
                 times: Optional[int] = None,
                 torn: Optional[float] = None):
        self.seam = seam
        self.latency = latency
        self.error = error
        self.times = times           # None = every hit
        self.torn = torn             # fraction of bytes persisted, or None
        self.hits = 0

    def matches(self, seam: str) -> bool:
        return seam == self.seam or seam.startswith(self.seam + ".") \
            or seam.startswith(self.seam + ":")

    def exhausted(self) -> bool:
        return self.times is not None and self.hits >= self.times


class FaultInjector:
    """Holds armed rules; `check` is the seam entry point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[FaultRule] = []
        self._counter = None

    def arm(self, seam: str, *, latency: float = 0.0,
            error: Union[BaseException, type, None] = None,
            times: Optional[int] = None,
            torn: Optional[float] = None) -> FaultRule:
        """Arm a rule at `seam` (dotted-prefix matched). Returns the rule
        so tests can inspect `rule.hits`. Rules with `torn=` set fire
        only via `torn_fraction()`, never via `check()`."""
        rule = FaultRule(seam, latency=latency, error=error, times=times,
                         torn=torn)
        with self._lock:
            self._rules.append(rule)
        return rule

    def clear(self) -> None:
        with self._lock:
            self._rules = []

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def check(self, seam: str) -> None:
        """Apply every matching, non-exhausted rule at this seam."""
        if not self._rules:      # fast path: harness disarmed
            return
        fired: List[FaultRule] = []
        with self._lock:
            for rule in self._rules:
                if rule.torn is not None:   # torn rules fire via torn_fraction
                    continue
                if rule.matches(seam) and not rule.exhausted():
                    rule.hits += 1
                    fired.append(rule)
        for rule in fired:
            self._count(seam)
            if rule.latency > 0:
                time.sleep(rule.latency)
            if rule.error is not None:
                err = rule.error
                if isinstance(err, type):
                    err = err(f"injected fault at {seam}")
                raise err

    def dropped(self, seam: str) -> bool:
        """Packet-loss seam entry point: True when a matching rule is
        armed — the caller then behaves as if the message NEVER ARRIVED
        (a partition) instead of raising an error back to the sender.
        Counts as an injection; latency rules still apply. Seams:
        `fleet.net.<member>.heartbeat` (membership path) and
        `fleet.net.<member>.data` (query proxy path) let chaos tests
        distinguish a partitioned member from a crashed one."""
        if not self._rules:      # fast path: harness disarmed
            return False
        fired: List[FaultRule] = []
        with self._lock:
            for rule in self._rules:
                if rule.torn is not None:
                    continue
                if rule.matches(seam) and not rule.exhausted():
                    rule.hits += 1
                    fired.append(rule)
        for rule in fired:
            self._count(seam)
            if rule.latency > 0:
                time.sleep(rule.latency)
        return bool(fired)

    def torn_fraction(self, seam: str) -> Optional[float]:
        """Torn-write seam entry point: returns the fraction of bytes the
        caller should persist before simulating a crash, or None when no
        torn rule matches. Counts as an injection when armed."""
        if not self._rules:
            return None
        frac: Optional[float] = None
        with self._lock:
            for rule in self._rules:
                if rule.torn is None:
                    continue
                if rule.matches(seam) and not rule.exhausted():
                    rule.hits += 1
                    frac = rule.torn
                    break
        if frac is not None:
            self._count(seam)
        return frac

    def _count(self, seam: str) -> None:
        if self._counter is None:
            self._counter = get_registry().counter(
                "pio_faults_injected_total",
                "Faults injected by the chaos harness", labels=("seam",))
        self._counter.labels(seam=seam).inc()


_default = FaultInjector()


def faults() -> FaultInjector:
    """The process-default injector every seam consults."""
    return _default
