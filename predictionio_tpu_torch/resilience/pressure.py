"""Memory-pressure guard: soft and hard watermarks that trim and drain.

The port of `predictionio_tpu/resilience/pressure.py`. Two watermarks on
the fraction of the memory limit in use, the worse of the host's (this
process's RSS against the cgroup v2/v1 limit, `PIO_MEM_LIMIT_BYTES`, or
MemTotal) and the card's (this process's live allocator bytes,
`torch.cuda.memory_allocated`, against the card's `total_memory` times
the fraction `torch.cuda.set_per_process_memory_fraction` set):

  soft (`PIO_MEM_SOFT_FRAC`, default 0.85)
       every registered trim runs (the trace ring, the tsdb rings, the
       quality accumulators, the tenant key cache, the prepared-ingest
       cache), at most once per `TRIM_INTERVAL_S`, and new work is shed
       `503 surface=memory` while over it; work in flight completes.
  hard (`PIO_MEM_HARD_FRAC`, default 0.95)
       `/ready` fails as well, and the drain callbacks fire once: a
       graceful stop() rather than an out-of-memory kill mid-request.

The card is read as the JAX package reads its devices' `bytes_in_use`
against `bytes_limit`: this process's own bytes, so that the supervised
children that share one card each watch their own. It is read only where
the process has made its CUDA context already (the reading would make
one), and not at all on the CPU. `check()` runs on the watchdog's sweep
(`Watchdog.attach_guard`); the fault seams `mem.pressure.soft` and
`mem.pressure.hard` force a state.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import get_logger, get_registry
from predictionio_tpu_torch.resilience.faults import faults

_log = get_logger("pressure")

OK, SOFT, HARD = "ok", "soft", "hard"
_LEVELS = {OK: 0.0, SOFT: 1.0, HARD: 2.0}
DEFAULT_SOFT_FRAC = 0.85
DEFAULT_HARD_FRAC = 0.95
TRIM_INTERVAL_S = 10.0


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def host_memory_limit() -> Optional[int]:
    """The host memory budget in bytes: `PIO_MEM_LIMIT_BYTES`, else the
    cgroup v2 or v1 limit, else /proc/meminfo's MemTotal; None when
    nothing says (the guard then watches the card only)."""
    override = os.environ.get("PIO_MEM_LIMIT_BYTES", "").strip()
    if override:
        try:
            return int(float(override))
        except ValueError:
            pass
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path, "rb") as fh:
                raw = fh.read().strip()
        except OSError:
            continue
        if raw and raw != b"max":
            try:
                limit = int(raw)
            except ValueError:
                continue
            if 0 < limit < (1 << 60):    # v1 reports about 2^63 for none
                return limit
    try:
        with open("/proc/meminfo", "rb") as fh:
            for line in fh:
                if line.startswith(b"MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm", "rb") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def device_memory_frac() -> Optional[float]:
    """The worst of this process's `memory_allocated` over its limit
    across the cards; None without torch in the process, without CUDA,
    or before the process made its CUDA context."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        n = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — no reading
        return None
    get_frac = getattr(torch.cuda, "get_per_process_memory_fraction", None)
    worst: Optional[float] = None
    for i in range(n):
        try:
            limit = float(torch.cuda.get_device_properties(i).total_memory)
            if get_frac is not None:
                limit *= float(get_frac(i))
            in_use = float(torch.cuda.memory_allocated(i))
        except Exception:  # noqa: BLE001 — skip the card
            continue
        if limit <= 0:
            continue
        frac = in_use / limit
        if worst is None or frac > worst:
            worst = frac
    return worst


class MemoryGuard:
    """The watermark state machine and its trims (module docstring).
    `check()` is cheap (two /proc reads and the allocator's counters) and
    idempotent; the watchdog's sweep calls it, tests call it directly."""

    def __init__(self, soft_frac: Optional[float] = None,
                 hard_frac: Optional[float] = None,
                 limit_bytes: Optional[int] = None,
                 trim_interval_s: float = TRIM_INTERVAL_S):
        self.soft_frac = soft_frac if soft_frac is not None else _envf(
            "PIO_MEM_SOFT_FRAC", DEFAULT_SOFT_FRAC)
        self.hard_frac = hard_frac if hard_frac is not None else _envf(
            "PIO_MEM_HARD_FRAC", DEFAULT_HARD_FRAC)
        self.limit_bytes = limit_bytes if limit_bytes is not None \
            else host_memory_limit()
        self.trim_interval_s = trim_interval_s
        self.state = OK
        self._trims: List[Tuple[str, Callable[[], int]]] = []
        self._on_hard: List[Callable[[], None]] = []
        self._hard_fired = False
        self._last_trim = 0.0
        reg = get_registry()
        self._state_gauge = reg.gauge(
            "pio_mem_pressure_state",
            "Memory watermark state: 0 ok, 1 soft (trim+shed), "
            "2 hard (drain)")
        self._frac_gauge = reg.gauge(
            "pio_mem_used_frac",
            "Worst observed memory fraction (host RSS/limit vs device "
            "in_use/limit)")
        self._trim_counter = reg.counter(
            "pio_mem_trims_total",
            "Soft-watermark trim passes, by target", labels=("target",))
        self._trim_bytes = reg.counter(
            "pio_mem_trimmed_bytes_total",
            "Approximate bytes released by soft-watermark trims",
            labels=("target",))
        self._state_gauge.set(0.0)

    # -- registration -------------------------------------------------------
    def add_trim(self, target: str, fn: Callable[[], int]) -> None:
        """Register a trim of bounded state; `fn()` returns about the
        bytes it released."""
        self._trims.append((target, fn))

    def on_hard(self, fn: Callable[[], None]) -> None:
        """A callback fired once each time the hard watermark trips (the
        owner starts its graceful drain)."""
        self._on_hard.append(fn)

    # -- admission ----------------------------------------------------------
    def shedding(self) -> bool:
        """True while new work is refused `503 surface=memory`."""
        return self.state != OK

    def ready(self) -> bool:
        """False once the hard watermark tripped."""
        return self.state != HARD

    def detail(self) -> Dict:
        return {"state": self.state, "softFrac": self.soft_frac,
                "hardFrac": self.hard_frac,
                "limitBytes": self.limit_bytes}

    # -- the periodic check -------------------------------------------------
    def observed_frac(self) -> Optional[float]:
        """The worse of host RSS / limit and the card's fraction; None
        when neither can be read."""
        fracs = []
        if self.limit_bytes:
            rss = _rss_bytes()
            if rss is not None:
                fracs.append(rss / float(self.limit_bytes))
        dev = device_memory_frac()
        if dev is not None:
            fracs.append(dev)
        return max(fracs) if fracs else None

    def check(self) -> str:
        """Read, move between states, act; returns the new state."""
        f = faults()
        forced: Optional[str] = None
        if f.armed:
            if f.dropped("mem.pressure.hard"):
                forced = HARD
            elif f.dropped("mem.pressure.soft"):
                forced = SOFT
        frac = self.observed_frac()
        if frac is not None:
            self._frac_gauge.set(frac)
        if forced is not None:
            state = forced
        elif frac is None:
            state = OK
        elif frac >= self.hard_frac:
            state = HARD
        elif frac >= self.soft_frac:
            state = SOFT
        else:
            state = OK
        if state != self.state:
            _log.warning("mem_pressure_transition", previous=self.state,
                         state=state,
                         frac=round(frac, 4) if frac is not None else None)
        self.state = state
        self._state_gauge.set(_LEVELS[state])
        if state == OK:
            self._hard_fired = False        # re-arm the drain latch
            return state
        self._maybe_trim()
        if state == HARD and not self._hard_fired:
            self._hard_fired = True
            for fn in list(self._on_hard):
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — the drain is best effort
                    _log.warning("mem_hard_callback_failed",
                                 error=f"{type(e).__name__}: {e}")
        return state

    def _maybe_trim(self) -> int:
        now = time.monotonic()
        if now - self._last_trim < self.trim_interval_s:
            return 0
        self._last_trim = now
        total = 0
        for target, fn in list(self._trims):
            try:
                freed = int(fn() or 0)
            except Exception as e:  # noqa: BLE001 — trims are independent
                _log.warning("mem_trim_failed", target=target,
                             error=f"{type(e).__name__}: {e}")
                continue
            self._trim_counter.labels(target=target).inc()
            if freed > 0:
                self._trim_bytes.labels(target=target).inc(freed)
                total += freed
        _log.warning("mem_pressure_trimmed", state=self.state,
                     freed_bytes=total, targets=len(self._trims))
        return total
