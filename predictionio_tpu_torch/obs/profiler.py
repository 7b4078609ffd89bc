"""Always-on sampling profiler + runtime telemetry samplers.

The port of `predictionio_tpu/obs/profiler.py`. A named background
thread (`pio-torch-prof-sampler`) wakes `PIO_PROF_HZ` times per second
(default 19, a prime, so the sampler never phase-locks with 10-ms or
100-ms periodic work; `0` disables it), walks `sys._current_frames()`,
and folds every thread's stack into a bounded frame-trie. Threads are
attributed to the JAX package's *roles* (reactor, worker, drainer,
refresher, heartbeat, joiner, obs, supervisor, http, main) by the
port's own thread names (`_ROLE_PREFIXES`; the port names every thread
it starts, and a test holds each name to a role), so `/profile.json`
answers "what share of CPU samples land in wire workers against the
batch drainer" without any per-call instrumentation.

Exports, via `utils.http.HTTPServerBase` on every server:

  - ``GET /profile.json``  — per-role sample shares plus top frames by
    self and cumulative samples;
  - ``GET /profile.txt?fmt=collapsed`` — flamegraph-ready collapsed
    stacks (``role;frame;frame;... count`` per line; pipe into
    ``flamegraph.pl`` or speedscope).

The trie is bounded (`DEFAULT_MAX_NODES`, 4096): once the node budget
is spent, deeper frames fold into the deepest allocated node, so memory
stays O(budget) under pathological stack churn while hot paths
(allocated early, sampled often) keep full depth.

Alongside the sampler, this module owns the cheap runtime gauges: GC
pauses via `gc.callbacks` (`pio_gc_pause_seconds{generation}`), host
RSS/CPU/threads from `/proc/self`, and the card's allocator bytes from
`torch.cuda.memory_stats` (`pio_device_memory_bytes{device,kind}`),
read only in a process that has already made its CUDA context: the
scraper runs in every server, and a stats call would make a context in
`ingestd`, the event server or a router. All are sampled on the tsdb
scrape tick, not per request.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from predictionio_tpu_torch.obs.logs import get_logger
from predictionio_tpu_torch.obs.metrics import (MetricsRegistry,
                                                get_registry)

_log = get_logger("profiler")

DEFAULT_HZ = 19.0
DEFAULT_MAX_NODES = 4096

# the port's thread-name prefix -> the JAX package's role, first match
# wins (order matters: "wire-reactor-" before the generic "wire-" worker
# catch-all)
_ROLE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("wire-reactor-", "reactor"),
    ("wire-", "worker"),
    ("pio-torch-loadsim-", "worker"),   # loadsim's open-loop arrivals
    # the chaos drills (resilience/scenarios.py): the scripted autoscaler
    # loop acts as the supervisor does; the client hammers (the failover
    # loader, the tenant budget hammer, the loadsim thread) are load
    ("pio-torch-chaos-autoscale", "supervisor"),
    ("pio-torch-chaos-", "worker"),
    ("replica-", "worker"),             # REPLICATED's per-target writes
    ("pio-torch-batch-drain", "drainer"),
    ("pio-torch-feedback", "drainer"),
    ("pio-torch-plugin-drain", "drainer"),
    ("pio-torch-refresher", "refresher"),
    ("pio-torch-tier-pager", "refresher"),
    ("pio-torch-ingest-prefetch", "refresher"),
    ("pio-torch-fleet-", "heartbeat"),
    ("pio-torch-replica-agent", "heartbeat"),
    ("pio-torch-heartbeat-", "heartbeat"),
    ("pio-torch-ingestd-janitor", "heartbeat"),
    ("pio-fsck-sched", "heartbeat"),
    ("pio-torch-quality-join", "joiner"),
    ("pio-torch-prof", "obs"),
    ("pio-torch-tsdb", "obs"),
    ("pio-torch-watchdog", "obs"),
    ("pio-torch-supervisor", "supervisor"),   # with the retire drains
    ("pio-torch-server-stop", "supervisor"),
    ("pio-torch-signal-stop", "supervisor"),
    ("pio-torch-mem-drain", "supervisor"),
    ("pio-torch-http-", "http"),
    ("MainThread", "main"),
)


def role_of(thread_name: str) -> str:
    """Map a thread name to its serving role (see _ROLE_PREFIXES);
    names the port does not start (test harness threads, user code)
    are "other"."""
    for prefix, role in _ROLE_PREFIXES:
        if thread_name.startswith(prefix):
            return role
    return "other"


def format_thread_stack(ident: int, limit: int = 40) -> str:
    """One thread's current stack as a compact one-line string
    (`mod:func:line < mod:func:line < ...`, innermost first) from the
    same `sys._current_frames()` walk the sampler folds — the
    watchdog's stall dump. Empty string when the thread is gone."""
    frame = sys._current_frames().get(ident)
    if frame is None:
        return ""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < limit:
        code = f.f_code
        mod = code.co_filename.rsplit("/", 1)[-1]
        parts.append(f"{mod}:{code.co_name}:{f.f_lineno}")
        f = f.f_back
    return " < ".join(parts)


def _envf(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _Node:
    """One frame-trie node: children keyed by "module:function" and
    the count of samples whose stack ended exactly here."""

    __slots__ = ("children", "ended")

    def __init__(self):
        self.children: Dict[str, "_Node"] = {}
        self.ended = 0


class SamplingProfiler:
    """Bounded folded-stack sampler over `sys._current_frames()`.

    Directly instantiable for tests; the process-global instance
    (one sampler sees every thread, so per-server instances would
    multiply the overhead for identical data) comes from
    `ensure_started()`.
    """

    def __init__(self, hz: Optional[float] = None,
                 max_nodes: Optional[int] = None):
        self.hz = _envf("PIO_PROF_HZ", DEFAULT_HZ) if hz is None else hz
        self.max_nodes = max(16, int(DEFAULT_MAX_NODES if max_nodes is None
                                     else max_nodes))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-role trie roots; role itself is the first collapsed segment
        self._roots: Dict[str, _Node] = {}
        self._nodes = 0              # allocated trie nodes across roles
        self._truncated = 0          # samples folded at the node budget
        self._self_counts: Dict[str, int] = {}   # innermost frame
        self._cum_counts: Dict[str, int] = {}    # anywhere on stack
        self._role_samples: Dict[str, int] = {}
        self._samples = 0            # thread-samples folded
        self._ticks = 0              # sampler wakeups
        self._started_at = 0.0

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Spawn the sampler thread; False (and no thread) when hz<=0
        — hooks stay installed, the loop simply never exists, so
        `PIO_PROF_HZ=0` is zero-overhead."""
        if self.hz <= 0 or self.running:
            return False
        self._stop.clear()
        self._started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, name="pio-torch-prof-sampler", daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            try:
                self.sample_once(skip_ident=me)
            except Exception as e:     # never kill the sampler loop
                _log.warning("prof_sample_failed",
                             error=f"{type(e).__name__}: {e}")

    # -- sampling ------------------------------------------------------------
    def sample_once(self, skip_ident: Optional[int] = None) -> int:
        """Fold one sample of every live thread's stack; returns the
        number of threads folded. Public so tests can drive the fold
        deterministically without a live sampler thread."""
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded = 0
        with self._lock:
            self._ticks += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue
                role = role_of(names.get(ident, ""))
                stack: List[str] = []
                f = frame
                while f is not None:
                    code = f.f_code
                    mod = code.co_filename.rsplit("/", 1)[-1]
                    stack.append(f"{mod}:{code.co_name}")
                    f = f.f_back
                stack.reverse()        # outermost first, flamegraph order
                self._fold_locked(role, stack)
                folded += 1
            self._samples += folded
        return folded

    def _fold_locked(self, role: str, stack: List[str]) -> None:
        self._role_samples[role] = self._role_samples.get(role, 0) + 1
        if not stack:
            return
        node = self._roots.get(role)
        if node is None:
            if self._nodes >= self.max_nodes:   # budget covers roots too
                self._truncated += 1
                return
            node = self._roots[role] = _Node()
            self._nodes += 1
        truncated = False
        for key in stack:
            child = node.children.get(key)
            if child is None:
                if self._nodes >= self.max_nodes:
                    truncated = True
                    break
                child = node.children[key] = _Node()
                self._nodes += 1
            node = child
        if truncated:
            self._truncated += 1
        node.ended += 1
        innermost = stack[-1]
        self._self_counts[innermost] = self._self_counts.get(
            innermost, 0) + 1
        for key in set(stack):
            self._cum_counts[key] = self._cum_counts.get(key, 0) + 1

    # -- export --------------------------------------------------------------
    def snapshot_json(self, top: int = 30) -> Dict:
        """Shape served at /profile.json: role shares + top frames."""
        with self._lock:
            samples = self._samples
            roles = dict(self._role_samples)
            self_top = sorted(self._self_counts.items(),
                              key=lambda kv: -kv[1])[:top]
            cum_top = sorted(self._cum_counts.items(),
                             key=lambda kv: -kv[1])[:top]
            nodes, truncated = self._nodes, self._truncated
            ticks = self._ticks
        denom = float(samples) or 1.0

        def _frames(pairs: Iterable[Tuple[str, int]]) -> List[Dict]:
            return [{"frame": k, "samples": v,
                     "share": round(v / denom, 4)} for k, v in pairs]

        return {
            "hz": self.hz,
            "running": self.running,
            "ticks": ticks,
            "samples": samples,
            "since": self._started_at,
            "roles": {r: {"samples": n, "share": round(n / denom, 4)}
                      for r, n in sorted(roles.items(),
                                         key=lambda kv: -kv[1])},
            "top_self": _frames(self_top),
            "top_cumulative": _frames(cum_top),
            "trie": {"nodes": nodes, "max_nodes": self.max_nodes,
                     "truncated_samples": truncated},
        }

    def collapsed(self) -> str:
        """Flamegraph collapsed-stack format, one line per unique
        path: ``role;frame;frame;... count``."""
        lines: List[str] = []
        with self._lock:
            for role in sorted(self._roots):
                stack = [(self._roots[role], role)]
                while stack:
                    node, path = stack.pop()
                    if node.ended:
                        lines.append(f"{path} {node.ended}")
                    for key in sorted(node.children):
                        stack.append((node.children[key],
                                      f"{path};{key}"))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._roots.clear()
            self._nodes = 0
            self._truncated = 0
            self._self_counts.clear()
            self._cum_counts.clear()
            self._role_samples.clear()
            self._samples = 0
            self._ticks = 0


# -- process-global sampler ---------------------------------------------------
_global_lock = threading.Lock()
_global_profiler: Optional[SamplingProfiler] = None


def get_profiler() -> SamplingProfiler:
    """The process-global sampler (created from env knobs on first
    use; NOT started — see ensure_started)."""
    global _global_profiler
    with _global_lock:
        if _global_profiler is None:
            _global_profiler = SamplingProfiler()
        return _global_profiler


def ensure_started() -> SamplingProfiler:
    """Idempotently start the process-global sampler. With
    PIO_PROF_HZ=0 the instance exists (endpoints keep serving an
    empty profile) but no thread runs."""
    prof = get_profiler()
    if not prof.running:
        prof.start()
    return prof


def _reset_global_for_tests() -> None:
    global _global_profiler
    with _global_lock:
        prof, _global_profiler = _global_profiler, None
    if prof is not None:
        prof.stop()


# -- GC pause hook ------------------------------------------------------------
_gc_lock = threading.Lock()
_gc_registries: set = set()          # id() of registries already hooked
_gc_start_ns = 0


def install_gc_callbacks(metrics: Optional[MetricsRegistry] = None) -> bool:
    """Install a `gc.callbacks` hook observing every collection's
    wall time into `pio_gc_pause_seconds{generation}`. Idempotent per
    registry (one hook feeds one registry; a test registry gets its
    own). Returns True on install, False for already-installed."""
    metrics = metrics if metrics is not None else get_registry()
    hist = metrics.histogram(
        "pio_gc_pause_seconds",
        "Stop-the-world GC collection pauses by generation",
        buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
        labels=("generation",))
    with _gc_lock:
        if id(metrics) in _gc_registries:
            return False
        _gc_registries.add(id(metrics))

    # a collection runs in whichever thread allocated: one that holds the
    # histogram's lock (inside its own `labels`, `observe` or a snapshot
    # of it) would wait for itself forever. Such a pause waits here, and
    # the next collection that finds the lock free records it.
    pending: deque = deque(maxlen=1024)
    lock = hist._lock

    def _on_gc(phase: str, info: Dict) -> None:
        # CPython runs collections (and hence callbacks) under a
        # per-interpreter guard, so one start slot suffices
        global _gc_start_ns
        if phase == "start":
            _gc_start_ns = time.perf_counter_ns()
        elif phase == "stop" and _gc_start_ns:
            dt = (time.perf_counter_ns() - _gc_start_ns) / 1e9
            pending.append((str(info.get("generation", "?")), dt))
            if not lock.acquire(blocking=False):
                return
            lock.release()
            while pending:
                generation, seconds = pending.popleft()
                hist.labels(generation=generation).observe(seconds)

    gc.callbacks.append(_on_gc)
    return True


# -- host /proc sampler -------------------------------------------------------
class HostSampler:
    """RSS / CPU seconds / thread count from `/proc/self`, set on the
    tsdb tick. CPU is a monotone counter advanced by delta."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        m = metrics if metrics is not None else get_registry()
        self._rss = m.gauge("pio_host_rss_bytes",
                            "Resident set size of this process")
        self._threads = m.gauge("pio_host_threads",
                                "Live threads in this process")
        self._cpu = m.counter("pio_host_cpu_seconds_total",
                              "Process CPU time (user+system)")
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._tick = float(os.sysconf("SC_CLK_TCK")) or 100.0
        self._last_cpu = 0.0

    def sample(self) -> None:
        try:
            with open("/proc/self/statm", "rb") as fh:
                self._rss.set(int(fh.read().split()[1]) * self._page)
            with open("/proc/self/stat", "rb") as fh:
                raw = fh.read()
            # field 2 is "(comm)" and may contain spaces: split after
            # the closing paren, stat fields 14/15 are utime/stime and
            # 20 is num_threads (1-indexed in proc(5))
            fields = raw[raw.rindex(b")") + 2:].split()
            cpu = (int(fields[11]) + int(fields[12])) / self._tick
            self._threads.set(int(fields[17]))
            if cpu > self._last_cpu:
                self._cpu.inc(cpu - self._last_cpu)
            self._last_cpu = cpu
        except (OSError, ValueError, IndexError):
            pass                      # non-procfs hosts: gauges stay 0


def sample_device_memory(metrics: Optional[MetricsRegistry] = None) -> int:
    """The CUDA caching allocator's bytes per card into
    `pio_device_memory_bytes{device="cuda:<i>",kind}` (kind: in_use from
    `allocated_bytes.all.current`, peak from `allocated_bytes.all.peak`).
    Returns the number of cards sampled: 0 without torch in the process,
    without CUDA, or before the process made its CUDA context
    (`torch.cuda.is_initialized()`), since the stats call would make
    one."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return 0
        n = torch.cuda.device_count()
    except Exception:
        return 0
    m = metrics if metrics is not None else get_registry()
    gauge = m.gauge("pio_device_memory_bytes",
                    "Device allocator bytes by device and kind",
                    labels=("device", "kind"))
    sampled = 0
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i) or {}
        except Exception:
            stats = {}
        if not stats:
            continue
        dev = f"cuda:{i}"
        for kind, key in (("in_use", "allocated_bytes.all.current"),
                          ("peak", "allocated_bytes.all.peak")):
            if key in stats:
                gauge.labels(device=dev, kind=kind).set(float(stats[key]))
        sampled += 1
    return sampled
