"""Declarative chaos scenarios with invariant gates: `cli chaos`.

The port of `predictionio_tpu/resilience/scenarios.py`. `cli chaos run
<scenario>` composes the fault seams (`faults.py`'s, the watchdog's
`thread.<role>.stall` / `thread.<role>.die`, the memory guard's
`mem.pressure.soft` / `mem.pressure.hard`) into timed scripts against a
real in-process topology (servers on loopback over a trained model, an
open-loop failover client), then gates on invariants:

  zero-failed     no client request ultimately failed (the failover
                  loader retries 503s and follows leader redirects
                  inside each request's budget; only a request no
                  router served counts)
  fired-once      the watchdog detected the injected stall exactly once
  recovered       the wedged or killed loop ticks again (small age, not
                  degraded) before the scenario ends
  took-over       the standby holds the lease after a lease-loop death
  shed+trimmed    soft memory pressure shed `surface=memory` and
                  released measurable ring bytes

A violated invariant makes `run()` return `ok=False` (the CLI exits 1).

Scenarios (`names()`, `cli chaos list`): refresher-stall, refresher-die,
lease-failover, mem-soft, replica-kill, flash-crowd, diurnal-1-N-1,
hot-key and handoff-budget, with the JAX catalog's descriptions,
durations, steps, watch lists, load budgets and invariants.

Where the port differs: a server is a deployment of an engine instance
(`cli.main.deploy_instance` on the scenario's device), so `trained` is
(registry, engine, instance) and `run(..., device=...)` names the device
(None: `cuda`, which raises without CUDA; `train_tiny` trains there
too). A standby router is a router with no replicas that contends for
the lease (the port's `FleetConfig` has no standby flag). A run's
routers take a fleet name of their own, so that they inherit no lease
and no member snapshot of an earlier run on the same store. The router
pairs deploy their replica before the routers start: a deploy's seconds
of model load and warm beside a leader already up could starve its
0.5-s lease's renewals and hand the lease to the standby.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.obs import get_logger, get_registry
from predictionio_tpu_torch.resilience.faults import FaultError, faults
from predictionio_tpu_torch.resilience.watchdog import watchdog

_log = get_logger(__name__)

# chaos-grade fleet timings (the JAX catalog's)
FLEET_TIMINGS = dict(health_interval_s=0.1, heartbeat_s=0.1,
                     eject_threshold=2, drain_timeout_s=2.0,
                     lease_ttl_s=0.5)
SCENARIO_STALL_S = 1.0          # watchdog stall threshold during a run
SCENARIO_SWEEP_S = 0.05         # watchdog sweep cadence during a run


class ScenarioViolation(AssertionError):
    """A step or invariant found the system in a forbidden state."""


def _http(port: int, method: str, path: str, body=None, key: str = ""):
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    if key:
        req.add_header("Authorization", f"Bearer {key}")
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            raw = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(raw) if "json" in ct else raw)
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except ValueError:
            return e.code, None


class OpenLoopLoader:
    """Client hammer that fails over between ports the way a real fleet
    client does: try each port, skip 307 leader redirects to the next
    port, retry 503s — a request only counts as FAILED when no server
    serves it within its budget."""

    def __init__(self, ports: Sequence[int], threads: int = 2,
                 budget_s: float = 10.0,
                 body: Optional[Dict] = None):
        self.ports = list(ports)
        self.budget_s = budget_s
        self.body = body or {"user": "u1", "num": 2}
        self.halt = threading.Event()
        self.statuses: List[int] = []
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"pio-torch-chaos-load-{i}")
            for i in range(threads)]

    def _attempt(self, port: int) -> int:
        try:
            status, _ = _http(port, "POST", "/queries.json", self.body)
            return status
        except OSError:
            return -1

    def _one_request(self) -> int:
        end = time.perf_counter() + self.budget_s
        while time.perf_counter() < end and not self.halt.is_set():
            for port in self.ports:
                status = self._attempt(port)
                if status == 200:
                    return 200
                # 307: leader redirect — try the next port by hand
                # (urllib refuses to re-POST on 307); 5xx: retry
            time.sleep(0.05)
        return -1

    def _run(self) -> None:
        while not self.halt.is_set():
            status = self._one_request()
            if self.halt.is_set() and status != 200:
                return              # torn down mid-request: not a failure
            with self._lock:
                self.statuses.append(status)

    def start(self) -> "OpenLoopLoader":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self.halt.set()
        for t in self._threads:
            t.join(5)

    @property
    def requests(self) -> int:
        with self._lock:
            return len(self.statuses)

    @property
    def failures(self) -> List[int]:
        with self._lock:
            return [s for s in self.statuses if s != 200]


class ScenarioContext:
    """Everything a scenario's steps and invariants can reach: the
    topology under test, the load generator, metric baselines, and a
    notes dict for cross-step measurements."""

    def __init__(self, trained, device=None):
        self.registry, self.engine, self.instance = trained
        self.device = device
        # the run's routers share a fleet name of their own: its lease
        # and member snapshot, not an earlier run's (whose routers left
        # their members in the same store)
        self.fleet_name = f"chaos-{uuid.uuid4().hex[:12]}"
        self.servers: List = []        # stopped in reverse at teardown
        self.agents: List = []
        self.supervisor = None
        self.loader: Optional[OpenLoopLoader] = None
        self.ports: List[int] = []
        self.server = None             # single-server topologies
        self.leader = None             # router-pair topologies
        self.standby = None
        self.notes: Dict = {}
        self._base: Dict[Tuple, float] = {}

    # -- metrics ------------------------------------------------------------
    def metric(self, name: str, **labels) -> float:
        return get_registry().value(name, **labels)

    def mark(self, name: str, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        self._base[key] = self.metric(name, **labels)

    def delta(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        return self.metric(name, **labels) - self._base.get(key, 0.0)

    # -- helpers ------------------------------------------------------------
    def wait(self, pred: Callable[[], bool], timeout: float = 8.0,
             interval: float = 0.02, msg: str = "condition") -> None:
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            if pred():
                return
            time.sleep(interval)
        raise ScenarioViolation(f"timed out waiting for: {msg}")

    def note(self, key: str, value) -> None:
        self.notes[key] = value


@dataclass
class Scenario:
    """One declarative chaos script: a topology setup, timed steps,
    and end-of-run invariants. `watch` lists the (metric, labels)
    series whose baselines are captured after setup so invariants can
    assert on deltas."""
    name: str
    description: str
    duration_s: float
    setup: Callable[[ScenarioContext], None]
    steps: Tuple[Tuple[float, str, Callable[[ScenarioContext], None]], ...]
    invariants: Tuple[
        Tuple[str, Callable[[ScenarioContext], Optional[str]]], ...]
    watch: Tuple[Tuple[str, Dict[str, str]], ...] = ()
    load: bool = True
    load_budget_s: float = 10.0
    load_threads: int = 2
    tight_roles: Tuple[str, ...] = ()   # beats clamped to SCENARIO_STALL_S


@dataclass
class ScenarioReport:
    name: str
    ok: bool
    violations: List[str] = field(default_factory=list)
    requests: int = 0
    failures: int = 0
    elapsed_s: float = 0.0
    notes: Dict = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"name": self.name, "ok": self.ok,
                "violations": self.violations,
                "requests": self.requests, "failures": self.failures,
                "elapsedS": round(self.elapsed_s, 3),
                "notes": self.notes}


def format_report(report: ScenarioReport) -> str:
    lines = [f"scenario {report.name}: "
             f"{'PASS' if report.ok else 'FAIL'} "
             f"({report.requests} requests, {report.failures} failed, "
             f"{report.elapsed_s:.1f}s)"]
    for v in report.violations:
        lines.append(f"  VIOLATED: {v}")
    for k, v in sorted(report.notes.items()):
        lines.append(f"  note {k} = {v}")
    return "\n".join(lines)


# -- topologies ----------------------------------------------------------------

def train_tiny(app_name: str = "chaosapp", access_key: str = "CHAOSKEY",
               device=None):
    """A fresh in-memory storage registry with a trained tiny
    recommendation instance (20 users x 15 items, rank 4), enough to
    serve real /queries.json under chaos without a dataset on disk,
    trained on `device` (None: `cuda`). Installs the registry as the
    process default and returns (registry, engine, instance)."""
    import numpy as np

    from predictionio_tpu_torch.core.params import EngineParams
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.data.event import DataMap, Event
    from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                     StorageRegistry,
                                                     set_default)
    from predictionio_tpu_torch.models import recommendation as rec

    registry = StorageRegistry({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM",
    })
    set_default(registry)
    apps = registry.get_meta_data_apps()
    app_id = apps.insert(App(0, app_name))
    registry.get_meta_data_access_keys().insert(
        AccessKey(access_key, app_id, ()))
    events = registry.get_events()
    events.init(app_id)
    rng = np.random.RandomState(0)
    for u in range(20):
        for i in range(15):
            if rng.rand() > 0.5:
                continue
            r = 5.0 if i % 3 == u % 3 else 1.0
            events.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": r})), app_id)
    engine = rec.RecommendationEngine.apply()
    params = EngineParams(
        data_source_params=("", rec.DataSourceParams(app_name=app_name)),
        algorithm_params_list=(
            ("als", rec.ALSAlgorithmParams(rank=4, num_iterations=4,
                                           seed=1)),))
    instance = CoreWorkflow.run_train(
        engine, params, RuntimeContext(registry=registry, device=device))
    return registry, engine, instance


def _tighten(roles: Sequence[str], budget_s: float) -> None:
    """Clamp the live budgets of the targeted roles so injected stalls
    are detected on scenario timescales instead of production ones."""
    for beat in watchdog().beats():
        if beat.role in roles and not beat.closed:
            beat.budget_s = min(beat.budget_s, budget_s)


def _serve(ctx: ScenarioContext, **kw):
    """A started prediction server of the scenario's instance on a
    loopback ephemeral port: `cli deploy`'s `deploy_instance` on
    `ctx.device`, `kw` to it."""
    from predictionio_tpu_torch.cli.main import deploy_instance
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    return deploy_instance(
        ctx.engine, ctx.instance,
        RuntimeContext(registry=ctx.registry, device=ctx.device),
        host="127.0.0.1", port=0, **kw)


def _router(ctx: ScenarioContext, timings: Dict, tenancy=None):
    """A started router with no replicas of its own on the scenario's
    store: the first one of a store takes the lease, a later one stands
    by for it."""
    from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
    router = FleetServer(None, fleet=FleetConfig(replicas=0, **timings),
                         host="127.0.0.1", port=0, registry=ctx.registry,
                         tenancy=tenancy, engine_variant=ctx.fleet_name)
    router.start()
    return router


def _setup_refreshing_server(ctx: ScenarioContext) -> None:
    srv = _serve(ctx, refresh_interval_s=0.2)
    ctx.server = srv
    ctx.servers.append(srv)
    ctx.ports = [srv.port]


def _setup_plain_server(ctx: ScenarioContext) -> None:
    srv = _serve(ctx)
    ctx.server = srv
    ctx.servers.append(srv)
    ctx.ports = [srv.port]
    # pre-fill the tsdb rings so the soft-watermark trim has something
    # measurable to release
    scraper = getattr(srv, "_scraper", None)
    if scraper is not None:
        now = time.time()
        for i in range(4):
            scraper.tick(now=now + i)


def _setup_router_pair(ctx: ScenarioContext, tenancy=None) -> None:
    """A leader and a standby router on the run's store and one replica
    that beats both; `tenancy` is the routers' admission."""
    from predictionio_tpu_torch.serving.fleet import ReplicaAgent
    # the replica's deploy (a model load and a warm) comes first: beside
    # a leader already up, its seconds of work could starve the leader's
    # renewals of a 0.5-s lease and hand the lease to the standby
    replica = _serve(ctx)
    ctx.servers.append(replica)
    leader = _router(ctx, FLEET_TIMINGS, tenancy=tenancy)
    standby = _router(ctx, FLEET_TIMINGS, tenancy=tenancy)
    agent = ReplicaAgent(
        replica,
        [f"http://127.0.0.1:{leader.port}",
         f"http://127.0.0.1:{standby.port}"],
        heartbeat_s=0.1)
    agent.start()
    ctx.leader, ctx.standby = leader, standby
    ctx.servers += [standby, leader]
    ctx.agents.append(agent)
    ctx.ports = [leader.port, standby.port]
    ctx.wait(lambda: leader.is_leader(), msg="first router takes lease")
    ctx.wait(lambda: _admitted_remote(leader) >= 1
             and _admitted_remote(standby) >= 1,
             msg="replica admitted on both routers")


def _admitted_remote(router) -> int:
    return sum(1 for r in list(router._replicas) if r.admitted)


def _setup_supervised(ctx: ScenarioContext) -> None:
    from predictionio_tpu_torch.serving.supervisor import (ChildSpec,
                                                           Supervisor,
                                                           stub_child_argv)
    router = _router(ctx, FLEET_TIMINGS)
    url = f"http://127.0.0.1:{router.port}"
    sup = Supervisor(
        [ChildSpec(f"stub{i}",
                   stub_child_argv(url, heartbeat_s=0.2, name=f"stub{i}"))
         for i in range(2)],
        grace_s=5.0, poll_s=0.1, backoff_base_s=0.3)
    sup.start()
    ctx.leader = router
    ctx.servers.append(router)
    ctx.supervisor = sup
    ctx.ports = [router.port]
    # child processes cold-start a Python interpreter: generous barrier
    ctx.wait(lambda: _admitted_remote(router) >= 2, timeout=30.0,
             msg="both stub replicas registered and admitted")


# -- steps --------------------------------------------------------------------

def _arm_stall(role: str, wedge_s: float = 30.0):
    def step(ctx: ScenarioContext) -> None:
        faults().arm(f"thread.{role}.stall", latency=wedge_s, times=1)
    return step


def _arm_die(role: str):
    def step(ctx: ScenarioContext) -> None:
        faults().arm(f"thread.{role}.die", error=FaultError, times=1)
    return step


def _arm_soft_pressure(checks: int = 40):
    def step(ctx: ScenarioContext) -> None:
        faults().arm("mem.pressure.soft", times=checks)
    return step


def _vanish_leader_lease(ctx: ScenarioContext) -> None:
    """Simulate the LEADER's lease thread dying (deterministically —
    the `thread.lease.die` seam would race leader vs standby): point
    the beat at a nonexistent thread ident. The sweep sees the thread
    vanished (non-restartable -> degrade, /ready flips) and the real
    loop exits Superseded on its next tick, so renewal stops and the
    lease expires for the standby to claim."""
    beat = ctx.leader._lease_beat
    if beat is None:
        raise ScenarioViolation("leader has no lease beat")
    ctx.note("killed_leader_port", ctx.leader.port)
    beat.thread_ident = -1


def _kill_one_replica(ctx: ScenarioContext) -> None:
    child = ctx.supervisor.find("stub0")
    if child is None or child.proc is None:
        raise ScenarioViolation("supervised child stub0 not running")
    ctx.note("killed_pid", child.proc.pid)
    t0 = time.perf_counter()
    child.proc.kill()                       # SIGKILL: no drain, no mercy
    ctx.wait(lambda: ctx.supervisor.alive_count() < 2
             or _admitted_remote(ctx.leader) < 2, timeout=10.0,
             msg="fleet/supervisor notices the kill")
    ctx.wait(lambda: ctx.supervisor.alive_count() >= 2
             and _admitted_remote(ctx.leader) >= 2, timeout=30.0,
             msg="killed replica respawned and re-admitted")
    ctx.note("recovery_s", round(time.perf_counter() - t0, 3))


# -- invariants ---------------------------------------------------------------

def _no_failed_requests(ctx: ScenarioContext) -> Optional[str]:
    if ctx.loader is None:
        return None
    fails = ctx.loader.failures
    if fails:
        return (f"{len(fails)}/{ctx.loader.requests} client requests "
                f"ultimately failed")
    return None


def _fired_once(role: str):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        d = ctx.delta("pio_watchdog_stalls_total", role=role)
        if d != 1:
            return f"watchdog stalls for {role}: {d:g} (expected 1)"
        return None
    return inv


def _died_once(role: str):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        d = ctx.delta("pio_thread_deaths_total", role=role)
        if d < 1:
            return f"no death counted for {role}"
        return None
    return inv


def _restarted(role: str, at_least: int = 1):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        d = ctx.delta("pio_thread_restarts_total", role=role)
        if d < at_least:
            return f"{role} restarted {d:g} times (expected >= {at_least})"
        return None
    return inv


def _refresher_recovered(ctx: ScenarioContext) -> Optional[str]:
    beat = ctx.server._refresher.beat
    if beat is None:
        return "refresher beat gone"
    if beat.degraded:
        return f"refresher degraded: {beat.reason}"
    age = beat.age()
    if age > 1.5:
        return f"refresher not ticking (beat age {age:.2f}s)"
    return None


def _standby_took_over(ctx: ScenarioContext) -> Optional[str]:
    if not ctx.standby.is_leader():
        return "standby never took the lease"
    return None


def _old_leader_degraded(ctx: ScenarioContext) -> Optional[str]:
    ready, detail = ctx.leader.readiness()
    if ready:
        return "old leader still reports ready after lease-loop death"
    if "lease" not in detail.get("degradedLoops", []):
        return f"lease not in degradedLoops: {detail}"
    return None


def _memory_shed(ctx: ScenarioContext) -> Optional[str]:
    d = ctx.delta("pio_shed_total", surface="memory", app="")
    if d < 1:
        return "no requests shed with surface=memory"
    return None


def _memory_trimmed(ctx: ScenarioContext) -> Optional[str]:
    freed = sum(
        ctx.delta("pio_mem_trimmed_bytes_total", target=t)
        for t in ("tsdb", "trace", "quality", "tenant_keys",
                  "ingest_cache"))
    if ctx.delta("pio_mem_trims_total", target="tsdb") < 1:
        return "soft watermark never ran a trim pass"
    if freed <= 0:
        return "trim passes released no measurable bytes"
    ctx.note("trimmed_bytes", int(freed))
    return None


def _pressure_recovered(ctx: ScenarioContext) -> Optional[str]:
    state = ctx.server._pressure.state
    if state != "ok":
        return f"pressure state still {state} after seam exhausted"
    ready, _ = ctx.server.readiness()
    if not ready:
        return "server not ready again after soft pressure cleared"
    return None


def _replica_respawned(ctx: ScenarioContext) -> Optional[str]:
    d = ctx.delta("pio_supervisor_respawns_total", child="stub0")
    if d != 1:
        return f"stub0 respawned {d:g} times (expected 1)"
    if ctx.supervisor.alive_count() < 2:
        return f"only {ctx.supervisor.alive_count()} children alive"
    rec = ctx.notes.get("recovery_s")
    if rec is None:
        return "recovery time never recorded"
    return None


# -- elastic fleet: topologies, steps, invariants -----------------------------

class _SignalLevel:
    """Chaos seam for the load LEVEL as the autoscaler sees it: the
    scenario scripts the ring aggregate (deterministic on chaos
    timescales, like every other fault seam) while the traffic hitting
    the router is real — what the invariants gate is the grow/drain/
    admission behavior under live fire, not the scraper's sampling
    luck."""

    def __init__(self) -> None:
        self._level = "calm"

    def set(self, level: str) -> None:
        self._level = level

    def __call__(self):
        from predictionio_tpu_torch.serving.autoscaler import Signals
        if self._level == "surge":
            return Signals(qps=400.0, p99_s=0.9, shed_rps=5.0)
        return Signals(qps=0.0, p99_s=0.001)


class _Stopper:
    """Adapts a background thread to the ctx.servers teardown
    protocol (append LAST so it is stopped FIRST)."""

    def __init__(self, ev: threading.Event, thread: threading.Thread):
        self._ev = ev
        self._thread = thread

    def stop(self) -> None:
        self._ev.set()
        self._thread.join(2.0)


def _setup_autoscaled(max_children: int):
    """Router + supervisor with ONE stub child + an enabled Autoscaler
    driven at chaos cadence by a scripted signal level."""
    def setup(ctx: ScenarioContext) -> None:
        from predictionio_tpu_torch.serving.autoscaler import (
            AutoscaleConfig, Autoscaler)
        from predictionio_tpu_torch.serving.supervisor import (
            ChildSpec, Supervisor, stub_child_argv)
        # eject needs headroom here: the invariant under test is that
        # RETIREMENT never reads as suspicion, so a stub child starved
        # of CPU for a couple of 0.1 s probe intervals by the loadsim
        # surge (the whole scenario shares one pytest process) must not
        # eject and fake a violation
        router = _router(ctx, dict(FLEET_TIMINGS, eject_threshold=8))
        url = f"http://127.0.0.1:{router.port}"

        def spec(name: str) -> ChildSpec:
            return ChildSpec(
                name, stub_child_argv(url, heartbeat_s=0.2, name=name))

        sup = Supervisor([spec("base0")], grace_s=5.0, poll_s=0.1,
                         backoff_base_s=0.3)
        sup.start()
        level = _SignalLevel()
        asc = Autoscaler(
            AutoscaleConfig(
                enabled=True, min_children=1, max_children=max_children,
                breach_ticks=2, idle_ticks=3, cooldown_s=0.4,
                flap_window_s=60.0, max_flips=8),
            supervisor=sup, fleet=router, spec_factory=spec,
            signals_fn=level)
        router.autoscaler = asc
        ctx.leader = router
        ctx.servers.append(router)
        ctx.supervisor = sup
        ctx.ports = [router.port]
        ctx.autoscaler = asc
        ctx.signal_level = level
        stop = threading.Event()

        def drive() -> None:
            while not stop.is_set():
                asc.tick()
                time.sleep(0.1)

        th = threading.Thread(target=drive, daemon=True,
                              name="pio-torch-chaos-autoscale")
        th.start()
        ctx.servers.append(_Stopper(stop, th))
        ctx.wait(lambda: _admitted_remote(router) >= 1, timeout=30.0,
                 msg="base replica registered and admitted")
    return setup


_FLASH_DOC = {
    "name": "chaos-flash", "seed": 11,
    "apps": [{
        "key": "CHAOSKEY", "name": "flashapp",
        "n_users": 5000, "n_items": 200, "zipf_s": 1.1,
        "phases": [{"kind": "flash", "duration_s": 8.0, "rps": 8.0,
                    "peak_rps": 60.0, "at_s": 1.0, "ramp_s": 0.5,
                    "hold_s": 3.0}],
    }],
}

_HOTKEY_DOC = {
    "name": "chaos-hotkey", "seed": 13,
    "apps": [{
        "key": "CHAOSKEY", "name": "hotapp",
        "n_users": 2000, "n_items": 50, "zipf_s": 1.1,
        "phases": [
            {"kind": "steady", "duration_s": 2.0, "rps": 30.0},
            {"kind": "hotkey", "duration_s": 4.0, "rps": 30.0,
             "hot_frac": 0.7, "hot_user": 3},
            {"kind": "steady", "duration_s": 2.0, "rps": 30.0},
        ],
    }],
}


def _note_loadsim(ctx: ScenarioContext, result) -> None:
    by = result.by_status()
    pct = result.percentiles()
    ctx.note("loadsim_requests", sum(by.values()))
    ctx.note("loadsim_errors",
             sum(v for s, v in by.items() if s not in (200, 429)))
    p999 = pct[99.9] * 1e3
    ctx.note("loadsim_p999_ms",
             round(p999, 2) if p999 != float("inf") else -1.0)


def _flash_hits(ctx: ScenarioContext) -> None:
    from predictionio_tpu_torch.tools import loadsim
    sc = loadsim.scenario_from_dict(_FLASH_DOC)
    runner = loadsim.LoadRunner(sc, ctx.ports, timeout_s=5.0)
    th = threading.Thread(target=runner.run, daemon=True,
                          name="pio-torch-chaos-loadsim")
    th.start()
    ctx.loadsim_runner = runner
    ctx.loadsim_thread = th
    ctx.signal_level.set("surge")
    ctx.wait(lambda: ctx.supervisor.alive_count() >= 2, timeout=25.0,
             msg="autoscaler grew a child under the flash crowd")
    ctx.wait(lambda: _admitted_remote(ctx.leader) >= 2, timeout=30.0,
             msg="scaled child admitted into routing")
    ctx.note("peak_children", ctx.supervisor.alive_count())


def _crowd_subsides(ctx: ScenarioContext) -> None:
    ctx.loadsim_thread.join(30.0)
    ctx.signal_level.set("calm")
    ctx.wait(lambda: ctx.autoscaler.target == 1, timeout=25.0,
             msg="autoscaler decided to scale back down")
    if not ctx.autoscaler.drain_idle(20.0):
        raise ScenarioViolation("retirement drain never finished")
    ctx.wait(lambda: ctx.supervisor.alive_count() == 1, timeout=10.0,
             msg="victim process stopped after drain")
    _note_loadsim(ctx, ctx.loadsim_runner.result)


def _diurnal_peak(ctx: ScenarioContext) -> None:
    ctx.signal_level.set("surge")
    ctx.wait(lambda: ctx.autoscaler.target >= 3
             and ctx.supervisor.alive_count() >= 3, timeout=40.0,
             msg="fleet grew 1 -> 3 through sustained breach")
    ctx.wait(lambda: _admitted_remote(ctx.leader) >= 3, timeout=30.0,
             msg="scaled children admitted into routing")
    ctx.note("peak_children", ctx.supervisor.alive_count())


def _diurnal_trough(ctx: ScenarioContext) -> None:
    ctx.signal_level.set("calm")
    ctx.wait(lambda: ctx.autoscaler.target == 1, timeout=40.0,
             msg="fleet shrank back to 1")
    if not ctx.autoscaler.drain_idle(25.0):
        raise ScenarioViolation("retirement drain never finished")
    ctx.wait(lambda: ctx.supervisor.alive_count() == 1, timeout=15.0,
             msg="victim processes stopped after drain")
    ctx.wait(lambda: _admitted_remote(ctx.leader) == 1, timeout=10.0,
             msg="membership forgets the retired children")


def _hot_key_fire(ctx: ScenarioContext) -> None:
    from predictionio_tpu_torch.tools import loadsim
    sc = loadsim.scenario_from_dict(_HOTKEY_DOC)
    sched = loadsim.build_schedule(sc)
    hot = sum(1 for ev in sched if ev.user == 3)
    ctx.note("hot_share", round(hot / max(len(sched), 1), 3))
    runner = loadsim.LoadRunner(sc, ctx.ports, timeout_s=5.0)
    _note_loadsim(ctx, runner.run(sched))


# one rate-limited tenant across a leader crash: the numbers the
# handoff-budget gate is computed from
BUDGET_RATE = 3.0
BUDGET_BURST = 15.0


class _BudgetHammer:
    """One-tenant closed hammer at a fixed attempt pace far above the
    rate limit, failing over to the NEXT port only on connection
    failure — a 429 is an answer (the budget spoke), not a reason to
    shop the same request to another router."""

    def __init__(self, ports: Sequence[int], key: str = "CHAOSKEY",
                 interval_s: float = 0.05, threads: int = 2):
        self.ports = list(ports)
        self.key = key
        self.interval_s = interval_s
        self.halt = threading.Event()
        self._lock = threading.Lock()
        self.samples: List[Tuple[float, int, int]] = []
        self.t0 = 0.0
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"pio-torch-chaos-budget-{i}")
            for i in range(threads)]

    def _attempt(self, port: int) -> int:
        try:
            status, _ = _http(
                port, "POST", f"/queries.json?accessKey={self.key}",
                {"user": "u1", "num": 2})
            return status
        except OSError:
            return -1

    def _run(self) -> None:
        while not self.halt.is_set():
            status, port = -1, self.ports[0]
            for port in self.ports:
                status = self._attempt(port)
                if status != -1:
                    break
            with self._lock:
                self.samples.append((time.monotonic(), port, status))
            time.sleep(self.interval_s)

    def start(self) -> "_BudgetHammer":
        self.t0 = time.monotonic()
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self.halt.set()
        for t in self._threads:
            t.join(5)

    def admitted(self, port: Optional[int] = None) -> int:
        with self._lock:
            return sum(1 for _, p, s in self.samples
                       if s == 200 and (port is None or p == port))


def _setup_budget_pair(ctx: ScenarioContext) -> None:
    from predictionio_tpu_torch.tenancy import TenancyConfig
    _setup_router_pair(ctx, TenancyConfig(enabled=True, rate=BUDGET_RATE,
                                          burst=BUDGET_BURST))
    ctx.hammer = _BudgetHammer(ctx.ports).start()


def _crash_leader(ctx: ScenarioContext) -> None:
    """Die the SIGKILL way: no drain, no lease release — the journaled
    bucket snapshot stays in the lease record for the standby to
    inherit on TTL expiry."""
    ctx.note("admitted_before_crash", ctx.hammer.admitted())
    ctx.leader.crash()
    ctx.wait(lambda: ctx.standby.is_leader(), timeout=10.0,
             msg="standby takes the lease after TTL expiry")


def _budget_settles(ctx: ScenarioContext) -> None:
    ctx.hammer.stop()
    elapsed = time.monotonic() - ctx.hammer.t0
    ctx.note("hammer_elapsed_s", round(elapsed, 2))
    ctx.note("admitted_total", ctx.hammer.admitted())
    ctx.note("admitted_standby",
             ctx.hammer.admitted(port=ctx.standby.port))
    # rate x wall-time + ONE burst, plus slack for the journal staleness
    # at the instant of the crash (one lease TTL of refill)
    budget = (BUDGET_RATE * elapsed + BUDGET_BURST
              + BUDGET_RATE * 2 * FLEET_TIMINGS["lease_ttl_s"] + 2)
    ctx.note("admitted_budget", round(budget, 1))


def _scaled_back_to_base(ctx: ScenarioContext) -> Optional[str]:
    alive = ctx.supervisor.alive_count()
    if alive != 1:
        return f"{alive} children alive at end (expected 1)"
    if ctx.autoscaler.target != 1:
        return f"autoscaler target {ctx.autoscaler.target} at end"
    return None


def _peaked(n: int):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        peak = ctx.notes.get("peak_children", 0)
        if peak < n:
            return f"peak children {peak} (expected >= {n})"
        return None
    return inv


def _scale_decisions(ups: int, downs: int):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        du = ctx.delta("pio_autoscale_decisions_total", direction="up")
        dd = ctx.delta("pio_autoscale_decisions_total",
                       direction="down")
        if du < ups or dd < downs:
            return (f"decisions up={du:g} down={dd:g} "
                    f"(expected >= {ups}/{downs})")
        return None
    return inv


def _retirement_not_suspicion(victims: int):
    """The scale-down path must read as RETIRE at every layer: no
    eject transitions, no crash-loop respawn accounting for the
    scaled children."""
    def inv(ctx: ScenarioContext) -> Optional[str]:
        ejected = ctx.delta("pio_fleet_transitions_total",
                            event="eject")
        if ejected > 0:
            return (f"scale-down fed the suspicion/eject machinery "
                    f"({ejected:g} eject transitions)")
        retired = ctx.delta("pio_fleet_transitions_total",
                            event="retire")
        if retired < victims:
            return (f"retire transitions {retired:g} "
                    f"(expected >= {victims})")
        for name in ("scale1", "scale2"):
            if ctx.delta("pio_supervisor_respawns_total",
                         child=name) > 0:
                return f"retired child {name} hit the crash-loop breaker"
        return None
    return inv


def _loadsim_clean(p999_gate_ms: float = 2500.0):
    def inv(ctx: ScenarioContext) -> Optional[str]:
        errs = ctx.notes.get("loadsim_errors")
        if errs is None:
            return "loadsim result never recorded"
        if errs:
            return f"{errs} loadsim requests errored"
        p999 = ctx.notes.get("loadsim_p999_ms", -1.0)
        if not 0 <= p999 <= p999_gate_ms:
            return (f"loadsim p99.9 {p999}ms outside the "
                    f"{p999_gate_ms}ms gate")
        return None
    return inv


def _hot_pivot_skewed(ctx: ScenarioContext) -> Optional[str]:
    share = ctx.notes.get("hot_share", 0.0)
    if not 0.2 <= share <= 0.6:
        return f"hot-user share {share} outside the pivot band [0.2, 0.6]"
    return None


def _budget_respected(ctx: ScenarioContext) -> Optional[str]:
    admitted = ctx.notes.get("admitted_total", 0)
    budget = ctx.notes.get("admitted_budget", 0.0)
    if admitted > budget:
        return (f"{admitted} admits across the handoff exceed the "
                f"budget {budget} (double-burst regression)")
    if admitted < 1:
        return "hammer never got a single 200"
    return None


def _service_continued(ctx: ScenarioContext) -> Optional[str]:
    if not ctx.standby.is_leader():
        return "standby never took the lease"
    if ctx.notes.get("admitted_standby", 0) < 1:
        return "standby admitted nothing after the leader crash"
    return None


# -- the registry -------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def _define(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


_define(Scenario(
    name="refresher-stall",
    description="wedge the freshness loop; watchdog stack-dumps, "
                "supersedes, respawns; freshness recovers",
    duration_s=6.0,
    setup=_setup_refreshing_server,
    tight_roles=("refresher",),
    watch=(("pio_watchdog_stalls_total", {"role": "refresher"}),
           ("pio_thread_restarts_total", {"role": "refresher"})),
    steps=((1.0, "wedge refresher tick for 30s",
            _arm_stall("refresher")),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("watchdog fired exactly once",
                 _fired_once("refresher")),
                ("refresher restarted", _restarted("refresher")),
                ("freshness loop ticking again", _refresher_recovered)),
))

_define(Scenario(
    name="refresher-die",
    description="kill the freshness loop; death counted, respawned "
                "with backoff",
    duration_s=5.0,
    setup=_setup_refreshing_server,
    tight_roles=("refresher",),
    watch=(("pio_thread_deaths_total", {"role": "refresher"}),
           ("pio_thread_restarts_total", {"role": "refresher"})),
    steps=((1.0, "inject uncaught exception into refresher",
            _arm_die("refresher")),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("death counted", _died_once("refresher")),
                ("refresher restarted", _restarted("refresher")),
                ("freshness loop ticking again", _refresher_recovered)),
))

_define(Scenario(
    name="lease-failover",
    description="the leader's lease loop dies; its /ready degrades and "
                "the standby takes the lease on TTL expiry",
    duration_s=6.0,
    setup=_setup_router_pair,
    load_budget_s=15.0,
    steps=((1.5, "leader lease thread vanishes",
            _vanish_leader_lease),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("standby took the lease", _standby_took_over),
                ("old leader /ready degraded", _old_leader_degraded)),
))

_define(Scenario(
    name="mem-soft",
    description="forced soft watermark: bounded state trimmed, new "
                "work shed 503 surface=memory, full recovery",
    duration_s=6.0,
    setup=_setup_plain_server,
    load_budget_s=15.0,
    watch=(("pio_shed_total", {"surface": "memory", "app": ""}),
           ("pio_mem_trims_total", {"target": "tsdb"}),
           ("pio_mem_trimmed_bytes_total", {"target": "tsdb"}),
           ("pio_mem_trimmed_bytes_total", {"target": "trace"}),
           ("pio_mem_trimmed_bytes_total", {"target": "quality"}),
           ("pio_mem_trimmed_bytes_total", {"target": "tenant_keys"}),
           ("pio_mem_trimmed_bytes_total", {"target": "ingest_cache"})),
    steps=((0.5, "force soft watermark for ~2s of sweeps",
            _arm_soft_pressure(40)),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("new work shed surface=memory", _memory_shed),
                ("bounded state trimmed", _memory_trimmed),
                ("pressure cleared, serving again",
                 _pressure_recovered)),
))

_define(Scenario(
    name="replica-kill",
    description="SIGKILL one supervised replica; the supervisor "
                "respawns it and it re-registers into routing",
    duration_s=10.0,
    setup=_setup_supervised,
    load_budget_s=20.0,
    watch=(("pio_supervisor_respawns_total", {"child": "stub0"}),),
    steps=((1.0, "SIGKILL stub0 and await respawn+re-admission",
            _kill_one_replica),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("replica respawned and fleet whole",
                 _replica_respawned)),
))


_define(Scenario(
    name="flash-crowd",
    description="loadsim flash step against an autoscaled fleet: "
                "1 -> 2 under the surge, graceful drain back to 1, "
                "zero victim drops",
    duration_s=14.0,
    setup=_setup_autoscaled(max_children=2),
    load_budget_s=20.0,
    watch=(("pio_autoscale_decisions_total", {"direction": "up"}),
           ("pio_autoscale_decisions_total", {"direction": "down"}),
           ("pio_fleet_transitions_total", {"event": "eject"}),
           ("pio_fleet_transitions_total", {"event": "retire"}),
           ("pio_supervisor_respawns_total", {"child": "scale1"}),
           ("pio_supervisor_respawns_total", {"child": "scale2"})),
    steps=((0.5, "flash crowd arrives (loadsim + signal surge)",
            _flash_hits),
           (9.0, "crowd subsides; drain the scaled child",
            _crowd_subsides)),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("loadsim saw zero errors, p99.9 in gate",
                 _loadsim_clean()),
                ("fleet peaked at >= 2 children", _peaked(2)),
                ("fleet back to 1 child", _scaled_back_to_base),
                ("scale decisions counted", _scale_decisions(1, 1)),
                ("retirement never read as suspicion",
                 _retirement_not_suspicion(1))),
))

_define(Scenario(
    name="diurnal-1-N-1",
    description="two-stage diurnal swing: 1 -> 3 -> 1 with hysteresis "
                "and per-victim graceful drain; eject/respawn counters "
                "must not move",
    duration_s=16.0,
    setup=_setup_autoscaled(max_children=3),
    load_budget_s=20.0,
    watch=(("pio_autoscale_decisions_total", {"direction": "up"}),
           ("pio_autoscale_decisions_total", {"direction": "down"}),
           ("pio_fleet_transitions_total", {"event": "eject"}),
           ("pio_fleet_transitions_total", {"event": "retire"}),
           ("pio_supervisor_respawns_total", {"child": "scale1"}),
           ("pio_supervisor_respawns_total", {"child": "scale2"})),
    steps=((0.5, "morning peak: sustained breach to 3 children",
            _diurnal_peak),
           (8.0, "evening trough: drain back to 1", _diurnal_trough)),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("fleet peaked at 3 children", _peaked(3)),
                ("fleet back to 1 child", _scaled_back_to_base),
                ("scale decisions counted", _scale_decisions(2, 2)),
                ("retirement never read as suspicion",
                 _retirement_not_suspicion(2))),
))

_define(Scenario(
    name="hot-key",
    description="loadsim hot-key pivot (70% of arrivals onto one user) "
                "against a real server: zero errors, p99.9 in gate",
    duration_s=10.0,
    setup=_setup_plain_server,
    load_budget_s=15.0,
    steps=((0.3, "run the hot-key trace (steady / pivot / steady)",
            _hot_key_fire),),
    invariants=(("zero failed client requests", _no_failed_requests),
                ("loadsim saw zero errors, p99.9 in gate",
                 _loadsim_clean()),
                ("pivot actually skewed onto the hot user",
                 _hot_pivot_skewed)),
))

_define(Scenario(
    name="handoff-budget",
    description="one rate-limited tenant across a leader crash: total "
                "admits on both routers stay within rate x wall-time "
                "+ one burst (journaled bucket inheritance)",
    duration_s=9.0,
    setup=_setup_budget_pair,
    load=False,                      # the budget hammer IS the load
    steps=((3.0, "leader crashes (no drain, no lease release)",
            _crash_leader),
           (8.0, "stop the hammer; compute the admit budget",
            _budget_settles)),
    invariants=(("admits within rate x time + one burst",
                 _budget_respected),
                ("standby took over and kept serving",
                 _service_continued)),
))


def names() -> List[str]:
    return sorted(SCENARIOS)


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; have: {', '.join(names())}")


# -- the runner ---------------------------------------------------------------

def run(name_or_scenario, trained=None, device=None) -> ScenarioReport:
    """Execute one scenario end to end: build the topology, start the
    open-loop load, fire the timed steps, evaluate the invariants,
    tear everything down. Returns the report; `ok=False` on any
    violated invariant (the CLI maps that to a non-zero exit).
    `trained` is (registry, engine, instance), by default `train_tiny`
    on `device`; the servers deploy the instance on `device` (None:
    `cuda`)."""
    sc = (name_or_scenario if isinstance(name_or_scenario, Scenario)
          else get(name_or_scenario))
    wd = watchdog()
    saved = (wd.stall_s, wd.interval_s)
    faults().clear()
    violations: List[str] = []
    ctx = ScenarioContext(
        trained if trained is not None else train_tiny(device=device),
        device=device)
    t_start = time.perf_counter()
    try:
        wd.stall_s, wd.interval_s = SCENARIO_STALL_S, SCENARIO_SWEEP_S
        wd.ensure_started()
        _log.info("scenario_setup", scenario=sc.name)
        sc.setup(ctx)
        if sc.tight_roles:
            _tighten(sc.tight_roles, SCENARIO_STALL_S)
        for metric_name, labels in sc.watch:
            ctx.mark(metric_name, **labels)
        if sc.load:
            ctx.loader = OpenLoopLoader(
                ctx.ports, threads=sc.load_threads,
                budget_s=sc.load_budget_s).start()
        t0 = time.perf_counter()
        for at_s, label, action in sorted(sc.steps, key=lambda s: s[0]):
            delay = t0 + at_s - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            _log.info("scenario_step", scenario=sc.name, at_s=at_s,
                      step=label)
            try:
                action(ctx)
            except ScenarioViolation as e:
                violations.append(f"step '{label}': {e}")
            except Exception as e:   # noqa: BLE001 — fail loud, run on
                violations.append(
                    f"step '{label}' crashed: {type(e).__name__}: {e}")
        tail = t0 + sc.duration_s - time.perf_counter()
        if tail > 0:
            time.sleep(tail)
        if ctx.loader is not None:
            ctx.loader.stop()
        for label, inv in sc.invariants:
            try:
                problem = inv(ctx)
            except ScenarioViolation as e:
                problem = str(e)
            except Exception as e:   # noqa: BLE001 — fail loud, run on
                problem = f"invariant crashed: {type(e).__name__}: {e}"
            if problem:
                violations.append(f"{label}: {problem}")
    finally:
        faults().clear()
        if ctx.loader is not None:
            ctx.loader.stop()
        if ctx.supervisor is not None:
            try:
                ctx.supervisor.stop()
            except Exception:   # noqa: BLE001 — teardown best-effort
                pass
        for agent in ctx.agents:
            try:
                agent.stop()
            except Exception:   # noqa: BLE001 — teardown best-effort
                pass
        for srv in reversed(ctx.servers):
            try:
                srv.stop()
            except Exception:   # noqa: BLE001 — teardown best-effort
                pass
        wd.stall_s, wd.interval_s = saved
    report = ScenarioReport(
        name=sc.name, ok=not violations, violations=violations,
        requests=ctx.loader.requests if ctx.loader is not None else 0,
        failures=len(ctx.loader.failures) if ctx.loader is not None
        else 0,
        elapsed_s=time.perf_counter() - t_start, notes=ctx.notes)
    _log.info("scenario_done", scenario=sc.name, ok=report.ok,
              violations=len(violations))
    return report
