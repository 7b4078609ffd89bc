"""Replica supervisor: child processes with respawn, backoff, breaker.

The port of `predictionio_tpu/serving/supervisor.py`. `cli deploy
--supervised N` runs N replicas as child processes of a router-only
fleet instead of in-process replicas: a replica that crashes, runs out
of memory or is SIGKILLed takes down one process, not the plane. The
supervisor:

  - spawns each child from a `ChildSpec` argv (the CLI builds them from
    its own argv: the same deploy flags, `--join` back to the router and
    an ephemeral port; `child_argv_from_parent`) and watches their exits
    on a `pio-torch-supervisor` thread, which beats the watchdog;
  - respawns a dead child after a jittered exponential backoff, so that
    a fast-crashing child cannot hot-loop the host;
  - gives up on a slot after `breaker_k` deaths inside
    `breaker_window_s` (the fleet serves on with the others);
  - stops SIGTERM first: each child gets `grace_s` for its graceful
    drain (`install_signal_handlers` routes SIGTERM to
    `PredictionServer.stop()`), then SIGKILL.

A child runs `python -m predictionio_tpu_torch.cli deploy ...` and
registers through its `ReplicaAgent`, so a respawned replica is routed
again within one heartbeat with no supervisor-to-router coupling. Each
child is a whole process with its own CUDA context and its own plan
(K1 on the card it shares); the kernel library is built once, by the
first process to need it, and loaded from `_build/` by the others.

`python -m predictionio_tpu_torch.serving.supervisor --stub ...` runs
the stub child of the tests: a minimal HTTP replica (a canned
`/queries.json`, an honest `/ready`) that registers through a real
`ReplicaAgent`, with no model load.

The autoscaler (`serving/autoscaler.py`) changes the set at runtime:
`grow(spec)` adds a slot and spawns it (a duplicate name is refused),
`retire(name)` marks the child retiring, SIGTERMs it, SIGKILLs it after
`grace_s` and removes its slot. A retiring child's exit is a decision,
not a death: the watch loop skips it, so it is never respawned, backed
off or counted by the breaker or `pio_supervisor_respawns_total`.

Metrics: `pio_supervisor_children{state}` (alive/backoff/given_up) and
`pio_supervisor_respawns_total{child}`.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from predictionio_tpu_torch.obs import get_logger, get_registry
from predictionio_tpu_torch.resilience.watchdog import watchdog

_log = get_logger("supervisor")

DEFAULT_GRACE_S = 10.0
BACKOFF_BASE_S = 0.5
BACKOFF_MAX_S = 10.0
BREAKER_K = 5
BREAKER_WINDOW_S = 60.0


@dataclass
class ChildSpec:
    """One supervised child: a name for logs/metrics plus the argv to
    exec. `env` entries overlay the parent environment."""
    name: str
    argv: List[str]
    env: Dict[str, str] = field(default_factory=dict)


class _Child:
    """Runtime state for one supervised slot."""

    def __init__(self, spec: ChildSpec):
        self.spec = spec
        self.proc: Optional[subprocess.Popen] = None
        self.death_times: List[float] = []
        self.next_spawn_at: Optional[float] = None
        self.given_up = False
        self.respawns = 0
        self.last_rc: Optional[int] = None
        # scale-down in progress: the exit is a decision, not a death
        self.retiring = False

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def snapshot(self) -> Dict:
        return {"name": self.spec.name, "alive": self.alive,
                "pid": self.proc.pid if self.proc is not None else None,
                "respawns": self.respawns, "givenUp": self.given_up,
                "retiring": self.retiring, "lastRc": self.last_rc}


class Supervisor:
    """Spawn, watch, respawn, and gracefully stop child replicas."""

    def __init__(self, specs: Sequence[ChildSpec], *,
                 grace_s: float = DEFAULT_GRACE_S,
                 poll_s: float = 0.2,
                 backoff_base_s: float = BACKOFF_BASE_S,
                 backoff_max_s: float = BACKOFF_MAX_S,
                 breaker_k: int = BREAKER_K,
                 breaker_window_s: float = BREAKER_WINDOW_S):
        self.grace_s = grace_s
        self.poll_s = poll_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.breaker_k = max(1, breaker_k)
        self.breaker_window_s = breaker_window_s
        self._children = [_Child(s) for s in specs]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beat = None                # watchdog liveness stamp
        reg = get_registry()
        self._respawns = reg.counter(
            "pio_supervisor_respawns_total",
            "Child replicas respawned after an unexpected exit",
            labels=("child",))
        self._state_gauge = reg.gauge(
            "pio_supervisor_children",
            "Supervised children by state", labels=("state",))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Supervisor":
        for child in self._children:
            self._spawn_child(child)
        if self.beat is None:
            self.beat = watchdog().register(
                "supervisor", budget_s=self.poll_s * 10.0 + 5.0,
                restart=self._spawn_monitor)
            watchdog().ensure_started()
        self._spawn_monitor()
        return self

    def _spawn_monitor(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """SIGTERM every child, give each `grace_s` for its graceful
        drain, SIGKILL the stragglers, then stop the monitor."""
        self._stop.set()
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()
        procs = [c.proc for c in self._children if c.alive]
        for proc in procs:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + self.grace_s
        for proc in procs:
            _reap(proc, max(deadline - time.monotonic(), 0.05))
        t = self._thread
        if t is not None:
            t.join(timeout=self.poll_s * 10.0 + 5.0)
        self._export_states()

    # -- introspection ------------------------------------------------------
    def children(self) -> List[Dict]:
        with self._lock:
            return [c.snapshot() for c in self._children]

    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for c in self._children if c.alive)

    def find(self, name: str) -> Optional[_Child]:
        with self._lock:
            for c in self._children:
                if c.spec.name == name:
                    return c
        return None

    # -- elastic grow/retire ------------------------------------------------
    def grow(self, spec: ChildSpec) -> None:
        """Add one slot at runtime and spawn it (the autoscaler's scale-
        up); it is respawned and breaker-guarded like the others."""
        if self.find(spec.name) is not None:
            raise ValueError(f"child {spec.name!r} already supervised")
        child = _Child(spec)
        with self._lock:
            self._children.append(child)
        self._spawn_child(child)
        self._export_states()

    def retire(self, name: str, grace_s: Optional[float] = None) -> bool:
        """Stop one child, SIGTERM first, SIGKILL after `grace_s`, and
        remove its slot (the autoscaler's scale-down). The retiring flag
        keeps the watch loop from counting the exit as a death. False
        when no such child exists."""
        child = self.find(name)
        if child is None:
            return False
        child.retiring = True
        proc = child.proc
        if proc is not None and child.alive:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            _reap(proc, self.grace_s if grace_s is None else grace_s)
        with self._lock:
            self._children = [c for c in self._children if c is not child]
        _log.info("supervisor_child_retired", child=name)
        self._export_states()
        return True

    # -- spawning -----------------------------------------------------------
    def _spawn_child(self, child: _Child) -> None:
        env = dict(os.environ)
        env.update(child.spec.env)
        try:
            child.proc = subprocess.Popen(child.spec.argv, env=env)
        except OSError as e:
            child.last_rc = -1
            _log.error("supervisor_spawn_failed", child=child.spec.name,
                       error=f"{type(e).__name__}: {e}")
            self._on_death(child, time.monotonic())
            return
        child.next_spawn_at = None
        _log.info("supervisor_child_started", child=child.spec.name,
                  pid=child.proc.pid)

    def _on_death(self, child: _Child, now: float) -> None:
        child.death_times = [t for t in child.death_times
                             if now - t <= self.breaker_window_s]
        child.death_times.append(now)
        if len(child.death_times) >= self.breaker_k:
            child.given_up = True
            _log.error("supervisor_crash_loop_giveup",
                       child=child.spec.name,
                       deaths=len(child.death_times))
            return
        n = len(child.death_times)
        backoff = min(self.backoff_base_s * (2.0 ** (n - 1)),
                      self.backoff_max_s)
        backoff *= 1.0 + random.random() * 0.25     # jitter
        child.next_spawn_at = now + backoff
        _log.warning("supervisor_respawn_scheduled",
                     child=child.spec.name, rc=child.last_rc,
                     backoff_s=round(backoff, 3))

    # -- the watch loop -----------------------------------------------------
    def _loop(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._loop_body)
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        beat = self.beat
        while not self._stop.wait(self.poll_s):
            if beat is not None:
                beat.tick()
            self.poll_once()

    def poll_once(self) -> None:
        """One supervision pass (public so tests drive it
        synchronously): reap exits, schedule/execute respawns."""
        now = time.monotonic()
        with self._lock:
            children = list(self._children)
        for child in children:
            if child.given_up or child.retiring:
                continue
            if child.next_spawn_at is not None:
                if now >= child.next_spawn_at and not self._stop.is_set():
                    child.respawns += 1
                    self._respawns.labels(child=child.spec.name).inc()
                    self._spawn_child(child)
                continue
            proc = child.proc
            if proc is None:
                continue
            rc = proc.poll()
            if rc is None:
                continue
            child.last_rc = rc
            _log.warning("supervisor_child_died", child=child.spec.name,
                         rc=rc, pid=proc.pid)
            self._on_death(child, now)
        self._export_states()

    def _export_states(self) -> None:
        alive = backoff = given_up = 0
        for c in self._children:
            if c.given_up:
                given_up += 1
            elif c.alive:
                alive += 1
            else:
                backoff += 1
        g = self._state_gauge
        g.labels(state="alive").set(float(alive))
        g.labels(state="backoff").set(float(backoff))
        g.labels(state="given_up").set(float(given_up))


def _reap(proc: subprocess.Popen, grace_s: float) -> None:
    """Wait `grace_s` for a SIGTERMed child, then SIGKILL it."""
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        _log.warning("supervisor_sigkill_straggler", pid=proc.pid)
        try:
            proc.kill()
            proc.wait(timeout=5.0)
        except (OSError, subprocess.TimeoutExpired):
            pass


def child_argv_from_parent(argv: Sequence[str], router_url: str,
                           extra: Sequence[str] = ()) -> List[str]:
    """A supervised child's argv from the parent's CLI argv (after the
    program): the same deploy flags, less those a child must not
    inherit (supervision, replica count, port, join, advertise, the
    autoscaler's, member name, standby), plus `--join` back to the router
    and an ephemeral port. The child runs the port's own CLI."""
    drop_with_value = {"--supervised", "--replicas", "--port", "--join",
                       "--advertise", "--autoscale", "--autoscale-min",
                       "--autoscale-max", "--member-name"}
    drop_bare = {"--standby"}
    out: List[str] = []
    skip = False
    for arg in argv:
        if skip:
            skip = False
            continue
        key = arg.split("=", 1)[0]
        if key in drop_with_value:
            skip = "=" not in arg
            continue
        if key in drop_bare:
            continue
        out.append(arg)
    out += ["--join", router_url, "--port", "0", *extra]
    return [sys.executable, "-m", "predictionio_tpu_torch.cli", *out]


def stub_child_argv(routers: str, server_key: str = "",
                    heartbeat_s: float = 0.5,
                    name: str = "stub") -> List[str]:
    """The argv of the stub replica (this module's main)."""
    argv = [sys.executable, "-m", "predictionio_tpu_torch.serving.supervisor",
            "--stub", "--routers", routers,
            "--heartbeat", str(heartbeat_s), "--name", name]
    if server_key:
        argv += ["--key", server_key]
    return argv


# -- the stub child ----------------------------------------------------------

def _run_stub(routers: List[str], server_key: str,
              heartbeat_s: float, name: str) -> int:
    """A minimal replica process: HTTPServerBase serving a canned
    /queries.json + honest /ready, registered with the routers through
    a REAL ReplicaAgent — the full process lifecycle (register,
    heartbeat, SIGTERM drain, SIGKILL death, respawn re-register)
    without a model load. Exits 0 on SIGTERM."""
    from predictionio_tpu_torch.serving.fleet import ReplicaAgent
    from predictionio_tpu_torch.utils.http import HTTPServerBase, Response

    class _StubReplica(HTTPServerBase):
        def __init__(self):
            super().__init__(host="127.0.0.1", port=0)
            self.instance = f"stub-{name}"

            @self.router.post("/queries.json")
            def queries(req):
                return Response.json(
                    {"itemScores": [], "stub": name,
                     "pid": os.getpid()})

        def readiness(self):
            return (True, {"stub": name})

        def current_instance_id(self) -> str:
            return self.instance

    server = _StubReplica()
    server.start(background=True)
    agent = ReplicaAgent(server, routers, server_key=server_key,
                         heartbeat_s=heartbeat_s, member_name=name)
    agent.start()
    done = threading.Event()

    def _term(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    done.wait()   # until SIGTERM or SIGINT
    agent.stop()
    server.shutdown()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="predictionio_tpu_torch.serving.supervisor",
        description="the stub supervised replica of the tests")
    ap.add_argument("--stub", action="store_true", required=True)
    ap.add_argument("--routers", required=True,
                    help="comma-separated router URLs")
    ap.add_argument("--key", default="")
    ap.add_argument("--heartbeat", type=float, default=0.5)
    ap.add_argument("--name", default="stub")
    args = ap.parse_args(argv)
    routers = [u for u in args.routers.split(",") if u]
    return _run_stub(routers, args.key, args.heartbeat, args.name)


if __name__ == "__main__":   # pragma: no cover
    raise SystemExit(main())
