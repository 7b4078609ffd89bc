"""Fleet control plane: serving from several processes, leases, rolling
reloads, the cross-host catalog mesh.

The port of `predictionio_tpu/serving/fleet.py`. `cli deploy --replicas N`
puts N in-process `PredictionServer` replicas (each with its own
micro-batcher, deployment and loopback port) behind a `FleetServer`;
`cli deploy --join http://router:8000` starts a standalone replica
anywhere that registers itself with the router(s) through a
`ReplicaAgent` and heartbeats; `cli deploy --supervised N` runs N such
replicas as child processes (`serving/supervisor.py`). In-process and
remote members share one membership table and are routed,
health-gated and rolled alike. The control plane:

  - gates routing on health: a member serves only while admitted.
    Remote members beat `POST /fleet/heartbeat` (model id, readiness,
    shard); the monitor thread probes every member's `/ready` each
    `health_interval_s`. Ejection needs `eject_threshold` consecutive
    suspicions and a stale heartbeat, except for data-path evidence (a
    transport error or a 5xx while routing), which ejects at the
    threshold alone. A good probe or a ready beat re-admits, after a
    post-eject quarantine.
  - routes `/queries.json` round-robin over admitted members over
    pooled kept-alive connections (`utils.wire.HTTPConnectionPool`) and
    retries a transport failure on the next member, so a member dying
    mid-request costs the client nothing; an HTTP answer (a 503 shed, a
    400) passes through. A member that left the rotation after a
    request picked it (an eject, a reload, a retirement) is skipped, so
    a drain that saw nothing in flight sees no later request. A request whose deadline is spent is shed 504
    before dialling (`pio_shed_total{surface="deadline"}`).
  - elects a leader through a TTL lease in the store every router
    shares (`Leases`): non-leaders answer `/queries.json` with 307 to
    the leader and refuse `/reload`. A dead leader's lease expires and
    a standby takes over, rebuilding membership from heartbeats and the
    persisted member snapshot.
  - rolls `/reload` (leader only) one member at a time: eject, drain,
    reload (the member's own rollback applies), probe, admit. Progress
    is journaled in the lease row, so the next leader resumes an
    interrupted roll. A member that dies mid-reload stays ejected and
    the roll goes on; a failed load (500, rolled back) is admitted
    again on the old model and aborts the roll; an unreachable member
    is skipped.
  - with `mesh="items=N@fleet"` merges catalog slices: in-process
    replica i serves `ShardSlice(N, i % N)` (`ops/topk_sharded.py`, K1
    over its rows only); remote members declare theirs in heartbeats.
    A query fans out to one admitted owner of every slice
    (`/shard/queries.json`) and the candidates merge by (-score,
    global id), with id dedupe: bit-identical to one card's plan when
    every slice answers, `partial: true` when a slice has no live
    owner.
  - is the tenancy boundary: it authenticates and charges a request
    once and asserts the identity to its replicas in a signed
    `X-PIO-App` (`tenancy/admission.py`); its spent token buckets ride
    the lease journal, so a standby that takes over adopts them.

Fault seams (`resilience.faults`): `fleet.net.<member>.heartbeat` drops
a member's probes and beats, `fleet.net.<member>.data` its proxied
queries. The health monitor and the lease loop beat the watchdog
(`resilience/watchdog.py`); a stalled or dead lease loop fails the
router's `/ready`, so that a standby takes the lease.

The JAX `FleetServer` builds its replicas from a `ServerConfig` and a
registry. The port's `PredictionServer` takes a loaded deployment, so
the port's router takes a `replica_factory(index, *, mesh, tenancy)`
that returns a started replica (`cli.main.fleet_replica_factory`, over
`deploy_instance`).

A router given a registry sweeps its stores once when it is made
(`data.fsck.startup_check`) and runs the scheduled fsck when
`PIO_FSCK_INTERVAL_S` is set; its replicas skip their own sweeps.

Traces (`obs/trace.py`): the router's own entry is `kind="router"`
(outside `pio_serve_seconds`, which the replica's serve entry owns), with
a `proxy:<member>` span per answered attempt, `proxy_retry:<member>` per
transport failure, `shard:<i/n>:<member>` and `shard_retry:<member>` on
the mesh fan-out; it asserts its signed child context in `X-PIO-Trace`
to the member, and to the client of a standby's 307, so that the hops
stitch under one trace id. A rolling reload is a `rolling_reload`
background span.

`GET /quality.json` gathers each admitted member's `/quality.json` under
its key (a member that does not answer is reported with its error).

Federation: the router's tsdb tick (`PIO_TSDB_INTERVAL_S`) also scrapes
every admitted member's `/metrics` over the pooled upstream connections
(2-s timeout each, the whole scrape inside the scraper's watchdog beat):
the last good text of each member is served again by `GET /federate`
with a `member` label on every sample, and the scrape derives the
per-member gauges `pio_fleet_member_qps`, `pio_fleet_member_p99_seconds`,
`pio_fleet_member_burn` and `pio_fleet_member_reactor_balance` into the
router's own ring (one `/tsdb.json` holds the fleet's history; `GET
/fleet.html` charts it, `tools/dashboard.py`). A failed scrape counts
`pio_fleet_metrics_scrapes_total{outcome="error"}` and is probe-grade
suspicion; the member's last good text stays. The same tick drives the
attached `autoscaler` (`serving/autoscaler.py`), which reads that ring.

Elastic scale-down: `retire_member` takes a member out of rotation as
state `retiring` (its beats neither re-admit nor eject it) and drains it;
it counts `pio_fleet_transitions_total{event="retire"}`, never an eject,
and leaves the suspicion counters alone. `forget_member` then drops it
from the table, the persisted snapshot, its `member` series of the
registry and the ring (unlike the JAX router, whose ring keeps a retired
member's last qps and p99 in the autoscaler's signals for good).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import re
import secrets
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence
from urllib.parse import urlencode

from predictionio_tpu_torch.data.storage.base import Model, StorageError
from predictionio_tpu_torch.obs import MetricsRegistry, get_logger, trace
from predictionio_tpu_torch.resilience import (DeadlineExceeded,
                                               OverloadedError,
                                               current_deadline, faults)
from predictionio_tpu_torch.resilience.watchdog import watchdog
from predictionio_tpu_torch.tenancy import (TENANT_HEADER,
                                            AdmissionController,
                                            TenancyConfig)
from predictionio_tpu_torch.utils.http import (HTTPError, HTTPServerBase,
                                               Request, Response,
                                               retry_after_header)
from predictionio_tpu_torch.utils.wire import (BIN_CONTENT_TYPE,
                                               HTTPConnectionPool,
                                               decode_bin_query)

_log = get_logger("fleet")

# forwarded to the member verbatim (deadline, request id, auth, body
# type, the tenant and trace assertions; the router's own assertions win)
_FORWARD_HEADERS = ("X-PIO-Deadline-Ms", "X-Request-ID", "Authorization",
                    "Content-Type", TENANT_HEADER, trace.TRACE_HEADER)

# the model-store id of the persisted member snapshot (per variant), as
# the JAX package names it
_MEMBERS_BLOB_PREFIX = "__fleet_members__"

ReplicaFactory = Callable[..., Any]


def measure_store_rtt(leases, holder: str, samples: int = 3) -> float:
    """Median compare-and-swap round trip of the lease store, over a
    throwaway probe lease. A lease TTL within a few of these would flap
    leadership on every slow write."""
    name = f"__rtt_probe__{holder or 'fleet'}"
    times = []
    for _ in range(max(1, samples)):
        t0 = time.perf_counter()
        try:
            leases.acquire(name, holder, 1.0)
            leases.release(name, holder)
        except Exception:  # noqa: BLE001 — a failed probe measures nothing
            continue
        times.append(time.perf_counter() - t0)
    if not times:
        return 0.0
    times.sort()
    return times[len(times) // 2]


# a proxied attempt's timeout when the request has no deadline
PROXY_TIMEOUT_S = 30.0
# one member's /reload budget during a roll
RELOAD_TIMEOUT_S = 120.0


@dataclass
class FleetConfig:
    """Control-plane knobs."""
    replicas: int = 3
    health_interval_s: float = 1.0     # the /ready probe cadence
    # consecutive suspicions before ejection (PIO_FLEET_SUSPECT_N)
    eject_threshold: int = 3
    # a roll's wait for a member's in-flight requests
    drain_timeout_s: float = 10.0
    # remote heartbeat cadence; 0 = health_interval_s
    # (PIO_FLEET_HEARTBEAT_S)
    heartbeat_s: float = 0.0
    # the leader lease's TTL (PIO_FLEET_LEASE_TTL_S)
    lease_ttl_s: float = 10.0
    # "host:port" other hosts reach this router at (default
    # 127.0.0.1:<bound port>)
    advertise: str = ""

    def effective_heartbeat_s(self) -> float:
        return self.heartbeat_s if self.heartbeat_s > 0 \
            else self.health_interval_s


def fleet_config_from_env(cfg: Mapping[str, str], **overrides) -> FleetConfig:
    """A FleetConfig from environment-style config: PIO_FLEET_LEASE_TTL_S,
    PIO_FLEET_HEARTBEAT_S, PIO_FLEET_SUSPECT_N; `overrides` win."""
    kw: Dict[str, object] = {}
    try:
        if cfg.get("PIO_FLEET_LEASE_TTL_S"):
            kw["lease_ttl_s"] = float(cfg["PIO_FLEET_LEASE_TTL_S"])
        if cfg.get("PIO_FLEET_HEARTBEAT_S"):
            kw["heartbeat_s"] = float(cfg["PIO_FLEET_HEARTBEAT_S"])
        if cfg.get("PIO_FLEET_SUSPECT_N"):
            kw["eject_threshold"] = int(cfg["PIO_FLEET_SUSPECT_N"])
    except ValueError as e:
        raise ValueError(f"bad PIO_FLEET_* value: {e}") from e
    kw.update(overrides)
    return FleetConfig(**kw)


class _Replica:
    """One member and its routing state: an in-process replica
    (`server` set, a loopback port) or a remote one that registered
    over HTTP (`server` None: an address and its heartbeats)."""

    def __init__(self, index: int, server=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.index = index
        self.server = server
        self.host = host
        self.port = port
        self.lock = threading.Lock()
        self.admitted = False
        # starting|serving|ejected|reloading|dead|stopping|retiring
        self.state = "starting"
        self.failures = 0         # consecutive suspicions
        self.inflight = 0
        self.last_beat = time.monotonic()
        self.ejected_at = 0.0     # monotonic stamp of the last eject
        self.model_id = ""
        self.name = ""            # a supervised child's name
        self.shard = ""           # the catalog slice it serves, "i/n"
        self.role = "serve"       # serve|ingest: only serve is routed to

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def remote(self) -> bool:
        return self.server is None

    def beat(self, model_id: Optional[str] = None) -> None:
        with self.lock:
            self.last_beat = time.monotonic()
            if model_id is not None:
                self.model_id = model_id

    def running(self) -> bool:
        if self.server is not None:
            return self.server.is_running()
        return self.state != "dead"

    def snapshot(self) -> dict:
        with self.lock:
            return {"replica": self.index, "port": self.port,
                    "member": self.key, "remote": self.server is None,
                    "state": self.state, "admitted": self.admitted,
                    "failures": self.failures, "inflight": self.inflight,
                    "model": self.model_id, "name": self.name,
                    "shard": self.shard, "role": self.role,
                    "beat_age_s": round(time.monotonic() - self.last_beat,
                                        3)}


class FleetServer(HTTPServerBase):
    """The control plane in front of N `PredictionServer` members.

    `replica_factory(index, *, mesh, tenancy)` returns a started replica
    on a loopback port (`mesh` its `ShardSlice` or None, `tenancy` the
    router's config as a replica runs it); it is called
    `fleet.replicas` times at `start()`. `registry` is the store the
    routers of one fleet share (leases, the member snapshot, access
    keys and quotas); None serves as the only leader. `mesh`
    "items=N@fleet" merges N catalog slices. `server_key` guards
    `/reload`, `/stop` and the membership routes. `tenancy` (default
    `PIO_TENANCY`/`PIO_TENANT_*`) makes the router the fleet's
    admission point."""

    def __init__(self, replica_factory: Optional[ReplicaFactory] = None, *,
                 fleet: Optional[FleetConfig] = None,
                 host: str = "127.0.0.1", port: int = 8000, registry=None,
                 mesh: str = "", server_key: str = "",
                 tenancy: Optional[TenancyConfig] = None,
                 engine_variant: str = "default", max_inflight: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 wire: Optional[str] = None):
        super().__init__(host=host, port=port, metrics=metrics,
                         max_inflight=max_inflight, wire=wire)
        from predictionio_tpu_torch.utils.security import KeyAuthentication
        self.fleet = fleet if fleet is not None else FleetConfig()
        if self.fleet.replicas < 0:
            raise ValueError(
                "replicas must be >= 0 (0 = router only: --join feeds "
                "members, or --standby contends for the lease)")
        if self.fleet.replicas > 0 and replica_factory is None:
            raise ValueError("in-process replicas need a replica_factory")
        self._factory = replica_factory
        self.registry = registry
        self.server_key = server_key
        self.engine_variant = engine_variant or "default"
        # torch loads with the router's plans, not with `ReplicaAgent`
        # (the supervisor's stub children import this module)
        from predictionio_tpu_torch.ops.topk_sharded import parse_fleet_mesh
        parsed = parse_fleet_mesh(mesh)
        if parsed is not None and parsed[1] is not None:
            raise ValueError(f"a router merges slices: {mesh!r} names a "
                             "member's slice (items=N@fleet:i)")
        self._mesh_shards = parsed[0] if parsed is not None else 0
        self.store_rtt_s = 0.0
        self.auth = KeyAuthentication(server_key or None)
        tcfg = tenancy if tenancy is not None else TenancyConfig.from_env()
        if tcfg.enabled and not tcfg.header_key:
            # no operator key: a per-fleet secret, so that in-process
            # replicas verify the router's assertion (remote replicas
            # need the shared PIO_SERVER_ACCESS_KEY)
            tcfg = dataclasses.replace(tcfg,
                                       header_key=secrets.token_hex(16))
        self.admission = AdmissionController(tcfg, registry=registry,
                                             metrics=self.metrics)
        self._rr_lock = threading.Lock()
        self._rr_next = 0
        self._upstream = HTTPConnectionPool()
        self._reload_lock = threading.Lock()
        # the journal's "roll" key, merged with the bucket snapshot by
        # the one builder `_journal_payload`
        self._roll_pending: List[str] = []
        self._stopping = False
        self.stopped = threading.Event()
        self._monitor_stop = threading.Event()
        self._monitor_beat = None
        self._lease_beat = None
        self._fleet_obs = _fleet_metrics(self.metrics)
        # the attached control loop (serving/autoscaler.py), ticked by
        # the tsdb scrape once set
        self.autoscaler = None
        # federation: each member's last good /metrics text, and its
        # previous parsed scrape (rates and p99 are deltas between two)
        self._federate_lock = threading.Lock()
        self._federated: Dict[str, str] = {}
        self._member_prom_last: Dict[str, tuple] = {}
        self._scrape_next = 0
        self._members_lock = threading.Lock()
        self._advertise = self.fleet.advertise
        self._holder = self._advertise
        self._leases = None
        self._lease_name = f"fleet-leader-{self.engine_variant}"
        self._is_leader = False
        self._leader_hint = ""
        self._lease_stop = threading.Event()
        self._replicas: List[_Replica] = []
        # one recovery sweep and one scheduled fsck per fleet: its
        # replicas skip theirs
        self._fsck_sched = None
        if registry is not None:
            from predictionio_tpu_torch.data.fsck import (
                start_scheduled_fsck, startup_check)
            startup_check(registry, log=_log.warning)
            self._fsck_sched = start_scheduled_fsck(registry,
                                                    log=_log.warning)
        self._routes()

    # -- lifecycle ----------------------------------------------------------
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    def start(self, background: bool = True) -> int:
        """Start the in-process replicas (replica i serves slice i % N
        in mesh mode), bind, take or observe the lease, then start the
        health monitor and the lease loop; returns the bound port."""
        from predictionio_tpu_torch.ops.topk_sharded import ShardSlice
        n = self._mesh_shards
        tenancy = self.admission.config.replica_variant()
        for i in range(self.fleet.replicas):
            server = self._factory(
                i, mesh=ShardSlice(n, i % n) if n else None,
                tenancy=tenancy)
            rep = _Replica(i, server, port=server.port)
            rep.shard = server.shard_spec()
            rep.model_id = server.current_instance_id()
            self._replicas.append(rep)
            if self._probe(rep):
                rep.beat()
                self._admit(rep)
            _log.info("replica_started", replica=i, port=rep.port,
                      shard=rep.shard, admitted=rep.admitted)
        port = super().start(background=True)
        if not self._advertise:
            self._advertise = f"127.0.0.1:{port}"
        self._holder = self._advertise
        self._resolve_leases()
        self._apply_rtt_floor()
        self._restore_members()
        # leadership settles before start() returns
        self._lease_tick()
        wd = watchdog()
        self._monitor_beat = wd.register(
            "health", budget_s=self.fleet.health_interval_s * 3.0 + 5.0,
            restart=self._spawn_monitor)
        self._lease_beat = wd.register(
            "lease", budget_s=self.fleet.lease_ttl_s + 5.0)
        self._spawn_monitor()
        threading.Thread(target=self._lease_loop,
                         name="pio-torch-fleet-lease", daemon=True).start()
        wd.ensure_started()
        if not background and self._thread is not None:
            self._thread.join()
        return port

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the fleet: the replicas drain their accepted requests,
        the lease is released (a standby takes over at once, not after
        the TTL), then the router's socket closes. Idempotent; sets
        `stopped` when done."""
        with self._rr_lock:
            if self._stopping:
                return
            self._stopping = True
        self._monitor_stop.set()
        self._lease_stop.set()
        self._close_beats()
        if self._fsck_sched is not None:
            self._fsck_sched.stop()
        for rep in list(self._replicas):
            with rep.lock:
                rep.admitted = False
                rep.state = "stopping"
            if rep.server is None:
                continue
            try:
                rep.server.stop(timeout)
            except Exception as e:  # noqa: BLE001 — stop the others
                _log.warning("replica_stop_failed", replica=rep.index,
                             error=f"{type(e).__name__}: {e}")
        if self._leases is not None and self._is_leader:
            try:
                self._leases.release(self._lease_name, self._holder)
            except Exception as e:  # noqa: BLE001 — the TTL expires it
                _log.warning("lease_release_failed",
                             error=f"{type(e).__name__}: {e}")
        self._is_leader = False
        self._fleet_obs["leader"].set(0.0)
        self._upstream.close()
        self.shutdown()
        self.stopped.set()

    def crash(self) -> None:
        """Die as a SIGKILLed router does, for chaos drills: no drain, no
        snapshot and no lease release, so a standby takes over only when
        the lease's TTL expires. In-process replicas are left running (a
        router-only fleet models a leader crash across hosts)."""
        with self._rr_lock:
            self._stopping = True
        self._monitor_stop.set()
        self._lease_stop.set()
        self._close_beats()
        if self._fsck_sched is not None:
            self._fsck_sched.stop()
        self.shutdown()

    def _close_beats(self) -> None:
        for beat in (self._monitor_beat, self._lease_beat):
            if beat is not None:
                beat.close()
        self._monitor_beat = None
        self._lease_beat = None

    def readiness(self):
        """/ready: at least one member admitted, and no control loop the
        watchdog gave up on (a dead lease loop cannot renew)."""
        admitted = [r.index for r in self._replicas
                    if r.admitted and r.running()]
        detail: Dict[str, Any] = {"replicas": len(self._replicas),
                                  "admitted": admitted,
                                  "leader": self._is_leader}
        dead = [b.role for b in (self._monitor_beat, self._lease_beat)
                if b is not None and b.degraded]
        if dead:
            detail["degradedLoops"] = dead
            return (False, detail)
        return (bool(admitted), detail)

    # -- leadership ---------------------------------------------------------
    def is_leader(self) -> bool:
        return self._is_leader

    def _resolve_leases(self) -> None:
        if self.registry is None:
            _log.warning("lease_dao_unavailable_always_leader",
                         error="no registry")
            return
        try:
            self._leases = self.registry.get_leases()
        except StorageError as e:
            # no lease DAO: the only leader (unsafe only beside a
            # second router)
            _log.warning("lease_dao_unavailable_always_leader",
                         error=str(e))

    def _apply_rtt_floor(self) -> None:
        """Clamp the lease TTL to at least 10x the store's measured
        round trip (and the heartbeat to a third of that), warning: a
        TTL the store cannot renew in time flaps leadership."""
        if self._leases is None:
            return
        rtt = measure_store_rtt(self._leases, self._holder)
        self.store_rtt_s = rtt
        self.metrics.gauge(
            "pio_fleet_store_rtt_seconds",
            "Median lease-store CAS round-trip measured at start").set(rtt)
        if rtt <= 0:
            return
        floor = 10.0 * rtt
        if self.fleet.lease_ttl_s < floor:
            _log.warning("lease_ttl_below_rtt_floor_clamped",
                         configured_ttl_s=self.fleet.lease_ttl_s,
                         store_rtt_s=round(rtt, 4),
                         clamped_ttl_s=round(floor, 3))
            self.fleet.lease_ttl_s = floor
        hb_floor = floor / 3.0
        if 0 < self.fleet.heartbeat_s < hb_floor:
            _log.warning("heartbeat_below_rtt_floor_clamped",
                         configured_heartbeat_s=self.fleet.heartbeat_s,
                         clamped_heartbeat_s=round(hb_floor, 3))
            self.fleet.heartbeat_s = hb_floor

    def _lease_tick(self) -> None:
        if self._leases is None:
            if not self._is_leader:
                self._become_leader(previous="", journal="")
            return
        try:
            cur = self._leases.get(self._lease_name)
            # a renewal journals the buckets (and any roll); an
            # acquisition passes None, so that the store keeps the dead
            # leader's journal for `_become_leader` to inherit
            journal = self._journal_payload() if self._is_leader else None
            got = self._leases.acquire(
                self._lease_name, self._holder, self.fleet.lease_ttl_s,
                journal=journal)
            if got is None and (cur is None or cur.holder == self._holder):
                # the holder won the race after our read: learn it now,
                # not a tick later
                cur = self._leases.get(self._lease_name)
        except Exception as e:  # noqa: BLE001 — keep the current role
            _log.warning("lease_tick_failed",
                         error=f"{type(e).__name__}: {e}")
            return
        if got is not None:
            self._leader_hint = self._holder
            if not self._is_leader:
                prev = cur.holder if (cur is not None
                                      and cur.holder != self._holder) else ""
                self._become_leader(previous=prev, journal=got.journal)
            return
        self._leader_hint = cur.holder if cur is not None else ""
        if self._is_leader:
            self._step_down()
        # shadow the leader's journaled buckets (clamp-down only), so a
        # standby serving in the handoff gap mints no second burst
        if cur is not None and cur.journal:
            doc = _json_doc(cur.journal)
            if doc.get("buckets"):
                self.admission.adopt_buckets(doc)

    def _become_leader(self, previous: str, journal: str) -> None:
        self._is_leader = True
        self._fleet_obs["leader"].set(1.0)
        if previous:
            self._fleet_obs["handoff"].inc()
            _log.warning("leader_takeover", holder=self._holder,
                         previous=previous)
        else:
            _log.info("leader_elected", holder=self._holder)
        self._restore_members()
        doc = _json_doc(journal)
        # the dead leader's spent buckets before anything admits here
        adopted = self.admission.adopt_buckets(doc)
        if adopted:
            _log.info("tenant_budget_adopted", tenants=adopted,
                      previous=previous)
        pending = [str(k) for k in (doc.get("roll") or [])]
        self._roll_pending = list(pending)
        if pending:
            _log.warning("resuming_interrupted_roll", pending=pending)
            threading.Thread(target=self._resume_roll, args=(pending,),
                             name="pio-torch-fleet-roll-resume",
                             daemon=True).start()

    def _step_down(self) -> None:
        self._is_leader = False
        self._fleet_obs["leader"].set(0.0)
        _log.warning("leader_stepped_down", holder=self._holder,
                     leader=self._leader_hint)

    def _lease_loop(self) -> None:
        beat = self._lease_beat
        if beat is not None:
            beat.guard(self._lease_body)
        else:
            self._lease_body()

    def _lease_body(self) -> None:
        beat = self._lease_beat
        interval = max(self.fleet.lease_ttl_s / 3.0, 0.02)
        while not self._lease_stop.wait(interval):
            if beat is not None:
                beat.tick()
            self._lease_tick()

    def _journal_payload(self) -> str:
        """The leader's journal: the roll's pending members and the
        spent-bucket snapshot (one builder for both writers)."""
        doc: dict = {}
        if self._roll_pending:
            doc["roll"] = list(self._roll_pending)
        snap = self.admission.export_buckets()
        if snap:
            doc["t"] = snap["t"]
            doc["buckets"] = snap["buckets"]
        return json.dumps(doc) if doc else ""

    def _journal_roll(self, pending: List[str]) -> None:
        """Record the members still to roll in the lease row (renewing
        it); an empty list clears the roll."""
        self._roll_pending = list(pending)
        if self._leases is None or not self._is_leader:
            return
        try:
            self._leases.acquire(self._lease_name, self._holder,
                                 self.fleet.lease_ttl_s,
                                 journal=self._journal_payload())
        except Exception as e:  # noqa: BLE001 — the renewal retries
            _log.warning("roll_journal_write_failed",
                         error=f"{type(e).__name__}: {e}")

    def _resume_roll(self, pending: List[str]) -> None:
        try:
            report = self.rolling_reload(only=pending)
            _log.info("roll_resumed", aborted=report["aborted"],
                      results=len(report["results"]))
        except HTTPError as e:
            _log.warning("roll_resume_not_run", error=e.message)

    # -- membership ---------------------------------------------------------
    def _find_member(self, key: str) -> Optional[_Replica]:
        for rep in list(self._replicas):
            if rep.key == key:
                return rep
        return None

    def _add_member(self, host: str, port: int) -> _Replica:
        with self._members_lock:
            for rep in self._replicas:
                if rep.host == host and rep.port == port:
                    return rep
            rep = _Replica(len(self._replicas), host=host, port=port)
            self._replicas.append(rep)
        self._update_gauges()
        return rep

    def _members_blob_id(self) -> str:
        return _MEMBERS_BLOB_PREFIX + self.engine_variant

    def _persist_members(self) -> None:
        """Snapshot the remote members into the model store, so that a
        restarted router admits them at once."""
        if self.registry is None:
            return
        remote = [{"member": r.key, "model": r.model_id, "shard": r.shard,
                   "role": r.role}
                  for r in list(self._replicas) if r.remote]
        try:
            self.registry.get_model_data_models().insert(Model(
                self._members_blob_id(),
                json.dumps({"members": remote}).encode()))
        except Exception as e:  # noqa: BLE001 — beats rebuild it
            _log.warning("member_snapshot_write_failed",
                         error=f"{type(e).__name__}: {e}")

    def _restore_members(self) -> None:
        if self.registry is None:
            return
        try:
            blob = self.registry.get_model_data_models().get(
                self._members_blob_id())
            entries = (json.loads(bytes(blob.models)).get("members", [])
                       if blob is not None else [])
        except Exception as e:  # noqa: BLE001 — beats rebuild it
            _log.warning("member_snapshot_read_failed",
                         error=f"{type(e).__name__}: {e}")
            return
        for entry in entries:
            member = str(entry.get("member", ""))
            host, sep, port_s = member.rpartition(":")
            if not sep or not host or not port_s.isdigit() \
                    or self._find_member(member) is not None:
                continue
            rep = self._add_member(host, int(port_s))
            rep.model_id = str(entry.get("model", ""))
            rep.shard = str(entry.get("shard", ""))
            rep.role = str(entry.get("role", "")) or "serve"
            if self._probe(rep):
                rep.beat()
                self._admit(rep)
            _log.info("member_restored", member=member,
                      admitted=rep.admitted)

    def _handle_beat(self, req: Request, register: bool) -> Response:
        try:
            body = req.json()
        except ValueError as e:
            raise HTTPError(400, str(e))
        member = str(body.get("member", ""))
        host, sep, port_s = member.rpartition(":")
        if not sep or not host or not port_s.isdigit():
            raise HTTPError(400, "member must be 'host:port'")
        if faults().dropped(f"fleet.net.{member}.heartbeat"):
            raise HTTPError(503, "heartbeat dropped (injected partition)")
        rep = self._find_member(member)
        if rep is None:
            # a heartbeat registers too: a router restarted from
            # scratch learns the fleet within one beat
            rep = self._add_member(host, int(port_s))
            self._fleet_obs["transitions"].labels(event="register").inc()
            _log.info("member_registered", member=member,
                      explicit=register)
            self._persist_members()
        rep.beat(model_id=str(body.get("model", "")))
        ready = bool(body.get("ready", True))
        with rep.lock:
            name = str(body.get("name", ""))
            if name:
                rep.name = name
            rep.shard = str(body.get("shard", ""))
            # an ingest member beats and is admitted, never routed to
            rep.role = str(body.get("role", "")) or "serve"
            # a retiring member beats on while it drains: no re-admit,
            # no eject
            busy = rep.state in ("reloading", "stopping", "retiring")
            if rep.state == "dead":
                rep.state = "starting"
        if not busy:
            if ready:
                self._maybe_admit(rep)
            else:
                self._eject(rep, "member reported not ready")
        return Response.json({
            "member": member, "admitted": rep.admitted,
            "leader": self._leader_hint, "shard": rep.shard,
            "heartbeat_s": self.fleet.effective_heartbeat_s()})

    # -- health gating ------------------------------------------------------
    def _grace_s(self) -> float:
        # eject-stale after about three missed beats
        return 3.0 * self.fleet.effective_heartbeat_s()

    def _probe(self, rep: _Replica) -> bool:
        if faults().dropped(f"fleet.net.{rep.key}.heartbeat"):
            return False
        try:
            with urllib.request.urlopen(
                    f"http://{rep.host}:{rep.port}/ready",
                    timeout=2) as resp:
                return resp.status == 200
        except Exception:  # noqa: BLE001 — unready, unreachable alike
            return False

    def _admit(self, rep: _Replica, *, unless_busy: bool = False) -> None:
        """Into the rotation. `unless_busy` (a probe's or a beat's good
        evidence) leaves a member alone that a retire, a roll or a stop
        took out of the rotation after the caller looked: checked under
        the member's lock, so that such evidence never re-admits it."""
        with rep.lock:
            if unless_busy and rep.state in ("reloading", "stopping",
                                             "retiring"):
                return
            was = rep.admitted
            rep.admitted = True
            rep.state = "serving"
            rep.failures = 0
        if not was:
            self._fleet_obs["transitions"].labels(event="admit").inc()
        self._update_gauges()

    def _maybe_admit(self, rep: _Replica) -> None:
        """Admit on good evidence unless the member is in post-eject
        quarantine (else a member cut off on its data path, whose
        control path looks healthy, would flap)."""
        with rep.lock:
            quarantined = (rep.ejected_at > 0.0
                           and time.monotonic() - rep.ejected_at
                           < self._grace_s())
        if not quarantined:
            self._admit(rep, unless_busy=True)

    def _eject(self, rep: _Replica, reason: str) -> None:
        with rep.lock:
            was = rep.admitted
            rep.admitted = False
            rep.ejected_at = time.monotonic()
            if rep.state == "serving":
                rep.state = "ejected"
        if was:
            self._fleet_obs["transitions"].labels(event="eject").inc()
            _log.warning("replica_ejected", replica=rep.index,
                         member=rep.key, reason=reason)
        self._update_gauges()

    def _record_failure(self, rep: _Replica, reason: str,
                        data_path: bool = False) -> None:
        """One suspicion: data-path evidence ejects at the threshold,
        probe-only evidence also needs a stale heartbeat."""
        with rep.lock:
            rep.failures += 1
            over = rep.failures >= self.fleet.eject_threshold
            stale = (time.monotonic() - rep.last_beat) >= self._grace_s()
        if over and (data_path or stale):
            self._eject(rep, reason)

    def _spawn_monitor(self) -> None:
        threading.Thread(target=self._monitor_loop,
                         name="pio-torch-fleet-health", daemon=True).start()

    def _monitor_loop(self) -> None:
        beat = self._monitor_beat
        if beat is not None:
            beat.guard(self._monitor_body)
        else:
            self._monitor_body()

    def _monitor_body(self) -> None:
        beat = self._monitor_beat
        while not self._monitor_stop.wait(self.fleet.health_interval_s):
            if beat is not None:
                beat.tick()
            for rep in list(self._replicas):
                with rep.lock:
                    skip = rep.state in ("reloading", "stopping",
                                         "retiring")
                self._fleet_obs["beat_age"].labels(member=rep.key).set(
                    time.monotonic() - rep.last_beat)
                if skip:
                    continue
                if self._probe(rep):
                    rep.beat()
                    self._maybe_admit(rep)
                else:
                    self._record_failure(rep, "readiness probe failed")

    def _update_gauges(self) -> None:
        members = list(self._replicas)
        self._fleet_obs["admitted"].set(
            float(sum(1 for r in members if r.admitted)))
        self._fleet_obs["size"].set(float(len(members)))
        self._fleet_obs["members"].set(float(len(members)))
        for rep in members:
            if rep.shard:
                self._fleet_obs["shard_owner"].labels(
                    shard=rep.shard, member=rep.key).set(
                        1.0 if rep.admitted else 0.0)

    # -- elastic scale-down (a drain, not a death) ---------------------------
    def member_by_name(self, name: str) -> Optional[_Replica]:
        """The member a supervised child registered as: its heartbeat's
        name, else the stub child's model id `stub-<name>`."""
        for rep in list(self._replicas):
            if rep.name == name or rep.model_id == f"stub-{name}":
                return rep
        return None

    def retire_member_named(self, name: str) -> bool:
        rep = self.member_by_name(name)
        if rep is None:
            return False
        return self.retire_member(rep)

    def retire_member(self, rep: _Replica) -> bool:
        """Out of rotation as `retiring`, then drained: a `retire`
        transition, never an eject, and the suspicion counters stay as
        they are. Returns whether the drain ended inside
        `drain_timeout_s`."""
        with rep.lock:
            rep.admitted = False
            rep.state = "retiring"
        self._fleet_obs["transitions"].labels(event="retire").inc()
        self._update_gauges()
        _log.info("member_retiring", member=rep.key, name=rep.name)
        drained = self._await_drain(rep)
        if not drained:
            _log.warning("retire_drain_timeout", member=rep.key,
                         inflight=rep.inflight)
        return drained

    def forget_member(self, key: str) -> None:
        """Drop a retired member from the table and the persisted
        snapshot (a later beat of a lingering process registers it
        again)."""
        with self._members_lock:
            self._replicas = [r for r in self._replicas if r.key != key]
        with self._federate_lock:
            self._federated.pop(key, None)
        self._member_prom_last.pop(key, None)
        # its last gauge values would stay in the ring for good and hold
        # the autoscaler's signals (a retired member's flash-time qps
        # and p99): its series go with it
        for fam in ("member_qps", "member_p99", "member_burn",
                    "member_balance", "beat_age"):
            self._fleet_obs[fam].remove(member=key)
        self.tsdb.forget(lambda k: f"member={key}}}" in k
                         or f"member={key}," in k)
        self._persist_members()
        self._update_gauges()
        _log.info("member_forgotten", member=key)

    # -- metrics federation -------------------------------------------------
    def _obs_collectors(self):
        """The tsdb tick also scrapes the members (their derived gauges
        land in this router's ring) and then ticks the autoscaler, which
        reads them."""
        return super()._obs_collectors() + [self._scrape_members,
                                            self._autoscale_tick]

    def _autoscale_tick(self) -> None:
        a = self.autoscaler
        if a is not None:
            a.tick()

    def _scrape_budget_s(self) -> float:
        """The whole scrape's time: the scraper's watchdog budget
        (interval x 3 + 5) less the wait before the tick and the
        autoscaler's share."""
        sc = self._scraper
        interval = sc.interval_s if sc is not None else 0.0
        return max(2.0, interval * 2.0 + 2.0)

    def _scrape_members(self) -> None:
        """Each admitted member's /metrics over the pooled upstream
        connections (2-s timeout): the text is kept for /federate and
        folded into the member gauges. A failed scrape counts
        outcome="error" and is probe-grade suspicion (never a lone
        ejection cause); the last good text stays. Members past the
        tick's budget wait for the next tick, which starts after the
        last one scraped."""
        members = [r for r in list(self._replicas) if r.admitted]
        if not members:
            return
        start = self._scrape_next % len(members)
        members = members[start:] + members[:start]
        end = time.monotonic() + self._scrape_budget_s()
        for n, rep in enumerate(members):
            left = end - time.monotonic()
            if left <= 0.05:
                self._scrape_next = start + n
                return
            try:
                status, _rh, body = self._upstream.request(
                    rep.host, rep.port, "GET", "/metrics", None, {},
                    timeout=min(2.0, left))
                if status != 200:
                    raise OSError(f"scrape status {status}")
            except OSError as e:
                self._fleet_obs["scrapes"].labels(outcome="error").inc()
                self._record_failure(rep, f"metrics scrape failed: {e}")
                continue
            text = body.decode("utf-8", "replace")
            with self._federate_lock:
                self._federated[rep.key] = text
            self._fleet_obs["scrapes"].labels(outcome="ok").inc()
            try:
                self._derive_member_gauges(rep.key, text)
            except (ValueError, KeyError, ZeroDivisionError):
                pass     # a malformed exposition still federates
        self._scrape_next = start + len(members)

    def _derive_member_gauges(self, member: str, text: str) -> None:
        """One member scrape into the `pio_fleet_member_*` gauges: the
        burn lands at once, the rates and the p99 need two scrapes."""
        now = time.monotonic()
        parsed = _parse_prom(text)
        prev = self._member_prom_last.get(member)
        self._member_prom_last[member] = (now, parsed)
        obs = self._fleet_obs
        burn = 0.0
        for (name, labels), v in parsed.items():
            if (name == "pio_slo_burn_rate"
                    and dict(labels).get("window") == "5m"):
                burn = max(burn, v)
        obs["member_burn"].labels(member=member).set(burn)
        if prev is None:
            return
        pts, pparsed = prev
        dt = now - pts
        if dt <= 0:
            return

        def _sum(cur: Dict, name: str) -> float:
            return sum(v for (n, _l), v in cur.items() if n == name)

        dreq = (_sum(parsed, "pio_http_requests_total")
                - _sum(pparsed, "pio_http_requests_total"))
        if dreq >= 0:
            obs["member_qps"].labels(member=member).set(dreq / dt)
        obs["member_p99"].labels(member=member).set(
            _prom_hist_p99(parsed, pparsed,
                           "pio_http_request_duration_seconds_bucket"))
        # reactor balance: max/mean of the per-reactor request deltas
        # (1.0 = evenly sharded accepts)
        per_reactor: Dict[str, float] = {}
        for (name, labels), v in parsed.items():
            if name == "pio_wire_requests_total":
                r = dict(labels).get("reactor", "0")
                pv = pparsed.get((name, labels), 0.0)
                per_reactor[r] = per_reactor.get(r, 0.0) + (v - pv)
        deltas = [d for d in per_reactor.values() if d >= 0]
        if deltas and sum(deltas) > 0:
            mean = sum(deltas) / len(deltas)
            obs["member_balance"].labels(member=member).set(
                max(deltas) / mean if mean > 0 else 1.0)

    # -- routing ------------------------------------------------------------
    def _rotation(self) -> List[_Replica]:
        """The admitted serving members, rotated round-robin (an
        ingest member is never in it)."""
        admitted = [r for r in self._replicas
                    if r.admitted and r.role == "serve"]
        if not admitted:
            return []
        with self._rr_lock:
            start = self._rr_next % len(admitted)
            self._rr_next += 1
        return admitted[start:] + admitted[:start]

    @staticmethod
    def _forward_headers(req: Request,
                         extra: Optional[Dict[str, str]]) -> Dict[str, str]:
        headers = {}
        for name in _FORWARD_HEADERS:
            v = req.header(name)
            if v:
                headers[name] = v
        if extra:
            headers.update(extra)
        return headers

    def _attempt_timeout(self, deadline, what: str) -> float:
        """A proxied attempt's timeout; a spent deadline sheds 504
        before dialling."""
        timeout = PROXY_TIMEOUT_S
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0.005:
                self._shed_counter.labels(surface="deadline", app="").inc()
                raise DeadlineExceeded(
                    f"deadline budget exhausted before dialing {what}")
            timeout = min(timeout, remaining)
        return timeout

    def _send(self, rep: _Replica, method: str, path: str,
              body: Optional[bytes], headers: Dict[str, str],
              timeout: float):
        """One pooled request to one member; transport failures raise
        OSError, and `_LeftRotation` a member that left the rotation
        (ejected, reloading, retiring) after the request picked it: the
        admitted check and the in-flight count share its lock, so that a
        drain that saw zero in flight sees no later request."""
        if faults().dropped(f"fleet.net.{rep.key}.data"):
            raise OSError(f"injected partition: fleet.net.{rep.key}.data")
        with rep.lock:
            if not rep.admitted:
                raise _LeftRotation(rep.key)
            rep.inflight += 1
        try:
            return self._upstream.request(rep.host, rep.port, method, path,
                                          body, headers, timeout)
        finally:
            with rep.lock:
                rep.inflight -= 1

    def _leader_gate(self, req: Request, p=None) -> None:
        """Non-leaders redirect data traffic to the leader (307), or 503
        while no leader is elected. The redirect carries the request's
        trace context (`p`), so that a client re-asserting it at the
        leader stitches the two hops under one trace id."""
        if self._is_leader:
            return
        leader = self._leader_hint
        if leader and leader != self._advertise:
            self._fleet_obs["routed"].labels(outcome="redirected").inc()
            hdrs = {"Location": f"http://{leader}{req.path}"}
            if p is not None:
                trace.annotate_pending(p, kind="router")
                hdrs[trace.TRACE_HEADER] = trace.child_header(p)
            raise HTTPError(307, f"not the fleet leader; try {leader}",
                            headers=hdrs)
        raise HTTPError(503, "no fleet leader elected",
                        headers={"Retry-After": "1"})

    def _route(self, req: Request,
               extra_headers: Optional[Dict[str, str]] = None) -> Response:
        """To an admitted member; a transport failure retries on the
        next one (each feeding the ejection count)."""
        p = trace.current()
        self._leader_gate(req, p)
        deadline = current_deadline()
        rotation = self._rotation()
        if not rotation:
            self._fleet_obs["routed"].labels(outcome="no_replica").inc()
            raise HTTPError(503, "no healthy replica available",
                            headers={"Retry-After": "1"})
        headers = self._forward_headers(req, extra_headers)
        path = req.path + (f"?{urlencode(dict(req.query))}"
                           if req.query else "")
        body = req.body if req.method == "POST" else None
        last_err: Optional[Exception] = None
        for rep in rotation:
            timeout = self._attempt_timeout(deadline, "a replica")
            t_dial = time.perf_counter()
            try:
                status, rheaders, rbody = self._send(
                    rep, req.method, path, body, headers, timeout)
            except _LeftRotation:
                continue
            except OSError as e:
                last_err = e
                trace.add_span(p, f"proxy_retry:{rep.key}", t_dial,
                               time.perf_counter())
                self._record_failure(
                    rep, f"route error: {type(e).__name__}: {e}",
                    data_path=True)
                self._fleet_obs["routed"].labels(outcome="retried").inc()
                continue
            trace.add_span(p, f"proxy:{rep.key}", t_dial,
                           time.perf_counter())
            if status >= 500:
                # the member answered: pass it on, but count it
                self._record_failure(rep, f"HTTP {status}", data_path=True)
            else:
                with rep.lock:
                    rep.failures = 0
            self._fleet_obs["routed"].labels(outcome="ok").inc()
            keep = {k: v for k, v in rheaders.items()
                    if k.lower() == "retry-after"}
            return Response(status=status, body=rbody, headers=keep,
                            content_type=rheaders.get("Content-Type",
                                                      "application/json"))
        self._fleet_obs["routed"].labels(outcome="exhausted").inc()
        raise HTTPError(
            503, "every admitted replica unreachable (last: "
                 f"{type(last_err).__name__ if last_err else 'n/a'})",
            headers={"Retry-After": "1"})

    def _route_mesh(self, req: Request,
                    extra_headers: Optional[Dict[str, str]] = None
                    ) -> Response:
        """The catalog-mesh merge: one admitted owner of every slice
        answers `/shard/queries.json` (a transport failure retries the
        next owner of the same slice), and the (global id, score)
        candidates merge by (-score, id) with id dedupe. A slice without
        a live owner degrades the answer (`partial: true`); a client
        error (4xx) of a member passes through."""
        p = trace.current()
        self._leader_gate(req, p)
        deadline = current_deadline()
        n = self._mesh_shards
        shards = [f"{i}/{n}" for i in range(n)]
        owners: Dict[str, List[_Replica]] = {s: [] for s in shards}
        for rep in self._replicas:
            if rep.admitted and rep.shard in owners:
                owners[rep.shard].append(rep)
        if not any(owners.values()):
            # no member declares a slice: plain routing
            return self._route(req, extra_headers=extra_headers)
        headers = self._forward_headers(req, extra_headers)
        body = req.body
        if (headers.get("Content-Type") or "").startswith(BIN_CONTENT_TYPE):
            # the member surface speaks JSON; a frame is (user, num)
            decoded = decode_bin_query(body)
            if decoded is None:
                raise HTTPError(400, "malformed binary query frame")
            body = json.dumps({"user": decoded[0],
                               "num": decoded[1]}).encode()
            headers["Content-Type"] = "application/json"
        path = "/shard/queries.json" + (
            f"?{urlencode(dict(req.query))}" if req.query else "")
        cands: List[tuple] = []
        num = 0
        degraded: List[str] = []
        for shard in shards:
            got = None
            for rep in owners[shard]:
                timeout = self._attempt_timeout(deadline, "a slice owner")
                t_dial = time.perf_counter()
                try:
                    status, rheaders, rbody = self._send(
                        rep, "POST", path, body, headers, timeout)
                except _LeftRotation:
                    continue
                except OSError as e:
                    trace.add_span(p, f"shard_retry:{rep.key}", t_dial,
                                   time.perf_counter())
                    self._record_failure(
                        rep, f"shard route error: {type(e).__name__}: {e}",
                        data_path=True)
                    self._fleet_obs["routed"].labels(
                        outcome="retried").inc()
                    continue
                trace.add_span(p, f"shard:{shard}:{rep.key}", t_dial,
                               time.perf_counter())
                if status >= 500:
                    self._record_failure(rep, f"HTTP {status}",
                                         data_path=True)
                    continue
                if status >= 400:
                    return Response(
                        status=status, body=rbody,
                        content_type=rheaders.get("Content-Type",
                                                  "application/json"))
                with rep.lock:
                    rep.failures = 0
                try:
                    got = json.loads(rbody)
                except ValueError:
                    self._record_failure(rep, "unparseable shard reply",
                                         data_path=True)
                    got = None
                    continue
                break
            if got is None:
                degraded.append(shard)
                continue
            num = max(num, int(got.get("num") or 0))
            cands.extend((int(c[0]), float(c[1]), c[2])
                         for c in got.get("cands", ()))
        if not cands and degraded:
            self._fleet_obs["mesh"].labels(outcome="empty").inc()
            self._fleet_obs["routed"].labels(outcome="exhausted").inc()
            raise HTTPError(
                503, f"no mesh shard reachable ({len(degraded)}/{n} "
                     "degraded)", headers={"Retry-After": "1"})
        # the plans' own tie-break, then id dedupe (which also collapses
        # the whole-catalog answers of members without a slice)
        cands.sort(key=lambda c: (-c[1], c[0]))
        seen = set()
        top: List[dict] = []
        for gid, score, name in cands:
            key = gid if gid >= 0 else f"name:{name}"
            if key in seen:
                continue
            seen.add(key)
            top.append({"item": name, "score": score})
            if num and len(top) >= num:
                break
        out: Dict[str, object] = {"itemScores": top}
        if degraded:
            out["partial"] = True
            out["degradedShards"] = degraded
            self._fleet_obs["mesh"].labels(outcome="partial").inc()
        else:
            self._fleet_obs["mesh"].labels(outcome="ok").inc()
        self._fleet_obs["routed"].labels(outcome="ok").inc()
        return Response.json(out)

    # -- rolling reload -----------------------------------------------------
    def _await_drain(self, rep: _Replica) -> bool:
        """Wait (bounded) for the router's requests in flight to `rep`;
        new traffic is already diverted."""
        waiter = threading.Event()
        end = time.perf_counter() + self.fleet.drain_timeout_s
        while time.perf_counter() < end:
            with rep.lock:
                if rep.inflight == 0:
                    return True
            waiter.wait(0.02)
        with rep.lock:
            return rep.inflight == 0

    def _reload_replica(self, rep: _Replica) -> dict:
        """POST /reload on one member: {"status": code} (0 = transport
        failure), bounded by `RELOAD_TIMEOUT_S` and any deadline."""
        timeout = RELOAD_TIMEOUT_S
        deadline = current_deadline()
        if deadline is not None:
            remaining = deadline.remaining()
            if remaining <= 0.005:
                return {"status": 0,
                        "detail": "deadline exhausted before reload dial"}
            timeout = min(timeout, remaining)
        headers = {}
        if self.server_key:
            headers["Authorization"] = "Basic " + base64.b64encode(
                f"{self.server_key}:".encode()).decode()
        req = urllib.request.Request(
            f"http://{rep.host}:{rep.port}/reload", data=b"",
            method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return {"status": resp.status}
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("message", "")
            except Exception:  # noqa: BLE001 — the status says enough
                detail = ""
            return {"status": e.code, "detail": detail}
        except OSError as e:
            return {"status": 0, "detail": f"{type(e).__name__}: {e}"}

    def rolling_reload(self, only: Optional[List[str]] = None) -> dict:
        """One member at a time: eject, drain, reload, probe, admit
        (leader only; the module docstring has the failure policy).
        Returns {"results": [...], "aborted": bool}."""
        if not self._is_leader:
            raise HTTPError(
                503, "not the fleet leader (leader: "
                     f"{self._leader_hint or 'unknown'}); only the lease "
                     "holder may run a rolling reload")
        if not self._reload_lock.acquire(blocking=False):
            raise HTTPError(409, "a rolling reload is already running")
        t_roll = time.perf_counter()
        try:
            members = list(self._replicas)
            if only is not None:
                wanted = set(only)
                members = [m for m in members if m.key in wanted]
            results: List[dict] = []
            aborted = False
            pending = [m.key for m in members]
            for rep in members:
                # journal first: a leader dying here leaves `rep`
                # pending, and the next leader rolls it
                self._journal_roll(pending)
                if rep.server is not None and not rep.server.is_running():
                    results.append({"replica": rep.index,
                                    "outcome": "skipped_dead"})
                    pending.remove(rep.key)
                    continue
                if not rep.admitted and not self._probe(rep):
                    results.append({"replica": rep.index,
                                    "member": rep.key,
                                    "outcome": "skipped_unreachable"})
                    pending.remove(rep.key)
                    continue
                with rep.lock:
                    rep.admitted = False
                    rep.state = "reloading"
                self._fleet_obs["transitions"].labels(
                    event="reload_start").inc()
                self._update_gauges()
                drained = self._await_drain(rep)
                outcome = self._reload_replica(rep)
                if outcome["status"] == 200:
                    ok = self._probe(rep)
                    if ok:
                        rep.beat()
                        self._admit(rep)
                        if rep.server is not None:
                            rep.model_id = rep.server.current_instance_id()
                    else:
                        with rep.lock:
                            rep.state = "ejected"
                    results.append({
                        "replica": rep.index, "member": rep.key,
                        "outcome": "reloaded" if ok
                        else "reloaded_not_ready", "drained": drained})
                elif outcome["status"] == 0:
                    # died mid-reload: it stays out; the others serve
                    with rep.lock:
                        rep.state = "dead"
                    self._update_gauges()
                    _log.warning("reload_replica_died", replica=rep.index,
                                 detail=outcome.get("detail", ""))
                    results.append({"replica": rep.index, "member": rep.key,
                                    "outcome": "died",
                                    "detail": outcome.get("detail", "")})
                else:
                    # the load failed and the member rolled back: admit it
                    # on the old model and abort (every member would fail)
                    if self._probe(rep):
                        self._admit(rep)
                    results.append({"replica": rep.index, "member": rep.key,
                                    "outcome": "load_failed_rolled_back",
                                    "detail": outcome.get("detail", "")})
                    aborted = True
                    break
                pending.remove(rep.key)
            self._journal_roll([])
            self._fleet_obs["rolls"].labels(
                outcome="aborted" if aborted else "ok").inc()
            rec = trace.get_recorder()
            if rec.enabled:
                rec.record_background(
                    "rolling_reload", t_roll, time.perf_counter(),
                    error="aborted" if aborted else "")
            _log.info("rolling_reload_done", aborted=aborted,
                      results=len(results))
            return {"results": results, "aborted": aborted}
        finally:
            self._reload_lock.release()

    # -- status -------------------------------------------------------------
    def status_json(self) -> Dict[str, Any]:
        return {"status": "alive", "role": "fleet",
                "leader": self._is_leader, "leaderHint": self._leader_hint,
                "advertise": self._advertise,
                "mesh_shards": self._mesh_shards,
                "tenancy": self.admission.enabled,
                "replicas": [rep.snapshot() for rep in self._replicas]}

    # -- routes -------------------------------------------------------------
    def _routes(self) -> None:
        r = self.router

        @r.post("/queries.json")
        def queries(req: Request) -> Response:
            # authenticate and charge before any routing: a standby that
            # redirects has spent the rate token already, so N standbys
            # cannot admit N x the rate in a handoff
            tenant = self.admission.resolve(req)
            try:
                guard = self.admission.admit(tenant)
            except OverloadedError as e:
                leader = self._leader_hint
                if not self._is_leader and leader \
                        and leader != self._advertise:
                    raise HTTPError(e.status, e.message, headers={
                        **retry_after_header(e.retry_after),
                        "Location": f"http://{leader}{req.path}"})
                raise
            with guard:
                extra = ({TENANT_HEADER:
                          self.admission.signed_header(tenant)}
                         if tenant is not None else None)
                p = trace.current()
                if p is not None:
                    # the router's hop is kind=router (outside
                    # pio_serve_seconds: the replica's serve entry owns
                    # that observation) and asserts a signed child
                    # context, so that the replica's spans stitch
                    trace.annotate_pending(
                        p, kind="router",
                        app=tenant.label if tenant is not None else "")
                    extra = dict(extra or ())
                    extra[trace.TRACE_HEADER] = trace.child_header(p)
                if self._mesh_shards:
                    return self._route_mesh(req, extra_headers=extra)
                return self._route(req, extra_headers=extra)

        @r.post("/fleet/register")
        def fleet_register(req: Request) -> Response:
            self.auth.check(req)
            return self._handle_beat(req, register=True)

        @r.post("/fleet/heartbeat")
        def fleet_heartbeat(req: Request) -> Response:
            self.auth.check(req)
            return self._handle_beat(req, register=False)

        @r.get("/status.json")
        def status(req: Request) -> Response:
            return Response.json(self.status_json())

        @r.get("/")
        def index(req: Request) -> Response:
            return Response.json(self.status_json())

        @r.post("/reload")
        def reload(req: Request) -> Response:
            self.auth.check(req)
            report = self.rolling_reload()
            return Response.json(report,
                                 status=500 if report["aborted"] else 200)

        @r.get("/quality.json")
        def quality_json(req: Request) -> Response:
            # each admitted member's snapshot; a member that does not
            # answer is reported, never fatal
            members = {}
            for rep in list(self._replicas):
                if not rep.admitted:
                    continue
                try:
                    with urllib.request.urlopen(
                            f"http://{rep.host}:{rep.port}/quality.json",
                            timeout=2) as resp:
                        members[rep.key] = json.loads(
                            resp.read().decode("utf-8"))
                except (OSError, ValueError) as e:
                    members[rep.key] = {
                        "error": f"{type(e).__name__}: {e}"}
            return Response.json({"role": "fleet", "members": members})

        @r.get("/fleet.html")
        def fleet_html(req: Request) -> Response:
            from predictionio_tpu_torch.tools.dashboard import _fleet_page
            return Response.text(
                _fleet_page(self.tsdb,
                            [rep.snapshot() for rep in self._replicas]),
                content_type="text/html")

        @r.get("/federate")
        def federate(req: Request) -> Response:
            # each member's last good /metrics text with a `member`
            # label on every sample: one scrape target for the fleet (a
            # member's failures never fail the endpoint)
            with self._federate_lock:
                items = sorted(self._federated.items())
            out: List[str] = []
            for member, text in items:
                for line in text.splitlines():
                    if not line or line.startswith("#"):
                        continue
                    out.append(_federate_line(line, member))
            return Response.text(
                "\n".join(out) + ("\n" if out else ""),
                content_type="text/plain; version=0.0.4; charset=utf-8")

        @r.post("/stop")
        def stop(req: Request) -> Response:
            self.auth.check(req)
            threading.Thread(target=self.stop, daemon=True,
                             name="pio-torch-fleet-stop").start()
            return Response.json({"message": "Fleet shutting down"})


class _LeftRotation(Exception):
    """A member picked for a request left the rotation before the send."""


def _json_doc(text: str) -> dict:
    if not text:
        return {}
    try:
        doc = json.loads(text)
    except ValueError:
        return {}
    return doc if isinstance(doc, dict) else {}


class ReplicaAgent:
    """The heartbeat loop of a standalone replica (`cli deploy --join
    http://router:8000[,http://standby:8000]`): registers the local
    server with every router, then beats {member, model, name, shard,
    role, ready} each `heartbeat_s`. Beating every router keeps each
    membership table warm, so that a standby that wins the lease routes
    at once; a heartbeat registers too."""

    def __init__(self, server, routers: Sequence[str], advertise: str = "",
                 server_key: str = "", heartbeat_s: float = 0.0,
                 member_name: str = "", role: str = "serve"):
        self.server = server
        self.routers = [u.rstrip("/") for u in routers if u]
        self.advertise = advertise
        self.server_key = server_key
        self.heartbeat_s = heartbeat_s
        self.member_name = member_name
        # "ingest" (`cli ingestd --join`) rides the same membership and
        # beats, and the router keeps it out of the query rotation
        self.role = role
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._router_down: Dict[str, bool] = {}
        self.beat = None

    def start(self) -> None:
        if not self.advertise:
            self.advertise = f"127.0.0.1:{self.server.port}"
        if self._beat_all("/fleet/register", first=True) == 0:
            _log.warning("fleet_register_failed_everywhere",
                         routers=",".join(self.routers))
        if self.heartbeat_s <= 0:
            self.heartbeat_s = 1.0
        if self.beat is None:
            # a dead agent means missed beats and the ejection of a
            # healthy replica: restartable, on a tight budget
            self.beat = watchdog().register(
                "agent", budget_s=self.heartbeat_s * 3.0 + 5.0,
                restart=self._spawn)
            watchdog().ensure_started()
        self._spawn()

    def _spawn(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-replica-agent", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _payload(self) -> bytes:
        try:
            ready, _ = self.server.readiness()
        except Exception:  # noqa: BLE001 — report not ready
            ready = False
        shard = getattr(self.server, "shard_spec", lambda: "")()
        return json.dumps({"member": self.advertise,
                           "model": self.server.current_instance_id(),
                           "name": self.member_name, "shard": shard,
                           "role": self.role,
                           "ready": bool(ready)}).encode()

    def _post(self, url: str, data: bytes) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.server_key:
            headers["Authorization"] = "Basic " + base64.b64encode(
                f"{self.server_key}:".encode()).decode()
        req = urllib.request.Request(url, data=data, method="POST",
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=3) as resp:
            return json.loads(resp.read() or b"{}")

    def _beat_all(self, path: str, first: bool = False) -> int:
        data = self._payload()
        ok = 0
        for router in self.routers:
            try:
                out = self._post(router + path, data)
            except (OSError, ValueError) as e:
                if not self._router_down.get(router):
                    _log.warning("fleet_router_unreachable", router=router,
                                 error=f"{type(e).__name__}: {e}")
                self._router_down[router] = True
                continue
            if self._router_down.get(router):
                _log.info("fleet_router_reachable_again", router=router)
            self._router_down[router] = False
            ok += 1
            if first and self.heartbeat_s <= 0:
                hb = float(out.get("heartbeat_s") or 0)
                if hb > 0:
                    self.heartbeat_s = hb
        return ok

    def _loop(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._loop_body)
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        beat = self.beat
        while not self._stop.wait(self.heartbeat_s):
            if beat is not None:
                beat.tick()
            self._beat_all("/fleet/heartbeat")


_PROM_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_prom(text: str) -> Dict[tuple, float]:
    """Prometheus text exposition -> {(name, sorted label tuple):
    value}; a line that does not parse is skipped (a member of a newer
    build still federates)."""
    out: Dict[tuple, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        try:
            value = float(val)
        except ValueError:
            continue
        brace = head.find("{")
        if brace < 0:
            out[(head, ())] = value
        else:
            labels = tuple(sorted(_PROM_LABEL_RE.findall(head[brace:])))
            out[(head[:brace], labels)] = value
    return out


def _prom_hist_p99(parsed: Dict[tuple, float], prev: Dict[tuple, float],
                   bucket_name: str) -> float:
    """p99 of the histogram's growth between two scrapes, over every
    series of `bucket_name` together (linear within the bucket, the
    registry's own estimator); 0.0 when nothing was observed."""
    by_le: Dict[float, float] = {}
    for (name, labels), v in parsed.items():
        if name != bucket_name:
            continue
        le_s = dict(labels).get("le", "+Inf")
        le = float("inf") if le_s == "+Inf" else float(le_s)
        delta = v - prev.get((name, labels), 0.0)
        if delta > 0:
            by_le[le] = by_le.get(le, 0.0) + delta
    if not by_le:
        return 0.0
    bounds = sorted(by_le)
    total = by_le[bounds[-1]] if bounds[-1] == float("inf") else max(
        by_le.values())
    if total <= 0:
        return 0.0
    target = 0.99 * total
    lower = 0.0
    prev_cum = 0.0
    for le in bounds:
        cum = by_le[le]
        if cum >= target:
            if le == float("inf"):
                return lower
            span = cum - prev_cum
            frac = ((target - prev_cum) / span) if span > 0 else 1.0
            return lower + (le - lower) * frac
        prev_cum = cum
        lower = le if le != float("inf") else lower
    return lower


def _federate_line(line: str, member: str) -> str:
    """One exposition sample with `member=` added to its labels."""
    head, _, val = line.rpartition(" ")
    if head.endswith("}"):
        return f'{head[:-1]},member="{member}"}} {val}'
    return f'{head}{{member="{member}"}} {val}'


def _fleet_metrics(metrics: MetricsRegistry) -> Dict[str, Any]:
    return {
        "scrapes": metrics.counter(
            "pio_fleet_metrics_scrapes_total",
            "Member /metrics federation scrapes by outcome",
            labels=("outcome",)),
        "member_qps": metrics.gauge(
            "pio_fleet_member_qps",
            "Per-member HTTP request rate derived from federation "
            "scrapes", labels=("member",)),
        "member_p99": metrics.gauge(
            "pio_fleet_member_p99_seconds",
            "Per-member request p99 over the last scrape interval",
            labels=("member",)),
        "member_burn": metrics.gauge(
            "pio_fleet_member_burn",
            "Per-member worst 5m SLO burn rate", labels=("member",)),
        "member_balance": metrics.gauge(
            "pio_fleet_member_reactor_balance",
            "Per-member max/mean reactor request skew (1.0 = balanced)",
            labels=("member",)),
        "routed": metrics.counter(
            "pio_fleet_routed_total",
            "Router outcomes (ok/retried/redirected/no_replica/exhausted)",
            labels=("outcome",)),
        "transitions": metrics.counter(
            "pio_fleet_transitions_total",
            "Member lifecycle events (admit/eject/register/reload_start)",
            labels=("event",)),
        "rolls": metrics.counter(
            "pio_fleet_rolling_reload_total",
            "Rolling reloads by outcome", labels=("outcome",)),
        "admitted": metrics.gauge(
            "pio_fleet_replicas_admitted",
            "Members currently admitted to routing"),
        "size": metrics.gauge(
            "pio_fleet_replicas_total", "Members managed by the fleet"),
        "members": metrics.gauge(
            "pio_fleet_members",
            "Members in the routing table (in-process + remote)"),
        "leader": metrics.gauge(
            "pio_fleet_leader",
            "1 while this router holds the fleet leadership lease"),
        "handoff": metrics.counter(
            "pio_fleet_handoff_total",
            "Leadership handoffs (lease taken over from a dead holder)"),
        "beat_age": metrics.gauge(
            "pio_fleet_heartbeat_age_seconds",
            "Seconds since each member's last heartbeat or healthy probe",
            labels=("member",)),
        "shard_owner": metrics.gauge(
            "pio_fleet_shard_owner",
            "Mesh shard ownership (1 = admitted owner of the shard)",
            labels=("shard", "member")),
        "mesh": metrics.counter(
            "pio_fleet_mesh_merged_total",
            "Cross-host mesh merges by outcome (ok/partial/empty)",
            labels=("outcome",)),
    }
