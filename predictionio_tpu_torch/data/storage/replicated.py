"""Replicated model store ("REPLICATED" type): quorum writes + read-repair.

The port of `predictionio_tpu/data/storage/replicated.py`: one torn blob
or one lost disk must never cost a deploy. A REPLICATED source is a
virtual Models (and Leases) store fanning out over N other configured
sources:

  PIO_STORAGE_SOURCES_<N>_TYPE=REPLICATED
  PIO_STORAGE_SOURCES_<N>_REPLICAS=R1,R2,R3    (names of other sources)
  PIO_STORAGE_SOURCES_<N>_QUORUM=2             (optional; default majority)

Semantics:

  - `insert`/`delete` fan out to every target CONCURRENTLY (one worker
    per target) and ack once a QUORUM of targets succeeded — write
    latency tracks the quorum-th fastest target, not the sum of all
    targets; stragglers finish in the background so healthy-but-slow
    replicas still converge. Each target is independently wrapped in
    the registry's resilience proxy, so per-target retry schedules,
    retry budgets, and circuit breakers apply before a
    target counts as failed. Fewer acks than quorum raises
    StorageError.
  - `get` reads targets in configured order and returns the first
    INTACT copy (the envelope checksum is the arbiter). A replica
    that was corrupt (`CorruptBlobError`) or missing the blob is
    READ-REPAIRED in place: the verified payload is rewritten through
    the target's own atomic-write path, counted in
    `pio_model_repair_total{target}`. Unreachable targets are skipped,
    never written.
  - `fsck` aggregates each target's own fsck pass (quarantine etc. per
    driver) and `check_divergence(ids)` compares payload digests across
    replicas for the given instance ids — same id, differing checksum
    is the silent failure mode quorum writes leave behind; with
    `repair` the majority (first-target tie-break) copy is rewritten
    everywhere (`pio doctor --repair`).

The registry hands each target DAO out through its normal construction
path, so chaos seams (`storage.<target>.Models.*`,
`storage.<target>.models.insert.torn`) and metrics keep their
per-target identity — a partition of one target mid-quorum-write is
one armed fault rule away.
"""

from __future__ import annotations

import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

# a module import (not names): integrity imports storage.base, so this
# module may load while integrity is still initializing
from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (Lease, Model,
                                                      StorageError)
from predictionio_tpu_torch.obs import get_logger, get_registry

_log = get_logger("storage.replicated")


def _metrics():
    reg = get_registry()
    return {
        "repair": reg.counter(
            "pio_model_repair_total",
            "Model blobs rewritten on a replica by read-repair or "
            "divergence repair", labels=("target",)),
        "writes": reg.counter(
            "pio_replica_writes_total",
            "Per-target replica write outcomes", labels=("target",
                                                         "outcome")),
        "quorum": reg.counter(
            "pio_replica_quorum_total",
            "Quorum-acked operations by outcome", labels=("op", "outcome")),
        "divergence": reg.counter(
            "pio_replica_divergence_total",
            "Instance ids found with diverging replica checksums"),
    }


class ReplicatedStorageClient:
    """Holds the target-source names; DAOs are resolved lazily through
    the owning registry so each target keeps its own resilience proxy."""

    # the registry passes itself to factories advertising this flag
    needs_registry = True

    def __init__(self, config: Optional[dict] = None, registry=None):
        self.config = dict(config or {})
        self.registry = registry
        self.source_name = self.config.get("SOURCE_NAME", "REPLICATED")
        raw = self.config.get("REPLICAS", self.config.get("replicas", ""))
        self.targets: List[str] = [t.strip() for t in raw.split(",")
                                   if t.strip()]
        if len(self.targets) < 2:
            raise StorageError(
                f"REPLICATED source {self.source_name} needs >= 2 target "
                "sources (PIO_STORAGE_SOURCES_<N>_REPLICAS=A,B[,C...])")
        if registry is None:
            raise StorageError(
                "REPLICATED source requires registry-driven construction")
        for t in self.targets:
            if t == self.source_name:
                raise StorageError(
                    f"REPLICATED source {self.source_name} lists itself "
                    "as a replica target")
            scfg = registry.sources.get(t)
            if scfg is None:
                raise StorageError(
                    f"REPLICATED source {self.source_name}: unknown "
                    f"target source {t!r}")
            if scfg.get("TYPE", "").upper() == "REPLICATED":
                raise StorageError(
                    f"REPLICATED source {self.source_name}: target {t!r} "
                    "is itself REPLICATED (nesting not supported)")
        q = self.config.get("QUORUM", self.config.get("quorum"))
        self.quorum = int(q) if q else len(self.targets) // 2 + 1
        if not (1 <= self.quorum <= len(self.targets)):
            raise StorageError(
                f"REPLICATED source {self.source_name}: QUORUM "
                f"{self.quorum} outside 1..{len(self.targets)}")


class ReplicatedModels(base.Models):
    """Quorum-write / read-repair Models DAO over the client's targets."""

    def __init__(self, client: ReplicatedStorageClient):
        self.c = client
        self._lock = threading.Lock()
        self._daos: Optional[List[Tuple[str, base.Models]]] = None
        self._inflight: List = []    # straggler writes past quorum ack
        self._m = _metrics()

    def _targets(self) -> List[Tuple[str, base.Models]]:
        """(name, DAO) per target, resolved once through the registry
        (each comes back wrapped in its own resilience proxy)."""
        with self._lock:
            if self._daos is None:
                self._daos = [
                    (t, self.c.registry.get_data_object(t, "Models"))
                    for t in self.c.targets]
            return self._daos

    # -- writes -------------------------------------------------------------
    def _fan_out(self, op: str, fn) -> None:
        """Fan the write out to every target CONCURRENTLY and ack as
        soon as a QUORUM succeeded — write latency is the quorum-th
        fastest target (bounded by max(target)), not sum(target) as the
        old serial loop was. Stragglers keep running after the ack so
        slow-but-healthy replicas still converge; their per-target
        metrics and failure logs land when they finish. Each worker
        calls the target through its own resilience proxy, so
        per-target retry schedules, budgets, and breakers are exactly
        what they were under the serial loop."""
        targets = self._targets()
        n = len(targets)
        cond = threading.Condition()
        state = {"acks": 0, "done": 0}
        failures: List[Tuple[str, Exception]] = []

        def run(name: str, dao: base.Models) -> None:
            try:
                fn(dao)
            except Exception as e:
                self._m["writes"].labels(target=name,
                                         outcome="failed").inc()
                _log.warning("replica_write_failed", op=op, target=name,
                             error=f"{type(e).__name__}: {e}")
                with cond:
                    failures.append((name, e))
                    state["done"] += 1
                    cond.notify_all()
                return
            self._m["writes"].labels(target=name, outcome="ok").inc()
            with cond:
                state["acks"] += 1
                state["done"] += 1
                cond.notify_all()

        pool = ThreadPoolExecutor(max_workers=n,
                                  thread_name_prefix=f"replica-{op}")
        try:
            futs = [pool.submit(run, name, dao) for name, dao in targets]
            with self._lock:
                self._inflight = [f for f in self._inflight
                                  if not f.done()] + futs
            with cond:
                while state["acks"] < self.c.quorum and state["done"] < n:
                    cond.wait(timeout=0.5)
                acks = state["acks"]
                detail = "; ".join(f"{name}: {type(e).__name__}: {e}"
                                   for name, e in failures)
        finally:
            # no wait: an early quorum ack must not join stragglers
            pool.shutdown(wait=False)
        if acks < self.c.quorum:
            self._m["quorum"].labels(op=op, outcome="failed").inc()
            raise StorageError(
                f"replicated {op}: quorum not met "
                f"({acks}/{self.c.quorum} of {len(self.c.targets)} "
                f"targets acked; failures: {detail})")
        self._m["quorum"].labels(op=op, outcome="ok").inc()

    def _drain(self, timeout_s: float = 30.0) -> None:
        """Join straggler replica writes from earlier quorum-acked
        fan-outs (deterministic sequencing for tests and shutdown)."""
        with self._lock:
            pending, self._inflight = self._inflight, []
        for f in pending:
            try:
                f.result(timeout=timeout_s)
            except Exception:
                pass    # the worker already logged and counted it

    def insert(self, m: Model) -> None:
        self._fan_out("insert", lambda dao: dao.insert(m))

    def delete(self, mid: str) -> None:
        self._fan_out("delete", lambda dao: dao.delete(mid))

    # -- reads + read-repair ------------------------------------------------
    def get(self, mid: str) -> Optional[Model]:
        """First intact copy wins; earlier replicas that were corrupt or
        missing the blob are repaired from it (envelope-level
        read-repair). Targets that ERRORED (unreachable/breaker-open)
        are skipped and never written — repair needs positive evidence
        the replica is alive but wrong, not merely silent."""
        stale: List[Tuple[str, base.Models, str]] = []   # needs rewrite
        errors: List[Exception] = []
        saw_target = False
        for name, dao in self._targets():
            try:
                model = dao.get(mid)
            except integrity.CorruptBlobError as e:
                # the replica answered — positive evidence it is alive
                # but wrong, which is exactly what repair needs
                saw_target = True
                stale.append((name, dao, f"corrupt: {e}"))
                continue
            except (StorageError, OSError) as e:
                errors.append(e)
                continue
            saw_target = True
            if model is None:
                stale.append((name, dao, "missing"))
                continue
            self._repair(mid, model, stale)
            return model
        if saw_target:
            # every reachable replica agreed the blob does not exist
            if any(reason.startswith("corrupt") for _, _, reason in stale):
                raise integrity.CorruptBlobError(
                    f"model {mid}: every replica holding the blob is "
                    "corrupt; no intact copy to repair from")
            return None
        if errors:
            raise errors[-1]
        return None

    def _repair(self, mid: str, model: Model,
                stale: Sequence[Tuple[str, base.Models, str]]) -> None:
        for name, dao, reason in stale:
            try:
                dao.insert(model)
            except Exception as e:
                _log.warning("read_repair_failed", id=mid, target=name,
                             error=f"{type(e).__name__}: {e}")
                continue
            self._m["repair"].labels(target=name).inc()
            _log.warning("read_repair", id=mid, target=name, was=reason)

    def list_model_ids(self) -> List[str]:
        """Union of every reachable target's enumerable ids — a blob a
        quorum write missed on some replica still shows up as long as
        ONE replica holds it (that asymmetry is exactly what the
        divergence sweep wants to examine)."""
        ids: set = set()
        for name, dao in self._targets():
            lister = getattr(dao, "list_model_ids", None)
            if lister is None:
                continue
            try:
                ids.update(lister())
            except (StorageError, OSError) as e:
                _log.warning("list_model_ids_failed", target=name,
                             error=f"{type(e).__name__}: {e}")
        return sorted(ids)

    # -- fsck / divergence ---------------------------------------------------
    def fsck(self, repair: bool = False) -> List[dict]:
        """Each target's own fsck pass, findings tagged with the target
        name. A target whose fsck itself fails contributes one
        `fsck_error` finding instead of aborting the sweep."""
        findings: List[dict] = []
        for name, dao in self._targets():
            run = getattr(dao, "fsck", None)
            if run is None:
                continue
            try:
                found = run(repair=repair)
            except (StorageError, OSError) as e:
                found = [{"kind": "fsck_error", "reason": str(e),
                          "action": "none"}]
            for f in found:
                f.setdefault("target", name)
            findings.extend(found)
        return findings

    def check_divergence(self, ids: Sequence[str],
                         repair: bool = False) -> List[dict]:
        """Compare payload digests for each instance id across replicas.

        Divergence = same id, differing checksums (or a copy missing /
        corrupt on some replicas) — what a partitioned target misses
        during a quorum write, or silent rot fsck alone can't arbitrate.
        With `repair`, the majority digest (first-target order breaks
        ties) is rewritten to every disagreeing replica."""
        findings: List[dict] = []
        targets = self._targets()
        for mid in ids:
            copies: Dict[str, Optional[Model]] = {}
            states: Dict[str, str] = {}
            for name, dao in targets:
                try:
                    m = dao.get(mid)
                except integrity.CorruptBlobError:
                    states[name] = "corrupt"
                    copies[name] = None
                    continue
                except (StorageError, OSError) as e:
                    states[name] = f"unreachable: {type(e).__name__}"
                    copies[name] = None
                    continue
                if m is None:
                    states[name] = "missing"
                    copies[name] = None
                else:
                    states[name] = "sha256:" + hashlib.sha256(
                        m.models).hexdigest()[:16]
                    copies[name] = m
            digests = [s for s in states.values() if s.startswith("sha256:")]
            if not digests:
                continue   # nowhere intact: nothing to arbitrate
            if len(set(states.values())) == 1:
                continue   # all replicas agree
            self._m["divergence"].inc()
            finding = {"kind": "replica_divergence", "id": mid,
                       "replicas": dict(states),
                       "reason": "replica checksums disagree",
                       "action": "none"}
            if repair:
                finding["action"] = self._repair_divergence(
                    mid, targets, states, copies)
            findings.append(finding)
        return findings

    def _repair_divergence(self, mid, targets, states, copies) -> str:
        # majority digest wins; ties break in configured target order
        counts: Dict[str, int] = {}
        for s in states.values():
            if s.startswith("sha256:"):
                counts[s] = counts.get(s, 0) + 1
        best = max(counts.values())
        winner = next(s for n, _ in targets
                      if (s := states[n]).startswith("sha256:")
                      and counts[s] == best)
        source = next(copies[n] for n, _ in targets if states[n] == winner)
        repaired = []
        for name, dao in targets:
            if states[name] == winner \
                    or states[name].startswith("unreachable"):
                continue
            try:
                dao.insert(source)
            except Exception as e:
                _log.warning("divergence_repair_failed", id=mid,
                             target=name,
                             error=f"{type(e).__name__}: {e}")
                continue
            self._m["repair"].labels(target=name).inc()
            repaired.append(name)
        return (f"rewrote {','.join(repaired)} from {winner}"
                if repaired else "repair failed on every replica")

    # -- quarantine delegation ----------------------------------------------
    def quarantine_stats(self) -> Dict[str, float]:
        """Aggregate quarantine footprint across targets (for the
        `pio_quarantine_bytes` gauge)."""
        total = {"bytes": 0.0, "count": 0.0}
        for _, dao in self._targets():
            stats = getattr(dao, "quarantine_stats", None)
            if stats is None:
                continue
            try:
                s = stats()
            except (StorageError, OSError):
                continue
            total["bytes"] += s.get("bytes", 0.0)
            total["count"] += s.get("count", 0.0)
        return total

    def quarantine_gc(self, retention_s: float) -> List[dict]:
        """Chain each target's quarantine GC (scheduled-fsck retention)."""
        findings: List[dict] = []
        for name, dao in self._targets():
            gc = getattr(dao, "quarantine_gc", None)
            if gc is None:
                continue
            try:
                found = gc(retention_s)
            except (StorageError, OSError) as e:
                found = [{"kind": "quarantine_gc_error", "reason": str(e),
                          "action": "none"}]
            for f in found:
                f.setdefault("target", name)
            findings.extend(found)
        return findings


class ReplicatedLeases(base.Leases):
    """Quorum lease over the targets: a holder is the leader only while
    a majority of target stores agree. Two routers racing through a
    partition can each win a minority of targets, but never two
    overlapping majorities — the same overlap argument as the quorum
    writes above. A failed (sub-quorum) acquire releases the targets it
    did win, so a partial grab never starves the actual winner."""

    def __init__(self, client: ReplicatedStorageClient):
        self.c = client
        self._lock = threading.Lock()
        self._daos: Optional[List[Tuple[str, base.Leases]]] = None

    def _targets(self) -> List[Tuple[str, base.Leases]]:
        with self._lock:
            if self._daos is None:
                daos = []
                for t in self.c.targets:
                    try:
                        daos.append(
                            (t, self.c.registry.get_data_object(t, "Leases")))
                    except StorageError as e:
                        _log.warning("lease_target_unsupported", target=t,
                                     error=str(e))
                self._daos = daos
            return self._daos

    def acquire(self, name: str, holder: str, ttl_s: float,
                journal: Optional[str] = None) -> Optional[Lease]:
        targets = self._targets()
        won: List[Tuple[str, base.Leases]] = []
        lease: Optional[Lease] = None
        for tname, dao in targets:
            try:
                got = dao.acquire(name, holder, ttl_s, journal)
            except (StorageError, OSError) as e:
                _log.warning("lease_acquire_failed", target=tname,
                             error=f"{type(e).__name__}: {e}")
                continue
            if got is not None:
                won.append((tname, dao))
                lease = got
        if len(won) >= self.c.quorum:
            return lease
        for tname, dao in won:
            try:
                dao.release(name, holder)
            except (StorageError, OSError):
                pass    # its TTL will expire it
        return None

    def get(self, name: str) -> Optional[Lease]:
        """The majority holder's freshest row; with no majority, the
        freshest row seen (conservative: callers treat any row as a
        possibly-live lease)."""
        rows: List[Lease] = []
        for tname, dao in self._targets():
            try:
                row = dao.get(name)
            except (StorageError, OSError):
                continue
            if row is not None:
                rows.append(row)
        if not rows:
            return None
        by_holder: Dict[str, List[Lease]] = {}
        for row in rows:
            by_holder.setdefault(row.holder, []).append(row)
        majority = [ls for ls in by_holder.values()
                    if len(ls) >= self.c.quorum]
        pool = majority[0] if majority else rows
        return max(pool, key=lambda l: l.expires_at)

    def release(self, name: str, holder: str) -> bool:
        released = False
        for tname, dao in self._targets():
            try:
                released = dao.release(name, holder) or released
            except (StorageError, OSError):
                pass
        return released
