"""Storage registry: config-driven backend discovery and DAO construction.

The port of `predictionio_tpu/data/storage/registry.py` (Storage.scala:
147-452). Sources are declared by
`PIO_STORAGE_SOURCES_<NAME>_TYPE` (plus driver keys such as `_PATH`);
`PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}`
bind the three data roles to sources. Layers, highest first: an explicit
dict, the process environment, a `pio-env` file (KEY=VALUE lines) named
by `$PIO_ENV_FILE` or found at `./pio-env` or `~/.pio_store/pio-env`.

Drivers register in `DRIVERS` (`register_driver`): MEM and SQLITE for
every DAO; EVLOG (a journal per app/channel, `PATH`) and PEVLOG (the
indexed, delta-capable event store: time-bucketed segment journals,
`PATH` and `BUCKET_HOURS`, default 24) for events only; POSTGRES and
PGSQL (`postgres.py`, over the wire client `pgwire.py`: `URL` or
`HOST`/`PORT`/`DATABASE`/`USERNAME`/`PASSWORD`) for every DAO but
leases; LOCALFS (`PATH`) for models and leases; OBJECTSTORE, S3 and
HDFS (fsspec, imported when such a source is opened) for models;
REPLICATED (`REPLICAS`, `QUORUM`) for models and leases over other
sources. With no configuration at all, one SQLITE source at
`./.pio_store/pio.db` holds everything, the JAX package's zero-config
default, so that both packages run from one directory share one store.

Every DAO comes wrapped in `resilient.ResilientDAO` (retry of transient
errors, one circuit breaker and one retry budget per source, the
`storage.<source>.<dao>.<method>` fault seams), except a REPLICATED
source's, whose targets carry their own (a quorum failure is final and
must not be retried). The per-source keys `RESILIENCE` (`off` unwraps),
`RETRY_ATTEMPTS`, `RETRY_BASE_DELAY`, `BREAKER_THRESHOLD`,
`BREAKER_RECOVERY_S` and `RETRY_BUDGET` (tokens; `off` unbudgeted) tune
them, at the JAX defaults (3 attempts from 50 ms, 5 failures, 30 s, 50
tokens). `breaker_states()` feeds every server's `/ready`.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    TRANSIENT_STORAGE_ERRORS, StorageError)
from predictionio_tpu_torch.data.storage.resilient import ResilientDAO
from predictionio_tpu_torch.resilience import (CircuitBreaker, RetryBudget,
                                               RetryPolicy)

# type name -> {"client": factory, "daos": {dao name -> DAO class}}
DRIVERS: Dict[str, Dict[str, object]] = {}


def register_driver(type_name: str, client_factory: Callable,
                    daos: Mapping[str, Callable]) -> None:
    DRIVERS[type_name.upper()] = {"client": client_factory, "daos": dict(daos)}


def _register_builtin_drivers() -> None:
    from predictionio_tpu_torch.data.storage import (evlog, localfs, memory,
                                                     objectstore, pevlog,
                                                     postgres, replicated,
                                                     sqlite)

    register_driver("MEM", memory.MemStorageClient, {
        "Apps": memory.MemApps,
        "AccessKeys": memory.MemAccessKeys,
        "Channels": memory.MemChannels,
        "EngineInstances": memory.MemEngineInstances,
        "EvaluationInstances": memory.MemEvaluationInstances,
        "Models": memory.MemModels,
        "Leases": memory.MemLeases,
        "TenantQuotas": memory.MemTenantQuotas,
        "SLOObjectives": memory.MemSLOObjectives,
        "Events": memory.MemEvents,
    })
    register_driver("SQLITE", sqlite.SQLiteStorageClient, {
        "Apps": sqlite.SQLiteApps,
        "AccessKeys": sqlite.SQLiteAccessKeys,
        "Channels": sqlite.SQLiteChannels,
        "EngineInstances": sqlite.SQLiteEngineInstances,
        "EvaluationInstances": sqlite.SQLiteEvaluationInstances,
        "Models": sqlite.SQLiteModels,
        "Leases": sqlite.SQLiteLeases,
        "TenantQuotas": sqlite.SQLiteTenantQuotas,
        "SLOObjectives": sqlite.SQLiteSLOObjectives,
        "Events": sqlite.SQLiteEvents,
    })
    register_driver("EVLOG", evlog.EvlogStorageClient, {
        "Events": evlog.EvlogEvents,
    })
    register_driver("PEVLOG", pevlog.PevlogStorageClient, {
        "Events": pevlog.PevlogEvents,
    })
    register_driver("LOCALFS", localfs.LocalFSStorageClient, {
        "Models": localfs.LocalFSModels,
        "Leases": localfs.LocalFSLeases,
    })
    # the reference's jdbc driver set; the connection opens with the
    # source, and POSTGRES keeps no lease table (as the JAX driver)
    for type_name in ("POSTGRES", "PGSQL"):
        register_driver(type_name, postgres.PostgresStorageClient, {
            "Apps": postgres.PostgresApps,
            "AccessKeys": postgres.PostgresAccessKeys,
            "Channels": postgres.PostgresChannels,
            "EngineInstances": postgres.PostgresEngineInstances,
            "EvaluationInstances": postgres.PostgresEvaluationInstances,
            "Models": postgres.PostgresModels,
            "TenantQuotas": postgres.PostgresTenantQuotas,
            "SLOObjectives": postgres.PostgresSLOObjectives,
            "Events": postgres.PostgresEvents,
        })
    # S3 and HDFS are the reference's driver names; OBJECTSTORE takes
    # any fsspec URL (fsspec is imported when such a source opens)
    for type_name in ("OBJECTSTORE", "S3", "HDFS"):
        register_driver(type_name, objectstore.ObjectStoreStorageClient,
                        {"Models": objectstore.ObjectStoreModels})
    register_driver("REPLICATED", replicated.ReplicatedStorageClient, {
        "Models": replicated.ReplicatedModels,
        "Leases": replicated.ReplicatedLeases,
    })


_register_builtin_drivers()

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")
_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")


def load_env_file(path: Optional[str] = None) -> Dict[str, str]:
    """KEY=VALUE lines of a pio-env file (bin/load-pio-env.sh)."""
    candidates = [path] if path else [
        os.environ.get("PIO_ENV_FILE"),
        "./pio-env", os.path.expanduser("~/.pio_store/pio-env")]
    out: Dict[str, str] = {}
    for cand in candidates:
        if cand and Path(cand).is_file():
            for line in Path(cand).read_text().splitlines():
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip().strip('"').strip("'")
            break
    return out


def effective_config(overrides: Optional[Mapping[str, str]] = None
                     ) -> Dict[str, str]:
    """Layered config: env file < process env < explicit overrides."""
    cfg = load_env_file()
    cfg.update({k: v for k, v in os.environ.items() if k.startswith("PIO_")})
    if overrides:
        cfg.update(overrides)
    return cfg


class StorageRegistry:
    """Sources (driver clients) and repository bindings; hands out DAOs
    (the accessors of Storage.scala:399-452)."""

    def __init__(self, config: Optional[Mapping[str, str]] = None):
        self.config = effective_config(config)
        self._lock = threading.RLock()
        self._clients: Dict[str, object] = {}
        self._daos: Dict[Tuple[str, str], object] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._budgets: Dict[str, Optional[RetryBudget]] = {}
        self.sources, self.repositories = self._parse(self.config)

    @staticmethod
    def _parse(cfg: Mapping[str, str]):
        sources: Dict[str, Dict[str, str]] = {}
        repos: Dict[str, Dict[str, str]] = {}
        for k, v in cfg.items():
            m = _SOURCE_RE.match(k)
            if m:
                sources.setdefault(m.group(1), {})[m.group(2)] = v
            m = _REPO_RE.match(k)
            if m:
                repos.setdefault(m.group(1), {})[m.group(2)] = v
        if not sources:
            # zero-config default: one sqlite file source for everything
            sources = {"PIO": {"TYPE": "SQLITE",
                               "PATH": "./.pio_store/pio.db"}}
        for name, scfg in sources.items():
            if "TYPE" not in scfg:
                raise StorageError(
                    f"Storage source {name} has no TYPE configured "
                    f"(PIO_STORAGE_SOURCES_{name}_TYPE)")
            if scfg["TYPE"].upper() not in DRIVERS:
                raise StorageError(
                    f"Storage source {name} has unknown TYPE "
                    f"{scfg['TYPE']!r}; known: {sorted(DRIVERS)}")
        # a repository without a SOURCE binds to the first source whose
        # driver has the DAO the repository needs
        needs = {"METADATA": "Apps", "EVENTDATA": "Events",
                 "MODELDATA": "Models"}
        for repo in REPOSITORIES:
            repos.setdefault(repo, {})
            if "SOURCE" not in repos[repo]:
                candidates = [
                    name for name, scfg in sources.items()
                    if needs[repo] in DRIVERS[scfg["TYPE"].upper()]["daos"]]
                repos[repo]["SOURCE"] = (candidates[0] if candidates
                                         else next(iter(sources)))
            repos[repo].setdefault("NAME", "pio_" + repo.lower())
        return sources, repos

    def _client(self, source_name: str):
        with self._lock:
            if source_name not in self._clients:
                if source_name not in self.sources:
                    raise StorageError(
                        f"Undefined storage source: {source_name}")
                scfg = dict(self.sources[source_name])
                scfg.setdefault("SOURCE_NAME", source_name)
                if scfg["TYPE"].upper() == "SQLITE" and "PATH" in scfg:
                    Path(scfg["PATH"]).expanduser().parent.mkdir(
                        parents=True, exist_ok=True)
                factory = DRIVERS[scfg["TYPE"].upper()]["client"]
                # a virtual source (REPLICATED) resolves its targets'
                # DAOs back through this registry
                self._clients[source_name] = (
                    factory(scfg, registry=self)
                    if getattr(factory, "needs_registry", False)
                    else factory(scfg))
            return self._clients[source_name]

    def get_data_object(self, source_name: str, dao: str):
        """(Storage.getDataObject, Storage.scala:308-357)"""
        with self._lock:
            key = (source_name, dao)
            if key not in self._daos:
                scfg = self.sources[source_name]
                driver = DRIVERS[scfg["TYPE"].upper()]
                if dao not in driver["daos"]:
                    raise StorageError(
                        f"Storage type {scfg['TYPE']} does not support "
                        f"data object {dao}")
                raw = driver["daos"][dao](self._client(source_name))
                self._daos[key] = self._wrap_resilient(raw, source_name,
                                                       dao, scfg)
            return self._daos[key]

    def _wrap_resilient(self, dao: object, source: str, dao_name: str,
                        scfg: Mapping[str, str]):
        """`dao` behind retry, the source's breaker and budget, and its
        fault seams; REPLICATED (each target wrapped already) and
        `RESILIENCE=off` stay bare."""
        default = ("off" if scfg["TYPE"].upper() == "REPLICATED"
                   else "on")
        if str(scfg.get("RESILIENCE", default)).lower() in (
                "off", "0", "false", "no"):
            return dao
        policy = RetryPolicy(
            attempts=int(scfg.get("RETRY_ATTEMPTS", 3)),
            base_delay=float(scfg.get("RETRY_BASE_DELAY", 0.05)),
            retryable=TRANSIENT_STORAGE_ERRORS)
        return ResilientDAO(
            dao, seam=f"storage.{source}.{dao_name}", source=source,
            breaker=self._breaker(source, scfg), policy=policy,
            budget=self._budget(source, scfg))

    def _breaker(self, source: str, scfg: Mapping[str, str]
                 ) -> CircuitBreaker:
        """One breaker per source, shared by all its DAOs."""
        breaker = self._breakers.get(source)
        if breaker is None:
            breaker = CircuitBreaker(
                f"storage.{source}",
                failure_threshold=int(scfg.get("BREAKER_THRESHOLD", 5)),
                recovery_time=float(scfg.get("BREAKER_RECOVERY_S", 30.0)))
            self._breakers[source] = breaker
        return breaker

    def _budget(self, source: str, scfg: Mapping[str, str]
                ) -> Optional[RetryBudget]:
        """One retry budget per source (amplification is a per-backend
        matter); None when `RETRY_BUDGET` is off."""
        if source not in self._budgets:
            raw = str(scfg.get("RETRY_BUDGET", "50")).lower()
            self._budgets[source] = (
                None if raw in ("off", "0", "false", "no", "none", "")
                else RetryBudget(capacity=float(raw)))
        return self._budgets[source]

    def breaker_states(self) -> Dict[str, str]:
        """Each opened source's breaker state ("closed", "open",
        "half-open") by source name: every server's `/ready` reads it."""
        with self._lock:
            breakers = dict(self._breakers)
        return {name: b.state for name, b in breakers.items()}

    def _repo_dao(self, repo: str, dao: str):
        return self.get_data_object(self.repositories[repo]["SOURCE"], dao)

    def get_meta_data_apps(self) -> base.Apps:
        return self._repo_dao("METADATA", "Apps")

    def get_meta_data_access_keys(self) -> base.AccessKeys:
        return self._repo_dao("METADATA", "AccessKeys")

    def get_meta_data_channels(self) -> base.Channels:
        return self._repo_dao("METADATA", "Channels")

    def get_meta_data_engine_instances(self) -> base.EngineInstances:
        return self._repo_dao("METADATA", "EngineInstances")

    def get_meta_data_evaluation_instances(self
                                           ) -> base.EvaluationInstances:
        return self._repo_dao("METADATA", "EvaluationInstances")

    def get_model_data_models(self) -> base.Models:
        return self._repo_dao("MODELDATA", "Models")

    def get_leases(self) -> base.Leases:
        """The lease DAO on the MODELDATA source (the store every router
        of a fleet shares); StorageError when its driver has none (the
        fleet then runs as the only leader)."""
        return self._repo_dao("MODELDATA", "Leases")

    def get_meta_data_tenant_quotas(self) -> base.TenantQuotas:
        """Per-app admission overrides; StorageError when the driver has
        none (admission keeps its defaults)."""
        return self._repo_dao("METADATA", "TenantQuotas")

    def get_meta_data_slo_objectives(self) -> base.SLOObjectives:
        """Per-app SLO overrides; StorageError when the driver has none
        (the SLO tracker keeps its defaults)."""
        return self._repo_dao("METADATA", "SLOObjectives")

    def get_events(self) -> base.EventStore:
        return self._repo_dao("EVENTDATA", "Events")

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                close = getattr(client, "close", None)
                if close:
                    close()
            self._clients.clear()
            self._daos.clear()


_default: Optional[StorageRegistry] = None
_default_lock = threading.Lock()


def storage(refresh: bool = False) -> StorageRegistry:
    """The process-wide default registry, built from the environment on
    first use."""
    global _default
    with _default_lock:
        if _default is None or refresh:
            _default = StorageRegistry()
        return _default


def set_default(registry: Optional[StorageRegistry]) -> None:
    """Install (or clear) the process-default registry."""
    global _default
    with _default_lock:
        _default = registry
