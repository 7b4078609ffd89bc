"""Storage registry: config-driven backend discovery and DAO construction.

The port of `predictionio_tpu/data/storage/registry.py` (Storage.scala:
147-452) without the resilience wrapper. Sources are declared by
`PIO_STORAGE_SOURCES_<NAME>_TYPE` (plus driver keys such as `_PATH`);
`PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}`
bind the three data roles to sources. Layers, highest first: an explicit
dict, the process environment, a `pio-env` file (KEY=VALUE lines) named
by `$PIO_ENV_FILE` or found at `./pio-env` or `~/.pio_store/pio-env`.

Drivers register in `DRIVERS` (`register_driver`): MEM and SQLITE for
every DAO; EVLOG (a journal per app/channel, `PATH`) and PEVLOG (the
indexed, delta-capable event store: time-bucketed segment journals,
`PATH` and `BUCKET_HOURS`, default 24) for events only. With
no configuration at all, one SQLITE source at `./.pio_store/pio.db`
holds everything, the JAX package's zero-config default, so that both
packages run from one directory share one store.
"""

from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import StorageError

# type name -> {"client": factory, "daos": {dao name -> DAO class}}
DRIVERS: Dict[str, Dict[str, object]] = {}


def register_driver(type_name: str, client_factory: Callable,
                    daos: Mapping[str, Callable]) -> None:
    DRIVERS[type_name.upper()] = {"client": client_factory, "daos": dict(daos)}


def _register_builtin_drivers() -> None:
    from predictionio_tpu_torch.data.storage import (evlog, memory, pevlog,
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
                self._clients[source_name] = DRIVERS[
                    scfg["TYPE"].upper()]["client"](scfg)
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
                self._daos[key] = driver["daos"][dao](
                    self._client(source_name))
            return self._daos[key]

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
