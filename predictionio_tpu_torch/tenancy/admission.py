"""Per-app admission control of the serve path.

The port of `predictionio_tpu/tenancy/admission.py`. The reference gates
every EVENT with per-app access keys (EventServer.scala:92-130) but
serves predictions open; with tenancy on, `/queries.json` authenticates
with the same app access keys (the `AccessKeys` / `Apps` DAOs), and
every admitted request carries a `TenantIdentity` that the
micro-batcher's DRR lanes (`tenancy/drr.py`) schedule by.

Three layers, all per tenant:

  - a token-bucket RATE limit (`rate` req/s refill, `burst` capacity);
  - a CONCURRENCY quota (`concurrency` in flight, 0 = unlimited);
  - the micro-batcher's per-tenant lane cap and DRR weight
    (`batch_params`), from the same quota row.

The first two shed with `QuotaExceeded`: 429 with `Retry-After` (the
bucket's next-token estimate), counted in `pio_shed_total{surface=
"quota",app}`. That is the JAX status. The port's `InflightLimiter`
sheds a saturated server with 503 instead (`resilience/shed.py`); the
two are kept apart on purpose.

Defaults come from `PIO_TENANCY`, `PIO_TENANT_RATE`, `PIO_TENANT_BURST`,
`PIO_TENANT_CONCURRENCY`, `PIO_TENANT_QUEUE_MAX`, `PIO_TENANT_MAX` (or
the deploy's flags); per-app overrides live in the `TenantQuotas` DAO
and are read again after `overrides_ttl_s`.

Fleet trust: the router authenticates and charges a request once, then
asserts the identity to its replicas in `X-PIO-App`, HMAC-SHA256-signed
with the fleet's `header_key` (`PIO_SERVER_ACCESS_KEY`, or a secret the
router makes for its in-process replicas). A replica runs the
`replica_variant()` (`trust_header`): a verified header skips auth and
charge, fairness still applies; an unsigned or forged one falls
through to key auth. The header's format and signature are the JAX
package's, so either package's router can front the other's replicas.

Per-tenant state is LRU-bounded at `max_tenants` (`BoundedTenantMap`).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Mapping, Optional, Tuple

from predictionio_tpu_torch.data.storage.base import TenantQuota
from predictionio_tpu_torch.obs import (MetricsRegistry, get_logger,
                                        get_registry, trace)
from predictionio_tpu_torch.resilience import OverloadedError
from predictionio_tpu_torch.utils.http import (HTTPError, Request,
                                               parse_basic_auth_value)

TENANT_HEADER = "X-PIO-App"
# the lane of every request when tenancy is off (or direct traffic to a
# trusted-header replica): one FIFO lane, no tenant bookkeeping
DEFAULT_TENANT = ""

# app labels ride in headers and metric labels: bounded length and
# charset, so a forged label cannot explode cardinality or smuggle
# header syntax
_LABEL_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.\-]{0,63}")

_log = get_logger("tenancy")


class QuotaExceeded(OverloadedError):
    """An app over its rate or concurrency quota: 429 with
    `Retry-After`."""

    status = 429


@dataclass(frozen=True)
class TenantIdentity:
    """An authenticated app on the serve path."""
    app_id: int
    label: str                   # the metrics `app` label (the app name)
    # asserted by the fleet router's signed header: the router charged
    # the quota already, so it is not charged again here
    pre_admitted: bool = False
    # a sub-tenant within the app (`?channel=`): its own bucket and
    # in-flight count, its own quota row over the app's
    channel: str = ""

    def header_value(self) -> str:
        return f"{self.app_id}:{self.label}:{self.channel}"

    @property
    def state_key(self) -> str:
        """The admission-state key ('/' is in neither a label nor a
        channel, so an app and its channels never collide)."""
        return f"{self.label}/{self.channel}" if self.channel \
            else self.label


@dataclass
class TenancyConfig:
    """Admission knobs (`PIO_TENANCY`, `PIO_TENANT_*`)."""
    enabled: bool = False
    rate: float = 100.0          # default per-app refill, req/s
    burst: float = 200.0         # default bucket capacity
    concurrency: int = 0         # default in-flight cap (0 = unlimited)
    queue_max: int = 64          # default per-tenant lane cap
    weight: float = 1.0          # default DRR weight
    max_tenants: int = 1024      # bound on per-tenant state
    # honor the fleet router's X-PIO-App (fleet replicas only)
    trust_header: bool = False
    # the HMAC key of X-PIO-App; empty on a trust_header replica means
    # the header is never honored
    header_key: str = ""
    # how stale a cached override or a cached access key may get
    overrides_ttl_s: float = 10.0

    @staticmethod
    def from_env(cfg: Optional[Mapping[str, str]] = None,
                 **overrides) -> "TenancyConfig":
        """From environment-style config (the CLI passes the storage
        registry's layered config); `overrides` win."""
        cfg = cfg if cfg is not None else os.environ
        kw: dict = {}
        mode = str(cfg.get("PIO_TENANCY", "") or "").strip().lower()
        if mode:
            kw["enabled"] = mode in ("on", "1", "true", "yes")
        try:
            for env, name, cast in (
                    ("PIO_TENANT_RATE", "rate", float),
                    ("PIO_TENANT_BURST", "burst", float),
                    ("PIO_TENANT_CONCURRENCY", "concurrency", int),
                    ("PIO_TENANT_QUEUE_MAX", "queue_max", int),
                    ("PIO_TENANT_MAX", "max_tenants", int)):
                raw = cfg.get(env)
                if raw:
                    kw[name] = cast(raw)
        except ValueError as e:
            raise ValueError(f"bad PIO_TENANT_* value: {e}") from e
        server_key = cfg.get("PIO_SERVER_ACCESS_KEY")
        if server_key:
            kw["header_key"] = server_key
        kw.update(overrides)
        return TenancyConfig(**kw)

    def default_quota(self) -> TenantQuota:
        return TenantQuota(appid=0, rate=self.rate, burst=self.burst,
                           concurrency=self.concurrency,
                           queue_max=self.queue_max, weight=self.weight)

    def replica_variant(self) -> "TenancyConfig":
        """A fleet replica's config: identity from the router's header,
        quotas charged upstream, fairness kept."""
        return replace(self, trust_header=True)


class _TokenBucket:
    """Lazy-refill token bucket on the monotonic clock; caller-locked."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = max(rate, 0.0)
        self.burst = max(burst, 1.0)
        self.tokens = self.burst
        self.t_last = time.monotonic()

    def try_take(self) -> float:
        """0.0 when a token was taken, else the seconds until one
        accrues."""
        now = time.monotonic()
        if self.rate > 0:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if self.rate <= 0:
            return 1.0               # rate 0: the tenant is blocked
        return (1.0 - self.tokens) / self.rate


@dataclass
class _TenantState:
    """What admission tracks for one tenant."""
    quota: TenantQuota
    bucket: _TokenBucket
    inflight: int = 0
    quota_loaded: float = field(default_factory=time.monotonic)


class BoundedTenantMap:
    """An LRU-bounded map for tenant-keyed state. `evictable` (over
    values) passes entries over at eviction, e.g. states with requests
    in flight, whose loss would leak concurrency slots; the map may
    then exceed `cap` by what is in flight."""

    def __init__(self, cap: int,
                 evictable: Optional[Callable[[object], bool]] = None):
        self.cap = max(1, int(cap))
        self._evictable = evictable
        self._entries: "OrderedDict[str, object]" = OrderedDict()

    def get(self, key: str):
        v = self._entries.get(key)
        if v is not None:
            self._entries.move_to_end(key)
        return v

    def put(self, key: str, value) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        if len(self._entries) <= self.cap:
            return
        for k in list(self._entries):    # oldest first
            if len(self._entries) <= self.cap:
                break
            if k == key:
                continue                 # never the fresh insert
            if self._evictable is None \
                    or self._evictable(self._entries[k]):
                del self._entries[k]

    def pop(self, key: str):
        return self._entries.pop(key, None)

    def clear(self) -> int:
        """Drop every entry; returns how many there were."""
        n = len(self._entries)
        self._entries.clear()
        return n

    def items(self):
        """(key, value) pairs, oldest first (under the owner's lock)."""
        return list(self._entries.items())

    def __len__(self) -> int:
        return len(self._entries)


class AdmissionController:
    """Authenticates `/queries.json` and enforces per-tenant quotas: one
    per `PredictionServer` and per `FleetServer`. `resolve` turns a
    request into a `TenantIdentity` (None with tenancy off); `admit`
    charges the bucket and the concurrency slot around the serve call,
    as a context manager."""

    def __init__(self, config: TenancyConfig, registry=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.config = config
        self.registry = registry
        metrics = metrics if metrics is not None else get_registry()
        self._lock = threading.Lock()
        self._tenants = BoundedTenantMap(
            config.max_tenants, evictable=lambda st: st.inflight <= 0)
        # access key -> (identity, load time): positive entries only,
        # read again after overrides_ttl_s so a revoked key stops
        self._keys = BoundedTenantMap(config.max_tenants)
        # spent buckets inherited from a previous lease holder for
        # tenants not seen here yet: (tokens, rate, burst, adopted at)
        self._inherited = BoundedTenantMap(config.max_tenants)
        self._warned_no_header_key = False
        self._shed = metrics.counter(
            "pio_shed_total", "Requests shed by surface at admission",
            labels=("surface", "app"))
        self._admitted = metrics.counter(
            "pio_tenant_admitted_total",
            "Requests admitted through per-tenant quota checks",
            labels=("app",))
        self._tenant_gauge = metrics.gauge(
            "pio_tenant_active", "Tenants with live admission state")
        self._quota_dao = None
        self._quota_dao_failed = False

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def trim_key_cache(self) -> int:
        """The memory-pressure trim: drop the access-key cache (a key
        seen again is read from the store once more). Returns about the
        bytes released."""
        with self._lock:
            return self._keys.clear() * 256

    # -- authentication -----------------------------------------------------
    def resolve(self, req: Request) -> Optional[TenantIdentity]:
        """The request's tenant; None with tenancy off. HTTPError 401 on
        missing or invalid credentials."""
        if not self.config.enabled:
            return None
        return self.resolve_raw(
            req.query_get("accessKey"), req.header(TENANT_HEADER),
            req.header("Authorization"), req.query_get("channel"))

    def resolve_raw(self, access_key: Optional[str],
                    tenant_header: Optional[str],
                    authorization: Optional[str],
                    channel: Optional[str] = None
                    ) -> Optional[TenantIdentity]:
        """`resolve` on the three raw values the fast route scans out of
        the header block (no Request, no header dict)."""
        if not self.config.enabled:
            return None
        if channel and not _LABEL_RE.fullmatch(channel):
            raise HTTPError(400, "Invalid channel.")
        if self.config.trust_header and tenant_header:
            ident = self._parse_header(tenant_header)
            if ident is not None:
                return ident
        key = access_key
        if key is None:
            key = parse_basic_auth_value(authorization)
            if key is None:
                raise HTTPError(401, "Missing accessKey.")
        now = time.monotonic()
        with self._lock:
            cached = self._keys.get(key)
        if cached is not None \
                and now - cached[1] <= self.config.overrides_ttl_s:
            return self._with_channel(cached[0], channel)
        try:
            ak = self._access_keys().get(key)
        except HTTPError:
            raise
        except Exception as e:  # noqa: BLE001 — the store is down
            if cached is not None:
                # keep serving a key that was valid
                return self._with_channel(cached[0], channel)
            raise HTTPError(503, "access-key store unavailable: "
                                 f"{type(e).__name__}") from e
        if ak is None:
            with self._lock:
                self._keys.pop(key)
            raise HTTPError(401, "Invalid accessKey.")
        ident = TenantIdentity(app_id=ak.appid,
                               label=self._app_label(ak.appid))
        with self._lock:
            self._keys.put(key, (ident, now))
        return self._with_channel(ident, channel)

    @staticmethod
    def _with_channel(ident: TenantIdentity,
                      channel: Optional[str]) -> TenantIdentity:
        if not channel or ident.channel == channel:
            return ident
        return replace(ident, channel=channel)

    def signed_header(self, tenant: TenantIdentity) -> str:
        """The X-PIO-App value a router asserts to its replicas:
        `appid:label:channel:hmac`, keyed on `header_key`; unsigned
        without a key (a verifying replica refuses it)."""
        payload = tenant.header_value()
        key = self.config.header_key
        if not key:
            return payload
        sig = hmac.new(key.encode(), payload.encode(),
                       hashlib.sha256).hexdigest()
        return f"{payload}:{sig}"

    def _parse_header(self, value: str) -> Optional[TenantIdentity]:
        """A verified X-PIO-App's identity, else None (key auth then)."""
        key = self.config.header_key
        if not key:
            if not self._warned_no_header_key:
                self._warned_no_header_key = True
                _log.warning(
                    "tenant_header_refused_no_key",
                    detail="trust_header set but no header_key; set "
                           "PIO_SERVER_ACCESS_KEY on every fleet host")
            return None
        payload, sep, sig = value.rpartition(":")
        if not sep:
            return None
        expect = hmac.new(key.encode(), payload.encode(),
                          hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, expect):
            return None
        appid, sep, rest = payload.partition(":")
        if not sep:
            return None
        label, _, channel = rest.partition(":")
        if not _LABEL_RE.fullmatch(label):
            return None
        if channel and not _LABEL_RE.fullmatch(channel):
            return None
        try:
            app_id = int(appid)
        except ValueError:
            return None
        return TenantIdentity(app_id=app_id, label=label,
                              pre_admitted=True, channel=channel)

    def _access_keys(self):
        if self.registry is None:
            raise HTTPError(503, "tenancy enabled but no metadata store")
        return self.registry.get_meta_data_access_keys()

    def _app_label(self, app_id: int) -> str:
        try:
            app = self.registry.get_meta_data_apps().get(app_id)
            if app is not None and app.name:
                return app.name
        except Exception:  # noqa: BLE001 — the label falls back
            pass
        return f"app-{app_id}"

    # -- quotas -------------------------------------------------------------
    def _quotas_dao(self):
        """The overrides DAO, or None when the store has none (warned
        once; the defaults apply)."""
        if self._quota_dao is None and not self._quota_dao_failed \
                and self.registry is not None:
            try:
                self._quota_dao = \
                    self.registry.get_meta_data_tenant_quotas()
            except Exception as e:  # noqa: BLE001 — defaults apply
                self._quota_dao_failed = True
                _log.warning("tenant_quota_dao_unavailable",
                             error=f"{type(e).__name__}: {e}")
        return self._quota_dao

    def _load_quota(self, tenant: TenantIdentity) -> TenantQuota:
        """Channel row over app row over the server default."""
        default = self.config.default_quota()
        dao = self._quotas_dao()
        if dao is None:
            return default
        try:
            row = dao.get(tenant.app_id)
            ch_row = dao.get(tenant.app_id, tenant.channel) \
                if tenant.channel else None
        except Exception as e:  # noqa: BLE001 — defaults apply
            _log.warning("tenant_quota_read_failed", app=tenant.label,
                         error=f"{type(e).__name__}: {e}")
            return default
        effective = row.merged_over(default) if row is not None \
            else default
        if ch_row is not None:
            effective = ch_row.merged_over(effective)
        return effective

    def _state(self, tenant: TenantIdentity) -> _TenantState:
        """The tenant's state, made or TTL-refreshed; the DAO read runs
        outside the lock, so one slow read stalls no other tenant."""
        with self._lock:
            st = self._tenants.get(tenant.state_key)
            if st is not None and (time.monotonic() - st.quota_loaded
                                   <= self.config.overrides_ttl_s):
                return st
        quota = self._load_quota(tenant)
        with self._lock:
            st = self._tenants.get(tenant.state_key)
            if st is None:
                st = _TenantState(
                    quota=quota,
                    bucket=_TokenBucket(quota.rate, quota.burst))
                self._apply_inherited(tenant.state_key, st)
                self._tenants.put(tenant.state_key, st)
                self._tenant_gauge.set(float(len(self._tenants)))
                return st
            if quota != st.quota:
                st.bucket.rate = max(quota.rate or 0.0, 0.0)
                st.bucket.burst = max(quota.burst or 1.0, 1.0)
            st.quota = quota
            st.quota_loaded = time.monotonic()
            return st

    def quota(self, tenant: TenantIdentity) -> TenantQuota:
        """The tenant's effective quota (the defaults merged with its
        stored overrides), from the TTL cache."""
        return self._state(tenant).quota

    def batch_params(self, tenant: Optional[TenantIdentity]
                     ) -> Tuple[str, float, int]:
        """(lane label, DRR weight, lane cap) for the micro-batcher; an
        explicit 0 lane cap means uncapped, only None inherits."""
        if tenant is None or not self.config.enabled:
            return DEFAULT_TENANT, 1.0, 0
        q = self._state(tenant).quota
        weight = q.weight if q.weight is not None else self.config.weight
        queue_max = (q.queue_max if q.queue_max is not None
                     else self.config.queue_max)
        return tenant.label, float(weight), int(queue_max)

    # -- admission ----------------------------------------------------------
    def admit(self, tenant: Optional[TenantIdentity]) -> "_AdmitGuard":
        """Charge the tenant's rate and concurrency quotas; raises
        `QuotaExceeded` (429) past either. Pre-admitted identities and
        tenancy off pass untouched."""
        if tenant is None or tenant.pre_admitted \
                or not self.config.enabled:
            return _AdmitGuard(self, None)
        st = self._state(tenant)
        with self._lock:
            wait = st.bucket.try_take()
            if wait > 0.0:
                self._shed.labels(surface="quota",
                                  app=tenant.state_key).inc()
                # a quota shed never reaches the serve path: tag the
                # pending trace with the shedding app here (its status
                # and error land as the response is encoded)
                trace.annotate_pending(trace.current(), app=tenant.label)
                raise QuotaExceeded(
                    f"app '{tenant.label}' over its rate quota "
                    f"({st.quota.rate:g} req/s)",
                    retry_after=max(wait, 0.05))
            cap = int(st.quota.concurrency or 0)
            if cap > 0 and st.inflight >= cap:
                self._shed.labels(surface="quota",
                                  app=tenant.state_key).inc()
                trace.annotate_pending(trace.current(), app=tenant.label)
                raise QuotaExceeded(
                    f"app '{tenant.label}' at its concurrency quota "
                    f"({cap} in flight)", retry_after=0.05)
            st.inflight += 1
        self._admitted.labels(app=tenant.label).inc()
        return _AdmitGuard(self, st)

    def _release(self, st: _TenantState) -> None:
        # the exact state admit() charged: a lookup by label could find
        # a state made anew after LRU churn and leak this slot
        with self._lock:
            if st.inflight > 0:
                st.inflight -= 1

    # -- budgets across a lease handoff -------------------------------------
    # A standby that starts with full buckets would grant every tenant a
    # second burst. The leader journals its spent buckets through the
    # lease row it renews; the router that wins the lease adopts them
    # before it admits anything. The stamp is wall-clock time, so that
    # another host can age it: the adopter credits the dead air's
    # accrual at each tenant's rate.

    def export_buckets(self) -> dict:
        """The spent-bucket snapshot for the lease journal."""
        if not self.config.enabled:
            return {}
        out = {}
        with self._lock:
            mono = time.monotonic()
            for key, st in self._tenants.items():
                b = st.bucket
                tokens = b.tokens
                if b.rate > 0:
                    tokens = min(b.burst,
                                 tokens + (mono - b.t_last) * b.rate)
                out[key] = {"tokens": round(tokens, 4),
                            "rate": b.rate, "burst": b.burst}
        return {"t": time.time(), "buckets": out} if out else {}

    def adopt_buckets(self, doc: Optional[Mapping]) -> int:
        """Inherit a previous holder's snapshot: a known bucket is
        clamped down to the inherited level (never raised), an unknown
        tenant's level is parked until its state is made. Returns the
        tenants adopted."""
        if not doc or not self.config.enabled:
            return 0
        buckets = doc.get("buckets") or {}
        try:
            age = max(0.0, time.time() - float(doc.get("t", 0.0)))
        except (TypeError, ValueError):
            age = 0.0
        n = 0
        with self._lock:
            mono = time.monotonic()
            for key, rec in buckets.items():
                try:
                    tokens = float(rec["tokens"])
                    rate = max(float(rec.get("rate", 0.0)), 0.0)
                    burst = max(float(rec.get("burst", 1.0)), 1.0)
                except (KeyError, TypeError, ValueError):
                    continue
                inherited = min(burst, tokens + age * rate)
                st = self._tenants.get(str(key))
                if st is not None:
                    # refill our own view first: adoption runs on every
                    # standby tick
                    own = st.bucket.tokens
                    if st.bucket.rate > 0:
                        own = min(st.bucket.burst,
                                  own + (mono - st.bucket.t_last)
                                  * st.bucket.rate)
                    st.bucket.tokens = min(own, inherited)
                    st.bucket.t_last = mono
                else:
                    self._inherited.put(str(key),
                                        (inherited, rate, burst, mono))
                n += 1
        return n

    def _apply_inherited(self, key: str, st: _TenantState) -> None:
        # under self._lock: the first state of a journaled tenant starts
        # from the inherited level plus what accrued since
        rec = self._inherited.pop(key)
        if rec is None:
            return
        tokens, rate, _burst, adopted_mono = rec
        accrued = tokens + (time.monotonic() - adopted_mono) * rate
        st.bucket.tokens = min(st.bucket.tokens, accrued)


class _AdmitGuard:
    """Releases the concurrency slot `admit` took; `with`-scoped."""

    __slots__ = ("_ctl", "_state")

    def __init__(self, ctl: AdmissionController,
                 state: Optional[_TenantState]):
        self._ctl = ctl
        self._state = state

    def __enter__(self) -> "_AdmitGuard":
        return self

    def __exit__(self, *exc) -> bool:
        if self._state is not None:
            self._ctl._release(self._state)
        return False
