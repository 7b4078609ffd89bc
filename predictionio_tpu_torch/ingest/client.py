"""The consumer side of the remote ingest service.

The port of `predictionio_tpu/ingest/client.py`.
`PIO_INGEST_SERVICE=host:port[,host:port...]` turns every consumer of
`scan_columns` (the pipeline's builders, hence `cli train`, and the
streaming `Refresher`) into a remote consumer: the scan runs on the
ingest service (`cli ingestd`) and the consumer assembles its
CRC-framed column blocks (`ingest.blockproto`) into the very
`EventColumns` a local scan gives, pulling them through a prefetch
window of 32 MiB (the JAX package's `PIO_INGEST_WINDOW_BYTES` default),
so that its memory stays flat whatever the store's size.

The failure ladder, cheapest first:
  1. a torn or corrupt block    -> fetch the same seq again (3 tries)
  2. an endpoint dead mid-scan  -> post the spec to the next endpoint
                                   (the service coalesces, so a retry
                                   at an unchanged watermark is cheap)
  3. every endpoint dead        -> `IngestUnavailable`; the
                                   `RemoteIngestStore` wrapper falls
                                   back to the wrapped store's local
                                   scan unless `PIO_INGEST_FALLBACK=off`.
The fallback is a host scan, the JAX package's semantics, counted as
`pio_ingest_remote_scans_total{outcome="fallback"}`; the other outcomes
are ok, delta_invalidated, error and unavailable, and
`pio_ingest_remote_blocks_total` and `pio_ingest_remote_retries_total`
count blocks and re-fetches.

`maybe_remote(store)` is the one seam: the pipeline and the refresher
call it on the event store they read, and it changes nothing unless
`PIO_INGEST_SERVICE` is set.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import threading
from typing import List, Optional, Tuple

from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.storage import columns as C
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest import blockproto as proto
from predictionio_tpu_torch.obs import get_logger, get_registry

_log = get_logger(__name__)

ENV_SERVICE = "PIO_INGEST_SERVICE"
ENV_FALLBACK = "PIO_INGEST_FALLBACK"

WINDOW_BYTES = 32 << 20     # undecoded blocks held ahead of the assembler
_BLOCK_RETRIES = 3          # re-fetches of one torn seq before failover
_SCAN_TIMEOUT_S = 600.0     # a POST waits while the service scans


class IngestUnavailable(RuntimeError):
    """Every configured ingest endpoint failed; the caller decides
    whether to scan locally instead."""


def endpoints(env: Optional[str] = None) -> List[Tuple[str, int]]:
    """`PIO_INGEST_SERVICE` (or `env`) as (host, port) pairs."""
    raw = env if env is not None else os.environ.get(ENV_SERVICE, "")
    out: List[Tuple[str, int]] = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"{ENV_SERVICE} entry {part!r} is not host:port")
        out.append((host, int(port)))
    return out


def fallback_enabled() -> bool:
    return os.environ.get(ENV_FALLBACK, "").strip().lower() not in (
        "off", "0", "false", "no")


def _metrics():
    reg = get_registry()
    return {
        "scans": reg.counter(
            "pio_ingest_remote_scans_total",
            "Remote ingest scans by terminal outcome",
            labels=("outcome",)),
        "blocks": reg.counter(
            "pio_ingest_remote_blocks_total",
            "Column blocks fetched from the ingest service"),
        "retries": reg.counter(
            "pio_ingest_remote_retries_total",
            "Block re-fetches after a torn/corrupt frame"),
    }


class _Endpoint:
    """One kept-alive connection to one ingest service."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._conn: Optional[http.client.HTTPConnection] = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=_SCAN_TIMEOUT_S)
        return self._conn

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None) -> Tuple[int, dict, bytes]:
        conn = self._connection()
        headers = {"Content-Type": "application/json"} if body else {}
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        except Exception:
            # a dead kept-alive connection fails every later request on
            # it: drop it, so that the next call dials again
            self.close()
            raise

    def start_scan(self, spec: dict) -> dict:
        status, headers, data = self._request(
            "POST", "/ingest/scan.json",
            json.dumps(spec, separators=(",", ":")).encode())
        if status == 409 or headers.get(
                "X-Pio-Ingest-Error") == "delta_invalidated":
            raise DeltaInvalidated("ingest service: delta invalidated")
        if status != 200:
            raise ConnectionError(
                f"ingest scan failed: HTTP {status} {data[:200]!r}")
        return json.loads(data.decode())

    def fetch_block(self, scan_id: str, seq: int) -> bytes:
        status, _headers, data = self._request(
            "GET", f"/ingest/block/{scan_id}/{seq}")
        if status != 200:
            raise ConnectionError(
                f"ingest block {seq} failed: HTTP {status}")
        return data


class _Prefetcher:
    """Fetches blocks ahead of the assembler on a thread, at most
    `budget_bytes` (counted in whole MiB) of undecoded frames ahead."""

    def __init__(self, ep: _Endpoint, scan_id: str, n_blocks: int,
                 budget_bytes: int, metrics: dict):
        self._ep = ep
        self._scan = scan_id
        self._n = n_blocks
        self._q: "queue.Queue" = queue.Queue()
        self._budget = threading.BoundedSemaphore(
            max(1, budget_bytes // (1 << 20)))
        self._stop = threading.Event()
        self._m = metrics
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="pio-torch-ingest-prefetch")
        self._thread.start()

    def _run(self) -> None:
        for seq in range(self._n):
            if self._stop.is_set():
                return
            try:
                blob = self._fetch_checked(seq)
            except Exception as e:  # noqa: BLE001 — handed to the consumer
                self._q.put(("err", seq, e))
                return
            # charge ceil(MiB) against the window before handing it over
            for _ in range(max(1, len(blob) >> 20)):
                while not self._budget.acquire(timeout=0.5):
                    if self._stop.is_set():
                        return
            self._q.put(("ok", seq, blob))
        self._q.put(("eof", self._n, None))

    def _fetch_checked(self, seq: int) -> bytes:
        """One seq, fetched again on a torn or corrupt frame: a CRC
        reject costs that block, never the scan."""
        last: Exception = integrity.CorruptBlobError("unreached")
        for _attempt in range(_BLOCK_RETRIES):
            blob = self._ep.fetch_block(self._scan, seq)
            try:
                integrity.unwrap(blob)
                return blob
            except integrity.CorruptBlobError as e:
                last = e
                self._m["retries"].inc()
        raise last

    def get(self, timeout: float = _SCAN_TIMEOUT_S):
        kind, seq, payload = self._q.get(timeout=timeout)
        if kind == "ok":
            for _ in range(max(1, len(payload) >> 20)):
                try:
                    self._budget.release()
                except ValueError:
                    break
        return kind, seq, payload

    def close(self) -> None:
        self._stop.set()


def _remote_scan_once(ep: _Endpoint, spec: dict,
                      metrics: dict) -> C.EventColumns:
    info = ep.start_scan(spec)
    scan_id, rows = info["scan"], int(info["rows"])
    n_blocks = int(info["blocks"])
    asm = proto.BlockAssembler(scan_id, rows)
    if n_blocks == 0:
        return asm.columns()
    pre = _Prefetcher(ep, scan_id, n_blocks, WINDOW_BYTES, metrics)
    try:
        while not asm.complete:
            kind, _seq, payload = pre.get()
            if kind == "err":
                raise payload
            if kind == "eof":
                break
            asm.add(*proto.decode_block(payload))
            metrics["blocks"].inc()
    finally:
        pre.close()
    return asm.columns()


def remote_scan_columns(app_id: int, channel_id: Optional[int] = None,
                        **kwargs) -> C.EventColumns:
    """`scan_columns` on the ingest service: each configured endpoint in
    turn; `IngestUnavailable` when all fail, `DeltaInvalidated` as is
    when the service's store cannot decode the delta asked for."""
    eps = endpoints()
    if not eps:
        raise IngestUnavailable(f"{ENV_SERVICE} not set")
    m = _metrics()
    spec = proto.encode_spec(app_id, channel_id, **kwargs)
    errors: List[str] = []
    for host, port in eps:
        ep = _Endpoint(host, port)
        try:
            cols = _remote_scan_once(ep, spec, m)
            m["scans"].labels(outcome="ok").inc()
            return cols
        except DeltaInvalidated:
            m["scans"].labels(outcome="delta_invalidated").inc()
            raise
        except proto.BlockProtocolError:
            # a protocol fault is no transport flake: raised, not
            # retried on every endpoint
            m["scans"].labels(outcome="error").inc()
            raise
        except Exception as e:  # noqa: BLE001 — fail over to the next
            errors.append(f"{host}:{port}: {type(e).__name__}: {e}")
            _log.warning("ingest_endpoint_failed",
                         endpoint=f"{host}:{port}", error=str(e))
        finally:
            ep.close()
    m["scans"].labels(outcome="unavailable").inc()
    raise IngestUnavailable("; ".join(errors))


class RemoteIngestStore:
    """An event store whose `scan_columns` runs on the ingest service
    and whose every other method is the wrapped local store's. A dead
    service falls back to the wrapped store's own scan (counted
    `outcome="fallback"`) unless `PIO_INGEST_FALLBACK=off`."""

    def __init__(self, inner):
        self._inner = inner

    @property
    def inner(self):
        return self._inner

    def scan_columns(self, app_id: int, channel_id: Optional[int] = None,
                     *, workers: Optional[int] = None, **kwargs):
        # `workers` sizes the service's pool, not ours: it stays off the
        # wire spec and the service applies its own
        try:
            return remote_scan_columns(app_id, channel_id, **kwargs)
        except DeltaInvalidated:
            raise
        except (IngestUnavailable, proto.BlockProtocolError) as e:
            if not fallback_enabled():
                raise
            _log.warning("ingest_fallback_local", error=str(e))
            _metrics()["scans"].labels(outcome="fallback").inc()
            return self._inner.scan_columns(
                app_id, channel_id, workers=workers, **kwargs)

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def maybe_remote(store):
    """`store` wrapped for remote ingest when `PIO_INGEST_SERVICE` is
    set, else `store` itself; a wrapped store is returned as is."""
    if isinstance(store, RemoteIngestStore):
        return store
    if not os.environ.get(ENV_SERVICE, "").strip():
        return store
    return RemoteIngestStore(store)
