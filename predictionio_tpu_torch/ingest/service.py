"""`cli ingestd`: the remote ingest service.

The port of `predictionio_tpu/ingest/service.py`. It moves the columnar
scan out of every trainer and refresher into one service that owns
`scan_columns` (pushdown and PEVLOG's `--workers` process pool) and
streams CRC-framed column blocks (`ingest.blockproto`) to any number of
consumers over the port's HTTP front end. It is a host service: it
takes no device and never creates a CUDA context.

Every request is keyed by (spec, watermark) and coalesced: concurrent
subscribers join the one scan in flight, and later subscribers at the
same watermark replay the cached columns, so N consumers at one
watermark cost one underlying scan, and a consumer holds the finished
columns plus one block.

Protocol (pulled, so that a consumer can resume mid-stream):

    POST /ingest/scan.json           {spec} -> {scan, rows, blocks, ...}
    GET  /ingest/block/<scan>/<seq>  -> one CRC-framed column block
    GET  /ingest/scans.json          -> the cached and running scans

A torn block is fetched again by its seq; a dead service is a
connection error and the consumer falls back to its local scan
(`ingest.client`). A delta the store cannot decode answers 409 with
`X-Pio-Ingest-Error: delta_invalidated`, which the consumer raises as
`DeltaInvalidated`. Fault seams: `ingest.stream.die` (an error rule
fails block serving) and `ingest.stream.torn` (a torn rule truncates a
block in flight). `/ready` is 503 while a storage breaker is open.

Metrics: `pio_ingest_service_scans_total{outcome}` (ok, error,
delta_invalidated), `pio_ingest_service_coalesced_total`,
`pio_ingest_service_blocks_total`, `pio_ingest_service_block_bytes_total`,
`pio_ingest_service_cached_scans`, `pio_ingest_service_cached_bytes`.
Sizes: `--block-rows` (default 65,536 rows per block); the cache keeps
the 4 most recently used finished scans, and the janitor (a watchdog
beat, `ingestd.janitor`) drops a scan idle for 300 s: the JAX package's
defaults of `PIO_INGEST_SCAN_CACHE` and `PIO_INGEST_SCAN_TTL_S`, which
`IngestConfig` sets here.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.data.storage import columns as C
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest import blockproto as proto
from predictionio_tpu_torch.obs import get_logger
from predictionio_tpu_torch.resilience.faults import faults
from predictionio_tpu_torch.resilience.watchdog import watchdog
from predictionio_tpu_torch.utils.http import (HTTPError, HTTPServerBase,
                                               Request, Response)

_log = get_logger(__name__)

DEFAULT_BLOCK_ROWS = 65_536
DEFAULT_SCAN_CACHE = 4
DEFAULT_SCAN_TTL_S = 300.0
_SCAN_WAIT_S = 300.0       # longest a POST waits for its scan


@dataclass
class IngestConfig:
    ip: str = "0.0.0.0"
    port: int = 7200
    block_rows: int = 0          # 0 = DEFAULT_BLOCK_ROWS
    scan_cache: int = 0          # 0 = DEFAULT_SCAN_CACHE
    scan_ttl_s: float = 0.0      # 0 = DEFAULT_SCAN_TTL_S
    workers: Optional[int] = None   # scan pool width; None = the store's

    def effective_block_rows(self) -> int:
        return self.block_rows or DEFAULT_BLOCK_ROWS

    def effective_scan_cache(self) -> int:
        return self.scan_cache or DEFAULT_SCAN_CACHE

    def effective_ttl_s(self) -> float:
        return self.scan_ttl_s if self.scan_ttl_s > 0 else DEFAULT_SCAN_TTL_S


class _Scan:
    """One shared scan, the coalescing unit. Subscribers wait on `done`;
    once finished, `cols` and the table sizes at each block's end serve
    every block fetch."""

    __slots__ = ("key", "scan_id", "state", "done", "cols", "error",
                 "error_kind", "watermark", "block_rows", "n_blocks",
                 "ent_counts", "tgt_counts", "created", "last_used",
                 "bytes")

    def __init__(self, key: str, watermark, block_rows: int):
        self.key = key
        self.scan_id = uuid.uuid4().hex[:16]
        self.state = "running"          # running | done | error
        self.done = threading.Event()
        self.cols: Optional[C.EventColumns] = None
        self.error = ""
        self.error_kind = ""            # "" | delta_invalidated | scan_failed
        self.watermark = watermark
        self.block_rows = block_rows
        self.n_blocks = 0
        self.ent_counts: List[int] = []   # table size after block k
        self.tgt_counts: List[int] = []
        self.created = time.monotonic()
        self.last_used = self.created
        self.bytes = 0

    def finish(self, cols: C.EventColumns) -> None:
        self.cols = cols
        n = cols.n
        br = self.block_rows
        self.n_blocks = -(-n // br) if n else 0
        # the tables are first-seen over the sorted rows: their sizes
        # after rows [0, hi) are max(ix[:hi]) + 1 (a target of -1 adds
        # none), one cumulative max per side
        ent_hi, tgt_hi = [], []
        if n:
            ent_cum = np.maximum.accumulate(cols.entity_ix)
            tgt_cum = np.maximum.accumulate(cols.target_ix)
            for k in range(self.n_blocks):
                hi = min((k + 1) * br, n) - 1
                ent_hi.append(int(ent_cum[hi]) + 1)
                tgt_hi.append(int(tgt_cum[hi]) + 1)
        self.ent_counts, self.tgt_counts = ent_hi, tgt_hi
        self.bytes = sum(a.nbytes for a in (
            cols.entity_ix, cols.target_ix, cols.value, cols.t_us))
        self.bytes += sum(len(s) for s in cols.entities)
        self.bytes += sum(len(s) for s in cols.targets)
        self.state = "done"
        self.done.set()

    def fail(self, kind: str, msg: str) -> None:
        self.error_kind, self.error = kind, msg
        self.state = "error"
        self.done.set()

    def snapshot(self) -> dict:
        return {"scan": self.scan_id, "state": self.state,
                "rows": self.cols.n if self.cols is not None else None,
                "blocks": self.n_blocks, "bytes": self.bytes,
                "idle_s": round(time.monotonic() - self.last_used, 1)}


class IngestService(HTTPServerBase):
    """The ingest service's front end (one per `cli ingestd`) over
    `registry`'s event store (None: the process default)."""

    def __init__(self, config: Optional[IngestConfig] = None,
                 registry=None, metrics=None):
        self.config = config or IngestConfig()
        super().__init__(host=self.config.ip, port=self.config.port,
                         metrics=metrics)
        if registry is None:
            from predictionio_tpu_torch.data.storage import storage
            registry = storage()
        self.registry = registry
        self._scan_lock = threading.Lock()
        self._scans: Dict[str, _Scan] = {}       # coalescing key -> scan
        self._by_id: Dict[str, _Scan] = {}       # scan id -> scan
        self._janitor_stop = threading.Event()
        self._janitor: Optional[threading.Thread] = None
        self.janitor_beat = None
        reg = self.metrics
        self._m = {
            "scans": reg.counter(
                "pio_ingest_service_scans_total",
                "Underlying columnar scans executed by the ingest "
                "service", labels=("outcome",)),
            "coalesced": reg.counter(
                "pio_ingest_service_coalesced_total",
                "Scan subscriptions served by an in-flight or cached "
                "shared scan instead of a fresh one"),
            "blocks": reg.counter(
                "pio_ingest_service_blocks_total",
                "Column blocks streamed to consumers"),
            "block_bytes": reg.counter(
                "pio_ingest_service_block_bytes_total",
                "Framed column-block bytes streamed to consumers"),
            "cached": reg.gauge(
                "pio_ingest_service_cached_scans",
                "Completed shared scans held for replay"),
            "cached_bytes": reg.gauge(
                "pio_ingest_service_cached_bytes",
                "Host bytes held by cached shared scans"),
        }
        self._routes()

    # -- lifecycle ----------------------------------------------------------
    def start(self, background: bool = True) -> int:
        port = super().start(background=background)
        if self.janitor_beat is None:
            interval = max(1.0, self.config.effective_ttl_s() / 4.0)
            self.janitor_beat = watchdog().register(
                "ingestd.janitor", budget_s=interval * 3.0 + 5.0,
                restart=self._spawn_janitor)
        self._spawn_janitor()
        watchdog().ensure_started()
        return port

    def shutdown(self) -> None:
        self._janitor_stop.set()
        beat, self.janitor_beat = self.janitor_beat, None
        if beat is not None:
            beat.close()
        t = self._janitor
        if t is not None:
            t.join(timeout=5)
        super().shutdown()

    def readiness(self) -> Tuple[bool, Dict[str, object]]:
        states = self.registry.breaker_states()
        open_breakers = sorted(n for n, s in states.items() if s == "open")
        return not open_breakers, {
            "storageBreakers": states,
            "cachedScans": len(self._by_id)}

    def current_instance_id(self) -> str:
        return "ingestd"            # a fleet member serving no model

    # -- janitor (the watchdog-supervised TTL sweep) -------------------------
    def _spawn_janitor(self) -> None:
        self._janitor = threading.Thread(
            target=self._janitor_loop, name="pio-torch-ingestd-janitor",
            daemon=True)
        self._janitor.start()

    def _janitor_loop(self) -> None:
        beat = self.janitor_beat
        if beat is not None:
            beat.guard(self._janitor_body)
        else:
            self._janitor_body()

    def _janitor_body(self) -> None:
        beat = self.janitor_beat
        interval = max(1.0, self.config.effective_ttl_s() / 4.0)
        while not self._janitor_stop.wait(interval):
            if beat is not None:
                beat.tick()
            self._sweep_scans()

    def _sweep_scans(self) -> None:
        ttl = self.config.effective_ttl_s()
        now = time.monotonic()
        with self._scan_lock:
            stale = [s for s in self._scans.values()
                     if s.state != "running" and now - s.last_used > ttl]
            for s in stale:
                self._drop_locked(s)
            self._update_gauges_locked()

    def _drop_locked(self, scan: _Scan) -> None:
        self._scans.pop(scan.key, None)
        self._by_id.pop(scan.scan_id, None)

    def _update_gauges_locked(self) -> None:
        done = [s for s in self._scans.values() if s.state == "done"]
        self._m["cached"].set(float(len(done)))
        self._m["cached_bytes"].set(float(sum(s.bytes for s in done)))

    # -- the shared scan ----------------------------------------------------
    def _get_or_scan(self, spec: dict) -> _Scan:
        """One underlying scan per (spec, watermark); the caller waits
        on `scan.done`."""
        app_id, channel_id, kwargs = proto.decode_spec(spec)
        store = self.registry.get_events()
        watermark = store.ingest_watermark(app_id, channel_id)
        key = proto.spec_key(spec, watermark)
        with self._scan_lock:
            got = self._scans.get(key)
            # join a scan in flight always; replay a finished one only
            # where the store has watermarks (None cannot show that the
            # cached columns are still current)
            if got is not None and (
                    got.state == "running" or
                    (got.state == "done" and watermark is not None)):
                got.last_used = time.monotonic()
                self._m["coalesced"].inc()
                return got
            if got is not None:
                self._by_id.pop(got.scan_id, None)
            scan = _Scan(key, watermark, self.config.effective_block_rows())
            self._scans[key] = scan
            self._by_id[scan.scan_id] = scan
            self._evict_locked()
        self._run_scan(scan, store, app_id, channel_id, kwargs)
        return scan

    def _evict_locked(self) -> None:
        keep = self.config.effective_scan_cache()
        done = sorted((s for s in self._scans.values()
                       if s.state != "running"),
                      key=lambda s: s.last_used, reverse=True)
        for s in done[keep:]:
            self._drop_locked(s)
        self._update_gauges_locked()

    def _run_scan(self, scan: _Scan, store, app_id: int,
                  channel_id: Optional[int], kwargs: dict) -> None:
        t0 = time.perf_counter()
        try:
            cols = store.scan_columns(
                app_id, channel_id, workers=self.config.workers, **kwargs)
        except DeltaInvalidated as e:
            scan.fail("delta_invalidated", str(e))
            self._m["scans"].labels(outcome="delta_invalidated").inc()
            return
        except Exception as e:  # noqa: BLE001 — answered to the consumer
            scan.fail("scan_failed", f"{type(e).__name__}: {e}")
            self._m["scans"].labels(outcome="error").inc()
            _log.exception("ingest_scan_failed", app=app_id)
            return
        scan.finish(cols)
        self._m["scans"].labels(outcome="ok").inc()
        with self._scan_lock:
            self._update_gauges_locked()
        _log.info("ingest_scan_done", app=app_id, rows=cols.n,
                  blocks=scan.n_blocks,
                  seconds=round(time.perf_counter() - t0, 3))

    # -- routes -------------------------------------------------------------
    def _routes(self) -> None:
        router = self.router

        @router.post("/ingest/scan.json")
        def scan_endpoint(req: Request) -> Response:
            try:
                spec = req.json()
            except ValueError as e:
                raise HTTPError(400, f"bad spec: {e}")
            try:
                scan = self._get_or_scan(spec)
            except proto.BlockProtocolError as e:
                raise HTTPError(400, str(e))
            budget = _SCAN_WAIT_S
            if req.deadline is not None:
                budget = max(0.1, min(budget, req.deadline.remaining()))
            if not scan.done.wait(timeout=budget):
                raise HTTPError(504, "scan still running; retry")
            if scan.state == "error":
                status = 409 if scan.error_kind == "delta_invalidated" \
                    else 500
                raise HTTPError(status, scan.error,
                                headers={"X-Pio-Ingest-Error":
                                         scan.error_kind})
            return Response.json({
                "scan": scan.scan_id, "rows": scan.cols.n,
                "blocks": scan.n_blocks, "block_rows": scan.block_rows,
                "watermark": scan.watermark})

        @router.get("/ingest/block/<scan>/<seq>")
        def block_endpoint(req: Request) -> Response:
            faults().check("ingest.stream.die")
            scan = self._by_id.get(req.params["scan"])
            if scan is None or scan.state != "done":
                # 410: evicted or never finished; the consumer posts the
                # spec again rather than retrying the seq
                raise HTTPError(410, "unknown or retired scan")
            try:
                seq = int(req.params["seq"])
            except ValueError:
                raise HTTPError(400, "seq must be an integer")
            if not 0 <= seq < scan.n_blocks:
                raise HTTPError(404, f"block {seq} out of range "
                                     f"[0,{scan.n_blocks})")
            scan.last_used = time.monotonic()
            blob = self._encode_block(scan, seq)
            torn = faults().torn_fraction("ingest.stream.torn")
            if torn is not None:
                blob = blob[:max(1, int(len(blob) * torn))]
            self._m["blocks"].inc()
            self._m["block_bytes"].inc(float(len(blob)))
            return Response(body=blob,
                            content_type="application/octet-stream")

        @router.get("/ingest/scans.json")
        def scans_endpoint(req: Request) -> Response:
            with self._scan_lock:
                snaps = [s.snapshot() for s in self._scans.values()]
            return Response.json({"scans": snaps})

    def _encode_block(self, scan: _Scan, seq: int) -> bytes:
        cols = scan.cols
        lo = seq * scan.block_rows
        hi = min(lo + scan.block_rows, cols.n)
        ent_base = scan.ent_counts[seq - 1] if seq else 0
        tgt_base = scan.tgt_counts[seq - 1] if seq else 0
        return proto.encode_block(
            scan.scan_id, seq, cols, lo, hi,
            ent_base, scan.ent_counts[seq], tgt_base, scan.tgt_counts[seq])
