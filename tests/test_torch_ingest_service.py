"""The port's remote ingest service (`predictionio_tpu_torch.ingest.
blockproto`, `service`, `client`) against the JAX package's, on the CPU.

It mirrors `tests/test_ingest_service.py` (block framing with the CRC
reject and the resume, shared-scan coalescing, the kill fallback and
`PIO_INGEST_FALLBACK=off`, SQLITE's columnar scan against the Event
oracle, delta invalidation through the service, the scan pool's reuse,
endpoint parsing, the fleet's ingest role) and adds:

  - across packages: the port's client against the JAX `IngestService`
    and the JAX client against the port's, over one PEVLOG store, each
    bit-identical to a local scan; specs, `spec_key` and blocks written
    by either package read by the other;
  - the slice: `run_train` with `PIO_INGEST_SERVICE` set (the prepared
    cache off) bit-identical to the local-scan train and within the ALS
    tolerance (RMSE 1e-2) of the JAX train of the same store; a
    `Refresher` tick through the service folding exactly what a local
    tick folds; a torn block fetched again and counted.
"""

import json
import signal
import threading
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu.data.storage import columns as jcolumns
from predictionio_tpu.ingest import blockproto as jproto
from predictionio_tpu.ingest import client as jclient
from predictionio_tpu.ingest.service import IngestConfig as JIngestConfig
from predictionio_tpu.ingest.service import IngestService as JIngestService
from predictionio_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from predictionio_tpu_torch.core.persistence import deserialize_models
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data import integrity
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (App, StorageRegistry,
                                                 columns)
from predictionio_tpu_torch.data.storage.base import _UNSET, DeltaInvalidated
from predictionio_tpu_torch.data.storage.sqlite import (SQLiteEvents,
                                                        SQLiteStorageClient)
from predictionio_tpu_torch.ingest import blockproto as proto
from predictionio_tpu_torch.ingest import client as iclient
from predictionio_tpu_torch.ingest.client import (IngestUnavailable,
                                                  RemoteIngestStore,
                                                  maybe_remote,
                                                  remote_scan_columns)
from predictionio_tpu_torch.ingest.service import (IngestConfig,
                                                   IngestService)
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience.faults import faults

pytestmark = [pytest.mark.ingestd, pytest.mark.torch]

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
SPEC = {"rate": ("prop", "rating")}


@pytest.fixture(autouse=True)
def _time_limit():
    def expired(*_):
        raise TimeoutError("test exceeded its 90-s limit")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(90)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    faults().clear()


def _mk(i: int, n_users: int = 7, n_items: int = 11,
        name: str = "rate") -> Event:
    return Event(event=name, entity_type="user", entity_id=f"u{i % n_users}",
                 target_entity_type="item", target_entity_id=f"i{i % n_items}",
                 properties=DataMap({"rating": float(i % 5) + 1.0}),
                 event_time=T0 + timedelta(seconds=i))


def _config(tmp_path) -> dict:
    """SQLITE metadata and models, PEVLOG events: one store both
    packages read."""
    return {
        "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
        "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
        "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
        "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB",
    }


def _pevlog_registry(tmp_path):
    return StorageRegistry(_config(tmp_path))


@pytest.fixture
def served(tmp_path, monkeypatch):
    """A PEVLOG store with 500 events behind a live port IngestService
    (64-row blocks); PIO_INGEST_SERVICE points at it. Yields (service,
    store)."""
    reg = _pevlog_registry(tmp_path)
    ev = reg.get_events()
    ev.init(1)
    ev.insert_batch([_mk(i) for i in range(500)], 1)
    svc = IngestService(
        IngestConfig(ip="127.0.0.1", port=0, block_rows=64), reg,
        metrics=MetricsRegistry())      # its own: counts are exact
    port = svc.start()
    monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{port}")
    yield svc, ev
    svc.shutdown()
    reg.close()


def _assert_cols_equal(a, b):
    assert np.array_equal(a.entity_ix, b.entity_ix)
    assert np.array_equal(a.target_ix, b.target_ix)
    assert np.array_equal(a.value, b.value)
    assert np.array_equal(a.t_us, b.t_us)
    assert a.entity_ix.dtype == b.entity_ix.dtype == np.int32
    assert a.value.dtype == b.value.dtype == np.float32
    assert a.t_us.dtype == b.t_us.dtype == np.int64
    assert list(a.entities) == list(b.entities)
    assert list(a.targets) == list(b.targets)


def _remote_value(name: str, **labels) -> float:
    return get_registry().value(name, **labels) or 0.0


class TestFraming:
    def test_round_trip_multi_block(self, tmp_path):
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(200)], 1)
        cols = ev.scan_columns(1, value_spec=SPEC)
        rows, br = cols.n, 37          # not a divisor of the rows
        n_blocks = -(-rows // br)
        ent_cum = np.maximum.accumulate(cols.entity_ix)
        tgt_cum = np.maximum.accumulate(cols.target_ix)
        asm = proto.BlockAssembler("s1", rows)
        eb = tb = 0
        for k in range(n_blocks):
            lo, hi = k * br, min((k + 1) * br, rows)
            eh, th = int(ent_cum[hi - 1]) + 1, int(tgt_cum[hi - 1]) + 1
            blob = proto.encode_block("s1", k, cols, lo, hi, eb, eh, tb, th)
            header, arrays = proto.decode_block(blob)
            asm.add(header, arrays)
            eb, tb = eh, th
        assert asm.complete
        _assert_cols_equal(asm.columns(), cols)
        reg.close()

    def test_torn_blob_is_crc_rejected(self, tmp_path):
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(50)], 1)
        cols = ev.scan_columns(1, value_spec=SPEC)
        blob = proto.encode_block(
            "s1", 0, cols, 0, cols.n, 0, len(cols.entities),
            0, len(cols.targets))
        with pytest.raises(integrity.CorruptBlobError):
            proto.decode_block(blob[: len(blob) // 2])
        flipped = bytearray(blob)
        flipped[-3] ^= 0x40
        with pytest.raises(integrity.CorruptBlobError):
            proto.decode_block(bytes(flipped))
        reg.close()

    def test_out_of_order_block_is_protocol_error(self, tmp_path):
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(50)], 1)
        cols = ev.scan_columns(1, value_spec=SPEC)
        blob = proto.encode_block(
            "s1", 1, cols, 0, cols.n, 0, len(cols.entities),
            0, len(cols.targets))
        asm = proto.BlockAssembler("s1", cols.n)
        with pytest.raises(proto.BlockProtocolError):
            asm.add(*proto.decode_block(blob))
        reg.close()

    def test_spec_round_trip(self):
        spec = proto.encode_spec(
            3, 7, start_time=T0, until_time=T0 + timedelta(days=1),
            entity_type="user", event_names=["rate", "buy"],
            target_entity_type="item", value_spec=SPEC,
            require_target=True, since={"j": 10}, upto={"j": 20})
        app, ch, kwargs = proto.decode_spec(spec)
        assert (app, ch) == (3, 7)
        assert kwargs["start_time"] == T0
        assert kwargs["until_time"] == T0 + timedelta(days=1)
        assert kwargs["event_names"] == ["buy", "rate"]
        assert kwargs["target_entity_type"] == "item"
        assert kwargs["target_entity_id"] is _UNSET
        assert kwargs["value_spec"] == {"rate": ("prop", "rating")}
        assert kwargs["since"] == {"j": 10}
        assert kwargs["upto"] == {"j": 20}
        # the coalescing key moves with the watermark
        assert proto.spec_key(spec, {"j": 1}) != proto.spec_key(
            spec, {"j": 2})


class TestAcrossPackages:
    """Specs, keys and blocks written by either package, read by the
    other; each package's client against the other's service."""

    @pytest.mark.parametrize("target", [_UNSET, None, "item"])
    def test_spec_and_key_equal_in_both_packages(self, target):
        from predictionio_tpu.data.storage.base import _UNSET as J_UNSET
        jtarget = J_UNSET if target is _UNSET else target
        kw = dict(start_time=T0, until_time=T0 + timedelta(hours=5),
                  entity_type="user", event_names=["rate", "buy"],
                  value_spec={"rate": ("prop", "rating"), "buy": 4.0},
                  since={"a": 3}, upto={"a": 9})
        ours = proto.encode_spec(1, None, target_entity_type=target,
                                 target_entity_id=target, **kw)
        theirs = jproto.encode_spec(1, None, target_entity_type=jtarget,
                                    target_entity_id=jtarget, **kw)
        assert json.dumps(ours, sort_keys=True) == json.dumps(
            theirs, sort_keys=True)
        for wm in (None, {"seg": 12, "tomb": 0}):
            assert proto.spec_key(ours, wm) == jproto.spec_key(theirs, wm)
        # each package decodes the other's spec to the same filter
        _, _, mine = proto.decode_spec(theirs)
        _, _, jax_side = jproto.decode_spec(ours)
        got = mine["target_entity_type"]
        assert got is _UNSET if target is _UNSET else got == target
        jgot = jax_side["target_entity_type"]
        assert jgot is J_UNSET if target is _UNSET else jgot == target
        assert mine["value_spec"] == jax_side["value_spec"]

    def test_blocks_decode_in_the_other_package(self, tmp_path):
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i, n_users=13, n_items=17)
                         for i in range(300)], 1)
        cols = ev.scan_columns(1, value_spec=SPEC)
        jcols = jcolumns.EventColumns(
            cols.entity_ix, cols.target_ix, cols.value, cols.t_us,
            list(cols.entities), list(cols.targets))
        br = 64
        ent_cum = np.maximum.accumulate(cols.entity_ix)
        tgt_cum = np.maximum.accumulate(cols.target_ix)
        mine = proto.BlockAssembler("s", cols.n)
        theirs = jproto.BlockAssembler("s", cols.n)
        eb = tb = 0
        for k in range(-(-cols.n // br)):
            lo, hi = k * br, min((k + 1) * br, cols.n)
            eh, th = int(ent_cum[hi - 1]) + 1, int(tgt_cum[hi - 1]) + 1
            jblob = jproto.encode_block("s", k, jcols, lo, hi, eb, eh,
                                        tb, th)
            pblob = proto.encode_block("s", k, cols, lo, hi, eb, eh, tb, th)
            assert pblob == jblob           # the same bytes on the wire
            mine.add(*proto.decode_block(jblob))
            theirs.add(*jproto.decode_block(pblob))
            eb, tb = eh, th
        _assert_cols_equal(mine.columns(), cols)
        _assert_cols_equal(theirs.columns(), cols)
        reg.close()

    def test_port_client_against_the_jax_service(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("PIO_WATCHDOG", "off")
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(500)], 1)
        jreg = JRegistry(_config(tmp_path))
        jsvc = JIngestService(
            JIngestConfig(ip="127.0.0.1", port=0, block_rows=64), jreg,
            metrics=JMetricsRegistry())
        port = jsvc.start()
        monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{port}")
        try:
            for kw in (dict(value_spec=SPEC),
                       dict(value_spec={"*": 1.0}, entity_type="user",
                            target_entity_type="item")):
                local = ev.scan_columns(1, **kw)
                _assert_cols_equal(remote_scan_columns(1, **kw), local)
            assert jsvc.metrics.value("pio_ingest_service_scans_total",
                                      outcome="ok") == 2.0
        finally:
            jsvc.shutdown()
            jreg.close()
            reg.close()

    def test_jax_client_against_the_port_service(self, served):
        svc, ev = served
        for kw in (dict(value_spec=SPEC),
                   dict(value_spec={"*": 1.0}, entity_type="user",
                        target_entity_type="item")):
            local = ev.scan_columns(1, **kw)
            _assert_cols_equal(jclient.remote_scan_columns(1, **kw), local)
        wm1 = ev.ingest_watermark(1)
        ev.insert_batch([_mk(500 + i) for i in range(40)], 1)
        wm2 = ev.ingest_watermark(1)
        local = ev.scan_columns(1, value_spec=SPEC, since=wm1, upto=wm2)
        _assert_cols_equal(jclient.remote_scan_columns(
            1, value_spec=SPEC, since=wm1, upto=wm2), local)
        assert svc.metrics.value("pio_ingest_service_scans_total",
                                 outcome="ok") == 3.0


class TestRemoteScan:
    def test_remote_equals_local_oracle(self, served):
        svc, ev = served
        local = ev.scan_columns(1, value_spec=SPEC)
        _assert_cols_equal(remote_scan_columns(1, value_spec=SPEC), local)

    def test_torn_block_refetches_same_seq(self, served):
        svc, ev = served
        local = ev.scan_columns(1, value_spec=SPEC)
        before = _remote_value("pio_ingest_remote_retries_total")
        # one torn frame mid-stream: the client rejects it by its CRC
        # and fetches the SAME seq again, with no restart of the scan
        rule = faults().arm("ingest.stream.torn", torn=0.5, times=1)
        _assert_cols_equal(remote_scan_columns(1, value_spec=SPEC), local)
        assert rule.hits == 1
        assert _remote_value("pio_ingest_remote_retries_total") == \
            before + 1.0
        assert svc.metrics.value("pio_ingest_service_blocks_total") == \
            float(-(-local.n // 64) + 1)

    def test_coalescing_two_subscribers_one_scan(self, served):
        svc, ev = served
        results, errors = [], []

        def subscribe():
            try:
                results.append(remote_scan_columns(1, value_spec=SPEC))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=subscribe, name=f"sub-{i}")
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        assert len(results) == 2
        _assert_cols_equal(results[0], results[1])
        # ONE underlying scan for the (spec, watermark) key
        assert svc.metrics.value(
            "pio_ingest_service_scans_total", outcome="ok") == 1.0
        assert svc.metrics.value(
            "pio_ingest_service_coalesced_total") == 1.0

    def test_service_kill_falls_back_to_local(self, served):
        svc, ev = served
        faults().arm("ingest.stream.die", error=RuntimeError)
        store = maybe_remote(ev)
        assert isinstance(store, RemoteIngestStore)
        local = ev.scan_columns(1, value_spec=SPEC)
        before = _remote_value("pio_ingest_remote_scans_total",
                               outcome="fallback")
        _assert_cols_equal(store.scan_columns(1, value_spec=SPEC), local)
        assert _remote_value("pio_ingest_remote_scans_total",
                             outcome="fallback") == before + 1.0

    def test_fallback_off_raises(self, served, monkeypatch):
        svc, ev = served
        monkeypatch.setenv("PIO_INGEST_FALLBACK", "off")
        faults().arm("ingest.stream.die", error=RuntimeError)
        with pytest.raises(IngestUnavailable):
            maybe_remote(ev).scan_columns(1, value_spec=SPEC)

    def test_dead_endpoint_unavailable(self, served, monkeypatch):
        monkeypatch.setenv("PIO_INGEST_SERVICE", "127.0.0.1:1")
        with pytest.raises(IngestUnavailable):
            remote_scan_columns(1, value_spec=SPEC)

    def test_second_endpoint_takes_over(self, served, monkeypatch):
        svc, ev = served
        monkeypatch.setenv("PIO_INGEST_SERVICE",
                           f"127.0.0.1:1,127.0.0.1:{svc.port}")
        _assert_cols_equal(remote_scan_columns(1, value_spec=SPEC),
                           ev.scan_columns(1, value_spec=SPEC))

    def test_wrapper_delegates_everything_else(self, served):
        svc, ev = served
        store = maybe_remote(ev)
        assert store.ingest_watermark(1) == ev.ingest_watermark(1)
        assert len(list(store.find(1))) == 500
        assert store.inner is ev

    def test_maybe_remote_noop_without_env(self, served, monkeypatch):
        svc, ev = served
        monkeypatch.delenv("PIO_INGEST_SERVICE")
        assert maybe_remote(ev) is ev
        monkeypatch.setenv("PIO_INGEST_SERVICE", "h:1")
        wrapped = maybe_remote(ev)
        assert maybe_remote(wrapped) is wrapped

    def test_delta_scan_through_service(self, served):
        svc, ev = served
        wm1 = ev.ingest_watermark(1)
        ev.insert_batch([_mk(500 + i) for i in range(40)], 1)
        wm2 = ev.ingest_watermark(1)
        local = ev.scan_columns(1, value_spec=SPEC, since=wm1, upto=wm2)
        assert local.n == 40
        _assert_cols_equal(remote_scan_columns(
            1, value_spec=SPEC, since=wm1, upto=wm2), local)

    def test_scans_listing_and_readiness(self, served):
        import urllib.request
        svc, ev = served
        remote_scan_columns(1, value_spec=SPEC)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/ingest/scans.json") as r:
            scans = json.loads(r.read())["scans"]
        assert [(s["state"], s["rows"], s["blocks"]) for s in scans] == [
            ("done", 500, 8)]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.port}/ready") as r:
            assert json.loads(r.read())["ready"] is True
        assert svc.metrics.value("pio_ingest_service_cached_scans") == 1.0

    def test_cache_evicts_past_its_size(self, served):
        svc, ev = served
        svc.config.scan_cache = 2
        for n in range(4):
            remote_scan_columns(1, value_spec={"rate": float(n + 1)})
        # a new scan evicts past the 2 most recently used finished ones,
        # as the JAX service does: they and the newest stay
        assert len(svc._scans) == 3
        svc._sweep_scans()
        svc.config.scan_ttl_s = 1e-6
        svc._sweep_scans()
        assert not svc._scans


class TestSQLiteScan:
    @pytest.fixture
    def sq(self):
        ev = SQLiteEvents(SQLiteStorageClient({"PATH": ":memory:"}))
        ev.init(1)
        return ev

    def test_bit_exact_vs_find_oracle(self, sq):
        sq.insert_batch([_mk(i) for i in range(300)], 1)
        native = sq.scan_columns(1, value_spec=SPEC)
        oracle = columns.columns_from_events(sq.find(1), SPEC, True)
        _assert_cols_equal(native, oracle)

    def test_bit_exact_vs_pevlog(self, sq, tmp_path):
        # distinct times: sqlite breaks ties of equal times by its random
        # id, pevlog by insertion order; only the time order is promised
        evs = [_mk(i) for i in range(300)]
        sq.insert_batch(evs, 1)
        reg = _pevlog_registry(tmp_path)
        pv = reg.get_events()
        pv.init(1)
        pv.insert_batch(evs, 1)
        _assert_cols_equal(sq.scan_columns(1, value_spec=SPEC),
                           pv.scan_columns(1, value_spec=SPEC))
        reg.close()

    def test_pushdown_filters_match_oracle(self, sq):
        evs = [_mk(i) for i in range(200)]
        evs += [_mk(i, name="view") for i in range(200, 260)]
        sq.insert_batch(evs, 1)
        kw = dict(start_time=T0 + timedelta(seconds=30),
                  until_time=T0 + timedelta(seconds=240),
                  event_names=["rate"], entity_type="user")
        native = sq.scan_columns(1, value_spec=SPEC, **kw)
        oracle = columns.columns_from_events(sq.find(1, **kw), SPEC, True)
        assert native.n > 0
        _assert_cols_equal(native, oracle)

    def test_properties_postfilter_matches_oracle(self, sq):
        sq.insert_batch([_mk(i) for i in range(100)], 1)
        native = sq.scan_columns(
            1, value_spec={"*": ("const", 1.0)},
            properties={"rating": 3.0})
        oracle = columns.columns_from_events(
            sq.find(1, properties={"rating": 3.0}),
            {"*": ("const", 1.0)}, True)
        assert native.n > 0
        _assert_cols_equal(native, oracle)

    def test_require_target_false(self, sq):
        sq.insert_batch([_mk(i) for i in range(40)], 1)
        sq.insert(Event(event="signup", entity_type="user",
                        entity_id="u0", properties=DataMap({}),
                        event_time=T0 + timedelta(days=2)), 1)
        native = sq.scan_columns(1, value_spec={"*": ("const", 1.0)},
                                 require_target=False)
        oracle = columns.columns_from_events(
            sq.find(1), {"*": ("const", 1.0)}, False)
        _assert_cols_equal(native, oracle)
        assert native.target_ix.min() == -1

    def test_watermark_bumps_on_writes(self, sq):
        wm0 = sq.ingest_watermark(1)
        assert wm0 is not None
        sq.insert(_mk(0), 1)
        wm1 = sq.ingest_watermark(1)
        assert wm1 != wm0
        eid = next(iter(sq.find(1))).event_id
        sq.delete(eid, 1)
        assert sq.ingest_watermark(1) != wm1

    def test_since_raises_delta_invalidated(self, sq):
        sq.insert_batch([_mk(i) for i in range(10)], 1)
        with pytest.raises(DeltaInvalidated):
            sq.scan_columns(1, value_spec=SPEC,
                            since={"gen": 1}, upto={"gen": 2})

    def test_delta_invalidated_propagates_through_service(
            self, sq, monkeypatch):
        sq.insert_batch([_mk(i) for i in range(10)], 1)

        class _Reg:
            def get_events(self):
                return sq

            def breaker_states(self):
                return {}

        svc = IngestService(
            IngestConfig(ip="127.0.0.1", port=0, block_rows=8), _Reg(),
            metrics=MetricsRegistry())
        port = svc.start()
        monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{port}")
        try:
            with pytest.raises(DeltaInvalidated):
                remote_scan_columns(1, value_spec=SPEC,
                                    since={"gen": 1}, upto={"gen": 2})
            # the wrapper raises it too: a delta never falls back
            with pytest.raises(DeltaInvalidated):
                maybe_remote(sq).scan_columns(
                    1, value_spec=SPEC, since={"gen": 1}, upto={"gen": 2})
            assert svc.metrics.value("pio_ingest_service_scans_total",
                                     outcome="delta_invalidated") == 2.0
        finally:
            svc.shutdown()


class TestPoolReuse:
    def test_spawn_counter_flat_across_scans(self, tmp_path):
        from predictionio_tpu_torch.data.storage import pevlog
        reg = _pevlog_registry(tmp_path)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(100)], 1)
        before = pevlog.POOL_SPAWNS
        ev.scan_columns(1, value_spec=SPEC, workers=2)
        after_first = pevlog.POOL_SPAWNS
        # a pool may not start in a sandbox; flat is the contract
        assert after_first - before <= 1
        for _ in range(3):
            ev.scan_columns(1, value_spec=SPEC, workers=2)
        assert pevlog.POOL_SPAWNS == after_first
        reg.close()


class TestEndpointParsing:
    def test_endpoints(self):
        assert iclient.endpoints("a:1, b:2") == [("a", 1), ("b", 2)]
        assert iclient.endpoints("") == []
        with pytest.raises(ValueError):
            iclient.endpoints("nocolon")
        assert iclient.endpoints("a:1, b:2") == jclient.endpoints("a:1, b:2")

    def test_window_and_fallback_knobs(self, monkeypatch):
        # the window is the JAX package's default, a constant here
        assert iclient.WINDOW_BYTES == jclient.DEFAULT_WINDOW_BYTES
        monkeypatch.setenv("PIO_INGEST_FALLBACK", "off")
        assert not iclient.fallback_enabled()
        monkeypatch.delenv("PIO_INGEST_FALLBACK")
        assert iclient.fallback_enabled()


class TestFleetRole:
    def test_ingest_member_stays_out_of_rotation(self):
        from predictionio_tpu_torch.serving.fleet import (FleetServer,
                                                          _Replica)

        serve = _Replica(0, server=None, host="h", port=1)
        serve.admitted = True
        ingest = _Replica(1, server=None, host="h", port=2)
        ingest.admitted = True
        ingest.role = "ingest"

        class _F:
            _replicas = [serve, ingest]
            _rr_lock = threading.Lock()
            _rr_next = 0

        assert FleetServer._rotation(_F()) == [serve]
        assert ingest.snapshot()["role"] == "ingest"
        assert serve.snapshot()["role"] == "serve"

    def test_ingestd_joins_a_router_as_an_ingest_member(self, served):
        """A port `ReplicaAgent(role="ingest")` over an IngestService
        registers with a router, is admitted, and gets no query."""
        import urllib.request
        from predictionio_tpu_torch.serving.fleet import (FleetConfig,
                                                          FleetServer,
                                                          ReplicaAgent)
        svc, _ = served
        router = FleetServer(None, fleet=FleetConfig(replicas=0),
                             host="127.0.0.1", port=0)
        rport = router.start()
        agent = ReplicaAgent(svc, [f"http://127.0.0.1:{rport}"],
                             role="ingest")
        try:
            agent.start()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rport}/status.json") as r:
                members = json.loads(r.read())["replicas"]
            assert [(m["role"], m["admitted"]) for m in members] == [
                ("ingest", True)]
            assert router._rotation() == []
        finally:
            agent.stop()
            router.shutdown()


# -- the slice: train and refresh through the service --------------------------

PARAMS = dict(rank=4, num_iterations=8, seed=1)


def _seed(events, app_id, n_users=40, n_items=25):
    """Ratings planted from rank-3 factors plus noise, 1-5 stars: a
    system well enough determined that ALS from the port's init and from
    the JAX package's reaches the same fit."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(n_users, 3)) / 1.3
    y = rng.normal(size=(n_items, 3)) / 1.3
    batch = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() > 0.55:
                continue
            r = np.clip(np.round(3 + x[u] @ y[i] + 0.3 * rng.normal()), 1, 5)
            batch.append(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": float(r)}),
                event_time=T0 + timedelta(minutes=len(batch))))
    events.insert_batch(batch, app_id)
    return batch


@pytest.fixture
def project(tmp_path, monkeypatch):
    """An app with ratings over SQLITE + PEVLOG, a port IngestService on
    it, the prepared cache off; yields (registry, app id, engine,
    params, service)."""
    monkeypatch.setenv("PIO_INGEST_CACHE", "off")
    registry = StorageRegistry(_config(tmp_path))
    app_id = registry.get_meta_data_apps().insert(App(0, "ingestapp"))
    events = registry.get_events()
    events.init(app_id)
    _seed(events, app_id)
    svc = IngestService(IngestConfig(ip="127.0.0.1", port=0, block_rows=50),
                        registry, metrics=MetricsRegistry())
    svc.start()
    engine = rec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "ingestapp"}},
        "algorithms": [{"name": "als", "params": PARAMS}]})
    yield registry, app_id, engine, params, svc, tmp_path
    svc.shutdown()
    registry.close()


def _trained_model(registry, engine, params):
    row = CoreWorkflow.run_train(engine, params, RuntimeContext(
        registry=registry, device="cpu"))
    model, = deserialize_models(
        registry.get_model_data_models().get(row.id).models, row.id,
        [None], None, retrain=None)
    return row, model


def _rmse(users, items, x, y, batch) -> float:
    err = [(float(e.properties.get("rating")) - float(
        x[users(e.entity_id)] @ y[items(e.target_entity_id)])) ** 2
        for e in batch]
    return float(np.sqrt(np.mean(err)))


def test_train_through_the_service_equals_the_local_train(project,
                                                          monkeypatch):
    registry, app_id, engine, params, svc, tmp_path = project
    monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{svc.port}")
    ok0 = _remote_value("pio_ingest_remote_scans_total", outcome="ok")
    fb0 = _remote_value("pio_ingest_remote_scans_total", outcome="fallback")
    row_r, remote = _trained_model(registry, engine, params)
    assert _remote_value("pio_ingest_remote_scans_total",
                         outcome="ok") == ok0 + 1.0
    assert _remote_value("pio_ingest_remote_scans_total",
                         outcome="fallback") == fb0
    assert svc.metrics.value("pio_ingest_service_scans_total",
                             outcome="ok") == 1.0
    monkeypatch.delenv("PIO_INGEST_SERVICE")
    row_l, local = _trained_model(registry, engine, params)
    assert row_r.status == row_l.status == "COMPLETED"
    assert remote.users.keys() == local.users.keys()
    assert remote.items.keys() == local.items.keys()
    assert torch.equal(remote.user_factors, local.user_factors)
    assert torch.equal(remote.item_factors, local.item_factors)
    # the JAX train of the same store, within the ALS tolerance
    from predictionio_tpu.core.runtime import RuntimeContext as JContext
    from predictionio_tpu.models import recommendation as jrec
    jreg = JRegistry(_config(tmp_path))
    jengine = jrec.RecommendationEngine.apply()
    jparams = jengine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "ingestapp"}},
        "algorithms": [{"name": "als", "params": PARAMS}]})
    jmodel, = jengine.train(JContext(registry=jreg), jparams)
    jreg.close()
    batch = list(registry.get_events().find(app_id))
    ours = _rmse(local.users, local.items, local.user_factors.numpy(),
                 local.item_factors.numpy(), batch)
    theirs = _rmse(jmodel.users, jmodel.items,
                   np.asarray(jmodel.user_factors),
                   np.asarray(jmodel.item_factors), batch)
    assert abs(ours - theirs) < 1e-2


def test_refresher_tick_through_the_service_folds_as_a_local_tick(
        project, monkeypatch):
    from predictionio_tpu_torch.cli import main as cli_main
    from predictionio_tpu_torch.streaming import Refresher
    registry, app_id, engine, params, svc, _ = project
    row, _ = _trained_model(registry, engine, params)
    ctx = RuntimeContext(registry=registry, device="cpu")
    servers = [cli_main.deploy_instance(engine, row, ctx, port=0,
                                        batch_max=4) for _ in range(2)]
    try:
        refreshers = [Refresher(s, interval_s=999.0) for s in servers]
        assert [r.tick() for r in refreshers] == ["baseline"] * 2
        events = registry.get_events()
        events.insert_batch([Event(
            event="rate", entity_type="user", entity_id=f"u{u}",
            target_entity_type="item", target_entity_id=f"i{(u * 7) % 25}",
            properties=DataMap({"rating": 5.0}),
            event_time=T0 + timedelta(days=1, seconds=u))
            for u in range(0, 40, 3)], app_id)
        scans0 = svc.metrics.value("pio_ingest_service_scans_total",
                                   outcome="ok")
        monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{svc.port}")
        assert refreshers[0].tick() == "folded"
        # the delta, the template's delta re-scan and its history read
        assert svc.metrics.value("pio_ingest_service_scans_total",
                                 outcome="ok") == scans0 + 3.0
        monkeypatch.delenv("PIO_INGEST_SERVICE")
        assert refreshers[1].tick() == "folded"
        remote, local = (s.deployment.models[0] for s in servers)
        assert torch.equal(remote.user_factors, local.user_factors)
        assert torch.equal(remote.item_factors, local.item_factors)
        assert refreshers[0].status()["watermark"] == \
            refreshers[1].status()["watermark"]
    finally:
        for s in servers:
            s.stop()


def test_torn_block_in_a_train_is_fetched_again(project, monkeypatch):
    registry, app_id, engine, params, svc, _ = project
    monkeypatch.setenv("PIO_INGEST_SERVICE", f"127.0.0.1:{svc.port}")
    retries0 = _remote_value("pio_ingest_remote_retries_total")
    rule = faults().arm("ingest.stream.torn", torn=0.3, times=2)
    row, torn = _trained_model(registry, engine, params)
    assert rule.hits == 2 and row.status == "COMPLETED"
    assert _remote_value("pio_ingest_remote_retries_total") == \
        retries0 + 2.0
    monkeypatch.delenv("PIO_INGEST_SERVICE")
    _, local = _trained_model(registry, engine, params)
    assert torch.equal(torn.item_factors, local.item_factors)


class TestIngestdCommand:
    def test_cli_ingestd_serves_without_jax_or_a_device(self, tmp_path):
        """`cli ingestd` in a process where `import jax` and `import
        predictionio_tpu` fail: it serves a scan equal to the local one,
        exits 0 on SIGTERM, and never initializes CUDA."""
        import subprocess
        import sys
        from pathlib import Path
        repo = Path(__file__).resolve().parents[1]
        config = _config(tmp_path)
        reg = StorageRegistry(config)
        ev = reg.get_events()
        ev.init(1)
        ev.insert_batch([_mk(i) for i in range(300)], 1)
        code = (
            "import atexit, json, runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['predictionio_tpu'] = None\n"
            "def report():\n"
            "    t = sys.modules.get('torch')\n"
            "    print(json.dumps({'cuda_initialized': bool(\n"
            "        t is not None and t.cuda.is_initialized())}),\n"
            "        file=sys.stderr, flush=True)\n"
            "atexit.register(report)\n"
            "sys.argv = ['x', 'ingestd', '--ip', '127.0.0.1', '--port',\n"
            "            '0', '--block-rows', '32', '--workers', '2']\n"
            "runpy.run_module('predictionio_tpu_torch.cli',\n"
            "                 run_name='__main__')\n")
        import os
        env = {**os.environ, **config, "PYTHONPATH": str(repo)}
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            assert line.startswith("Ingest service started on 127.0.0.1:")
            port = int(line.rsplit(":", 1)[1])
            os.environ["PIO_INGEST_SERVICE"] = f"127.0.0.1:{port}"
            try:
                got = remote_scan_columns(1, value_spec=SPEC)
            finally:
                del os.environ["PIO_INGEST_SERVICE"]
            _assert_cols_equal(got, ev.scan_columns(1, value_spec=SPEC))
        finally:
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err[-2000:]
        assert json.loads(err.strip().splitlines()[-1]) == {
            "cuda_initialized": False}
        reg.close()
