"""The port's prediction quality (`predictionio_tpu_torch/obs/quality.py`
and its serve wiring) on the CPU, against the JAX package's
`obs/quality.py`.

Mirrors `tests/test_quality.py`: the quantile sketch against a numpy
oracle, the drift math, `QualityStats` on fake results, `QualityJoiner`
ticked against a MEM store, `CanaryGate` on a fake trace ring, a live
server's `/quality.json` (with the reference refrozen by `/reload`, the
switch off, and feedback clicks joined into a reward rate), and a fleet
whose roll to a scrambled model is vetoed by the canary with no failed
request while a good retrain rolls through. Parity with the JAX module
on the same inputs: sketch quantiles from the same seeded `random.Random`
equal, `psi` and `js_divergence` within 1e-12, `/quality.json`'s per-app
payload equal to the JAX server's for the same requests on the same
model, and the canary's overlap and verdict equal on the same two
tables.

Every test has its own SIGALRM limit."""

import base64
import json
import random
import signal
import threading
import time
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone
from types import SimpleNamespace

import numpy as np
import pytest

from predictionio_tpu.ingest import BiMap as JBiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.obs import quality as jq
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                     EventServerConfig)
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry)
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.obs import get_registry, trace
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.quality import (CanaryGate, CanaryVeto,
                                                QualityJoiner, QualityStats,
                                                QuantileSketch, _DriftState,
                                                js_divergence, psi)
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
from predictionio_tpu_torch.serving.server import FeedbackConfig

pytestmark = [pytest.mark.torch, pytest.mark.quality]

LIMIT_S = 120     # each test's own time limit
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


@pytest.fixture(autouse=True)
def _limits():
    """A time limit per test; the recorder back at sampling off."""
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    trace.configure(sample=0.0)


def call(port, method, path, body=None, headers=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(raw) if "json" in ct else raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def _pred(*pairs):
    """A fake predicted result: itemScores of (item, score) pairs."""
    return SimpleNamespace(itemScores=[
        SimpleNamespace(item=i, score=s) for i, s in pairs])


def _seed_ratings(events, app_id, invert=False):
    """The 20 x 15 block-structured ratings of the JAX suite; `invert`
    flips the preference (the scrambled model)."""
    rng = np.random.RandomState(0)
    for u in range(20):
        for i in range(15):
            if rng.rand() > 0.5:
                continue
            liked = i % 3 == u % 3
            r = (1.0 if liked else 5.0) if invert \
                else (5.0 if liked else 1.0)
            events.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": r})), app_id)


def _train(reg, app_name, seed=1):
    engine = prec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": app_name}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 4, "seed": seed}}]})
    ctx = RuntimeContext(registry=reg, device="cpu")
    return engine, CoreWorkflow.run_train(engine, params, ctx), ctx


@pytest.fixture()
def trained():
    """A MEM store with a trained instance of app `qualapp`."""
    reg = StorageRegistry(MEM)
    app_id = reg.get_meta_data_apps().insert(App(0, "qualapp"))
    reg.get_meta_data_access_keys().insert(AccessKey("QKEY", app_id, ()))
    reg.get_events().init(app_id)
    _seed_ratings(reg.get_events(), app_id)
    engine, row, ctx = _train(reg, "qualapp")
    return reg, engine, row, ctx, app_id


# -- the quantile sketch ------------------------------------------------------

class TestQuantileSketch:
    def test_quantiles_match_numpy_oracle(self):
        data = np.random.RandomState(7).lognormal(0.0, 1.0, size=4000)
        sk = QuantileSketch(k=128, rng=random.Random(0))
        for v in data:
            sk.update(float(v))
        s = np.sort(data)
        for q in (0.05, 0.25, 0.5, 0.75, 0.9, 0.99):
            rank = np.searchsorted(s, sk.quantile(q), side="right") / len(s)
            assert abs(rank - q) < 0.05, f"q={q} rank={rank}"
        assert sk.quantile(0.0) == s[0] and sk.quantile(1.0) == s[-1]
        assert sk.n == 4000

    def test_merge_weight_exact_and_order_insensitive(self):
        rs = np.random.RandomState(11)
        chunks = [rs.normal(loc=m, scale=1.0, size=2000).astype(float)
                  for m in (0.0, 1.0, 5.0)]

        def _sk(i):
            sk = QuantileSketch(k=128, rng=random.Random(i))
            for v in chunks[i]:
                sk.update(v)
            return sk

        left = _sk(0).merge(_sk(1)).merge(_sk(2))
        right = _sk(0).merge(_sk(1).merge(_sk(2)))
        s = np.sort(np.concatenate(chunks))
        for merged in (left, right):
            assert merged.n == 6000
            assert merged.quantile(0.0) == s[0]
            assert merged.quantile(1.0) == s[-1]
            for q in (0.1, 0.5, 0.9):
                rank = np.searchsorted(
                    s, merged.quantile(q), side="right") / len(s)
                assert abs(rank - q) < 0.06, f"q={q} rank={rank}"

    def test_bounded_memory(self):
        sk = QuantileSketch(k=64, rng=random.Random(1))
        for i in range(50_000):
            sk.update((i * 2654435761) % 100_003 / 100_003)
        assert all(len(buf) < 64 for buf in sk.levels)
        assert sum(len(buf) for buf in sk.levels) < 64 * len(sk.levels)
        assert len(sk.levels) <= 14 and sk.n == 50_000

    def test_empty_sketch(self):
        sk = QuantileSketch(k=16)
        assert sk.quantile(0.5) is None
        assert sk.cdf(1.0) == 0.0 and sk.n == 0

    @pytest.mark.parametrize("k,seed", [(16, 0), (64, 3), (128, 9)])
    def test_quantiles_equal_the_jax_sketch(self, k, seed):
        """The same stream and the same seeded `random.Random`: the same
        levels, quantiles and cdf as the JAX sketch, merges included."""
        data = np.random.RandomState(seed).normal(size=3000)
        mine = QuantileSketch(k=k, rng=random.Random(seed))
        theirs = jq.QuantileSketch(k=k, rng=random.Random(seed))
        other_m = QuantileSketch(k=k, rng=random.Random(seed + 1))
        other_j = jq.QuantileSketch(k=k, rng=random.Random(seed + 1))
        for v in data:
            mine.update(float(v))
            theirs.update(float(v))
            other_m.update(float(v) * 2.0)
            other_j.update(float(v) * 2.0)
        mine.merge(other_m)
        theirs.merge(other_j)
        assert mine.levels == theirs.levels and mine.n == theirs.n
        for q in (0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert mine.quantile(q) == theirs.quantile(q)
        for x in (-1.0, 0.0, 0.5, 2.0):
            assert mine.cdf(x) == theirs.cdf(x)


# -- the drift math -----------------------------------------------------------

class TestDriftMath:
    def test_psi_identity_and_shift(self):
        assert psi([10, 10, 10], [10, 10, 10]) == pytest.approx(0.0,
                                                                abs=1e-9)
        assert psi([80, 15, 5], [5, 15, 80]) > 0.25

    def test_js_symmetric_and_bounded(self):
        a, b = [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]
        assert js_divergence(a, a) == pytest.approx(0.0, abs=1e-9)
        assert js_divergence(a, b) == pytest.approx(js_divergence(b, a))
        assert 0.9 < js_divergence(a, b) <= 1.0 + 1e-9

    def test_drift_state_same_distribution_is_quiet(self):
        rs = np.random.RandomState(3)
        sk = QuantileSketch(k=128, rng=random.Random(0))
        for v in rs.normal(size=2000):
            sk.update(float(v))
        ds = _DriftState(sk, now_min=1000)
        assert ds.ref_n == 2000 and len(ds.edges) == 9
        for v in rs.normal(size=400):
            ds.observe(float(v), 1000)
        p, j = ds.drift(1000, 5)
        assert p < 0.15 and j < 0.1

    def test_drift_state_shifted_distribution_fires(self):
        rs = np.random.RandomState(3)
        sk = QuantileSketch(k=128, rng=random.Random(0))
        for v in rs.normal(size=2000):
            sk.update(float(v))
        ds = _DriftState(sk, now_min=1000)
        for v in rs.normal(loc=4.0, size=400):
            ds.observe(float(v), 1000)
        p, j = ds.drift(1000, 5)
        assert p > 1.0 and j > 0.3
        assert ds.drift(1300, 5) == (0.0, 0.0)    # no traffic: no drift

    def test_constant_reference_does_not_blow_up(self):
        sk = QuantileSketch(k=16)
        for _ in range(100):
            sk.update(1.0)
        ds = _DriftState(sk, now_min=10)
        assert ds.edges == [1.0]
        for _ in range(50):
            ds.observe(1.0, 10)
        assert ds.drift(10, 5)[0] == pytest.approx(0.0, abs=0.01)
        ds2 = _DriftState(sk, now_min=10)
        for _ in range(50):
            ds2.observe(2.0, 10)
        p2, _ = ds2.drift(10, 5)
        assert p2 > 1.0 and np.isfinite(p2)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_equal_the_jax_math(self, seed):
        rs = np.random.RandomState(seed)
        for n in (2, 3, 10, 17):
            a = list(rs.randint(0, 50, n).astype(float))
            b = list(rs.random_sample(n) * rs.randint(0, 3))
            assert abs(psi(a, b) - jq.psi(a, b)) <= 1e-12
            assert abs(js_divergence(a, b) - jq.js_divergence(a, b)) <= 1e-12
        sk = QuantileSketch(k=32, rng=random.Random(seed))
        jsk = jq.QuantileSketch(k=32, rng=random.Random(seed))
        for v in rs.normal(size=500):
            sk.update(float(v))
            jsk.update(float(v))
        mine, theirs = _DriftState(sk, 7), jq._DriftState(jsk, 7)
        assert mine.edges == theirs.edges
        assert mine.ref_probs == theirs.ref_probs
        for v in rs.normal(loc=0.5, size=200):
            mine.observe(float(v), 7)
            theirs.observe(float(v), 7)
        for got, want in zip(mine.drift(7, 5), theirs.drift(7, 5)):
            assert abs(got - want) <= 1e-12


# -- the serve-path accumulator ----------------------------------------------

class TestQualityStats:
    def test_autofreeze_and_snapshot_shape(self):
        qs = QualityStats(metrics=MetricsRegistry(), k=64)
        for i in range(60):
            qs.observe_result(
                "a", _pred(("x", 1.0 + 0.01 * (i % 10)), ("y", 0.4)),
                "u1", ())
        st = qs.snapshot()["a"]
        assert st["n"] == 60
        assert st["reference"] is not None and st["reference"]["n"] == 50
        q = st["quantiles"]["top1"]
        assert q["n"] == 10 and 1.0 <= q["p50"] <= 1.1
        assert q["min"] <= q["p50"] <= q["p90"] <= q["p99"] <= q["max"]
        assert "margin" in st["quantiles"]
        assert "top1_psi" in st["windows"]["5m"]
        assert "margin_js" in st["windows"]["1h"]

    def test_refreeze_moves_the_reference(self):
        qs = QualityStats(metrics=MetricsRegistry(), k=64)
        for i in range(50):
            qs.observe_result("a", _pred(("x", 0.01 * i)), None, ())
        ref1 = qs.snapshot()["a"]["reference"]
        assert ref1 is not None and ref1["n"] == 50
        for i in range(50):
            qs.observe_result("a", _pred(("x", 0.01 * i)), None, ())
        assert qs.snapshot()["a"]["windows"]["5m"]["top1_psi"] < 0.2
        qs.freeze_reference()
        ref2 = qs.snapshot()["a"]["reference"]
        assert ref2["n"] == 50 and ref2["frozen_at"] >= ref1["frozen_at"]
        for i in range(50):
            qs.observe_result("a", _pred(("x", 5.0 + 0.01 * i)), None, ())
        w = qs.snapshot()["a"]["windows"]["5m"]
        assert w["top1_psi"] > 1.0 and w["top1_js"] > 0.3

    def test_empty_and_unknown_ratios(self):
        qs = QualityStats(metrics=MetricsRegistry(), k=32)
        maps = ({"u1": 0},)
        qs.observe_result("b", _pred(), "ghost", maps)
        qs.observe_result("b", _pred(("x", 1.0)), "u1", maps)
        st = qs.snapshot()["b"]
        assert st["empty_total"] == 1 and st["unknown_total"] == 1
        w = st["windows"]["5m"]
        assert w["empty_ratio"] == pytest.approx(0.5)
        assert w["unknown_ratio"] == pytest.approx(0.5)

    def test_lru_caps_the_app_map(self):
        qs = QualityStats(metrics=MetricsRegistry(), max_apps=2, k=32)
        for app in ("a", "b", "c"):
            qs.observe_result(app, _pred(("x", 1.0)), None, ())
        assert set(qs.snapshot()) == {"b", "c"}

    def test_gauges_exported(self):
        reg = MetricsRegistry()
        qs = QualityStats(metrics=reg, k=64)
        for i in range(50):
            qs.observe_result("a", _pred(("x", 0.01 * i), ("y", -1.0)),
                              None, ())
        for _ in range(20):
            qs.observe_result("a", _pred(("x", 9.0), ("y", -1.0)), None, ())
        qs.observe_result("a", _pred(), None, ())
        qs._sync_gauges(time.time() + 10.0, int(time.time() // 60.0))
        assert reg.value("pio_pred_drift", app="a", metric="top1_psi",
                         window="5m") > 0.5
        assert reg.value("pio_pred_ratio", app="a", kind="empty",
                         window="5m") > 0.0

    def test_trim_drops_the_accumulators(self):
        qs = QualityStats(metrics=MetricsRegistry(), k=32)
        for i in range(10):
            qs.observe_result("a", _pred(("x", float(i))), None, ())
        assert qs.trim() > 0
        assert qs.snapshot() == {}
        qs.observe_result("a", _pred(("x", 1.0)), None, ())
        assert qs.snapshot()["a"]["n"] == 1


# -- the feedback join --------------------------------------------------------

def _fake_server(reg, app_name="joinapp"):
    """The deployment surface `locate_event_store` reads."""
    app_id = reg.get_meta_data_apps().insert(App(0, app_name))
    reg.get_events().init(app_id)
    dep = SimpleNamespace(instance=SimpleNamespace(
        data_source_params=json.dumps(
            {"name": "", "params": {"app_name": app_name}})))
    return SimpleNamespace(deployment=dep,
                           ctx=RuntimeContext(registry=reg)), app_id


class TestQualityJoiner:
    def test_exact_prid_join(self):
        reg = StorageRegistry(MEM)
        srv, app_id = _fake_server(reg)
        metrics = MetricsRegistry()
        j = QualityJoiner(srv, attribution_s=30.0, metrics=metrics)
        assert j.tick() == "baseline"
        events = reg.get_events()
        events.insert(Event(event="predict", entity_type="pio_pr",
                            entity_id="PR1"), app_id)
        assert j.tick() == "scanned"
        assert j.snapshot()["pending"] == 1
        events.insert(Event(event="click", entity_type="user",
                            entity_id="u1",
                            properties=DataMap({"prId": "PR1"})), app_id)
        assert j.tick() == "scanned"
        snap = j.snapshot()
        assert snap["pending"] == 0
        assert snap["apps"]["joinapp"]["joined_total"] == 1
        assert snap["apps"]["joinapp"]["reward_rate"] == 1.0
        assert metrics.value("pio_feedback_join_total", app="joinapp",
                             outcome="joined") == 1
        assert metrics.value("pio_pred_reward_rate", app="joinapp") == 1.0

    def test_wallclock_expiry_counts_unjoined(self):
        reg = StorageRegistry(MEM)
        srv, app_id = _fake_server(reg)
        metrics = MetricsRegistry()
        j = QualityJoiner(srv, attribution_s=0.05, metrics=metrics)
        j.tick()
        reg.get_events().insert(Event(event="predict", entity_type="pio_pr",
                                      entity_id="PR2"), app_id)
        assert j.tick() == "scanned"
        time.sleep(0.12)
        j.tick()
        snap = j.snapshot()
        assert snap["pending"] == 0
        assert snap["apps"]["joinapp"]["unjoined_total"] == 1
        assert snap["apps"]["joinapp"]["unjoined_ratio"] == 1.0
        assert metrics.value("pio_feedback_join_total", app="joinapp",
                             outcome="expired") == 1

    def test_event_time_outside_window_expires(self):
        reg = StorageRegistry(MEM)
        srv, app_id = _fake_server(reg)
        metrics = MetricsRegistry()
        j = QualityJoiner(srv, attribution_s=30.0, metrics=metrics)
        j.tick()
        now = datetime.now(timezone.utc)
        events = reg.get_events()
        events.insert(Event(event="predict", entity_type="pio_pr",
                            entity_id="PR3", event_time=now), app_id)
        events.insert(Event(event="click", entity_type="user",
                            entity_id="u1",
                            properties=DataMap({"prId": "PR3"}),
                            event_time=now + timedelta(seconds=60)), app_id)
        assert j.tick() == "scanned"
        assert metrics.value("pio_feedback_join_total", app="joinapp",
                             outcome="expired") == 1
        assert metrics.value("pio_feedback_join_total", app="joinapp",
                             outcome="joined") == 0

    def test_unknown_prid_ignored(self):
        reg = StorageRegistry(MEM)
        srv, app_id = _fake_server(reg)
        j = QualityJoiner(srv, attribution_s=30.0, metrics=MetricsRegistry())
        j.tick()
        reg.get_events().insert(
            Event(event="click", entity_type="user", entity_id="u1",
                  properties=DataMap({"prId": "GHOST"})), app_id)
        j.tick()
        snap = j.snapshot()
        assert snap["pending"] == 0 and snap["apps"] == {}

    def test_events_without_a_prid_are_passed_over(self):
        """The store's other events (ratings, a drip) carry no prId: the
        tick passes over them and joins the click (the JAX joiner's
        mandatory `get` raises on them)."""
        reg = StorageRegistry(MEM)
        srv, app_id = _fake_server(reg)
        metrics = MetricsRegistry()
        j = QualityJoiner(srv, attribution_s=30.0, metrics=metrics)
        j.tick()
        events = reg.get_events()
        events.insert(Event(event="predict", entity_type="pio_pr",
                            entity_id="PR4"), app_id)
        events.insert(Event(event="rate", entity_type="user", entity_id="u1",
                            target_entity_type="item",
                            target_entity_id="i1",
                            properties=DataMap({"rating": 4.0})), app_id)
        events.insert(Event(event="conversion", entity_type="pio_pr",
                            entity_id="PR4",
                            properties=DataMap({"prId": "PR4"})), app_id)
        assert j.tick() == "scanned"
        assert j.snapshot()["apps"]["joinapp"]["joined_total"] == 1
        assert metrics.value("pio_feedback_join_total", app="joinapp",
                             outcome="joined") == 1

    def test_outcomes_without_deployment(self):
        reg = StorageRegistry(MEM)
        srv = SimpleNamespace(deployment=None,
                              ctx=RuntimeContext(registry=reg))
        j = QualityJoiner(srv, metrics=MetricsRegistry())
        assert j.tick() == "no_deployment"
        srv.deployment = SimpleNamespace(instance=SimpleNamespace(
            data_source_params="{}"))
        assert j.tick() == "no_app"

    def test_registers_the_jax_role_and_budget(self):
        from predictionio_tpu_torch.resilience.watchdog import watchdog
        reg = StorageRegistry(MEM)
        srv, _ = _fake_server(reg)
        j = QualityJoiner(srv, interval_s=1.0, metrics=MetricsRegistry())
        j.start()
        try:
            assert j.beat in watchdog().beats()
            assert (j.beat.role, j.beat.budget_s, j.beat.restartable) \
                == ("joiner", 8.0, True)
        finally:
            j.stop()
        assert j.beat is None


# -- the canary gate ----------------------------------------------------------

class _FakeRecorder:
    def __init__(self, entries):
        self._entries = entries

    def snapshot(self):
        return self._entries


def _serve_entries(n, app="a"):
    return [{"kind": "serve", "app": app,
             "query": {"user": f"u{i}", "num": 2}} for i in range(n)]


def _fake_ring(monkeypatch, entries):
    for mod in ("predictionio_tpu_torch.obs.quality",
                "predictionio_tpu.obs.quality"):
        monkeypatch.setattr(f"{mod}.trace.get_recorder",
                            lambda: _FakeRecorder(entries))


class TestCanaryGate:
    def test_identical_plans_pass(self, monkeypatch):
        _fake_ring(monkeypatch, _serve_entries(4))
        reg = MetricsRegistry()
        gate = CanaryGate(sample=8, min_overlap=0.5, metrics=reg)

        def replay(dep, qdicts):
            return [_pred(("i0", 1.0), ("i1", 0.5)) for _ in qdicts]

        report = gate.check("old", "new", replay)
        assert report["outcome"] == "pass"
        assert report["overlap"] == 1.0 and report["sampled"] == 4
        assert report["score_delta"] == 0.0
        assert report["per_app"]["a"] == 1.0
        assert gate.last is report
        assert reg.value("pio_canary_total", outcome="pass") == 1
        assert reg.value("pio_canary_overlap", app="a") == 1.0

    def test_disjoint_plans_vetoed(self, monkeypatch):
        _fake_ring(monkeypatch, _serve_entries(4))
        reg = MetricsRegistry()
        gate = CanaryGate(sample=8, min_overlap=0.5, metrics=reg)

        def replay(dep, qdicts):
            ids = ("i0", "i1") if dep == "old" else ("z0", "z1")
            return [_pred((ids[0], 1.0), (ids[1], 0.5)) for _ in qdicts]

        with pytest.raises(CanaryVeto, match="overlap 0.000"):
            gate.check("old", "new", replay)
        assert gate.last["outcome"] == "fail"
        assert reg.value("pio_canary_total", outcome="fail") == 1

    def test_report_only_when_threshold_unset(self, monkeypatch):
        _fake_ring(monkeypatch, _serve_entries(2))
        gate = CanaryGate(sample=8, min_overlap=0.0,
                          metrics=MetricsRegistry())

        def replay(dep, qdicts):
            ids = ("i0",) if dep == "old" else ("z0",)
            return [_pred((ids[0], 1.0)) for _ in qdicts]

        report = gate.check("old", "new", replay)
        assert report["outcome"] == "pass" and report["overlap"] == 0.0

    def test_empty_results_agree_and_empty_ring_skips(self, monkeypatch):
        _fake_ring(monkeypatch, _serve_entries(2))
        gate = CanaryGate(sample=8, min_overlap=0.9,
                          metrics=MetricsRegistry())

        def replay(dep, qdicts):
            return [_pred() for _ in qdicts]

        assert gate.check("old", "new", replay)["overlap"] == 1.0
        _fake_ring(monkeypatch, [])
        reg = MetricsRegistry()
        gate2 = CanaryGate(sample=8, min_overlap=0.9, metrics=reg)
        assert gate2.check("old", "new", replay) is None
        assert reg.value("pio_canary_total", outcome="skipped") == 1

    @pytest.mark.parametrize("min_overlap", [0.0, 0.3, 0.9])
    def test_overlap_and_verdict_equal_the_jax_gate(self, monkeypatch,
                                                    min_overlap):
        """Two tables of the same catalog, served through both packages'
        plain top-k: the same overlap, score delta and verdict."""
        rng = np.random.default_rng(4)
        x = rng.integers(-4, 5, (12, 6)).astype(np.float32)
        old = rng.integers(-4, 5, (40, 6)).astype(np.float32)
        new = old.copy()
        new[::3] = rng.integers(-4, 5, (14, 6)).astype(np.float32)
        items = [f"i{n}" for n in range(40)]
        _fake_ring(monkeypatch, [
            {"kind": "serve", "app": "a" if n % 2 else "b",
             "query": {"user": n, "num": 1 + n % 5}} for n in range(10)])

        def replay(table, qdicts):
            out = []
            for qd in qdicts:
                s = x[qd["user"]] @ table.T
                top = sorted(range(len(s)), key=lambda j: (-s[j], j))
                out.append(_pred(*[(items[j], float(s[j]))
                                   for j in top[:qd["num"]]]))
            return out

        results = []
        for gate in (CanaryGate(sample=16, min_overlap=min_overlap,
                                metrics=MetricsRegistry()),
                     jq.CanaryGate(sample=16, min_overlap=min_overlap,
                                   metrics=None)):
            try:
                gate.check(old, new, replay)
                vetoed = False
            except (CanaryVeto, jq.CanaryVeto):
                vetoed = True
            last = dict(gate.last)
            last.pop("ts")
            results.append((vetoed, last))
        assert results[0] == results[1]


def test_plan_calls_count_every_concurrent_call():
    """The canary calls a plan beside the drainer: K1 plan calls counted
    from many threads at a tiny switch interval lose no update."""
    import sys
    from predictionio_tpu_torch.ops import topk
    plan = SimpleNamespace(calls=0)
    before = topk.PLAN_CALLS
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [topk.count_plan_call(plan) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert plan.calls == 32_000 and topk.PLAN_CALLS - before == 32_000


# -- live HTTP ----------------------------------------------------------------

class TestLiveQuality:
    def test_quality_json_and_reload_refreeze(self, trained):
        reg, engine, row, ctx, _ = trained
        srv = cli.deploy_instance(engine, row, ctx, port=0, batch_max=8,
                                  metrics=MetricsRegistry())
        try:
            for i in range(60):
                status, _ = call(srv.port, "POST", "/queries.json",
                                 {"user": f"u{i % 20}", "num": 3})
                assert status == 200
            status, _ = call(srv.port, "POST", "/queries.json",
                             {"user": "ghost", "num": 3})
            assert status == 200            # empty and an unknown user
            status, body = call(srv.port, "GET", "/quality.json")
            assert status == 200 and body["enabled"] is True
            st = body["apps"][""]
            assert st["n"] == 61
            assert st["empty_total"] >= 1 and st["unknown_total"] >= 1
            assert st["quantiles"]["top1"]["n"] >= 1
            ref1 = st["reference"]
            assert ref1 is not None and ref1["n"] == 50
            assert "top1_psi" in st["windows"]["5m"]
            assert call(srv.port, "POST", "/reload")[0] == 200
            st = call(srv.port, "GET", "/quality.json")[1]["apps"][""]
            # the ghost carries no top-1 score: the refrozen reference
            # holds the 10 scores after the automatic freeze
            assert st["reference"]["n"] == 10
            assert st["reference"]["frozen_at"] >= ref1["frozen_at"]
            assert call(srv.port, "GET", "/status.json")[1]["quality"]
        finally:
            srv.stop()

    def test_quality_off_disables_endpoint(self, trained):
        reg, engine, row, ctx, _ = trained
        srv = cli.deploy_instance(engine, row, ctx, port=0, batch_max=8,
                                  quality=False, metrics=MetricsRegistry())
        try:
            call(srv.port, "POST", "/queries.json", {"user": "u1", "num": 2})
            status, body = call(srv.port, "GET", "/quality.json")
            assert status == 200
            assert body["enabled"] is False and body["apps"] == {}
            assert "joiner" not in body and "canary" not in body
        finally:
            srv.stop()

    def test_feedback_carries_prid_and_clicks_become_reward(self, trained):
        reg, engine, row, ctx, app_id = trained
        trace.configure(sample=1.0, ring=64)
        es = EventServer(EventServerConfig(ip="127.0.0.1", port=0), reg,
                         metrics=MetricsRegistry())
        es.start()
        metrics = MetricsRegistry()
        srv = cli.deploy_instance(
            engine, row, ctx, port=0, batch_max=8, metrics=metrics,
            feedback=FeedbackConfig("127.0.0.1", es.port, "QKEY"),
            attribution_s=60.0)
        try:
            for i in range(3):
                assert call(srv.port, "POST", "/queries.json",
                            {"user": f"u{i}", "num": 2})[0] == 200
            end = time.time() + 10
            found = []
            while len(found) < 3 and time.time() < end:
                found = list(reg.get_events().find(
                    app_id, event_names=["predict"]))
                time.sleep(0.05)
            assert len(found) >= 3, "feedback predict events missing"
            for ev in found:
                assert ev.entity_type == "pio_pr"
                assert ev.properties.get("prId") == ev.entity_id
                assert ev.properties.get("traceId")
            for ev in found:
                reg.get_events().insert(
                    Event(event="click", entity_type="user",
                          entity_id="u1",
                          properties=DataMap({"prId": ev.entity_id})),
                    app_id)
            end = time.time() + 15
            reward, body = 0.0, {}
            while reward == 0.0 and time.time() < end:
                status, body = call(srv.port, "GET", "/quality.json")
                assert status == 200
                japps = (body.get("joiner") or {}).get("apps") or {}
                reward = japps.get("qualapp", {}).get("reward_rate", 0.0)
                time.sleep(0.1)
            assert reward > 0.0, "clicks never joined into reward"
            assert body["joiner"]["attribution_s"] == 60.0
            assert body["joiner"]["apps"]["qualapp"]["joined_total"] >= 1
        finally:
            srv.stop()
            es.shutdown()

    def test_fast_route_traces_carry_the_query_dict(self, trained):
        """The canary's source: kept serve entries of the fast route
        (and the binary frame) and of the generic route carry a query
        dict, as the JAX entries do."""
        from predictionio_tpu_torch.utils.wire import encode_bin_query
        reg, engine, row, ctx, _ = trained
        trace.configure(sample=1.0, ring=64)
        srv = cli.deploy_instance(engine, row, ctx, port=0, batch_max=8,
                                  metrics=MetricsRegistry())
        try:
            assert call(srv.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2})[0] == 200
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/queries.json",
                data=encode_bin_query("u2", 3), method="POST",
                headers={"Content-Type": "application/x-pio-bin"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
            assert call(srv.port, "POST", "/queries.json",
                        {"user": "u3", "num": 2, "blackList": ["i1"]})[0] \
                == 200
            end = time.time() + 10
            entries = []
            while len(entries) < 3 and time.time() < end:
                entries = [e for e in trace.get_recorder().snapshot()
                           if e.get("kind") == "serve"]
                time.sleep(0.02)
            queries = sorted((e["query"] for e in entries),
                             key=lambda q: q["user"])
            assert queries == [{"user": "u1", "num": 2},
                               {"user": "u2", "num": 3},
                               {"user": "u3", "num": 2,
                                "blackList": ["i1"]}]
        finally:
            srv.stop()


# -- parity of /quality.json with the JAX server -------------------------------

N_USERS, N_ITEMS, RANK = 30, 120, 8
P_USERS = [f"u{n}" for n in range(N_USERS)]
P_ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _parity_factors():
    rng = np.random.default_rng(17)
    return (rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
            rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32))


def _jax_server(x, y):
    """The JAX server over the same integer-valued factors: an instance
    whose train returns them, in a MEM store."""
    from predictionio_tpu.core import CoreWorkflow as JWorkflow
    from predictionio_tpu.core import EngineParams as JParams
    from predictionio_tpu.core import RuntimeContext as JCtx
    from predictionio_tpu.data.event import DataMap as JMap
    from predictionio_tpu.data.event import Event as JEvent
    from predictionio_tpu.data.storage import App as JApp
    from predictionio_tpu.data.storage import StorageRegistry as JReg
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.serving import PredictionServer as JServer
    from predictionio_tpu.serving import ServerConfig

    reg = JReg(MEM)
    app = reg.get_meta_data_apps().insert(JApp(0, "parity"))
    reg.get_events().init(app)
    reg.get_events().insert(JEvent(
        event="rate", entity_type="user", entity_id="u0",
        target_entity_type="item", target_entity_id="i0",
        properties=JMap({"rating": 4.0})), app)
    jmodel = jals.ALSModel(x, y, JBiMap.from_keys(P_USERS),
                           JBiMap.from_keys(P_ITEMS))
    train = jrec.ALSAlgorithm.train
    jrec.ALSAlgorithm.train = lambda self, ctx, pd: jmodel
    try:
        JWorkflow.run_train(jrec.engine(), JParams(
            data_source_params=("", jrec.DataSourceParams(
                app_name="parity")),
            algorithm_params_list=(("als", jrec.ALSAlgorithmParams()),)),
            JCtx(registry=reg))
    finally:
        jrec.ALSAlgorithm.train = train
    srv = JServer(ServerConfig(ip="127.0.0.1", port=0, batch_window_ms=2),
                  registry=reg, engine=jrec.engine(), metrics=JMetrics())
    srv.start()
    return srv


def _strip_times(app_payload):
    out = json.loads(json.dumps(app_payload))
    if out.get("reference"):
        out["reference"].pop("frozen_at")
    return out


def test_quality_json_equals_the_jax_server():
    """The same 70 requests (one unknown user, empty answers for num 0
    excluded by both) on the same model: the per-app payload of
    `/quality.json` (counts, quantiles, windows, the reference's size)
    equals the JAX server's."""
    x, y = _parity_factors()
    model = pals.als_model_from_numpy(x, y, P_USERS, P_ITEMS, device="cpu")
    mine = cli.deploy(model, port=0, batch_max=16, metrics=MetricsRegistry())
    theirs = _jax_server(x, y)
    try:
        queries = [{"user": P_USERS[n % N_USERS], "num": 1 + n % 7}
                   for n in range(69)] + [{"user": "ghost", "num": 3}]
        for q in queries:
            assert call(mine.port, "POST", "/queries.json", q)[0] == 200
            assert call(theirs.port, "POST", "/queries.json", q)[0] == 200
        got = call(mine.port, "GET", "/quality.json")[1]
        want = call(theirs.port, "GET", "/quality.json")[1]
        assert got["enabled"] is want["enabled"] is True
        assert set(got["apps"]) == set(want["apps"]) == {""}
        assert _strip_times(got["apps"][""]) == \
            _strip_times(want["apps"][""])
        assert got["apps"][""]["n"] == 70
    finally:
        mine.stop()
        theirs.shutdown()


# -- the fleet: a canary-gated rolling reload ----------------------------------

class _Loader:
    """Client threads; every response status recorded."""

    def __init__(self, port, threads=2):
        self.port = port
        self.halt = threading.Event()
        self.statuses = []
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(threads)]

    def _run(self):
        while not self.halt.is_set():
            try:
                status, _ = call(self.port, "POST", "/queries.json",
                                 {"user": "u1", "num": 2})
            except OSError:
                status = -1
            with self._lock:
                self.statuses.append(status)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.halt.set()
        for t in self._threads:
            t.join(5)

    @property
    def failures(self):
        with self._lock:
            return [s for s in self.statuses if s != 200]


class TestFleetCanary:
    def test_scrambled_roll_vetoed_good_roll_passes(self, trained,
                                                    monkeypatch):
        """A model trained on inverted ratings becomes the latest
        instance; each replica's canary replays the kept serve traces
        through both plans, sees the top-k flip and refuses the reload,
        so the roll aborts with no failed request. A retrain with the
        same parameters and seed then rolls through; the router's
        `/quality.json` gathers both members."""
        reg, engine, row1, ctx, _ = trained
        monkeypatch.setenv("PIO_CANARY_SAMPLE", "8")
        monkeypatch.setenv("PIO_CANARY_MIN_OVERLAP", "0.7")
        trace.configure(sample=1.0, ring=256)
        factory = cli.fleet_replica_factory(engine, row1, ctx, batch_max=8,
                                            server_key="ck",
                                            metrics=MetricsRegistry())
        fleet = FleetServer(factory, fleet=FleetConfig(
            replicas=2, health_interval_s=0.1, eject_threshold=2,
            drain_timeout_s=2.0), port=0, metrics=MetricsRegistry(),
            server_key="ck", registry=reg)
        fleet.start()
        auth = {"Authorization": "Basic " + base64.b64encode(
            b"ck:").decode()}
        try:
            for i in range(10):
                assert call(fleet.port, "POST", "/queries.json",
                            {"user": f"u{i % 5}", "num": 3})[0] == 200
            sid = reg.get_meta_data_apps().insert(App(0, "scrambledapp"))
            reg.get_events().init(sid)
            _seed_ratings(reg.get_events(), sid, invert=True)
            _, row2, _ = _train(reg, "scrambledapp")
            assert row2.id != row1.id
            fail_before = get_registry().value("pio_canary_total",
                                               outcome="fail")
            with _Loader(fleet.port) as load:
                status, report = call(fleet.port, "POST", "/reload",
                                      headers=auth, timeout=120)
            assert status == 500 and report["aborted"] is True, report
            assert len(report["results"]) == 1
            r0 = report["results"][0]
            assert r0["outcome"] == "load_failed_rolled_back"
            assert "canary overlap" in r0["detail"]
            assert len(load.statuses) > 0 and load.failures == []
            # the replicas share the factory's registry
            vetoes = sum(m.value("pio_canary_total", outcome="fail") or 0
                         for m in {id(rep.server.metrics): rep.server.metrics
                                   for rep in fleet.replicas()}.values())
            assert vetoes == 1 and get_registry().value(
                "pio_canary_total", outcome="fail") == fail_before
            for rep in fleet.replicas():
                assert call(rep.port, "GET", "/status.json")[1][
                    "engineInstanceId"] == row1.id
            _, row3, _ = _train(reg, "qualapp", seed=1)
            with _Loader(fleet.port) as load2:
                status, report = call(fleet.port, "POST", "/reload",
                                      headers=auth, timeout=120)
            assert status == 200 and report["aborted"] is False
            assert [r["outcome"] for r in report["results"]] \
                == ["reloaded"] * 2
            assert len(load2.statuses) > 0 and load2.failures == []
            for rep in fleet.replicas():
                assert call(rep.port, "GET", "/status.json")[1][
                    "engineInstanceId"] == row3.id
                assert rep.server.quality_snapshot()["canary"][
                    "outcome"] == "pass"
            status, body = call(fleet.port, "GET", "/quality.json")
            assert status == 200 and body["role"] == "fleet"
            assert len(body["members"]) == 2
            assert all(m.get("enabled") for m in body["members"].values())
        finally:
            fleet.stop()
