"""The port's elastic fleet on the CPU, against the JAX package's: the
traffic harness (`predictionio_tpu_torch/tools/loadsim.py`), the
autoscaler (`serving/autoscaler.py`), the supervisor's grow and retire,
the router's member scrape, `/federate`, `/fleet.html` and retirement
(`serving/fleet.py`, `tools/dashboard.py`), per-channel quotas and
budget inheritance (`tenancy/admission.py`), and `cli deploy
--autoscale` and `cli loadsim`.

Mirrors `tests/test_elastic.py`'s TestSchedule, TestPopulationSkew,
TestWireShapes, TestDecide, TestElasticSupervisor, TestChannelQuotas and
TestBudgetInheritance and `tests/test_prof.py`'s TestFleetFederation.
Across the packages, exactly: `build_schedule`, `Event.encode` and
`expected_arrivals` for every built-in scenario and two seeds; the
`decide` sequence of one pseudo-random signal stream; `ring_signals`
over both rings; `_parse_prom`, `_prom_hist_p99` and `_federate_line`
on the /metrics text of a live server of each package; the `/fleet.html`
page. Then a CPU elastic loop: a port router, a supervisor with one
stub child, an autoscaler on a scripted signal level and a port
`LoadRunner` against the router, 1 -> 2 -> 1 with no failed request."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from predictionio_tpu.obs import tsdb as jtsdb
from predictionio_tpu.serving import autoscaler as jauto
from predictionio_tpu.serving import fleet as jfleet
from predictionio_tpu.serving import supervisor as jsup
from predictionio_tpu.tools import dashboard as jdash
from predictionio_tpu.tools import loadsim as jsim
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry,
                                                 TenantQuota)
from predictionio_tpu_torch.obs import MetricsRegistry, get_registry
from predictionio_tpu_torch.obs.tsdb import TSDB, series_key
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.resilience import OverloadedError
from predictionio_tpu_torch.serving import fleet as pfleet
from predictionio_tpu_torch.serving.autoscaler import (AutoscaleConfig,
                                                       Autoscaler, Signals,
                                                       ring_signals)
from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer
from predictionio_tpu_torch.serving import supervisor as psup
from predictionio_tpu_torch.serving.supervisor import (ChildSpec,
                                                       Supervisor,
                                                       stub_child_argv)
from predictionio_tpu_torch.tenancy.admission import (AdmissionController,
                                                      TenancyConfig,
                                                      TenantIdentity)
from predictionio_tpu_torch.tools import dashboard as pdash
from predictionio_tpu_torch.tools import loadsim
from predictionio_tpu_torch.utils.http import HTTPError, HTTPServerBase
from predictionio_tpu_torch.utils.http import Response
from predictionio_tpu_torch.utils.wire import (BIN_CONTENT_TYPE,
                                               decode_bin_query)

pytestmark = [pytest.mark.torch, pytest.mark.elastic]

LIMIT_S = 120     # each test's own time limit
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _metric(name, **labels):
    return get_registry().value(name, **labels)


def _wait(pred, msg="condition", timeout=30.0, interval=0.02):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for: {msg}")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["PIO_OBS_LOG_LEVEL"] = "WARNING"
    return env


def _get(port, path, timeout=10):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _post(port, body, timeout=10):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- loadsim: the schedule ------------------------------------------------------

def _builtin(name, scale, mod=loadsim):
    return mod.scale_durations(mod.scenario_from_dict(mod.BUILTIN[name]),
                               scale)


def _events(sched):
    return [(e.t, e.app, e.shape, e.user, e.banned) for e in sched]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(jsim.BUILTIN))
def test_schedule_equals_the_jax_one(name, seed):
    """The same numpy draws: every arrival's time, app, shape, user and
    bans, every body and content type, and the analytic count."""
    assert sorted(loadsim.BUILTIN) == sorted(jsim.BUILTIN)
    ours = replace(_builtin(name, 0.05), seed=seed)
    theirs = replace(_builtin(name, 0.05, jsim), seed=seed)
    mine, jax_sched = loadsim.build_schedule(ours), jsim.build_schedule(
        theirs)
    assert len(mine) > 50
    assert _events(mine) == _events(jax_sched)
    for ev, jev in zip(mine, jax_sched):
        assert ev.encode(ours.apps[ev.app]) == jev.encode(
            theirs.apps[jev.app])
    assert loadsim.expected_arrivals(ours) == jsim.expected_arrivals(theirs)


class TestSchedule:
    def test_build_is_deterministic_in_seed(self):
        sc = _builtin("flash-crowd", 0.05)
        first = loadsim.build_schedule(sc)
        assert first == loadsim.build_schedule(sc)
        assert len(first) > 50
        assert loadsim.build_schedule(replace(sc, seed=sc.seed + 1)) != first

    def test_arrival_count_tracks_analytic_integral(self):
        sc = _builtin("diurnal", 0.1)
        expected = loadsim.expected_arrivals(sc)
        got = len(loadsim.build_schedule(sc))
        assert expected > 400
        assert abs(got - expected) / expected < 0.15, (got, expected)

    def test_events_sorted_and_within_trace(self):
        sc = _builtin("hot-key", 0.05)
        ts = [e.t for e in loadsim.build_schedule(sc)]
        assert ts == sorted(ts)
        assert 0.0 <= ts[0] and ts[-1] < sc.duration_s()

    def test_phase_rate_curves(self):
        diurnal = loadsim.Phase(kind="diurnal", duration_s=60.0, rps=100.0,
                                amplitude=0.8, period_s=60.0)
        assert diurnal.rate_at(0.0) == pytest.approx(20.0)
        assert diurnal.rate_at(15.0) == pytest.approx(100.0)
        assert diurnal.rate_at(30.0) == pytest.approx(180.0)
        assert diurnal.peak_rate() == pytest.approx(180.0)
        flash = loadsim.Phase(kind="flash", duration_s=30.0, rps=10.0,
                              peak_rps=110.0, at_s=10.0, ramp_s=2.0,
                              hold_s=5.0)
        assert flash.rate_at(0.0) == pytest.approx(10.0)
        assert flash.rate_at(11.0) == pytest.approx(60.0)
        assert flash.rate_at(13.0) == pytest.approx(110.0)
        assert flash.rate_at(25.0) == pytest.approx(10.0)
        assert flash.peak_rate() == pytest.approx(110.0)
        jflash = jsim.Phase(kind="flash", duration_s=30.0, rps=10.0,
                            peak_rps=110.0, at_s=10.0, ramp_s=2.0,
                            hold_s=5.0)
        for ph in (diurnal, flash):
            for t in np.linspace(0.0, ph.duration_s, 200):
                assert ph.rate_at(float(t)) <= ph.peak_rate() + 1e-9
        for t in np.linspace(0.0, 30.0, 61):
            assert flash.rate_at(float(t)) == jflash.rate_at(float(t))

    def test_rejects_malformed_specs(self):
        with pytest.raises(ValueError):
            loadsim.Phase(kind="bogus", duration_s=1.0, rps=1.0)
        with pytest.raises(ValueError):
            loadsim.Phase(kind="steady", duration_s=0.0, rps=1.0)
        with pytest.raises(ValueError):
            loadsim.scenario_from_dict({
                "apps": [{"key": "K", "mix": {"nope": 1.0},
                          "phases": [{"kind": "steady",
                                      "duration_s": 1.0, "rps": 1.0}]}]})

    def test_scale_durations_preserves_rates(self):
        sc = _builtin("flash-crowd", 1.0)
        short = loadsim.scale_durations(sc, 0.1)
        assert short.duration_s() == pytest.approx(sc.duration_s() * 0.1)
        assert short.apps[0].phases[0].peak_rps == \
            sc.apps[0].phases[0].peak_rps
        assert loadsim.expected_arrivals(short) == pytest.approx(
            loadsim.expected_arrivals(sc) * 0.1, rel=0.05)

    def test_scenario_file_round_trip(self, tmp_path):
        path = tmp_path / "sc.json"
        path.write_text(json.dumps(loadsim.BUILTIN["hot-key"]))
        assert loadsim.load_scenario(str(path)) == \
            loadsim.scenario_from_dict(loadsim.BUILTIN["hot-key"])


class TestPopulationSkew:
    def test_zipf_head_carries_the_mass(self):
        draws = loadsim.ZipfRanks(1_000_000, 1.1).sample(
            np.random.RandomState(0), 20_000)
        assert draws.min() >= 0 and draws.max() < 1_000_000
        assert float((draws < 100).mean()) > 0.3
        assert np.bincount(draws[draws < 100]).argmax() == 0
        theirs = jsim.ZipfRanks(1_000_000, 1.1).sample(
            np.random.RandomState(0), 20_000)
        assert np.array_equal(draws, theirs)

    def test_hot_key_pivot_concentrates_on_target(self):
        events = loadsim.build_schedule(_builtin("hot-key", 0.1))
        mid = [e for e in events if 1.0 <= e.t < 3.0]
        hot = sum(1 for e in mid if e.user == 3) / max(len(mid), 1)
        assert 0.6 <= hot <= 0.9, hot
        edges = [e for e in events if e.t < 1.0 or e.t >= 3.0]
        cold = sum(1 for e in edges if e.user == 3) / max(len(edges), 1)
        assert cold < 0.2, cold


class TestWireShapes:
    SPEC = loadsim.AppSpec(key="K", num=7)

    def test_fast_shape_is_minimal_json(self):
        body, ctype = loadsim.Event(t=0.0, app=0, shape="fast",
                                    user=5).encode(self.SPEC)
        assert ctype == "application/json"
        assert json.loads(body) == {"user": "u5", "num": 7}

    def test_banned_shapes_carry_blacklist(self):
        for shape in ("generic", "banned"):
            body, _ = loadsim.Event(t=0.0, app=0, shape=shape, user=2,
                                    banned=(1, 9)).encode(self.SPEC)
            assert json.loads(body)["blackList"] == ["i1", "i9"]

    def test_bin_shape_roundtrips_the_frame(self):
        body, ctype = loadsim.Event(t=0.0, app=0, shape="bin",
                                    user=42).encode(self.SPEC)
        assert ctype == BIN_CONTENT_TYPE
        assert decode_bin_query(body) == ("u42", 7)

    def test_schedule_mixes_all_shapes(self):
        events = loadsim.build_schedule(_builtin("diurnal", 0.1))
        assert {e.shape for e in events} == set(loadsim.SHAPES)

    def test_emit_is_bench_format(self):
        res, jres = loadsim.LoadResult(), jsim.LoadResult()
        for r in (res, jres):
            for dt in (0.01, 0.02, 0.03):
                r.add(0, 200, dt)
            r.add(0, 429, 0.001)
            r.add(0, 500, 0.001)
        buf = io.StringIO()
        recs = res.emit("loadsim_t", duration_s=2.0, out=buf)
        lines = [json.loads(line) for line in
                 buf.getvalue().strip().splitlines()]
        assert lines == recs
        assert recs == jres.emit("loadsim_t", duration_s=2.0,
                                 out=io.StringIO())
        by = {r["metric"]: r for r in recs}
        assert by["loadsim_t_requests"]["value"] == 5
        assert by["loadsim_t_ok"]["value"] == 3
        assert by["loadsim_t_shed"]["value"] == 1
        assert by["loadsim_t_errors"]["value"] == 1
        assert res.by_status() == jres.by_status()
        for rec in recs:
            assert set(rec) == {"metric", "value", "unit", "vs_baseline"}


def test_runner_samples_file_against_a_live_server(tmp_path):
    """`loadsim.main` against a port server: every arrival answered 200,
    and `--samples` holds each one's scheduled second, status, latency
    and sent second, and the run's unix start."""
    srv = HTTPServerBase(host="127.0.0.1", port=0,
                         metrics=MetricsRegistry())

    @srv.router.post("/queries.json")
    def queries(req):
        return Response.json({"itemScores": []})

    srv.start()
    doc = {"name": "tiny", "seed": 3, "apps": [{
        "key": "K", "n_users": 1000, "n_items": 50,
        "phases": [{"kind": "steady", "duration_s": 1.0, "rps": 40.0}]}]}
    sc_file, samples = tmp_path / "sc.json", tmp_path / "samples.json"
    sc_file.write_text(json.dumps(doc))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = loadsim.main(["--scenario", str(sc_file), "--port",
                               str(srv.port), "--samples", str(samples)])
    finally:
        srv.shutdown()
    assert rc == 0
    by = {json.loads(line)["metric"]: json.loads(line)["value"]
          for line in out.getvalue().splitlines()}
    n = len(loadsim.build_schedule(loadsim.scenario_from_dict(doc)))
    assert by["loadsim_tiny_requests"] == by["loadsim_tiny_ok"] == n
    got = json.loads(samples.read_text())
    assert len(got["timeline"]) == n and got["late"] >= 0
    assert {s for _, s, _, _ in got["timeline"]} == {200}
    assert [t for t, _, _, _ in got["timeline"]] == sorted(
        e.t for e in loadsim.build_schedule(loadsim.scenario_from_dict(doc)))
    # each sent at or after its scheduled second, the run's start a unix
    # second of this run
    assert all(sent >= t - 1e-3 and dt > 0
               for t, _, dt, sent in got["timeline"])
    assert abs(got["started"] - time.time()) < 60


# -- the autoscaler's decision table --------------------------------------------

BREACH = Signals(qps=50.0, p99_s=1.0)
IDLE = Signals(qps=0.0, p99_s=0.001)
BUSY_OK = Signals(qps=100.0, p99_s=0.01)
DECIDE_CFG = dict(enabled=True, min_children=1, max_children=3,
                  breach_ticks=3, idle_ticks=2, cooldown_s=10.0,
                  flap_window_s=100.0, max_flips=2, idle_qps_per_child=5.0)


def _asc(**kw):
    return Autoscaler(AutoscaleConfig(**{**DECIDE_CFG, **kw}))


class TestDecide:
    def test_breach_must_persist_before_up(self):
        asc = _asc()
        assert [asc.decide(BREACH, 1, t) for t in (0.0, 1.0, 2.0)] == \
            ["hold", "hold", "up"]

    def test_single_bad_scrape_is_noise(self):
        asc = _asc()
        t = 0.0
        for _ in range(5):
            assert asc.decide(BREACH, 1, t) == "hold"
            assert asc.decide(BUSY_OK, 1, t + 1) == "hold"
            t += 2.0

    def test_idle_must_persist_before_down(self):
        asc = _asc()
        assert asc.decide(IDLE, 2, 0.0) == "hold"
        assert asc.decide(IDLE, 2, 1.0) == "down"

    def test_busy_but_healthy_holds_forever(self):
        asc = _asc()
        for t in range(50):
            assert asc.decide(BUSY_OK, 2, float(t)) == "hold"

    def test_bounds_clamp_both_directions(self):
        asc = _asc()
        for t in range(10):
            assert asc.decide(BREACH, 3, float(t)) == "hold"
        asc = _asc()
        for t in range(10):
            assert asc.decide(IDLE, 1, float(t)) == "hold"

    def test_cooldown_then_flap_damping(self):
        asc = _asc()
        ups = [t for t in range(104)
               if asc.decide(BREACH, 1, float(t)) == "up"]
        assert ups == [2, 12, 103]

    @pytest.mark.parametrize("sig", [
        Signals(p99_s=1.0), Signals(delay_s=1.0), Signals(burn=5.0),
        Signals(shed_rps=10.0)])
    def test_every_breach_surface_triggers(self, sig):
        asc = _asc()
        assert [asc.decide(sig, 1, t) for t in (0.0, 1.0, 2.0)] == \
            ["hold", "hold", "up"]

    def test_disabled_tick_holds(self):
        assert _asc(enabled=False).tick(now=0.0) == "hold"

    def test_standby_observes_but_never_acts(self):
        asc = Autoscaler(
            AutoscaleConfig(enabled=True, breach_ticks=1),
            fleet=SimpleNamespace(_is_leader=False, metrics=None))
        asc._breach = 5
        assert asc.tick(now=0.0) == "hold"
        assert asc._breach == 0

    def test_from_env_reads_the_jax_names(self, monkeypatch):
        assert AutoscaleConfig.from_env() == AutoscaleConfig(
            **vars(jauto.AutoscaleConfig.from_env()))
        knobs = {"PIO_AUTOSCALE": "on", "PIO_AUTOSCALE_MIN": "2",
                 "PIO_AUTOSCALE_MAX": "5", "PIO_AUTOSCALE_P99_MS": "40",
                 "PIO_AUTOSCALE_DELAY_MS": "20", "PIO_AUTOSCALE_BURN": "3",
                 "PIO_AUTOSCALE_SHED_RPS": "1.5",
                 "PIO_AUTOSCALE_IDLE_QPS": "9",
                 "PIO_AUTOSCALE_BREACH_TICKS": "2",
                 "PIO_AUTOSCALE_IDLE_TICKS": "4",
                 "PIO_AUTOSCALE_COOLDOWN_S": "25",
                 "PIO_AUTOSCALE_FLAP_WINDOW_S": "200",
                 "PIO_AUTOSCALE_MAX_FLIPS": "4"}
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        ours = AutoscaleConfig.from_env()
        assert vars(ours) == vars(jauto.AutoscaleConfig.from_env())
        assert ours.enabled and ours.min_children == 2 \
            and ours.cooldown_s == 25.0


@pytest.mark.parametrize("seed", [3, 17])
def test_decide_sequence_equals_the_jax_one(seed):
    """One pseudo-random stream of samples (levels around every
    threshold) and clock, the child count following the decisions: the
    same direction at every tick."""
    cfg = dict(DECIDE_CFG, max_children=4, cooldown_s=4.0, max_flips=3,
               flap_window_s=30.0)
    ours = Autoscaler(AutoscaleConfig(**cfg))
    theirs = jauto.Autoscaler(jauto.AutoscaleConfig(**cfg))
    rng = np.random.RandomState(seed)
    kids = {"ours": 1, "theirs": 1}
    seq, jseq = [], []
    t = 0.0
    for _ in range(400):
        t += float(rng.uniform(0.5, 1.5))
        vals = dict(qps=float(rng.choice([0.0, 2.0, 30.0, 200.0])),
                    p99_s=float(rng.choice([0.001, 0.2, 0.3])),
                    delay_s=float(rng.choice([0.0, 0.05, 0.2],
                                             p=[0.6, 0.3, 0.1])),
                    burn=float(rng.choice([0.0, 0.5, 2.0],
                                          p=[0.7, 0.2, 0.1])),
                    shed_rps=float(rng.choice([0.0, 1.0], p=[0.9, 0.1])))
        for name, asc, sig, out in (
                ("ours", ours, Signals(**vals), seq),
                ("theirs", theirs, jauto.Signals(**vals), jseq)):
            d = asc.decide(sig, kids[name], t)
            kids[name] += {"up": 1, "down": -1}.get(d, 0)
            out.append(d)
    assert seq == jseq
    assert {"up", "down", "hold"} <= set(seq)


def test_ring_signals_equal_over_both_rings():
    data = [
        ("pio_fleet_member_qps", {"member": "a"}, "", 2.0),
        ("pio_fleet_member_qps", {"member": "b"}, "", 3.0),
        ("pio_fleet_member_p99_seconds", {"member": "a"}, "", 0.1),
        ("pio_fleet_member_p99_seconds", {"member": "b"}, "", 0.3),
        ("pio_fleet_member_burn", {"member": "b"}, "", 2.5),
        ("pio_fleet_member_reactor_balance", {"member": "a"}, "", 1.4),
        ("pio_shed_total", {"app": "x", "surface": "quota"}, "rate", 1.5),
        ("pio_shed_total", {"app": "y", "surface": "queue"}, "rate", 0.5),
        ("pio_queue_delay_seconds", {"app": "x"}, "p99", 0.05),
        ("pio_http_requests_total", {"code": "200"}, "rate", 99.0),
    ]
    ours, theirs = TSDB(points=8), jtsdb.TSDB(points=8)
    for n, (name, labels, sfx, v) in enumerate(data):
        for db, key in ((ours, series_key(name, labels, sfx)),
                        (theirs, jtsdb.series_key(name, labels, sfx))):
            db.record_value(key, "gauge", 100.0 + n, v / 2)
            db.record_value(key, "gauge", 101.0 + n, v)
    sig, jsig = ring_signals(ours), jauto.ring_signals(theirs)
    assert vars(sig) == vars(jsig)
    assert sig.qps == pytest.approx(5.0)
    assert sig.p99_s == pytest.approx(0.3)
    assert sig.burn == pytest.approx(2.5)
    assert sig.shed_rps == pytest.approx(2.0)
    assert sig.delay_s == pytest.approx(0.05)
    assert sig.balance == pytest.approx(1.4)


# -- the supervisor: a retirement is a decision, not a death --------------------

def _sleeper(name):
    code = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "while True: time.sleep(0.1)\n")
    return ChildSpec(name, [sys.executable, "-c", code])


class TestElasticSupervisor:
    def test_grow_then_retire_without_respawn_accounting(self):
        sup = Supervisor([], poll_s=0.05, grace_s=5.0).start()
        try:
            before = _metric("pio_supervisor_respawns_total",
                             child="egrow") or 0.0
            sup.grow(_sleeper("egrow"))
            _wait(lambda: sup.alive_count() == 1, "child up")
            assert sup.find("egrow").retiring is False
            assert sup.retire("egrow") is True
            assert sup.children() == []
            time.sleep(0.3)     # polls that would miscount the exit
            assert (_metric("pio_supervisor_respawns_total",
                            child="egrow") or 0.0) == before
        finally:
            sup.stop()

    def test_grow_rejects_duplicate_names(self):
        sup = Supervisor([], poll_s=0.05, grace_s=5.0).start()
        try:
            sup.grow(_sleeper("edup"))
            with pytest.raises(ValueError):
                sup.grow(_sleeper("edup"))
            assert sup.retire("edup") is True
            assert sup.retire("edup") is False
        finally:
            sup.stop()

    def test_retire_sigkills_a_child_that_ignores_sigterm(self, tmp_path):
        flag = tmp_path / "up"
        code = ("import pathlib, signal, time\n"
                "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                f"pathlib.Path({str(flag)!r}).touch()\n"
                "time.sleep(120)\n")
        sup = Supervisor([ChildSpec("deaf", [sys.executable, "-c", code])],
                         poll_s=0.05, grace_s=5.0).start()
        try:
            _wait(flag.exists, "the child's handler")
            proc = sup.find("deaf").proc
            t0 = time.monotonic()
            assert sup.retire("deaf", grace_s=0.3) is True
            assert proc.returncode == -signal.SIGKILL
            assert time.monotonic() - t0 < 5.0
            assert sup.alive_count() == 0 and sup.children() == []
        finally:
            sup.stop()


def test_child_argv_drops_the_autoscale_flags_as_the_jax_one():
    parent = ["deploy", "--supervised", "1", "--autoscale", "on",
              "--autoscale-min=1", "--autoscale-max", "3", "--device", "cpu"]
    mine = psup.child_argv_from_parent(parent, "http://127.0.0.1:9",
                                       extra=("--member-name", "scale1"))
    theirs = jsup.child_argv_from_parent(parent, "http://127.0.0.1:9",
                                         extra=("--member-name", "scale1"))
    assert mine[3:] == theirs[3:] == [
        "deploy", "--device", "cpu", "--join", "http://127.0.0.1:9",
        "--port", "0", "--member-name", "scale1"]


# -- per-channel quotas and budget inheritance ----------------------------------

@pytest.fixture()
def admission():
    reg = StorageRegistry({
        "PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"})
    app_id = reg.get_meta_data_apps().insert(App(0, "elapp"))
    reg.get_meta_data_access_keys().insert(AccessKey("ELKEY", app_id, ()))
    quotas = reg.get_meta_data_tenant_quotas()
    quotas.upsert(TenantQuota(appid=app_id, rate=50.0, burst=50.0))
    quotas.upsert(TenantQuota(appid=app_id, rate=1000.0, burst=2.0,
                              channel="mob"))
    quotas.upsert(TenantQuota(appid=app_id, concurrency=1, channel="web"))
    cfg = TenancyConfig(enabled=True, rate=10.0, burst=20.0, queue_max=64,
                        header_key="elastic-secret")
    return AdmissionController(cfg, registry=reg,
                               metrics=MetricsRegistry()), app_id


class TestChannelQuotas:
    def test_three_level_resolution(self, admission):
        ctl, app_id = admission
        base = ctl.quota(TenantIdentity(app_id, "elapp"))
        assert (base.rate, base.burst) == (50.0, 50.0)
        mob = ctl.quota(TenantIdentity(app_id, "elapp", channel="mob"))
        assert (mob.rate, mob.burst) == (1000.0, 2.0)
        web = ctl.quota(TenantIdentity(app_id, "elapp", channel="web"))
        assert web.concurrency == 1
        assert (web.rate, web.burst) == (50.0, 50.0)
        other = ctl.quota(TenantIdentity(app_id, "elapp", channel="tv"))
        assert (other.rate, other.burst) == (50.0, 50.0)

    def test_state_keys_never_collide(self):
        assert TenantIdentity(1, "app").state_key == "app"
        assert TenantIdentity(1, "app", channel="mob").state_key \
            == "app/mob"

    def test_channel_buckets_are_isolated(self, admission):
        ctl, app_id = admission
        mob = TenantIdentity(app_id, "elapp", channel="mob")
        for _ in range(2):
            with ctl.admit(mob):
                pass
        with pytest.raises(OverloadedError):
            with ctl.admit(mob):
                pass
        with ctl.admit(TenantIdentity(app_id, "elapp")):
            pass
        with ctl.admit(TenantIdentity(app_id, "elapp", channel="tv")):
            pass

    def test_resolve_raw_stamps_and_validates_channel(self, admission):
        ctl, app_id = admission
        ident = ctl.resolve_raw("ELKEY", None, None, channel="mob")
        assert (ident.app_id, ident.label, ident.channel) \
            == (app_id, "elapp", "mob")
        with pytest.raises(HTTPError) as ei:
            ctl.resolve_raw("ELKEY", None, None, channel="bad/chan")
        assert ei.value.status == 400
        with pytest.raises(HTTPError) as ei:
            ctl.resolve_raw("WRONG", None, None)
        assert ei.value.status == 401

    def test_signed_header_roundtrips_channel(self, admission):
        ctl, app_id = admission
        replica = AdmissionController(ctl.config.replica_variant(),
                                      registry=None,
                                      metrics=MetricsRegistry())
        header = ctl.signed_header(
            TenantIdentity(app_id, "elapp", channel="mob"))
        got = replica.resolve_raw(None, header, None)
        assert got is not None and got.pre_admitted
        assert (got.app_id, got.label, got.channel) \
            == (app_id, "elapp", "mob")
        assert replica._parse_header(header[:-1] + "0") is None


class TestBudgetInheritance:
    def _ctl(self, rate=5.0, burst=10.0):
        return AdmissionController(
            TenancyConfig(enabled=True, rate=rate, burst=burst),
            registry=None, metrics=MetricsRegistry())

    def test_export_reflects_spend(self):
        ctl = self._ctl()
        ident = TenantIdentity(1, "t1")
        for _ in range(4):
            with ctl.admit(ident):
                pass
        doc = ctl.export_buckets()
        assert set(doc) == {"t", "buckets"}
        rec = doc["buckets"]["t1"]
        assert rec["burst"] == 10.0
        assert rec["tokens"] == pytest.approx(6.0, abs=0.5)

    def test_adopt_clamps_down_never_up(self):
        ctl = self._ctl()
        ident = TenantIdentity(1, "t1")
        for _ in range(8):
            with ctl.admit(ident):
                pass
        spent = ctl._tenants.get("t1").bucket.tokens
        assert spent < 3.0
        ctl.adopt_buckets({"t": time.time(), "buckets": {
            "t1": {"tokens": 10.0, "rate": 5.0, "burst": 10.0}}})
        assert ctl._tenants.get("t1").bucket.tokens \
            == pytest.approx(spent, abs=0.5)
        ctl.adopt_buckets({"t": time.time(), "buckets": {
            "t1": {"tokens": 0.5, "rate": 5.0, "burst": 10.0}}})
        assert ctl._tenants.get("t1").bucket.tokens \
            == pytest.approx(0.5, abs=0.5)

    def test_repeated_adoption_does_not_eat_refill(self):
        ctl = self._ctl(rate=1000.0, burst=10.0)
        ident = TenantIdentity(1, "t1")
        for _ in range(10):
            with ctl.admit(ident):
                pass
        doc = {"t": time.time(), "buckets": {
            "t1": {"tokens": 10.0, "rate": 1000.0, "burst": 10.0}}}
        for _ in range(5):
            ctl.adopt_buckets(doc)
            time.sleep(0.002)
        time.sleep(0.01)
        with ctl.admit(ident):
            pass

    def test_unseen_tenant_inherits_on_first_state(self):
        ctl = self._ctl()
        ctl.adopt_buckets({"t": time.time(), "buckets": {
            "flood": {"tokens": 1.0, "rate": 5.0, "burst": 10.0}}})
        with ctl.admit(TenantIdentity(2, "flood")):
            pass
        assert ctl._tenants.get("flood").bucket.tokens < 2.0

    def test_adopt_ignores_garbage(self):
        ctl = self._ctl()
        assert ctl.adopt_buckets(None) == 0
        assert ctl.adopt_buckets({}) == 0
        assert ctl.adopt_buckets({"t": "nope", "buckets": {
            "x": {"tokens": "garbage"},
            "y": {"tokens": 3.0, "rate": 1.0, "burst": 5.0}}}) == 1


# -- the federation helpers against the JAX ones --------------------------------

@pytest.fixture(scope="module")
def scraped_texts():
    """Two /metrics scrapes each of a live port server and a live JAX
    server, with requests (two routes, one of them slow) between."""
    from predictionio_tpu.obs import MetricsRegistry as JMetrics
    from predictionio_tpu.utils.http import HTTPServerBase as JServer
    from predictionio_tpu.utils.http import Response as JResponse
    out = {}
    for name, server_cls, resp_cls, metrics in (
            ("port", HTTPServerBase, Response, MetricsRegistry()),
            ("jax", JServer, JResponse, JMetrics())):
        srv = server_cls(host="127.0.0.1", port=0, metrics=metrics)

        @srv.router.get("/fast")
        def fast(req, resp_cls=resp_cls):
            return resp_cls.json({"ok": True})

        @srv.router.get("/slow")
        def slow(req, resp_cls=resp_cls):
            time.sleep(0.03)
            return resp_cls.json({"ok": True})

        srv.start()
        try:
            texts = []
            for burst in (5, 20):
                for n in range(burst):
                    _get(srv.port, "/slow" if n % 4 == 0 else "/fast")
                texts.append(_get(srv.port, "/metrics")[1])
        finally:
            srv.shutdown()
        out[name] = texts
    return out


def test_parse_prom_equals_the_jax_one(scraped_texts):
    for texts in scraped_texts.values():
        for text in texts:
            ours = pfleet._parse_prom(text)
            assert ours == jfleet._parse_prom(text)
            assert any(n == "pio_http_requests_total" for n, _ in ours)
    assert pfleet._parse_prom('x{a="1"} nope\n{ 2\n') == \
        jfleet._parse_prom('x{a="1"} nope\n{ 2\n')


def test_prom_hist_p99_equals_the_jax_one(scraped_texts):
    for texts in scraped_texts.values():
        first, second = (pfleet._parse_prom(t) for t in texts)
        for prev, cur in ((first, second), ({}, first), (second, second)):
            for name in ("pio_http_request_duration_seconds_bucket",
                         "no_such_bucket"):
                assert pfleet._prom_hist_p99(cur, prev, name) == \
                    jfleet._prom_hist_p99(cur, prev, name)
        assert pfleet._prom_hist_p99(
            second, first, "pio_http_request_duration_seconds_bucket") > 0


def test_federate_line_equals_the_jax_one(scraped_texts):
    for texts in scraped_texts.values():
        for line in texts[1].splitlines():
            if line and not line.startswith("#"):
                assert pfleet._federate_line(line, "127.0.0.1:9") == \
                    jfleet._federate_line(line, "127.0.0.1:9")


def test_fleet_page_equals_the_jax_page():
    members = [
        {"member": "127.0.0.1:7001", "state": "serving", "admitted": True,
         "failures": 0, "beat_age_s": 0.25},
        {"member": "127.0.0.1:7002", "state": "retiring",
         "admitted": False, "failures": 2, "beat_age_s": 1.5},
        {"member": "<b>", "state": "ejected", "admitted": False}]
    assert pdash._fleet_page(None, members) == \
        jdash._fleet_page(None, members)
    ours, theirs = TSDB(points=32), jtsdb.TSDB(points=32)
    rng = np.random.default_rng(5)
    keys = ([f"pio_fleet_member_qps{{member=m{k}}}" for k in range(10)]
            + ["pio_fleet_member_p99_seconds{member=m0}",
               "pio_fleet_member_burn{member=m0}",
               "pio_autoscale_children",
               "pio_autoscale_decisions_total{direction=up}:rate"])
    for step in range(6):
        for key in keys:
            v = float(rng.integers(0, 50)) / 4.0
            ours.record_value(key, "gauge", 1000.0 + step, v)
            theirs.record_value(key, "gauge", 1000.0 + step, v)
    assert pdash._fleet_page(ours, members) == \
        jdash._fleet_page(theirs, members)
    assert pdash._spark_svg([(0.0, 1.0)]) == jdash._spark_svg([(0.0, 1.0)])


# -- the router: federation and retirement --------------------------------------

N_USERS, N_ITEMS, RANK = 30, 120, 8
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _factory(i, *, mesh=None, tenancy=None):
    rng = np.random.default_rng(21)
    model = pals.als_model_from_numpy(
        rng.integers(-4, 5, (N_USERS, RANK)).astype(np.float32),
        rng.integers(-4, 5, (N_ITEMS, RANK)).astype(np.float32),
        USERS, ITEMS, device="cpu")
    return cli.deploy(model, port=0, batch_max=8, window_s=0.002,
                      mesh=mesh, tenancy=tenancy, metrics=MetricsRegistry())


def _fleet(replicas, **kw):
    cfg = dict(replicas=replicas, health_interval_s=0.5,
               eject_threshold=2, drain_timeout_s=2.0)
    cfg.update(kw)
    srv = FleetServer(_factory, fleet=FleetConfig(**cfg), port=0,
                      metrics=MetricsRegistry())
    srv.start()
    return srv


class TestFleetFederation:
    def test_federate_covers_members_and_survives_death(self):
        fleet = _fleet(3)
        try:
            for n in range(12):
                assert _post(fleet.port, {"user": USERS[n], "num": 3})[0] \
                    == 200
            fleet._scrape_members()
            members = [rep.key for rep in fleet.replicas()]
            status, text = _get(fleet.port, "/federate")
            assert status == 200
            for key in members:
                assert f'member="{key}"' in text
            assert 'pio_http_requests_total{' in text
            for n in range(6):
                _post(fleet.port, {"user": USERS[n], "num": 3})
            fleet._scrape_members()
            snap = fleet.metrics.snapshot()
            for fam in ("pio_fleet_member_burn", "pio_fleet_member_qps",
                        "pio_fleet_member_p99_seconds"):
                assert {s["labels"]["member"] for s in
                        snap[fam]["series"]} == set(members), fam
            assert fleet.metrics.value("pio_fleet_metrics_scrapes_total",
                                       outcome="ok") == 6
            victim = fleet.replicas()[0]
            victim.server.shutdown()
            fails_before = victim.failures
            fleet._scrape_members()
            assert fleet.metrics.value("pio_fleet_metrics_scrapes_total",
                                       outcome="error") >= 1
            assert victim.failures > fails_before
            status, text = _get(fleet.port, "/federate")
            assert status == 200
            for key in members:
                assert f'member="{key}"' in text
            status, page = _get(fleet.port, "/fleet.html")
            assert status == 200 and "Fleet observatory" in page
            for key in members:
                assert f"<td>{key}</td>" in page
        finally:
            fleet.stop()

    def test_federate_empty_before_first_scrape(self):
        fleet = _fleet(1)
        try:
            assert _get(fleet.port, "/federate") == (200, "")
        finally:
            fleet.stop()

    def test_scrape_stays_inside_its_budget_past_a_silent_member(self):
        """A member that accepts and never answers costs at most the
        tick's budget, and the member scraped next tick comes after it."""
        import socket
        fleet = _fleet(1)
        silent = socket.socket()
        silent.bind(("127.0.0.1", 0))
        silent.listen(8)
        try:
            rep = fleet._add_member("127.0.0.1", silent.getsockname()[1])
            fleet._admit(rep)
            budget = fleet._scrape_budget_s()
            fleet._scrape_next = len(fleet.replicas()) - 1   # the silent one
            t0 = time.monotonic()
            fleet._scrape_members()
            took = time.monotonic() - t0
            assert took <= budget + 0.5, (took, budget)
            assert fleet.metrics.value("pio_fleet_metrics_scrapes_total",
                                       outcome="error") >= 1
            assert fleet.metrics.value("pio_fleet_metrics_scrapes_total",
                                       outcome="ok") >= 1
        finally:
            silent.close()
            fleet.stop()


def test_retirement_is_a_drain_not_an_eject():
    fleet = _fleet(2)
    try:
        obs = fleet.metrics
        victim, keeper = fleet.replicas()
        victim.name = "scale1"
        assert fleet.member_by_name("scale1") is victim
        assert fleet.member_by_name("nobody") is None
        with victim.lock:
            victim.failures = 1
        ejects = obs.value("pio_fleet_transitions_total", event="eject") or 0
        drained = dict(victim.server.batcher.batch_sizes())
        assert fleet.retire_member_named("scale1") is True
        assert obs.value("pio_fleet_transitions_total", event="retire") == 1
        assert (obs.value("pio_fleet_transitions_total", event="eject")
                or 0) == ejects
        assert victim.failures == 1 and victim.state == "retiring"
        assert not victim.admitted
        for n in range(10):
            assert _post(fleet.port, {"user": USERS[n], "num": 2})[0] == 200
        assert victim.server.batcher.batch_sizes() == drained
        time.sleep(1.2)        # monitor passes: no re-admit, no eject
        assert victim.state == "retiring" and not victim.admitted
        fleet.forget_member(victim.key)
        status = json.loads(_get(fleet.port, "/status.json")[1])
        assert [m["member"] for m in status["replicas"]] == [keeper.key]
    finally:
        fleet.stop()


def test_a_member_retired_after_it_was_picked_gets_no_request():
    """A request that picked its members before a retirement (a stale
    rotation) skips the retired one: a drain that saw zero in flight
    sees no later request, and no suspicion is counted."""
    fleet = _fleet(2)
    try:
        victim, keeper = fleet.replicas()
        fleet._rotation = lambda: [victim, keeper]
        assert fleet.retire_member(victim) is True
        before = dict(victim.server.batcher.batch_sizes())
        for n in range(6):
            assert _post(fleet.port, {"user": USERS[n], "num": 2})[0] == 200
        assert victim.server.batcher.batch_sizes() == before
        assert victim.failures == 0 and victim.inflight == 0
        assert fleet.metrics.value("pio_fleet_routed_total",
                                   outcome="retried") in (None, 0.0)
    finally:
        fleet.stop()


def test_a_forgotten_member_leaves_the_autoscalers_signals():
    """The retired member's last qps and p99 leave the registry and the
    ring with it, so that they cannot hold the autoscaler's signals."""
    fleet = _fleet(2)
    try:
        victim, keeper = fleet.replicas()
        for n in range(3):
            for k in range(8):
                _post(fleet.port, {"user": USERS[k], "num": 2})
            fleet._scrape_members()
            fleet.tsdb.record_snapshot(fleet.metrics.snapshot(),
                                       now=1000.0 + n)
        fleet.metrics.gauge("pio_fleet_member_qps", "",
                            labels=("member",)).labels(
            member=victim.key).set(500.0)
        fleet.tsdb.record_snapshot(fleet.metrics.snapshot(), now=1003.0)
        assert ring_signals(fleet.tsdb).qps >= 500.0
        assert any(victim.key in k for k in fleet.tsdb.keys())
        fleet.retire_member(victim)
        fleet.forget_member(victim.key)
        fleet.tsdb.record_snapshot(fleet.metrics.snapshot(), now=1004.0)
        assert not any(victim.key in k for k in fleet.tsdb.keys())
        assert any(keeper.key in k for k in fleet.tsdb.keys())
        assert ring_signals(fleet.tsdb).qps < 500.0
        assert victim.key not in fleet.metrics.render()
    finally:
        fleet.stop()


# -- the CPU elastic loop -------------------------------------------------------

class _Level:
    """The load level the autoscaler sees, scripted (the traffic itself
    is real)."""

    def __init__(self):
        self.level = "calm"

    def __call__(self):
        if self.level == "surge":
            return Signals(qps=400.0, p99_s=0.9, shed_rps=5.0)
        return Signals(qps=0.0, p99_s=0.001)


def test_elastic_loop_one_to_two_to_one_under_load():
    # probes every 0.5 s and 8 suspicions to eject: a stub child starved
    # of CPU by a loaded host must not eject and fake a violation (the
    # loop gates that a retirement never counts as one)
    router = FleetServer(None, fleet=FleetConfig(
        replicas=0, health_interval_s=0.5, heartbeat_s=0.5,
        eject_threshold=8, drain_timeout_s=2.0), port=0,
        metrics=MetricsRegistry())
    router.start()
    url = f"http://127.0.0.1:{router.port}"

    def spec(name):
        return ChildSpec(name, stub_child_argv(url, heartbeat_s=0.2,
                                               name=name), env=_env())

    sup = Supervisor([spec("base0")], grace_s=5.0, poll_s=0.1,
                     backoff_base_s=0.3).start()
    level = _Level()
    asc = Autoscaler(AutoscaleConfig(
        enabled=True, min_children=1, max_children=2, breach_ticks=2,
        idle_ticks=3, cooldown_s=0.4, flap_window_s=60.0, max_flips=8),
        supervisor=sup, fleet=router, spec_factory=spec, signals_fn=level)
    router.autoscaler = asc
    halt = threading.Event()

    def drive():
        while not halt.is_set():
            asc.tick()
            time.sleep(0.1)

    ticker = threading.Thread(target=drive, daemon=True)
    respawns = sum(_metric("pio_supervisor_respawns_total", child=c) or 0.0
                   for c in ("base0", "scale1"))
    ejects = router.metrics.value("pio_fleet_transitions_total",
                                  event="eject") or 0.0

    def admitted():
        return sum(1 for r in router.replicas() if r.admitted)

    try:
        _wait(lambda: admitted() == 1, "the base child", 60)
        ticker.start()
        sc = loadsim.scenario_from_dict({
            "name": "cpu-flash", "seed": 11, "apps": [{
                "key": "K", "n_users": 5000, "n_items": 200,
                "phases": [{"kind": "flash", "duration_s": 8.0,
                            "rps": 8.0, "peak_rps": 40.0, "at_s": 1.0,
                            "ramp_s": 0.5, "hold_s": 3.0}]}]})
        runner = loadsim.LoadRunner(sc, [router.port], timeout_s=5.0)
        fire = threading.Thread(target=runner.run, daemon=True)
        fire.start()
        level.level = "surge"
        _wait(lambda: sup.alive_count() >= 2, "the grown child", 40)
        _wait(lambda: admitted() == 2, "scale1 admitted", 40)
        assert asc.target == 2
        assert router.member_by_name("scale1") is not None
        served_by = set()
        for _ in range(20):
            code, out = _post(router.port, {"user": "u1"})
            assert code == 200
            served_by.add(out["stub"])
        assert served_by == {"base0", "scale1"}
        fire.join(30)
        level.level = "calm"
        _wait(lambda: asc.target == 1, "the scale-down decision", 30)
        assert asc.drain_idle(20.0) is True
        _wait(lambda: sup.alive_count() == 1, "the retired process", 10)
        _wait(lambda: len(router.replicas()) == 1, "the member forgotten")
        assert [c["name"] for c in sup.children()] == ["base0"]
    finally:
        halt.set()
        if ticker.is_alive():
            ticker.join(5)
        sup.stop()
        router.stop()
    by = runner.result.by_status()
    assert sum(by.values()) > 50
    assert set(by) == {200}, by
    assert router.metrics.value("pio_fleet_transitions_total",
                                event="retire") == 1
    assert (router.metrics.value("pio_fleet_transitions_total",
                                 event="eject") or 0.0) == ejects
    assert sum(_metric("pio_supervisor_respawns_total", child=c) or 0.0
               for c in ("base0", "scale1")) == respawns
    assert router.metrics.value("pio_autoscale_decisions_total",
                                direction="up") == 1
    assert router.metrics.value("pio_autoscale_decisions_total",
                                direction="down") == 1


# -- the command line -----------------------------------------------------------

def test_cli_loadsim_dry_run_prints_the_jax_line(capsys):
    from predictionio_tpu.cli import main as jcli
    argv = ["loadsim", "--", "--scenario", "hot-key", "--port", "1",
            "--scale", "0.02", "--dry-run"]
    assert cli.main(argv) == 0
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert jcli.main(argv) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs
    assert json.loads(ours)["metric"] == "loadsim_hot-key_schedule"


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_deploy_refuses_autoscale_with_a_mesh(tmp_path, how):
    """`deploy --supervised 2 --mesh items=2@fleet` with the autoscaler
    on (`--autoscale on`, or PIO_AUTOSCALE) exits with a clear error
    before a router starts: a grown child would serve no slice."""
    env = {**_env(), "PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
           "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")}
    argv = [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
            "--supervised", "2", "--mesh", "items=2@fleet", "--device",
            "cpu", "--port", "0"]
    if how == "flag":
        argv += ["--autoscale", "on"]
    else:
        env["PIO_AUTOSCALE"] = "on"
    proc = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no --autoscale on (or PIO_AUTOSCALE) with --mesh" in proc.stderr
    assert "started on" not in proc.stdout


def test_cli_deploy_supervised_with_autoscale(tmp_path):
    """`deploy --supervised 1 --autoscale on --autoscale-min 1
    --autoscale-max 2 --device cpu` prints the JAX banner, its child is
    admitted and serves, and the router's /metrics has
    pio_autoscale_children."""
    from predictionio_tpu_torch.core.base import (DataSource, FirstServing,
                                                  IdentityPreparator)
    from predictionio_tpu_torch.core.engine import Engine
    from predictionio_tpu_torch.core.runtime import (RuntimeContext,
                                                     WorkflowParams)
    from predictionio_tpu_torch.core.workflow import CoreWorkflow
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm

    config = {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
              "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db")}
    registry = StorageRegistry(config)
    rng = np.random.default_rng(2)
    model = pals.als_model_from_numpy(
        rng.standard_normal((N_USERS, RANK), dtype=np.float32),
        rng.standard_normal((N_ITEMS, RANK), dtype=np.float32),
        USERS, ITEMS, device="cpu")

    class GivenModel(ALSAlgorithm):
        def train(self, ctx, pd):
            return model

    class NoEvents(DataSource):
        def read_training(self, ctx):
            return None

    engine = Engine(NoEvents, IdentityPreparator, {"als": GivenModel},
                    FirstServing)
    iid = CoreWorkflow.run_train(
        engine, engine.engine_params_from_variant(
            {"algorithms": [{"name": "als", "params": {}}]}),
        RuntimeContext(registry=registry, device="cpu",
                       workflow_params=WorkflowParams(
                           skip_sanity_check=True)),
        engine_factory="recommendation", engine_variant="default").id
    registry.close()
    env = {**_env(), **config, "PIO_FLEET_HEARTBEAT_S": "0.2",
           "PIO_TSDB_INTERVAL_S": "0.5"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--supervised", "1", "--autoscale", "on", "--autoscale-min", "1",
         "--autoscale-max", "2", "--device", "cpu", "--port", "0",
         "--engine-instance-id", iid, "--batch-max", "8"], cwd=tmp_path,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = proc.stdout.readline()
        head, _, tail = line.partition(" on ")
        assert head == "Fleet control plane started", line
        addr, _, what = tail.strip().partition(" ")
        assert what == ("(1 supervised replica processes, autoscale "
                        "[1, 2])"), line
        port = int(addr.rsplit(":", 1)[1])

        def member():
            st = json.loads(_get(port, "/status.json")[1])
            return [m for m in st["replicas"] if m["admitted"]]
        got = _wait(member, "the child's admission", 90)
        assert got[0]["name"] == "replica0"
        code, out = _post(port, {"user": "u1", "num": 3})
        assert code == 200 and len(out["itemScores"]) == 3
        _, text = _get(port, "/metrics")
        assert "\npio_autoscale_children 1\n" in text
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0
