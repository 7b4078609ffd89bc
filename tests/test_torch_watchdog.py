"""The port's watchdog beats and memory-pressure guard
(`predictionio_tpu_torch/resilience/watchdog.py`, `pressure.py`) on the
CPU.

Mirrors `tests/test_watchdog.py`'s TestDegradedReadiness, TestMemoryPressure
and the refresher-stall gate (the JAX scenario's setup, steps and
invariants written out, since the scenario runner is not ported): a
degraded loop fails its own server's /ready; the soft watermark trims and
sheds new work 503 while /ready holds, the hard one fires the drain once
and fails /ready; a wedged refresher is stalled once, restarted and ticks
again. Beside them: every loop registers the JAX role and budget; a
refresher tick that outlasts its budget while stamping its stages is no
stall, a wedged one is, and a restart leaves one refresher thread; a
SIGTERMed `cli deploy` with a refresher exits 0; `device_memory_frac` is
None on the CPU and never makes a CUDA context.

Every test has its own SIGALRM limit."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage import (AccessKey, App,
                                                 StorageRegistry)
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.obs import get_registry
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.resilience import faults
from predictionio_tpu_torch.resilience.pressure import MemoryGuard
from predictionio_tpu_torch.resilience.watchdog import progress, watchdog
from predictionio_tpu_torch.serving.server import FeedbackConfig

pytestmark = [pytest.mark.torch, pytest.mark.watchdog]

LIMIT_S = 120     # each test's own time limit
REPO = Path(__file__).resolve().parents[1]
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


@pytest.fixture(autouse=True)
def _limits():
    """A time limit per test; the fault seams disarmed either side and
    the process watchdog's thresholds restored."""
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    wd = watchdog()
    saved = (wd.stall_s, wd.interval_s)
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    faults().clear()
    yield
    faults().clear()
    wd.stall_s, wd.interval_s = saved
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _metric(name, **labels):
    return get_registry().value(name, **labels) or 0.0


def _wait(pred, msg, timeout=15.0, interval=0.02):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for: {msg}")


def call(port, method, path, body=None, timeout=10):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read().decode()
            ct = resp.headers.get("Content-Type", "")
            return (resp.status, json.loads(raw) if "json" in ct else raw,
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}"), dict(e.headers)


def _rate(events, app_id):
    rng = np.random.RandomState(0)
    for u in range(20):
        for i in range(15):
            if rng.rand() > 0.5:
                continue
            events.insert(Event(
                event="rate", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{i}",
                properties=DataMap({"rating": 5.0 if i % 3 == u % 3
                                    else 1.0})), app_id)


def _train(reg):
    engine = prec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "wdapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 4, "seed": 1}}]})
    ctx = RuntimeContext(registry=reg, device="cpu")
    return engine, CoreWorkflow.run_train(engine, params, ctx), ctx


@pytest.fixture()
def trained():
    """A MEM store with a trained instance of app `wdapp`."""
    reg = StorageRegistry(MEM)
    app_id = reg.get_meta_data_apps().insert(App(0, "wdapp"))
    reg.get_meta_data_access_keys().insert(AccessKey("WDKEY", app_id, ()))
    reg.get_events().init(app_id)
    _rate(reg.get_events(), app_id)
    return _train(reg)


def _start(trained, **kw):
    engine, row, ctx = trained
    return cli.deploy_instance(engine, row, ctx, port=0, batch_max=8,
                               metrics=MetricsRegistry(), **kw)


# -- a degraded loop fails its own server's /ready ----------------------------

class TestDegradedReadiness:
    def test_degraded_refresher_flips_ready(self, trained):
        srv = _start(trained, refresh_interval_s=60.0)
        other = _start(trained)
        try:
            assert srv.readiness()[0]
            srv._refresher.beat.mark_degraded("crash loop (test)")
            ready, detail = srv.readiness()
            assert not ready
            assert "refresher" in detail["degradedLoops"]
            assert call(srv.port, "GET", "/ready")[0] == 503
            # another server of the process is not this one's loops
            assert other.readiness()[0]
        finally:
            srv.stop()
            other.stop()


# -- the memory-pressure guard ------------------------------------------------

class TestMemoryPressure:
    def test_soft_trims_and_sheds_while_inflight_succeeds(self, trained):
        srv = _start(trained)
        try:
            now = time.time()
            for i in range(4):          # history for the tsdb trim
                srv._scraper.tick(now=now + i)
            trims_before = _metric("pio_mem_trims_total", target="tsdb")
            freed_before = _metric("pio_mem_trimmed_bytes_total",
                                   target="tsdb")
            shed = lambda: srv.metrics.value(   # noqa: E731
                "pio_shed_total", surface="memory", app="") or 0.0
            shed_before = shed()
            # a request in flight when the watermark trips completes
            faults().arm("serve.predict", latency=0.5, times=1)
            inflight = []
            t = threading.Thread(target=lambda: inflight.append(call(
                srv.port, "POST", "/queries.json", {"user": "u1",
                                                    "num": 2})))
            t.start()
            time.sleep(0.15)
            # the test drives the guard: the sweep must not spend the seam
            watchdog().detach_guard(srv._pressure)
            faults().arm("mem.pressure.soft", times=1)
            assert srv._pressure.check() == "soft"
            assert srv.readiness()[0]              # soft: still ready
            status, body, headers = call(srv.port, "POST", "/queries.json",
                                         {"user": "u1", "num": 2})
            assert status == 503 and "memory pressure" in body["message"]
            assert "Retry-After" in headers
            # the generic route sheds too
            assert call(srv.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2, "blackList": ["i1"]})[0] \
                == 503
            t.join(10)
            assert inflight and inflight[0][0] == 200
            assert shed() == shed_before + 2
            assert _metric("pio_mem_trims_total",
                           target="tsdb") == trims_before + 1
            assert _metric("pio_mem_trimmed_bytes_total",
                           target="tsdb") > freed_before
            for target in ("trace", "quality", "tenant_keys",
                           "ingest_cache"):
                assert _metric("pio_mem_trims_total", target=target) >= 1
            assert call(srv.port, "GET", "/status.json")[1][
                "memPressure"]["state"] == "soft"
            assert srv._pressure.check() == "ok"   # the seam is spent
            assert call(srv.port, "POST", "/queries.json",
                        {"user": "u1", "num": 2})[0] == 200
        finally:
            srv.stop()

    def test_hard_fires_drain_once_and_fails_ready(self):
        drains = []
        guard = MemoryGuard(limit_bytes=1 << 40)   # the real fraction ~0
        guard.on_hard(lambda: drains.append(1))
        faults().arm("mem.pressure.hard", times=2)
        assert guard.check() == "hard"
        assert not guard.ready()
        assert guard.check() == "hard"
        assert drains == [1]
        assert guard.check() == "ok"
        assert guard.ready()

    def test_hard_watermark_drains_the_server(self, trained):
        srv = _start(trained)
        try:
            assert srv._pressure in watchdog()._guards
            watchdog().detach_guard(srv._pressure)   # the test drives it
            faults().arm("mem.pressure.hard", times=1)
            assert srv._pressure.check() == "hard"
            ready, detail = srv.readiness()
            assert not ready
            assert detail["memPressure"]["state"] == "hard"
            _wait(lambda: not srv.is_running(),
                  "the hard watermark drains the server")
            assert srv._pressure not in watchdog()._guards
        finally:
            if srv.is_running():
                srv.stop()

    def test_watermarks_read_the_process_memory(self):
        """A guard whose watermarks sit below this process's RSS share
        goes soft, then hard, from the reading alone."""
        guard = MemoryGuard(limit_bytes=1 << 40)
        frac = guard.observed_frac()
        assert frac is not None and 0.0 < frac < 1.0
        assert MemoryGuard(soft_frac=frac / 2, hard_frac=1.0,
                           limit_bytes=1 << 40).check() == "soft"
        assert MemoryGuard(soft_frac=frac / 4, hard_frac=frac / 2,
                           limit_bytes=1 << 40).check() == "hard"


def test_device_memory_frac_is_none_on_the_cpu_and_makes_no_context():
    """In a fresh process: no reading, no CUDA context, and none either
    where CUDA is present but the process has no context yet (the
    reading is refused before any device call)."""
    code = r"""
import torch
from predictionio_tpu_torch.resilience import pressure
assert pressure.device_memory_frac() is None
pressure.MemoryGuard().check()
assert torch.cuda.is_initialized() is False
def boom(*a, **k):
    raise AssertionError("a device call without a CUDA context")
torch.cuda.is_available = lambda: True
torch.cuda.is_initialized = lambda: False
torch.cuda.memory_allocated = boom
torch.cuda.get_device_properties = boom
torch.cuda.device_count = boom
assert pressure.device_memory_frac() is None
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- every loop's beat: the JAX role and budget --------------------------------

def test_every_loop_registers_the_jax_role_and_budget(trained, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_TIER", "on")
    monkeypatch.setenv("PIO_TIER_HOT_FRAC", "0.25")
    engine, row, ctx = trained
    srv = cli.deploy_instance(
        engine, row, ctx, port=0, batch_max=8, items_device="cpu",
        refresh_interval_s=2.0, metrics=MetricsRegistry(),
        feedback=FeedbackConfig("127.0.0.1", 9, "WDKEY"))
    try:
        assert call(srv.port, "POST", "/queries.json",
                    {"user": "u1", "num": 2})[0] == 200
        _wait(lambda: srv.batcher._drain_beat is None, "the drainer retires")
        beats = {b.role: b for b in watchdog().beats()
                 if b in srv._own_beats()}
        assert (beats["refresher"].budget_s,
                beats["refresher"].restartable) == (2.0 * 3 + 5, True)
        assert (beats["joiner"].budget_s,
                beats["joiner"].restartable) == (1.0 * 3 + 5, True)
        assert beats["feedback"].budget_s == float("inf")
        assert beats["feedback"].restartable
        pager = srv._pager
        assert (beats["tier-pager"].budget_s, beats[
            "tier-pager"].restartable) == (pager.interval_s * 5 + 5, True)
        # each reactor registers as its loop starts
        _wait(lambda: all(r.beat is not None for r in srv._httpd.reactors),
              "every reactor's loop")
        reactors = [r.beat for r in srv._httpd.reactors]
        assert reactors and all(
            (b.role, b.budget_s, b.restartable) == ("reactor", 10.0, False)
            and b in watchdog().beats() for b in reactors)
        # the drainer registers for one busy burst
        seen = []
        register = watchdog().register

        def spy(role, budget_s=0.0, restart=None):
            beat = register(role, budget_s=budget_s, restart=restart)
            seen.append(beat)
            return beat
        monkeypatch.setattr(watchdog(), "register", spy)
        faults().arm("serve.predict", latency=0.5, times=1)
        answers = []
        t = threading.Thread(target=lambda: answers.append(call(
            srv.port, "POST", "/queries.json", {"user": "u2", "num": 2})))
        t.start()
        _wait(lambda: any(b.role == "drainer" for b in seen), "a drainer")
        watchdog().sweep()            # while the drainer lives
        t.join(10)
        assert answers[0][0] == 200
        drainer = [b for b in seen if b.role == "drainer"]
        assert drainer[0].budget_s == srv.batcher.submit_timeout_s \
            and not drainer[0].restartable
        _wait(lambda: drainer[0].closed, "the drainer's beat closes")
        watchdog().sweep()
        text = get_registry().render()
        for role in ("reactor", "drainer", "feedback", "tier-pager",
                     "refresher", "joiner"):
            assert f'pio_thread_beat_age_seconds{{role="{role}"}}' in text, \
                role
    finally:
        srv.stop()
    for b in (srv._refresher.beat, srv._joiner.beat, srv._pager):
        assert b is None


# -- the refresher: progress is not a stall, a wedge is ------------------------

def _tight(srv, budget_s):
    """The scenario runner's thresholds: the sweep every 50 ms, the
    refresher's budget clamped."""
    wd = watchdog()
    wd.stall_s, wd.interval_s = budget_s, 0.05
    srv._refresher.beat.budget_s = budget_s
    wd.ensure_started()


def _slow_tick(srv, seconds, stamp):
    """Replace the next ticks' body with one of `seconds`, stamping its
    stages (every 0.05 s) or not."""
    ref = srv._refresher
    original = ref._tick_inner
    ran = []

    def body(phases):
        if ran:
            return original(phases)
        ran.append(threading.get_ident())
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            time.sleep(0.05)
            if stamp:
                progress()
        return "noop"
    ref._tick_inner = body
    return ran


def test_a_long_tick_that_stamps_its_stages_is_no_stall(trained):
    srv = _start(trained, refresh_interval_s=0.2)
    try:
        _tight(srv, 0.4)
        stalls = _metric("pio_watchdog_stalls_total", role="refresher")
        ran = _slow_tick(srv, 1.5, stamp=True)
        _wait(lambda: ran, "the long tick starts")
        _wait(lambda: srv._refresher.last_ticks.get("noop", {}).get(
            "seconds", 0) > 1.4, "the long tick ends")
        assert _metric("pio_watchdog_stalls_total",
                       role="refresher") == stalls
        assert len(srv._refresher.threads()) == 1
        assert srv._refresher.threads()[0].ident == ran[0]
    finally:
        srv.stop()


def test_gate_refresher_stall_recovers(trained):
    """The JAX `refresher-stall` scenario: the loop wedged at its beat
    (`thread.refresher.stall`) under client load is stalled exactly once,
    superseded and restarted, ticks again, fails no request, and leaves
    one refresher thread once the wedged one wakes."""
    srv = _start(trained, refresh_interval_s=0.2)
    statuses, halt = [], threading.Event()

    def load():
        while not halt.is_set():
            statuses.append(call(srv.port, "POST", "/queries.json",
                                 {"user": "u1", "num": 2})[0])

    try:
        _tight(srv, 1.0)
        stalls = _metric("pio_watchdog_stalls_total", role="refresher")
        restarts = _metric("pio_thread_restarts_total", role="refresher")
        clients = [threading.Thread(target=load) for _ in range(2)]
        for t in clients:
            t.start()
        time.sleep(0.5)
        wedged = srv._refresher.threads()[0]
        faults().arm("thread.refresher.stall", latency=3.0, times=1)
        _wait(lambda: _metric("pio_thread_restarts_total",
                              role="refresher") > restarts,
              "the refresher restarts")
        beat = srv._refresher.beat
        _wait(lambda: beat.age() < 0.5 and len(
            srv._refresher.threads()) == 2, "the new thread ticks")
        _wait(lambda: not wedged.is_alive(), "the wedged thread ends")
        halt.set()
        for t in clients:
            t.join(10)
        assert _metric("pio_watchdog_stalls_total",
                       role="refresher") == stalls + 1
        assert not beat.degraded and beat.age() < 1.5
        assert len(srv._refresher.threads()) == 1
        assert srv._refresher.threads()[0] is not wedged
        assert statuses and set(statuses) == {200}
    finally:
        halt.set()
        srv.stop()
    assert srv._refresher.threads() == []


def test_a_wedged_tick_is_a_stall_and_its_thread_ends(trained):
    srv = _start(trained, refresh_interval_s=0.2)
    try:
        _tight(srv, 0.4)
        stalls = _metric("pio_watchdog_stalls_total", role="refresher")
        ran = _slow_tick(srv, 1.5, stamp=False)
        _wait(lambda: _metric("pio_watchdog_stalls_total",
                              role="refresher") > stalls, "the stall")
        # the replacement waits for the tick lock, beating
        _wait(lambda: len(srv._refresher.threads()) == 2, "the respawn")
        _wait(lambda: len(srv._refresher.threads()) == 1,
              "the wedged tick ends", timeout=10)
        assert srv._refresher.threads()[0].ident != ran[0]
        assert not srv._refresher.beat.degraded
    finally:
        srv.stop()


def test_progress_ends_a_superseded_thread():
    from predictionio_tpu_torch.resilience.watchdog import Beat
    beat = Beat("stage-test")
    out = []

    def body():
        progress()                    # stamps: the loop's own thread
        out.append("stamped")
        beat.thread_ident = -1        # the watchdog superseded it
        progress()
        out.append("ran on")

    beat.guard(body)
    assert out == ["stamped"] and not beat.dead
    progress()                        # outside a guard: nothing
    closed = Beat("stage-test")

    def stopped():
        closed.close()                # its owner stopped
        progress()
        out.append("ran on")

    closed.guard(stopped)
    assert out == ["stamped"] and not closed.dead


# -- a SIGTERMed deploy exits cleanly -------------------------------------------

def test_sigtermed_deploy_with_a_refresher_exits_cleanly(tmp_path):
    conf = {"PIO_STORAGE_SOURCES_SQL_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}
    reg = StorageRegistry(conf)
    app_id = reg.get_meta_data_apps().insert(App(0, "wdapp"))
    reg.get_events().init(app_id)
    _rate(reg.get_events(), app_id)
    _, row, _ = _train(reg)
    reg.close()
    env = {**os.environ, **conf, "PYTHONPATH": str(REPO),
           "PIO_OBS_LOG_LEVEL": "WARNING"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "deploy",
         "--device", "cpu", "--port", "0", "--engine-instance-id", row.id,
         "--engine-factory", "recommendation",
         "--refresh-interval", "0.2"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving engine instance"), \
            line + proc.stderr.read()
        port = int(line.split("http://")[1].split(" ")[0].rsplit(":", 1)[1])
        assert call(port, "POST", "/queries.json",
                    {"user": "u1", "num": 2})[0] == 200
        time.sleep(0.6)                 # a few refresher ticks
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, err
    assert "terminate called" not in err and "Traceback" not in err, err
