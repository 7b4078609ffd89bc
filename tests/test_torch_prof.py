"""The port's continuous observatory on the CPU, against the JAX
package's: the sampling profiler (`predictionio_tpu_torch/obs/
profiler.py`: frame-trie bounds, role attribution, collapsed stacks),
the GC pause hook, the tsdb ring (`obs/tsdb.py`: bounds, delta decode,
counter rates, the scraper's tick), the kernel probe
(`obs/kernelprobe.py`) and the endpoints every server answers
(`/profile.json`, `/profile.txt`, `/tsdb.json`).

Mirrors `tests/test_prof.py`'s TestSamplingProfiler, TestGCPauseHook,
TestTSDB and TestObservatoryEndpoints (its `pio-tpu top` case waits for
the admin tools and TestDashboardHistory for the rest of the dashboard:
ROADMAP.md, Queue 1 item 5(d)); its TestFleetFederation runs against the
port in `tests/test_torch_elastic.py`.
Across the packages: `series_key` and `TSDB.to_json` are equal for the
same inputs; every thread name the port starts maps to a JAX role, never
"other". Sampling is driven by `sample_once()` and `Scraper.tick(now=)`,
never by wall-clock rates."""

import gc
import json
import re
import signal
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.obs import MetricsRegistry as JMetrics
from predictionio_tpu.obs import profiler as jprof
from predictionio_tpu.obs import tsdb as jtsdb
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.obs import kernelprobe
from predictionio_tpu_torch.obs import profiler as prof_mod
from predictionio_tpu_torch.obs import tsdb as tsdb_mod
from predictionio_tpu_torch.obs.profiler import (SamplingProfiler,
                                                 install_gc_callbacks,
                                                 role_of)
from predictionio_tpu_torch.obs.tsdb import TSDB, Scraper, series_key
from predictionio_tpu_torch.utils.http import HTTPServerBase, Response

pytestmark = [pytest.mark.torch, pytest.mark.prof]

LIMIT_S = 120
PKG = Path(__file__).resolve().parents[1] / "predictionio_tpu_torch"
JAX_ROLES = {"reactor", "worker", "drainer", "refresher", "heartbeat",
             "joiner", "obs", "supervisor", "http", "main"}


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def http_get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return resp.status, resp.read().decode()


@pytest.fixture()
def obs_server():
    """A bare HTTPServerBase with one route; the process profiler is
    reset afterwards so that tests cannot leak samples into each
    other."""
    srv = HTTPServerBase(host="127.0.0.1", port=0,
                         metrics=MetricsRegistry())

    @srv.router.get("/ping")
    def ping(req):
        return Response.json({"ok": True})

    srv.start()
    yield srv
    srv.shutdown()
    prof_mod._reset_global_for_tests()


@pytest.fixture()
def clean_gc_hooks():
    before = list(gc.callbacks)
    hooked = set(prof_mod._gc_registries)
    yield
    gc.callbacks[:] = before
    prof_mod._gc_registries.intersection_update(hooked)


# -- profiler -------------------------------------------------------------------

def _port_thread_names():
    """Every thread name the port starts: `name=` (or
    `thread_name_prefix=`) string literals in its sources, with an
    f-string's fields filled by a digit."""
    pat = re.compile(r'(?:\bname|thread_name_prefix)=(f?)"([^"]+)"')
    names = set()
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        for m in re.finditer(r"threading\.Thread\(|ThreadPoolExecutor\(",
                             src):
            call = src[m.end():m.end() + 400]
            found = pat.search(call)
            assert found, f"{path.name}: a thread without a name"
            fstr, name = found.groups()
            names.add(re.sub(r"\{[^}]*\}", "0", name) if fstr else name)
    return sorted(names)


class TestSamplingProfiler:
    def test_role_of_prefix_table(self):
        assert role_of("wire-reactor-0") == "reactor"
        assert role_of("wire-3-worker-1") == "worker"
        assert role_of("pio-torch-batch-drain") == "drainer"
        assert role_of("pio-torch-refresher") == "refresher"
        assert role_of("pio-torch-fleet-health") == "heartbeat"
        assert role_of("pio-torch-prof-sampler") == "obs"
        assert role_of("pio-torch-tsdb-scraper") == "obs"
        assert role_of("pio-torch-http-8000") == "http"
        assert role_of("MainThread") == "main"
        assert role_of("Thread-17") == "other"

    def test_every_port_thread_maps_to_a_jax_role(self):
        names = _port_thread_names()
        for expected in ("pio-torch-batch-drain", "wire-reactor-0",
                         "wire-0-worker-0", "pio-torch-prof-sampler",
                         "pio-torch-tsdb-scraper", "pio-torch-fleet-lease",
                         "pio-torch-supervisor-retire",
                         "pio-torch-loadsim-fire"):
            assert expected in names
        unmapped = [n for n in names if role_of(n) == "other"]
        assert unmapped == []
        assert {role_of(n) for n in names} <= JAX_ROLES

    @pytest.mark.parametrize("port_name,jax_name", [
        ("wire-reactor-1", "wire-reactor-1"),
        ("wire-0-worker-3", "wire-0-worker-3"),
        ("pio-torch-batch-drain", "pio-batch-drain"),
        ("pio-torch-feedback", "pio-feedback-drain"),
        ("pio-torch-plugin-drain", "pio-plugin-drain-serve"),
        ("pio-torch-refresher", "pio-refresher"),
        ("pio-torch-fleet-lease", "pio-fleet-lease"),
        ("pio-torch-replica-agent", "pio-replica-agent"),
        ("pio-torch-heartbeat-7", "pio-heartbeat-7"),
        ("pio-fsck-sched", "pio-fsck-sched"),
        ("pio-torch-prof-sampler", "pio-prof-sampler"),
        ("pio-torch-tsdb-scraper", "pio-tsdb-scraper"),
        ("pio-torch-watchdog", "pio-watchdog"),
        ("pio-torch-supervisor", "pio-supervisor"),
        ("pio-torch-supervisor-retire", "pio-supervisor"),
        ("pio-torch-loadsim-fire", "wire-0-worker-0"),
        ("pio-torch-http-8000", "pio-http-serve-8000"),
        ("MainThread", "MainThread"),
    ])
    def test_roles_equal_the_jax_threads(self, port_name, jax_name):
        assert role_of(port_name) == jprof.role_of(jax_name) != "other"

    def test_hz_zero_never_starts(self):
        prof = SamplingProfiler(hz=0)
        assert prof.start() is False
        assert prof.running is False
        assert prof.snapshot_json()["running"] is False

    def test_trie_bounds_and_role_attribution(self):
        prof = SamplingProfiler(hz=0, max_nodes=16)
        halt = threading.Event()

        def _deep(n):
            if n > 0:
                return _deep(n - 1)
            halt.wait(10)

        threads = [threading.Thread(target=_deep, args=(40,),
                                    name=f"wire-reactor-{k}", daemon=True)
                   for k in range(3)]
        for t in threads:
            t.start()
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                prof.sample_once()
                snap = prof.snapshot_json()
                if (snap["roles"].get("reactor", {}).get("samples", 0) >= 3
                        and snap["trie"]["truncated_samples"] > 0):
                    break
                time.sleep(0.01)
        finally:
            halt.set()
            for t in threads:
                t.join(5)
        snap = prof.snapshot_json()
        assert snap["trie"]["nodes"] <= 16
        assert snap["trie"]["truncated_samples"] > 0
        assert snap["roles"]["reactor"]["samples"] >= 3
        assert snap["samples"] >= sum(
            r["samples"] for r in snap["roles"].values()) > 0

    def test_collapsed_stack_format(self):
        prof = SamplingProfiler(hz=0, max_nodes=256)
        prof.sample_once()
        out = prof.collapsed()
        assert out.endswith("\n")
        for line in out.strip().splitlines():
            path, _, count = line.rpartition(" ")
            assert int(count) >= 1
            assert path.split(";")[0] in JAX_ROLES | {"other"}
        assert "profiler.py:sample_once" in out

    def test_reset_clears_state(self):
        prof = SamplingProfiler(hz=0)
        prof.sample_once()
        assert prof.snapshot_json()["samples"] > 0
        prof.reset()
        snap = prof.snapshot_json()
        assert snap["samples"] == 0 and snap["trie"]["nodes"] == 0
        assert prof.collapsed() == ""

    def test_format_thread_stack_is_the_jax_format(self):
        halt = threading.Event()
        t = threading.Thread(target=halt.wait, args=(10,), daemon=True,
                             name="pio-torch-refresher")
        t.start()
        try:
            ours = prof_mod.format_thread_stack(t.ident)
            theirs = jprof.format_thread_stack(t.ident)
        finally:
            halt.set()
            t.join(5)
        assert ours == theirs
        assert ours.split(" < ")[0].startswith("threading.py:wait:")
        assert prof_mod.format_thread_stack(-1) == ""


    def test_a_sample_pins_no_returned_frame(self):
        """A sampled frame whose function has returned frees its locals
        without waiting for the cyclic GC: the snapshot of
        `sys._current_frames()` holds the sampler's own frame, and a
        cycle through it kept every sampled frame (a training loop's
        normal matrices and gathered slabs) alive until a collection
        (tens of GB of the card over an ALS run, PERF.md)."""
        import weakref
        inside, leave = threading.Event(), threading.Event()
        ref = []

        def work():
            held = np.ones(1 << 16)
            ref.append(weakref.ref(held))
            inside.set()
            leave.wait(10)

        prof = SamplingProfiler(hz=0)
        was = gc.isenabled()
        gc.disable()
        try:
            t = threading.Thread(target=work, name="pio-torch-test-work")
            t.start()
            assert inside.wait(10)
            prof.sample_once()
            leave.set()
            t.join(10)
            assert ref[0]() is None
        finally:
            if was:
                gc.enable()


class TestGCPauseHook:
    def test_histogram_fires_on_collect(self, clean_gc_hooks):
        reg = MetricsRegistry()
        assert install_gc_callbacks(reg) is True
        assert install_gc_callbacks(reg) is False   # idempotent
        gc.collect()
        fam = reg.snapshot()["pio_gc_pause_seconds"]
        assert fam["type"] == "histogram"
        assert sum(s["count"] for s in fam["series"]) >= 1
        gens = {s["labels"]["generation"] for s in fam["series"]}
        assert "2" in gens

    def test_a_collection_under_the_hooks_own_lock_never_waits(
            self, clean_gc_hooks):
        """A collection can start in a thread that holds the histogram's
        lock (inside its `labels`, `observe` or a snapshot): the hook
        must not wait for that thread, i.e. for itself. The pause is
        recorded by the next collection."""
        reg = MetricsRegistry()
        install_gc_callbacks(reg)
        hist = reg.histogram(
            "pio_gc_pause_seconds",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5),
            labels=("generation",))
        done = threading.Event()

        def collect_under_the_lock():
            with hist._lock:
                gc.collect()
            done.set()

        t = threading.Thread(target=collect_under_the_lock, daemon=True)
        t.start()
        assert done.wait(20), "the GC hook waited for its own lock"
        before = sum(s["count"] for s in
                     reg.snapshot()["pio_gc_pause_seconds"]["series"])
        gc.collect()
        after = sum(s["count"] for s in
                    reg.snapshot()["pio_gc_pause_seconds"]["series"])
        assert after >= before + 2      # the deferred pause and this one


# -- the device gauge and the kernel probe --------------------------------------

def test_sample_device_memory_never_makes_a_cuda_context():
    import torch
    reg = MetricsRegistry()
    assert prof_mod.sample_device_memory(reg) == 0
    assert torch.cuda.is_initialized() is False
    assert "pio_device_memory_bytes" not in reg.snapshot()


def test_build_watch_counts_no_build_in_steady_state():
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.ops import als as pals
    rng = np.random.default_rng(4)
    model = pals.als_model_from_numpy(
        rng.integers(-3, 4, (8, 4)).astype(np.float32),
        rng.integers(-3, 4, (50, 4)).astype(np.float32),
        [f"u{n}" for n in range(8)], [f"i{n}" for n in range(50)],
        device="cpu")
    srv = cli.deploy(model, port=0, batch_max=8, metrics=MetricsRegistry())
    try:
        with kernelprobe.build_watch(srv.metrics) as w:
            for n in range(8):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/queries.json",
                    data=json.dumps({"user": f"u{n}", "num": 3}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:
                    assert resp.status == 200
        assert w.count == 0
    finally:
        srv.stop()


def test_builds_and_launches_reach_the_registry():
    """`record_build` lands in every installed registry; `sync_launches`
    advances by the wrapper's delta and restarts after a reset."""
    from predictionio_tpu_torch.ops import fused_topk
    reg = MetricsRegistry()
    kernelprobe.install_kernel_probe(reg)
    with kernelprobe.build_watch(reg) as w:
        kernelprobe.record_build(2.0)
    assert w.count == 1
    assert reg.snapshot()["pio_kernel_build_seconds"]["series"][0][
        "count"] == 1
    saved = (fused_topk.LAUNCHES, fused_topk.SHARD_LAUNCHES)
    try:
        fused_topk.LAUNCHES, fused_topk.SHARD_LAUNCHES = 5, 2
        kernelprobe.sync_launches(reg)
        fused_topk.LAUNCHES = 9
        kernelprobe.sync_launches(reg)
        fused_topk.LAUNCHES = 3              # set back: 3 new launches
        kernelprobe.sync_launches(reg)
    finally:
        fused_topk.LAUNCHES, fused_topk.SHARD_LAUNCHES = saved
    assert reg.value("pio_kernel_launches_total", kernel="fused_topk") == 12
    assert reg.value("pio_kernel_launches_total",
                     kernel="shard_local_candidates") == 2


# -- tsdb ring ------------------------------------------------------------------

class TestTSDB:
    def test_series_key_canonical(self):
        assert series_key("m", {}) == "m"
        assert series_key("m", {"b": "2", "a": "1"}) == "m{a=1,b=2}"
        assert series_key("m", {"a": "1"}, "p99") == "m{a=1}:p99"

    @pytest.mark.parametrize("name,labels,suffix", [
        ("m", {}, ""), ("pio_serve_seconds", {"app": ""}, "rate"),
        ("pio_device_memory_bytes", {"kind": "in_use", "device": "cuda:0"},
         ""), ("x", {"z": "1", "a": "2", "m": "3"}, "p50")])
    def test_series_key_equals_the_jax_key(self, name, labels, suffix):
        assert series_key(name, labels, suffix) == \
            jtsdb.series_key(name, labels, suffix)

    def test_ring_bounds_and_delta_decode(self):
        db = TSDB(points=5)
        base = 1_000_000.0
        for k in range(10):
            db.record_value("g", "gauge", base + k, float(k))
        pts = db.to_json(series="g")["series"]["g"]["points"]
        assert len(pts) == 5
        assert [v for _, v in pts] == [5.0, 6.0, 7.0, 8.0, 9.0]
        assert [t for t, _ in pts] == pytest.approx(
            [base + k for k in range(5, 10)], abs=0.002)
        assert db.latest("g") == 9.0

    def test_counter_rate_math_and_reset_guard(self):
        db = TSDB(points=10)
        snap = lambda v: {"c_total": {             # noqa: E731
            "type": "counter", "help": "",
            "series": [{"labels": {}, "value": v}]}}
        db.record_snapshot(snap(0.0), now=100.0)
        assert db.keys() == []
        db.record_snapshot(snap(50.0), now=105.0)
        assert db.latest("c_total:rate") == pytest.approx(10.0)
        db.record_snapshot(snap(5.0), now=110.0)
        pts = db.to_json(series="c_total")["series"]["c_total:rate"]
        assert len(pts["points"]) == 1
        db.record_snapshot(snap(25.0), now=115.0)
        assert db.latest("c_total:rate") == pytest.approx(4.0)

    def test_histogram_fold_quantiles(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat_seconds", "h", buckets=(0.01, 0.1, 1.0))
        for _ in range(100):
            h.observe(0.05)
        db = TSDB(points=10)
        db.record_snapshot(reg.snapshot(), now=100.0)
        assert db.latest("lat_seconds:p50") is not None
        assert db.latest("lat_seconds:p99") is not None

    def test_max_series_cap_counts_drops(self):
        db = TSDB(points=4, max_series=2)
        for k in "abc":
            db.record_value(k, "gauge", 1.0, 1.0)
        assert sorted(db.keys()) == ["a", "b"]
        assert db.to_json()["dropped_series"] == 1

    def test_trim_keeps_the_newest_points(self):
        db = TSDB(points=16)
        for k in range(16):
            db.record_value("g", "gauge", 100.0 + k, float(k))
        assert db.trim(0.25) == 12 * 64
        assert [v for _, v in db.to_json()["series"]["g"]["points"]] == \
            [12.0, 13.0, 14.0, 15.0]

    def test_scraper_tick_disable_and_broken_collector(self):
        reg = MetricsRegistry()
        reg.gauge("g_now", "h").set(7.0)
        db = TSDB(points=8)
        calls = []

        def _boom():
            calls.append(1)
            raise RuntimeError("collector down")

        sc = Scraper(db, reg, interval_s=0, collectors=(_boom,))
        assert sc.start() is False
        assert sc.running is False
        sc.tick(now=50.0)
        assert calls == [1]
        assert db.latest("g_now") == 7.0

    def test_to_json_equals_the_jax_ring(self):
        """The same metric operations on both packages' registries,
        scraped into both rings at the same instants: the same
        /tsdb.json body (its `now` aside), filters included."""
        rng = np.random.default_rng(9)
        regs = (MetricsRegistry(), JMetrics())
        dbs = (TSDB(points=6), jtsdb.TSDB(points=6))
        fams = []
        for reg in regs:
            fams.append((
                reg.counter("req_total", "c", labels=("route",)),
                reg.gauge("depth", "g"),
                reg.histogram("lat_seconds", "h", labels=("app",),
                              buckets=(0.001, 0.01, 0.1, 1.0))))
        for tick in range(9):
            incs = rng.integers(0, 50, 2)
            depth = float(rng.integers(0, 64))
            lats = rng.lognormal(np.log(0.01), 1.0, 20)
            for c, g, h in fams:
                c.labels(route="/a").inc(float(incs[0]))
                c.labels(route="/b").inc(float(incs[1]))
                g.set(depth)
                for v in lats:
                    h.labels(app="x").observe(float(v))
            for reg, db in zip(regs, dbs):
                db.record_snapshot(reg.snapshot(), now=1000.0 + 0.5 * tick)
        for series, since in ((None, None), ("req_total,lat", None),
                              (None, "1002.0"), ("depth", "1003.25")):
            ours, theirs = (db.to_json(series, since) for db in dbs)
            ours.pop("now")
            theirs.pop("now")
            assert ours == theirs


# -- endpoints on every server --------------------------------------------------

class TestObservatoryEndpoints:
    def test_profile_json_and_collapsed(self, obs_server):
        prof = prof_mod.get_profiler()
        for _ in range(3):
            http_get(obs_server.port, "/ping")
            prof.sample_once()
        status, body = http_get(obs_server.port, "/profile.json")
        assert status == 200
        snap = json.loads(body)
        for field in ("hz", "running", "samples", "roles", "top_self",
                      "top_cumulative", "trie"):
            assert field in snap
        assert snap["samples"] > 0
        assert "main" in snap["roles"] or "http" in snap["roles"]
        status, text = http_get(obs_server.port,
                                "/profile.txt?fmt=collapsed")
        assert status == 200
        line = text.strip().splitlines()[0]
        assert int(line.rpartition(" ")[2]) >= 1
        status, text = http_get(obs_server.port, "/profile.txt?fmt=top")
        assert status == 200 and "samples" in text

    def test_tsdb_endpoint_series_and_since_filter(self, obs_server):
        db = obs_server.tsdb
        db.record_value("synth_g", "gauge", 1000.0, 1.0)
        db.record_value("synth_g", "gauge", 2000.0, 2.0)
        db.record_value("synth_other", "gauge", 2000.0, 9.0)
        status, body = http_get(obs_server.port,
                                "/tsdb.json?series=synth_g")
        assert status == 200
        out = json.loads(body)
        assert list(out["series"]) == ["synth_g"]
        assert len(out["series"]["synth_g"]["points"]) == 2
        status, body = http_get(
            obs_server.port, "/tsdb.json?series=synth_g&since=1500")
        assert json.loads(body)["series"]["synth_g"]["points"] == \
            [[2000.0, 2.0]]

    def test_live_scrape_captures_host_gauges(self, obs_server):
        sc = tsdb_mod.Scraper(obs_server.tsdb, obs_server.metrics,
                              interval_s=0,
                              collectors=obs_server._obs_collectors())
        sc.tick()
        assert (obs_server.tsdb.latest("pio_host_rss_bytes") or 0) > 0
        status, body = http_get(obs_server.port, "/tsdb.json")
        assert status == 200
        assert "pio_host_rss_bytes" in json.loads(body)["series"]

    def test_serve_plane_ticks_plan_bytes_and_serve_rate(self):
        """A prediction server's scrape: `pio_plan_resident_bytes` of its
        factors (the item table's exact bytes) and, over two ticks, the
        rate of `pio_serve_seconds`."""
        from predictionio_tpu_torch.cli import main as cli
        from predictionio_tpu_torch.ops import als as pals
        rng = np.random.default_rng(8)
        model = pals.als_model_from_numpy(
            rng.integers(-3, 4, (8, 4)).astype(np.float32),
            rng.integers(-3, 4, (50, 4)).astype(np.float32),
            [f"u{n}" for n in range(8)], [f"i{n}" for n in range(50)],
            device="cpu")
        srv = cli.deploy(model, port=0, batch_max=8,
                         metrics=MetricsRegistry())
        try:
            sc = tsdb_mod.Scraper(srv.tsdb, srv.metrics, interval_s=0,
                                  collectors=srv._obs_collectors())
            sc.tick(now=100.0)
            for n in range(6):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/queries.json",
                    data=json.dumps({"user": f"u{n}", "num": 2}).encode(),
                    headers={"Content-Type": "application/json"})
                urllib.request.urlopen(req, timeout=10).read()
            sc.tick(now=102.0)
        finally:
            srv.stop()
        db = srv.tsdb
        assert db.latest(
            "pio_plan_resident_bytes{bucket=factors,device=cpu:0}") == \
            50 * 4 * 4
        assert db.latest("pio_serve_seconds{app=}:rate") == \
            pytest.approx(3.0)
        assert db.latest("pio_host_threads") > 0
