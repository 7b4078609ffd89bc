"""The port's replica supervisor (`predictionio_tpu_torch/serving/
supervisor.py`) on the CPU: the stub child registers with a port router
through a real `ReplicaAgent`, is respawned after a SIGKILL and routed
again; a crash loop trips the breaker; stop is SIGTERM first, SIGKILL
for stragglers; a child's argv is the JAX function's with the port's own
CLI; and `cli deploy --supervised 2` serves a trained instance from two
child processes, one of them killed and respawned under load."""

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

import pytest

from predictionio_tpu.serving import supervisor as jsup
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.serving import supervisor as psup
from predictionio_tpu_torch.serving.fleet import FleetConfig, FleetServer

pytestmark = pytest.mark.torch

LIMIT_S = 240     # each test's own time limit
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


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["PIO_OBS_LOG_LEVEL"] = "WARNING"
    return env


def _wait(pred, what, timeout_s=60.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as resp:
        return json.loads(resp.read())


def _post(port, path, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- argv ---------------------------------------------------------------------

PARENT = ["deploy", "--engine-json", "e.json", "--supervised", "2",
          "--port=8000", "--replicas", "3", "--standby", "--join",
          "http://x:1", "--member-name", "m", "--advertise", "h:1",
          "--device", "cpu", "--tenancy", "on"]


def test_child_argv_is_the_jax_one_on_the_ports_cli():
    mine = psup.child_argv_from_parent(PARENT, "http://127.0.0.1:9",
                                       extra=("--member-name", "replica0"))
    assert mine[:3] == [sys.executable, "-m", "predictionio_tpu_torch.cli"]
    assert mine[3:] == ["deploy", "--engine-json", "e.json", "--device",
                        "cpu", "--tenancy", "on", "--join",
                        "http://127.0.0.1:9", "--port", "0",
                        "--member-name", "replica0"]
    theirs = jsup.child_argv_from_parent(
        [a for a in PARENT if a not in ("--advertise", "h:1")],
        "http://127.0.0.1:9", extra=("--member-name", "replica0"))
    assert theirs[:3] == [sys.executable, "-m", "predictionio_tpu.cli.main"]
    assert theirs[3:] == mine[3:]
    stub = psup.stub_child_argv("http://r:1", server_key="k", name="s")
    assert stub[:3] == [sys.executable, "-m",
                        "predictionio_tpu_torch.serving.supervisor"]


# -- the stub child -------------------------------------------------------------

@pytest.fixture()
def router():
    srv = FleetServer(None, fleet=FleetConfig(replicas=0,
                                              health_interval_s=0.1,
                                              eject_threshold=2),
                      port=0, server_key="sk", metrics=MetricsRegistry())
    srv.start()
    yield srv
    srv.stop()


def _member(router, name):
    for rep in router.replicas():
        if rep.name == name and rep.admitted:
            return rep
    return None


def test_the_stub_child_is_respawned_and_routed_again(router):
    spec = psup.ChildSpec("s0", psup.stub_child_argv(
        f"http://127.0.0.1:{router.port}", server_key="sk",
        heartbeat_s=0.1, name="s0"), env=_env())
    sup = psup.Supervisor([spec], poll_s=0.05, backoff_base_s=0.05,
                          grace_s=5.0).start()
    try:
        first = _wait(lambda: _member(router, "s0"), "the stub's admission")
        code, out = _post(router.port, "/queries.json", {"user": "u"})
        assert code == 200 and out["stub"] == "s0"
        pid = sup.children()[0]["pid"]
        assert out["pid"] == pid
        os.kill(pid, signal.SIGKILL)
        _wait(lambda: sup.children()[0]["respawns"] == 1
              and sup.children()[0]["alive"], "the respawn")
        new_pid = sup.children()[0]["pid"]
        assert new_pid != pid

        def routed_to_new():
            code, out = _post(router.port, "/queries.json", {"user": "u"})
            return code == 200 and out["pid"] == new_pid
        _wait(routed_to_new, "a query served by the respawned child")
        assert sup.children()[0]["lastRc"] == -signal.SIGKILL
        assert first.name == _member(router, "s0").name == "s0"
    finally:
        sup.stop()
    assert sup.alive_count() == 0
    assert sup.children()[0]["lastRc"] in (0, -signal.SIGKILL)


def test_a_crash_loop_trips_the_breaker():
    spec = psup.ChildSpec("crashy", [sys.executable, "-c",
                                     "import sys; sys.exit(3)"])
    sup = psup.Supervisor([spec], poll_s=0.02, backoff_base_s=0.01,
                          backoff_max_s=0.02, breaker_k=3,
                          breaker_window_s=60.0)
    sup.start()
    try:
        _wait(lambda: sup.children()[0]["givenUp"], "the breaker")
        snap = sup.children()[0]
        assert snap["respawns"] == 2 and snap["lastRc"] == 3
        assert not snap["alive"]
    finally:
        sup.stop()


def test_stop_is_sigterm_first_then_sigkill(tmp_path):
    """A child that drains on SIGTERM exits 0; one that ignores it is
    SIGKILLed once its grace is over."""
    polite = psup.ChildSpec("polite", [sys.executable, "-c", (
        "import pathlib, signal, sys, time\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
        f"pathlib.Path({str(tmp_path / 'polite')!r}).touch()\n"
        "time.sleep(120)\n")])
    stubborn = psup.ChildSpec("stubborn", [sys.executable, "-c", (
        "import pathlib, signal, time\n"
        "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
        f"pathlib.Path({str(tmp_path / 'stubborn')!r}).touch()\n"
        "time.sleep(120)\n")])
    sup = psup.Supervisor([polite, stubborn], poll_s=0.05, grace_s=1.0)
    sup.start()
    _wait(lambda: (tmp_path / "polite").exists()
          and (tmp_path / "stubborn").exists(), "both signal handlers")
    sup.stop()
    procs = {c.spec.name: c.proc.returncode for c in sup._children}
    assert procs == {"polite": 0, "stubborn": -signal.SIGKILL}
    assert sup.alive_count() == 0


# -- cli deploy --supervised ----------------------------------------------------

def test_cli_deploy_supervised_serves_and_respawns_a_killed_child(tmp_path):
    """A trained instance over sqlite, `deploy --supervised 2 --device
    cpu`: both children register and serve, the router retries past a
    child SIGKILLed under load (no request fails), the supervisor
    respawns it and it is admitted again; SIGTERM stops the router and
    both children, exit 0."""
    env = _env()
    env.update({"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
                "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
                "PIO_FLEET_HEARTBEAT_S": "0.2"})
    cli = [sys.executable, "-m", "predictionio_tpu_torch.cli"]

    def run(*args):
        out = subprocess.run([*cli, *args], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    app = json.loads(run("app", "new", "supapp"))
    lines = [json.dumps({"event": "rate", "entityType": "user",
                         "entityId": f"u{u}", "targetEntityType": "item",
                         "targetEntityId": f"i{i}",
                         "properties": {"rating": float(1 + (u + i) % 5)}})
             for u in range(12) for i in range(10) if (u * i) % 3 != 1]
    (tmp_path / "ev.jsonl").write_text("\n".join(lines) + "\n")
    run("import", "--appid", str(app["id"]), "--input", "ev.jsonl")
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": "supapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 2, "seed": 3}}]}))
    run("train", "--device", "cpu")
    proc = subprocess.Popen(
        [*cli, "deploy", "--supervised", "2", "--device", "cpu",
         "--port", "0", "--batch-max", "8"], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("Fleet control plane started on"), line
        port = int(line.split(" on ")[1].split(" ")[0].rsplit(":", 1)[1])

        def members():
            return [m for m in _get(port, "/status.json")["replicas"]
                    if m["admitted"]]
        _wait(lambda: len(members()) == 2, "both children", 120)
        assert sorted(m["name"] for m in members()) == ["replica0",
                                                        "replica1"]
        codes, halt = [], threading.Event()

        def load():
            while not halt.is_set():
                codes.append(_post(port, "/queries.json",
                                   {"user": "u1", "num": 3})[0])
        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        _wait(lambda: len(codes) > 20, "load")
        victim = members()[0]
        os.kill(_get(victim["port"], "/")["pid"], signal.SIGKILL)
        _wait(lambda: victim["member"] not in
              [m["member"] for m in members()], "the victim's ejection")
        _wait(lambda: len(members()) == 2, "the respawned child", 120)
        halt.set()
        for t in threads:
            t.join(timeout=30)
        assert codes and set(codes) == {200}, sorted(set(codes))
        for m in members():
            st = _get(m["port"], "/")
            assert st["plan_calls"] >= len(st["plan_buckets"][0])
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert rc == 0

