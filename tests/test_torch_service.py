"""The port's service commands (`predictionio_tpu_torch/cli/service.py`)
on the CPU, the counterpart of the JAX package's TestServiceOps: `cli
start-all` starts the event server, the dashboard and the admin server
as daemons with pidfiles, `cli daemon` a fourth, and `cli stop-all`
stops them all and removes their pidfiles. A pidfile naming a live
process whose command line lacks `predictionio_tpu_torch` (a recycled
pid, or a JAX daemon, whose command line names `predictionio_tpu`) is
stale: `stop-all` removes it and never signals that process.

Every test has its own SIGALRM limit."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu.cli import service as jservice
from predictionio_tpu_torch.cli import service as pservice

pytestmark = pytest.mark.torch

LIMIT_S = 150
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S}-s limit")
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PIO_STORAGE_SOURCES_PIO_TYPE="SQLITE",
               PIO_STORAGE_SOURCES_PIO_PATH=str(tmp_path / "pio.db"),
               PIO_OBS_LOG_LEVEL="WARNING")
    return subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", *args],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie child of this process counts as gone
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] != "Z"
    except OSError:
        return True


def _exec_done(pid):
    """Wait until a child started by Popen runs its own command line (a
    forked child shows its parent's until it execs)."""
    end = time.monotonic() + 30
    while b"time.sleep" not in Path(f"/proc/{pid}/cmdline").read_bytes():
        assert time.monotonic() < end, "the child never ran"
        time.sleep(0.01)


def _get(port, path="/"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.status


def test_start_all_daemon_stop_all(tmp_path):
    ports = _free_ports(4)
    run, log = tmp_path / "run", tmp_path / "log"
    stopped = None
    try:
        r = _cli(["start-all", "--ip", "127.0.0.1",
                  "--event-server-port", str(ports[0]),
                  "--dashboard-port", str(ports[1]),
                  "--admin-port", str(ports[2]),
                  "--pid-dir", str(run), "--log-dir", str(log)], tmp_path)
        assert r.returncode == 0, r.stderr + r.stdout
        started = json.loads(r.stdout)
        assert {s["name"] for s in started} == {
            "eventserver", "dashboard", "adminserver"}
        assert all(s["status"] == "up" for s in started)
        assert len(list(run.glob("pio-*.pid"))) == 3
        for port in ports[:3]:
            assert _get(port) == 200
        assert _get(ports[1], "/metrics.html") == 200
        r = _cli(["daemon", "--name", "extra", "--pid-dir", str(run),
                  "--log-dir", str(log), "--", "eventserver", "--ip",
                  "127.0.0.1", "--port", str(ports[3])], tmp_path)
        assert r.returncode == 0, r.stderr
        extra = json.loads(r.stdout)
        assert extra["name"] == "extra" and Path(extra["log"]).parent == log
        end = time.monotonic() + 60
        while True:
            try:
                assert _get(ports[3]) == 200
                break
            except OSError:
                assert time.monotonic() < end, "the daemon never answered"
                time.sleep(0.1)
        # a second daemon of one name is refused while the first lives
        r = _cli(["daemon", "--name", "extra", "--pid-dir", str(run),
                  "--", "eventserver", "--port", "0"], tmp_path)
        assert r.returncode == 1 and "already running" in r.stderr
        status = pservice.services_status(pid_dir=str(run))
        assert len(status) == 4 and all(s["status"] == "up" for s in status)
        pids = {s["name"]: s["pid"] for s in started}
        pids["extra"] = extra["pid"]
    finally:
        r = _cli(["stop-all", "--pid-dir", str(run)], tmp_path)
        stopped = json.loads(r.stdout) if r.returncode == 0 else None
    assert r.returncode == 0, r.stderr
    assert {s["name"]: s["status"] for s in stopped} == {
        "eventserver": "stopped", "dashboard": "stopped",
        "adminserver": "stopped", "extra": "stopped"}
    assert not list(run.glob("pio-*.pid"))
    for pid in pids.values():
        assert not _alive(pid), pid


@pytest.mark.parametrize("marker", ["", "predictionio_tpu"])
def test_a_pidfile_of_another_process_is_stale(tmp_path, marker):
    """A live process whose command line lacks `predictionio_tpu_torch`:
    with no package name at all (a recycled pid), or with the JAX
    package's (whose guard would take it for its own daemon)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, time; time.sleep(120)",
         *([marker] if marker else [])])
    run = tmp_path / "run"
    run.mkdir()
    (run / "pio-eventserver.pid").write_text(str(proc.pid))
    (run / "pio-junk.pid").write_text("not a pid")
    try:
        _exec_done(proc.pid)
        assert not pservice._is_ours(proc.pid)
        assert jservice._is_ours(proc.pid) == bool(marker)
        assert pservice.services_status(pid_dir=str(run)) == [
            {"name": "eventserver", "pid": proc.pid, "status": "dead"}]
        out = pservice.stop_all(pid_dir=str(run))
        assert out == [{"name": "eventserver", "pid": proc.pid,
                        "status": "not running"}]
        assert not list(run.glob("pio-*.pid"))
        time.sleep(0.2)
        assert proc.poll() is None, "stop-all signalled a foreign process"
    finally:
        proc.kill()
        proc.wait()


def test_daemonize_runs_the_ports_cli_and_replaces_a_stale_pidfile(
        tmp_path):
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(120)"])
    run, log = tmp_path / "run", tmp_path / "log"
    run.mkdir()
    (run / "pio-v.pid").write_text(str(sleeper.pid))
    try:
        _exec_done(sleeper.pid)
        info = pservice.daemonize(["version"], name="v", pid_dir=str(run),
                                  log_dir=str(log))
        assert info["pid"] != sleeper.pid
        assert (run / "pio-v.pid").read_text() == str(info["pid"])
        end = time.monotonic() + 60
        text = ""
        while time.monotonic() < end:
            text = Path(info["log"]).read_text()
            if text.strip():
                break
            time.sleep(0.1)
        import predictionio_tpu_torch
        assert text.strip() == predictionio_tpu_torch.__version__
        assert sleeper.poll() is None
    finally:
        sleeper.kill()
        sleeper.wait()
