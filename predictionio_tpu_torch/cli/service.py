"""Service operations: daemonized servers, start-all and stop-all.

The port of `predictionio_tpu/cli/service.py` (the reference's
`bin/pio-daemon`, a nohup and pidfile daemonizer, `bin/pio-start-all`,
the event server and the dashboard [and the admin server], and
`bin/pio-stop-all`). Children are detached `python -m
predictionio_tpu_torch.cli` subcommands (`start_new_session`, their
standard output and error to a log file) tracked by pidfiles under a
run directory (default `~/.pio_store/run`, logs in `~/.pio_store/log`,
the JAX package's). A pidfile counts only while the process it names
has `predictionio_tpu_torch` in its command line: a recycled pid, or a
JAX daemon of the same name, is stale and never signalled. The
services are host services and take no device.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional

DEFAULT_RUN_DIR = "~/.pio_store/run"
DEFAULT_LOG_DIR = "~/.pio_store/log"

# the services start_all starts (each with its ip and port arguments)
SERVICES = ("eventserver", "dashboard", "adminserver")


def _run_dir(path: Optional[str]) -> Path:
    p = Path(os.path.expanduser(path or DEFAULT_RUN_DIR))
    p.mkdir(parents=True, exist_ok=True)
    return p


def _log_dir(path: Optional[str]) -> Path:
    p = Path(os.path.expanduser(path or DEFAULT_LOG_DIR))
    p.mkdir(parents=True, exist_ok=True)
    return p


def _pidfile(run_dir: Path, name: str) -> Path:
    return run_dir / f"pio-{name}.pid"


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False
    except OSError:
        return False


def _is_ours(pid: int) -> bool:
    """The pid-recycling guard: the process is our daemon only if its
    command line names this package. `predictionio_tpu_torch`, not the
    JAX package's `predictionio_tpu`, which the port's name contains and
    which a JAX daemon's command line has: a stale pidfile must never
    get another process signalled."""
    try:
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        # no /proc (not Linux): ask ps
        try:
            cmdline = subprocess.run(
                ["ps", "-o", "command=", "-p", str(pid)],
                capture_output=True, timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            return False
    return b"predictionio_tpu_torch" in cmdline


def _read_pid(pidfile: Path) -> Optional[int]:
    """Parse a pidfile; corrupted/partial files are stale, not fatal."""
    try:
        return int(pidfile.read_text().strip())
    except (ValueError, OSError):
        return None


def daemonize(argv: List[str], *, name: str,
              pid_dir: Optional[str] = None,
              log_dir: Optional[str] = None) -> Dict[str, object]:
    """Run `python -m predictionio_tpu_torch.cli <argv>` detached with a
    pidfile (bin/pio-daemon). Returns {name, pid, log}."""
    run_dir = _run_dir(pid_dir)
    logs = _log_dir(log_dir)
    pidfile = _pidfile(run_dir, name)
    if pidfile.exists():
        old = _read_pid(pidfile)
        if old and _alive(old) and _is_ours(old):
            raise ValueError(
                f"{name} already running (pid {old}, {pidfile}); "
                "stop it first")
        pidfile.unlink()
    log_path = logs / f"pio-{name}.log"
    log_f = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", *argv],
        stdout=log_f, stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL, start_new_session=True,
        env=os.environ.copy())
    log_f.close()
    pidfile.write_text(str(proc.pid))
    return {"name": name, "pid": proc.pid, "log": str(log_path)}


def _wait_http(url: str, timeout_s: float) -> bool:
    import urllib.error
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=1):
                return True
        except urllib.error.HTTPError:
            return True   # non-2xx still means the server answered
        except Exception:
            time.sleep(0.1)
    return False


def start_all(*, ip: str = "127.0.0.1",
              event_server_port: int = 7070,
              dashboard_port: int = 9000,
              admin_port: int = 7071,
              pid_dir: Optional[str] = None,
              log_dir: Optional[str] = None,
              wait_s: float = 15.0) -> List[Dict[str, object]]:
    """Start the event server, the dashboard and the admin server as
    daemons (bin/pio-start-all) and wait until each answers HTTP."""
    specs = [
        ("eventserver", ["eventserver", "--ip", ip,
                         "--port", str(event_server_port)],
         f"http://{ip}:{event_server_port}/"),
        ("dashboard", ["dashboard", "--ip", ip,
                       "--port", str(dashboard_port)],
         f"http://{ip}:{dashboard_port}/"),
        ("adminserver", ["adminserver", "--ip", ip,
                         "--port", str(admin_port)],
         f"http://{ip}:{admin_port}/"),
    ]
    started = []
    for name, argv, health in specs:
        info = daemonize(argv, name=name, pid_dir=pid_dir, log_dir=log_dir)
        info["url"] = health
        started.append(info)
    for info in started:
        if not _wait_http(str(info["url"]), wait_s):
            raise RuntimeError(
                f"{info['name']} did not answer at {info['url']} within "
                f"{wait_s}s (log: {info['log']})")
        info["status"] = "up"
    return started


def stop_all(*, pid_dir: Optional[str] = None,
             wait_s: float = 10.0) -> List[Dict[str, object]]:
    """SIGTERM every pidfile-tracked service of this package
    (bin/pio-stop-all); a stale pidfile is removed, its process left
    alone."""
    run_dir = _run_dir(pid_dir)
    out = []
    for pidfile in sorted(run_dir.glob("pio-*.pid")):
        name = pidfile.stem[len("pio-"):]
        pid = _read_pid(pidfile)
        if pid is None:
            pidfile.unlink()
            continue
        if _alive(pid) and _is_ours(pid):
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
            deadline = time.time() + wait_s
            while _alive(pid) and time.time() < deadline:
                time.sleep(0.1)
            if _alive(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass   # exited between the check and the kill
            out.append({"name": name, "pid": pid, "status": "stopped"})
        else:
            # dead, or a recycled PID now owned by an unrelated process
            out.append({"name": name, "pid": pid, "status": "not running"})
        pidfile.unlink()
    return out


def services_status(*, pid_dir: Optional[str] = None
                    ) -> List[Dict[str, object]]:
    run_dir = _run_dir(pid_dir)
    out = []
    for pidfile in sorted(run_dir.glob("pio-*.pid")):
        try:
            pid = int(pidfile.read_text().strip())
        except ValueError:
            continue
        out.append({"name": pidfile.stem[len("pio-"):], "pid": pid,
                    "status": "up" if _alive(pid) and _is_ours(pid)
                    else "dead"})
    return out
