"""The admin REST API and `cli top`, the terminal observatory view.

The port of `predictionio_tpu/tools/admin.py` (the reference's
`tools/.../admin/AdminAPI.scala:77-95` and `admin/CommandClient.scala`:
app CRUD over REST on :7071), `cli adminserver`:

  GET  /                      -> server status
  GET  /cmd/app               -> list apps (with access keys)
  POST /cmd/app               -> create app {"name": ...}
  DELETE /cmd/app/<name>      -> delete app and its data
  DELETE /cmd/app/<name>/data -> wipe app event data

`top_view(host, port)` renders one screenful of a running server's
state (qps, p50/p99, shed rate, SLO burn, RSS, the quality, liveness
and autoscale lines, the profiler's top frames) read from its
observatory endpoints (`/tsdb.json`, `/profile.json`, `/quality.json`),
so it works against any server of the port (replica, router, event
server). The text is the JAX package's for the same endpoints. Both are
host services: they touch no device.
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass
from typing import Dict, Optional

from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.utils.http import (HTTPServerBase, Request,
                                               Response)


@dataclass
class AdminConfig:
    # localhost by default (AdminAPI.scala:132): this API exposes access
    # keys and deletes data unauthenticated, so binding elsewhere is an
    # explicit choice
    ip: str = "127.0.0.1"
    port: int = 7071


class AdminServer(HTTPServerBase):
    def __init__(self, config: AdminConfig, registry=None):
        super().__init__(host=config.ip, port=config.port)
        self.ctx = RuntimeContext(registry=registry)
        self._routes()

    def _routes(self):
        r = self.router
        from predictionio_tpu_torch.cli import ops

        @r.get("/")
        def index(req: Request) -> Response:
            return Response.json({"status": "alive"})

        @r.get("/cmd/app")
        def list_apps(req: Request) -> Response:
            reg = self.ctx.registry
            out = []
            for app in reg.get_meta_data_apps().get_all():
                keys = reg.get_meta_data_access_keys().get_by_appid(app.id)
                out.append({"name": app.name, "id": app.id,
                            "description": app.description,
                            "accessKeys": [k.key for k in keys]})
            return Response.json(out)

        @r.post("/cmd/app")
        def new_app(req: Request) -> Response:
            payload = req.json()
            name = payload.get("name")
            if not name:
                return Response.json({"message": "name required"}, 400)
            try:
                info = ops.app_new(self.ctx.registry, name,
                                   description=payload.get("description"))
            except ValueError as e:
                return Response.json({"message": str(e)}, 409)
            return Response.json(info, 201)

        @r.delete("/cmd/app/<name>")
        def delete_app(req: Request) -> Response:
            try:
                ops.app_delete(self.ctx.registry, req.params["name"],
                               force=True)
            except ValueError as e:
                return Response.json({"message": str(e)}, 404)
            return Response.json({"message": "deleted"})

        @r.delete("/cmd/app/<name>/data")
        def delete_data(req: Request) -> Response:
            try:
                ops.app_data_delete(self.ctx.registry, req.params["name"],
                                    force=True)
            except ValueError as e:
                return Response.json({"message": str(e)}, 404)
            return Response.json({"message": "data deleted"})


# -- `cli top` ----------------------------------------------------------------

def _fetch_json(host: str, port: int, path: str,
                timeout: float = 3.0) -> Dict:
    with urllib.request.urlopen(
            f"http://{host}:{port}{path}", timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _ring_latest(series: Dict, prefix: str,
                 agg: str = "sum") -> Optional[float]:
    """Aggregate the most recent point of every ring series matching
    `prefix` (sum for rates, max for burns); None when no series
    matches — "no data yet" and "0.0" are different answers."""
    vals = [entry["points"][-1][1]
            for key, entry in series.items()
            if key.startswith(prefix) and entry["points"]]
    if not vals:
        return None
    return max(vals) if agg == "max" else sum(vals)


def _fmt(v: Optional[float], pattern: str = "{:.1f}",
         scale: float = 1.0) -> str:
    return "-" if v is None else pattern.format(v * scale)


def _quality_line(host: str, port: int,
                  timeout: float = 3.0) -> Optional[str]:
    """One line of prediction-quality vitals from /quality.json —
    worst 5m drift (PSI), feedback-join reward rate, and the last
    roll's canary overlap. None when the endpoint is absent (event
    servers, routers) or unreachable: top degrades, never errors."""
    try:
        q = _fetch_json(host, port, "/quality.json", timeout)
    except (OSError, ValueError):
        return None
    if not isinstance(q, dict) or not q.get("enabled", False):
        return None
    drifts = [w.get(k, 0.0)
              for app in (q.get("apps") or {}).values()
              for w in (app.get("windows") or {}).values()
              for k in ("top1_psi", "margin_psi") if k in w]
    rewards = [a.get("reward_rate", 0.0)
               for a in ((q.get("joiner") or {}).get("apps")
                         or {}).values()]
    canary = q.get("canary") or {}
    return (f"  drift(psi) {_fmt(max(drifts) if drifts else None, '{:.3f}'):>6}"
            f"    reward {_fmt(max(rewards) if rewards else None, '{:.0%}'):>6}"
            f"    canary {_fmt(canary.get('overlap'), '{:.0%}'):>6}")


def _liveness_line(series: Dict) -> Optional[str]:
    """Self-healing vitals from the watchdog/pressure rings: how many
    loop beats are registered, the oldest beat age, degraded roles,
    stall/restart rates, and the memory-pressure state. None before
    the watchdog exports anything (event servers, old snapshots): top
    degrades, never errors."""
    beats = sum(1 for key, entry in series.items()
                if key.startswith("pio_thread_beat_age_seconds{")
                and entry["points"])
    if not beats:
        return None
    age = _ring_latest(series, "pio_thread_beat_age_seconds", agg="max")
    degraded = _ring_latest(series, "pio_thread_degraded")
    stalls = _ring_latest(series, "pio_watchdog_stalls_total")
    restarts = _ring_latest(series, "pio_thread_restarts_total")
    mem = _ring_latest(series, "pio_mem_pressure_state", agg="max")
    mem_s = "-" if mem is None else \
        {0: "ok", 1: "soft", 2: "hard"}.get(int(mem), "?")
    return (f"  beats {beats:>3} (oldest {_fmt(age, '{:.1f}s')})"
            f"    degraded {_fmt(degraded, '{:.0f}'):>3}"
            f"    stalls/s {_fmt(stalls, '{:.2f}'):>5}"
            f"    restarts/s {_fmt(restarts, '{:.2f}'):>5}"
            f"    mem {mem_s}")


def _autoscale_line(series: Dict) -> Optional[str]:
    """Elastic-fleet vitals from the router's ring: the autoscaler's
    child-count target, up/down decision rates, and the offered load it
    is reacting to. None on servers without an autoscaler (replicas,
    event servers): top degrades, never errors."""
    children = _ring_latest(series, "pio_autoscale_children", agg="max")
    if children is None:
        return None
    ups = _ring_latest(series,
                       "pio_autoscale_decisions_total{direction=up}")
    downs = _ring_latest(
        series, "pio_autoscale_decisions_total{direction=down}")
    qps = _ring_latest(series, "pio_fleet_member_qps{")
    p99 = _ring_latest(series, "pio_fleet_member_p99_seconds{",
                       agg="max")
    return (f"  autoscale {_fmt(children, '{:.0f}'):>3} children"
            f"    up/s {_fmt(ups, '{:.2f}'):>5}"
            f"    down/s {_fmt(downs, '{:.2f}'):>5}"
            f"    fleet qps {_fmt(qps):>8}"
            f"    fleet p99 {_fmt(p99, '{:.1f}ms', 1e3):>8}")


def top_view(host: str, port: int, timeout: float = 3.0,
             frames: int = 3) -> str:
    """One screenful of a running server's vitals from /tsdb.json +
    /profile.json (+ /quality.json where the serve plane exposes it).
    Raises OSError when the server is unreachable."""
    ring = _fetch_json(host, port, "/tsdb.json", timeout)["series"]
    prof = _fetch_json(host, port, "/profile.json", timeout)
    qps = _ring_latest(ring, "pio_http_requests_total{")
    p50 = _suffix_latest(ring, "pio_http_request_duration_seconds", ":p50")
    p99 = _suffix_latest(ring, "pio_http_request_duration_seconds", ":p99")
    shed = _ring_latest(ring, "pio_shed_total")
    burn = _ring_latest(ring, "pio_slo_burn_rate", agg="max")
    rss = _ring_latest(ring, "pio_host_rss_bytes", agg="max")
    lines = [
        f"pio-tpu top — {host}:{port}",
        f"  qps {_fmt(qps):>10}    p50 {_fmt(p50, '{:.2f}ms', 1e3):>10}"
        f"    p99 {_fmt(p99, '{:.2f}ms', 1e3):>10}",
        f"  shed/s {_fmt(shed):>7}    burn(5m) {_fmt(burn, '{:.2f}'):>6}"
        f"    rss {_fmt(rss, '{:.1f}MB', 1.0 / (1 << 20)):>10}",
        f"  profiler: {prof.get('samples', 0)} samples @ "
        f"{prof.get('hz', 0):g} Hz "
        f"({'on' if prof.get('running') else 'off'})",
    ]
    quality = _quality_line(host, port, timeout)
    if quality is not None:
        lines.insert(3, quality)
    liveness = _liveness_line(ring)
    if liveness is not None:
        lines.insert(3, liveness)
    autoscale = _autoscale_line(ring)
    if autoscale is not None:
        lines.insert(3, autoscale)
    for row in prof.get("top_self", [])[:frames]:
        lines.append(f"    {row['share']:>6.1%}  {row['frame']}")
    roles = prof.get("roles") or {}
    if roles:
        lines.append("  roles: " + "  ".join(
            f"{r}={st['share']:.0%}" for r, st in list(roles.items())[:6]))
    return "\n".join(lines)


def _suffix_latest(series: Dict, prefix: str,
                   suffix: str) -> Optional[float]:
    """Max of the most recent points across series matching BOTH the
    name prefix and the key suffix (quantile rings: `...}:p99`)."""
    vals = [entry["points"][-1][1]
            for key, entry in series.items()
            if key.startswith(prefix) and key.endswith(suffix)
            and entry["points"]]
    return max(vals) if vals else None


def run_top(host: str, port: int, watch_s: float = 0.0,
            iterations: Optional[int] = None, out=print) -> int:
    """The CLI's loop: one-shot by default; `--watch N` redraws every N
    seconds until interrupted (or `iterations` screens in tests).
    Returns a process exit code."""
    import time
    n = 0
    while True:
        try:
            out(top_view(host, port))
        except (OSError, ValueError) as e:
            out(f"[ERROR] top: {type(e).__name__}: {e}")
            return 1
        n += 1
        if watch_s <= 0 or (iterations is not None and n >= iterations):
            return 0
        try:
            time.sleep(watch_s)
        except KeyboardInterrupt:
            return 0
