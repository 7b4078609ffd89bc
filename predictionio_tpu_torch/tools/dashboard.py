"""The dashboard: completed evaluations, live metrics, traces, the fleet.

The port of `predictionio_tpu/tools/dashboard.py` (the reference's
`tools/.../dashboard/Dashboard.scala:60-160` and its templates): the
`Dashboard` server (`cli dashboard`) lists the completed evaluation
instances, most recent first, with a page and a JSON document per
instance, and serves `/metrics.html` (the registry's snapshot: a panel
per family group and sparkline history from the server's tsdb ring,
`obs/tsdb.py`) and `/traces.html` (a waterfall per trace of the flight
recorder, `obs/trace.py`), with CORS headers and the optional server
key (`DashboardConfig.server_key`). A fleet router serves `/fleet.html`
(`_fleet_page`): the membership table and each member's qps, p99, burn
and reactor balance, with the autoscaler's child count. The HTML is the
JAX package's, character for character, for the same store, snapshot
and ring, but for the Serving panel's prefixes: the port has no XLA
compiles, and its kernel builds (`pio_kernel_build*`) stand in their
place.
"""

from __future__ import annotations

import html
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.data.event import format_time
from predictionio_tpu_torch.obs import trace as _trace
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.utils.http import (HTTPServerBase, Request,
                                               Response)

CORS_HEADERS = {"Access-Control-Allow-Origin": "*",
                "Access-Control-Allow-Methods": "GET"}


@dataclass
class DashboardConfig:
    # localhost by default (Dashboard.scala:41); binding elsewhere is an
    # explicit choice
    ip: str = "127.0.0.1"
    port: int = 9000
    server_key: str = ""     # optional key auth (KeyAuthentication)


class Dashboard(HTTPServerBase):
    """The dashboard server over `registry`'s evaluation instances;
    `metrics` is the registry `/metrics.html` shows (the process default
    unless given). A host service: it touches no device."""

    def __init__(self, config: DashboardConfig, registry=None,
                 ssl_context=None,
                 metrics: Optional[MetricsRegistry] = None):
        super().__init__(host=config.ip, port=config.port,
                         ssl_context=ssl_context, metrics=metrics)
        from predictionio_tpu_torch.utils.security import KeyAuthentication
        self.auth = KeyAuthentication(config.server_key or None)
        self.ctx = RuntimeContext(registry=registry)
        self._routes()

    def _instances(self):
        return self.ctx.registry.get_meta_data_evaluation_instances()

    def _routes(self):
        r = self.router

        @r.get("/")
        def index(req: Request) -> Response:
            self.auth.check(req)
            rows = []
            for i in self._instances().get_completed():
                iid = html.escape(i.id, quote=True)
                rows.append(
                    f"<tr><td><a href='/engine_instances/{iid}'>{iid}</a>"
                    f"</td><td>{format_time(i.start_time)}</td>"
                    f"<td>{html.escape(i.evaluation_class)}</td>"
                    f"<td>{html.escape(i.evaluator_results)}</td></tr>")
            body = (
                "<html><head><title>PredictionIO-TPU Dashboard</title></head>"
                "<body><h1>Completed evaluations</h1>"
                "<table border=1><tr><th>Instance</th><th>Started</th>"
                "<th>Evaluation</th><th>Result</th></tr>"
                + "".join(rows) + "</table>"
                "<p><a href='/metrics.html'>Live metrics</a></p>"
                "</body></html>")
            return Response(status=200, body=body, content_type="text/html",
                            headers=CORS_HEADERS)

        @r.get("/metrics.html")
        def metrics_html(req: Request) -> Response:
            self.auth.check(req)
            return Response(status=200,
                            body=_metrics_page(self.metrics,
                                               tsdb=self.tsdb),
                            content_type="text/html", headers=CORS_HEADERS)

        @r.get("/traces.html")
        def traces_html(req: Request) -> Response:
            self.auth.check(req)
            return Response(status=200,
                            body=_traces_page(req.query_get),
                            content_type="text/html", headers=CORS_HEADERS)

        # the .json route must be registered first: routes match in order
        # and the plain <iid> capture would swallow "<id>.json"
        @r.get("/engine_instances/<iid>.json")
        def detail_json(req: Request) -> Response:
            self.auth.check(req)
            inst = self._instances().get(req.params["iid"])
            if inst is None:
                return Response.json({"message": "Not Found"}, 404)
            return Response(status=200, body=inst.evaluator_results_json,
                            content_type="application/json",
                            headers=CORS_HEADERS)

        @r.get("/engine_instances/<iid>")
        def detail(req: Request) -> Response:
            self.auth.check(req)
            inst = self._instances().get(req.params["iid"])
            if inst is None:
                return Response.json({"message": "Not Found"}, 404)
            body = (
                f"<html><body><h1>Evaluation {html.escape(inst.id)}</h1>"
                f"<p>{html.escape(inst.evaluation_class)} — "
                f"{html.escape(inst.evaluator_results)}</p>"
                f"{inst.evaluator_results_html}"  # framework-generated table
                "</body></html>")
            return Response(status=200, body=body, content_type="text/html",
                            headers=CORS_HEADERS)


# metric-family prefixes surfaced in the durability summary panel: the
# operator-facing "is the store healthy" view (breaker trips, fsck
# findings, janitored instances, exhausted retry budgets)
_DURABILITY_PREFIXES = ("pio_breaker", "pio_fsck", "pio_janitor",
                        "pio_retry_budget")


def _series_rows(name: str, fam: dict) -> list:
    rows = []
    for s in fam["series"]:
        labels = ",".join(f"{k}={v}" for k, v in sorted(
            s["labels"].items()))
        if fam["type"] == "histogram":
            val = (f"count={s['count']} sum={s['sum']:.6g} "
                   f"p50={s['p50']:.6g} p90={s['p90']:.6g} "
                   f"p99={s['p99']:.6g}")
        else:
            val = f"{s['value']:.6g}"
        rows.append(
            f"<tr><td>{html.escape(name)}</td>"
            f"<td>{html.escape(labels)}</td>"
            f"<td>{html.escape(fam['type'])}</td>"
            f"<td>{html.escape(val)}</td></tr>")
    return rows


# serving-performance families: the "is the hot path on the device" view
# (dispatch mix, kernel builds where the JAX package shows its backend
# recompiles, deploy warmup cost, coalesced batch sizes, and model
# staleness: freshness sits next to serve latency, so an operator sees
# "fast but stale" at a glance)
_SERVING_PREFIXES = ("pio_topk_dispatch", "pio_kernel_build",
                     "pio_serve_warmup", "pio_serve_batch_size",
                     "pio_freshness_seconds")

# multi-tenant admission families: per-app serve latency, quota sheds
# (pio_shed_total{surface=quota,...}), admitted counts, and live tenant
# state — the fairness/quota view of a shared fleet
_TENANCY_PREFIXES = ("pio_tenant", "pio_shed_total")

# wire-level transport families (selector front end): accepted/open
# connections, request/response counts, bytes in each direction, send
# failures, pipeline depth — the "is the socket layer healthy" view
_WIRE_PREFIXES = ("pio_wire",)

# SLO families: multi-window error-budget burn per app (burn > 1 eats
# budget; burn >= 14.4 on the 5m window is the fast-burn page threshold)
_SLO_PREFIXES = ("pio_slo",)

# prediction-quality families (obs/quality.py): score drift vs the
# deploy-time reference, result-shape ratios, feedback-join reward, and
# the last rolling reload's canary overlap — "is the model any good"
_QUALITY_PREFIXES = ("pio_pred_", "pio_canary_", "pio_feedback_join")

# the self-healing plane: thread liveness beats, watchdog verdicts,
# memory-pressure watermarks, and the replica supervisor
_SELFHEAL_PREFIXES = ("pio_thread_", "pio_watchdog_", "pio_mem_",
                      "pio_supervisor_")


def _reactor_balance(snapshot: dict) -> str:
    """Per-reactor connection/request balance: one row per accept
    shard, with each shard's share of total framed requests, so
    SO_REUSEPORT (or round-robin handoff) skew is visible at a glance.
    Empty string when the wire runs a single unlabeled reactor."""
    per: dict = {}

    def gather(family: str, key: str) -> None:
        fam = snapshot.get(family)
        if not fam:
            return
        for s in fam["series"]:
            r = s["labels"].get("reactor")
            if r is None:
                continue
            d = per.setdefault(r, {})
            d[key] = d.get(key, 0.0) + s["value"]

    gather("pio_wire_requests_total", "requests")
    gather("pio_wire_connections_accepted_total", "accepted")
    gather("pio_wire_connections_open", "open")
    if len(per) < 2:
        return ""
    total_req = sum(v.get("requests", 0.0) for v in per.values()) or 1.0
    rows = []
    for r in sorted(per, key=lambda x: (len(x), x)):
        v = per[r]
        share = 100.0 * v.get("requests", 0.0) / total_req
        rows.append(
            f"<tr><td>{html.escape(r)}</td>"
            f"<td>{v.get('accepted', 0.0):.0f}</td>"
            f"<td>{v.get('open', 0.0):.0f}</td>"
            f"<td>{v.get('requests', 0.0):.0f}</td>"
            f"<td>{share:.1f}%</td></tr>")
    return ("<h3>Reactor balance</h3>"
            "<table border=1><tr><th>Reactor</th><th>Accepted</th>"
            "<th>Open</th><th>Requests</th><th>Share</th></tr>"
            + "".join(rows) + "</table>")


def _wire_panel(snapshot: dict) -> str:
    """Summary table of the wire transport families so an operator sees
    connection churn, byte throughput, and send failures at a glance —
    plus the per-reactor accept-shard balance when the wire runs more
    than one reactor."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_WIRE_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Wire</h2>"
                "<p>No wire activity recorded yet (selector wire off, "
                "or no connections).</p>")
    return ("<h2>Wire</h2>" + _reactor_balance(snapshot)
            + "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


def _slo_panel(snapshot: dict) -> str:
    """Error-budget burn per app and window, plus the p99 exemplar link:
    the stored trace id nearest the pio_serve_seconds p99 bucket, linked
    into the /traces.html waterfall so 'p99 regressed' resolves to a
    real request in two clicks."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_SLO_PREFIXES):
            rows.extend(_series_rows(name, fam))
    links = []
    serve = snapshot.get("pio_serve_seconds")
    if serve:
        for s in serve["series"]:
            for ex in _nearest_exemplars(s):
                app = s["labels"].get("app", "") or "(default)"
                tid = html.escape(ex["trace_id"], quote=True)
                links.append(
                    f"<li>{html.escape(app)} p99&asymp;{s['p99']:.4g}s "
                    f"&rarr; <a href='/traces.html?trace={tid}'>{tid}</a> "
                    f"({ex['value']:.4g}s)</li>")
    body = []
    if rows:
        body.append("<table border=1><tr><th>Family</th><th>Labels</th>"
                    "<th>Type</th><th>Value</th></tr>" + "".join(rows)
                    + "</table>")
    else:
        body.append("<p>No SLO burn recorded yet (no traffic).</p>")
    if links:
        body.append("<p>p99 exemplars:</p><ul>" + "".join(links) + "</ul>")
    return "<h2>SLO burn rate</h2>" + "".join(body)


def _quality_panel(snapshot: dict) -> str:
    """Summary table of the prediction-quality families: drift vs the
    deploy-time reference (PSI / JS per window), empty/unknown-entity
    ratios, the feedback-join reward rate, and the last roll's canary
    overlap. The raw per-app snapshot lives at /quality.json."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_QUALITY_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Prediction quality</h2>"
                "<p>No quality telemetry recorded yet (PIO_QUALITY "
                "off, or no queries served).</p>")
    return ("<h2>Prediction quality</h2>"
            "<p>Raw snapshot: <a href='/quality.json'>/quality.json"
            "</a></p>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


def _nearest_exemplars(series: dict) -> list:
    """The exemplar row(s) nearest the series' p99 estimate (at most
    one): exemplars are per-bucket, so the closest |value - p99| is the
    one that actually lives in (or next to) the p99 bucket."""
    exs = series.get("exemplars") or []
    if not exs:
        return []
    p99 = series.get("p99", 0.0)
    return [min(exs, key=lambda e: abs(e["value"] - p99))]


def _tenancy_panel(snapshot: dict) -> str:
    """Summary table of the multi-tenant admission families: which app
    is being shed on which surface, per-app latency distributions, and
    how many tenants hold live admission state."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_TENANCY_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Multi-tenant admission</h2>"
                "<p>No per-app serve/shed activity recorded yet "
                "(tenancy off, or no queries).</p>")
    return ("<h2>Multi-tenant admission</h2>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


def _serving_panel(snapshot: dict) -> str:
    """Summary table of the serve-pipeline families so an operator sees
    the host/device dispatch mix, steady-state recompiles (should be
    flat after warmup), and warmup cost at a glance."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_SERVING_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Serving performance</h2>"
                "<p>No dispatch/compile/warmup activity recorded yet.</p>")
    return ("<h2>Serving performance</h2>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


_TIER_PREFIXES = ("pio_tier_", "pio_plan_resident_bytes",
                  "pio_fleet_shard_owner", "pio_fleet_mesh_merged")


def _tier_panel(snapshot: dict) -> str:
    """Summary table of the giant-catalog families: hot-slab size and
    hit ratio, batched promotion counts and page pass latency, device
    residency of the live plans, and cross-host shard ownership — the
    operator's view of whether the demand-paged hot set has converged
    (hit ratio high, promotions quiescent) and every mesh shard has an
    admitted owner."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_TIER_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Tiered / mesh catalog</h2>"
                "<p>No tiered plans or mesh shards active.</p>")
    return ("<h2>Tiered / mesh catalog</h2>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


def _selfheal_panel(snapshot: dict) -> str:
    """Summary table of the self-healing families: loop beat ages and
    degraded roles (watchdog), stall/restart/death counts, the
    memory-pressure state machine, and supervised-child states — the
    operator's first stop when /ready flips for no obvious reason."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_SELFHEAL_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Self-healing</h2>"
                "<p>No watchdog/pressure/supervisor activity recorded "
                "yet (watchdog off, or no loops registered).</p>")
    return ("<h2>Self-healing</h2>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


def _durability_panel(snapshot: dict) -> str:
    """Summary table of the resilience/durability families so an operator
    sees breaker trips, fsck quarantines, janitored trains, and exhausted
    retry budgets without scanning the full registry dump."""
    rows = []
    for name, fam in sorted(snapshot.items()):
        if name.startswith(_DURABILITY_PREFIXES):
            rows.extend(_series_rows(name, fam))
    if not rows:
        return ("<h2>Durability &amp; resilience</h2>"
                "<p>No breaker/fsck/janitor/retry-budget activity "
                "recorded yet.</p>")
    return ("<h2>Durability &amp; resilience</h2>"
            "<table border=1><tr><th>Family</th><th>Labels</th>"
            "<th>Type</th><th>Value</th></tr>" + "".join(rows)
            + "</table>")


# -- time-series sparklines ---------------------------------------------------

# (chart title, tsdb key prefixes) — each chart draws every matching
# ring series (capped) as its own labeled sparkline row
_HISTORY_CHARTS = (
    ("Serve qps", ("pio_http_requests_total{",)),
    ("Request p99 (s)", ("pio_http_request_duration_seconds",)),
    ("Shed rate", ("pio_shed_total",)),
    ("SLO burn", ("pio_slo_burn_rate",)),
    ("Host RSS (bytes)", ("pio_host_rss_bytes",)),
    ("GC pause p99 (s)", ("pio_gc_pause_seconds",)),
)

_SPARK_W = 260
_SPARK_H = 36
_MAX_SERIES_PER_CHART = 8


def _spark_svg(points: list, width: int = _SPARK_W,
               height: int = _SPARK_H) -> str:
    """One [(ts, value), ...] series as an inline SVG polyline,
    self-normalized to its own min/max (a sparkline shows shape, the
    label next to it shows magnitude)."""
    if len(points) < 2:
        return "<svg width='%d' height='%d'></svg>" % (width, height)
    ts = [p[0] for p in points]
    vs = [p[1] for p in points]
    t0, t1 = ts[0], ts[-1]
    vmin, vmax = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (vmax - vmin) or 1.0
    coords = " ".join(
        f"{(t - t0) / tspan * (width - 2) + 1:.1f},"
        f"{height - 1 - (v - vmin) / vspan * (height - 2):.1f}"
        for t, v in points)
    return (f"<svg width='{width}' height='{height}' "
            f"style='background:#f4f6f8'>"
            f"<polyline points='{coords}' fill='none' stroke='#36c' "
            "stroke-width='1.5'/></svg>")


def _history_rows(tsdb, prefixes: tuple) -> list:
    """Sparkline rows for every ring series matching the prefixes."""
    exported = tsdb.to_json()["series"]
    rows = []
    for key in sorted(exported):
        if not key.startswith(prefixes):
            continue
        if len(rows) >= _MAX_SERIES_PER_CHART:
            rows.append("<tr><td colspan=3><small>&hellip; more "
                        "series truncated</small></td></tr>")
            break
        pts = exported[key]["points"]
        last = pts[-1][1] if pts else 0.0
        rows.append(
            f"<tr><td><small>{html.escape(key)}</small></td>"
            f"<td>{_spark_svg(pts)}</td>"
            f"<td>{last:.6g}</td></tr>")
    return rows


def _history_panel(tsdb) -> str:
    """Sparkline history charts from the server's own time-series ring
    (obs/tsdb.py): qps, p99, shed, burn, RSS, GC over the ring's
    horizon. Empty until the scraper has ticked twice (rates need two
    sightings)."""
    if tsdb is None:
        return ""
    sections = []
    for title, prefixes in _HISTORY_CHARTS:
        rows = _history_rows(tsdb, prefixes)
        if not rows:
            continue
        sections.append(
            f"<h3>{html.escape(title)}</h3>"
            "<table><tr><th>Series</th><th>History</th><th>Last</th>"
            "</tr>" + "".join(rows) + "</table>")
    if not sections:
        return ("<h2>History</h2><p>No ring data yet (the tsdb "
                "scraper needs two ticks; PIO_TSDB_INTERVAL_S=0 "
                "disables it).</p>")
    return ("<h2>History</h2>"
            "<p>Raw ring: <a href='/tsdb.json'>/tsdb.json</a> "
            "(?series=prefix &amp;since=unix-ts)</p>"
            + "".join(sections))


# the fleet page's charts: (title, tsdb key prefixes)
_FLEET_MEMBER_CHARTS = (
    ("Member qps", ("pio_fleet_member_qps",)),
    ("Member p99 (s)", ("pio_fleet_member_p99_seconds",)),
    ("Member 5m burn", ("pio_fleet_member_burn",)),
    ("Member reactor balance (max/mean)",
     ("pio_fleet_member_reactor_balance",)),
    # the autoscaler's child count beside the load and tail it reacts to
    ("Elastic fleet: children",
     ("pio_autoscale_children", "pio_autoscale_decisions_total")),
    ("Elastic fleet: offered load vs p99",
     ("pio_fleet_member_qps", "pio_fleet_member_p99_seconds")),
)


def _fleet_page(tsdb, members: list) -> str:
    """`/fleet.html`: the membership table (member snapshots) and the
    member history charts from the router's ring."""
    rows = []
    for s in members:
        rows.append(
            f"<tr><td>{html.escape(str(s.get('member', '')))}</td>"
            f"<td>{html.escape(str(s.get('state', '')))}</td>"
            f"<td>{s.get('admitted', False)}</td>"
            f"<td>{s.get('failures', 0)}</td>"
            f"<td>{s.get('beat_age_s', 0.0):.2f}s</td></tr>")
    sections = []
    for title, prefixes in _FLEET_MEMBER_CHARTS:
        hrows = _history_rows(tsdb, prefixes) if tsdb is not None else []
        if hrows:
            sections.append(
                f"<h3>{html.escape(title)}</h3>"
                "<table><tr><th>Series</th><th>History</th><th>Last"
                "</th></tr>" + "".join(hrows) + "</table>")
    history = "".join(sections) if sections else (
        "<p>No member history yet — the federation scrape derives "
        "rates after two tsdb ticks.</p>")
    return (
        "<html><head><title>Fleet</title>"
        "<meta http-equiv='refresh' content='5'></head>"
        "<body><h1>Fleet observatory</h1>"
        "<p>Federated scrape: <a href='/federate'>/federate</a> "
        "&middot; ring: <a href='/tsdb.json'>/tsdb.json</a></p>"
        "<table border=1><tr><th>Member</th><th>State</th>"
        "<th>Admitted</th><th>Failures</th><th>Beat age</th></tr>"
        + "".join(rows) + "</table>" + history + "</body></html>")


def _metrics_page(metrics: MetricsRegistry, tsdb=None) -> str:
    """Registry snapshot as an auto-refreshing HTML table: counters and
    gauges show their value, histograms show count/sum and the estimated
    p50/p90/p99 (the same numbers /metrics exposes to a scraper), with a
    durability summary panel (breakers, fsck, janitor, retry budgets) on
    top and sparkline history charts from the server's time-series ring
    when one is passed."""
    snapshot = metrics.snapshot()
    rows = []
    for name, fam in sorted(snapshot.items()):
        rows.extend(_series_rows(name, fam))
    return (
        "<html><head><title>Metrics</title>"
        "<meta http-equiv='refresh' content='5'></head>"
        "<body><h1>Live metrics</h1>"
        "<p>Prometheus text format: <a href='/metrics'>/metrics</a> "
        "&middot; traces: <a href='/traces.html'>/traces.html</a> "
        "&middot; profile: <a href='/profile.json'>/profile.json</a></p>"
        + _history_panel(tsdb)
        + _serving_panel(snapshot) + _slo_panel(snapshot)
        + _quality_panel(snapshot)
        + _wire_panel(snapshot) + _tenancy_panel(snapshot)
        + _tier_panel(snapshot)
        + _selfheal_panel(snapshot) + _durability_panel(snapshot) +
        "<h2>All families</h2>"
        "<table border=1><tr><th>Family</th><th>Labels</th><th>Type</th>"
        "<th>Value</th></tr>" + "".join(rows) + "</table></body></html>")


# -- trace waterfall ----------------------------------------------------------

_BAR_PX = 600          # full-width pixel scale of one waterfall


def _waterfall(entries: list) -> str:
    """One trace's entries (router hop + replica serve share a trace_id)
    rendered as horizontal bars on a common relative time axis. Entries
    carry only relative span offsets, so hops are stacked in arrival
    order, each with its own stage bars underneath."""
    total = max((e.get("duration_ms", 0.0) for e in entries), default=0.0)
    scale = _BAR_PX / total if total > 0 else 0.0
    rows = []
    for e in entries:
        dur = e.get("duration_ms", 0.0)
        label = (f"{e.get('kind', '')}:{e.get('name', '')} "
                 f"[{e.get('app', '') or '-'}] status={e.get('status', 0)} "
                 f"{e.get('dispatch', '') or ''} {dur:.3f}ms")
        if e.get("error"):
            label += f" error={e['error']}"
        if e.get("batch_size"):
            label += f" batch={e['batch_size']}"
        rows.append(
            f"<div><tt>{html.escape(label)}</tt></div>"
            f"<div style='background:#36c;height:14px;"
            f"width:{max(int(dur * scale), 2)}px'></div>")
        for sp in e.get("spans", ()):
            left = max(int(sp.get("start_ms", 0.0) * scale), 0)
            width = max(int(sp.get("dur_ms", 0.0) * scale), 1)
            rows.append(
                f"<div style='margin-left:{left}px'>"
                f"<div style='background:#9cf;height:10px;display:"
                f"inline-block;width:{width}px'></div> "
                f"<small>{html.escape(sp.get('name', ''))} "
                f"{sp.get('dur_ms', 0.0):.3f}ms</small></div>")
    head = entries[0]
    tid = html.escape(head.get("trace_id", ""), quote=True)
    return (f"<h3><a href='/traces.html?trace={tid}'>{tid}</a> "
            f"&mdash; {total:.3f}ms, keep={html.escape(head.get('keep', ''))}"
            "</h3>" + "".join(rows))


def _traces_page(query_get) -> str:
    """The `/traces.html` waterfall view over the in-process trace ring:
    entries grouped by trace id (fleet hops stitch into one group), the
    per-stage spans drawn to a shared scale. Filters mirror
    `/traces.json`: ?app= &min_ms= &trace= &limit=."""
    rec = _trace.get_recorder()
    app = query_get("app")
    min_ms = query_get("min_ms")
    tid = query_get("trace")
    limit = query_get("limit")
    entries = rec.snapshot(
        app=app if app else None,
        min_ms=float(min_ms) if min_ms else None,
        trace_id=tid if tid else None,
        limit=int(limit) if limit else 50)
    groups: dict = {}
    for e in entries:                   # newest-first; keep that order
        groups.setdefault(e.get("trace_id", ""), []).append(e)
    sections = []
    for gid, group in groups.items():
        # within a trace, oldest entry first (router before replica)
        sections.append(_waterfall(list(reversed(group))))
    body = "".join(sections) if sections else (
        "<p>No traces in the ring. Enable sampling with "
        "PIO_TRACE_SAMPLE (errors and the slowest decile are kept "
        "even at 0).</p>")
    return (
        "<html><head><title>Traces</title></head>"
        "<body><h1>Flight recorder</h1>"
        "<p>JSON: <a href='/traces.json'>/traces.json</a> &middot; "
        "filters: ?app= &amp;min_ms= &amp;trace= &amp;limit=</p>"
        + body + "</body></html>")
