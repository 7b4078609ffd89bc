"""The fleet page of the dashboard: `GET /fleet.html` on a fleet router.

The port of the fleet part of `predictionio_tpu/tools/dashboard.py`:
the membership table and, from the router's own tsdb ring
(`obs/tsdb.py`), a sparkline per member series of qps, p99, 5-minute
SLO burn and reactor balance (derived by the router's federation
scrape, `serving/fleet.py`), and the autoscaler's child count against
the load it reacts to. The HTML is the JAX page's, character for
character, for the same ring and members.

The rest of the JAX dashboard (the evaluation `Dashboard` server,
`/metrics.html` and its panels, the traces page) is not ported yet
(ROADMAP.md, Queue 1 item 5(d)).
"""

from __future__ import annotations

import html

_SPARK_W = 260
_SPARK_H = 36
_MAX_SERIES_PER_CHART = 8


def _spark_svg(points: list, width: int = _SPARK_W,
               height: int = _SPARK_H) -> str:
    """One [(ts, value), ...] series as an inline SVG polyline, scaled
    to its own min and max (the shape; the value beside it gives the
    magnitude)."""
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
    """A sparkline row for each ring series that starts with one of
    `prefixes` (at most `_MAX_SERIES_PER_CHART`)."""
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
