"""The port's REST event server (`predictionio_tpu_torch.data.
eventserver`) and the prediction server's feedback loop, against the JAX
package:

  - one request script per case of `tests/test_eventserver.py`
    (`TestAuth`, `TestEventsCRUD`, `TestBatch`, `TestStatsAndPlugins`,
    `TestWebhooks`) goes to the JAX `EventServer` and to the port's, each
    on a MEM registry seeded with the same apps, keys and channels:
    statuses and bodies are equal once generated event ids and creation
    times are normalised, and the stored events read back equal through
    each package's `find`;
  - events posted to the port's server over SQLITE + PEVLOG read back
    in the JAX package's `find`, and `cli eventserver` serves in a
    subprocess until SIGTERM;
  - the feedback loop: one `predict` event per served query (entityType
    `pio_pr`, the instance id and the query among its properties),
    a dead event server dropping the events after the retries without
    failing a query, a full queue dropping instead of stalling, and a
    refresher tick over a delta of only `predict` events being `noop`.
"""

import base64
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from urllib.parse import quote, urlencode

import pytest

from predictionio_tpu.data.eventserver import EventServer as JEventServer
from predictionio_tpu.data.eventserver import (
    EventServerConfig as JEventServerConfig)
from predictionio_tpu.data.plugins import INPUT_BLOCKER as J_INPUT_BLOCKER
from predictionio_tpu.data.plugins import (
    EventServerPlugin as JEventServerPlugin)
from predictionio_tpu.data.storage import AccessKey as JAccessKey
from predictionio_tpu.data.storage import App as JApp
from predictionio_tpu.data.storage import Channel as JChannel
from predictionio_tpu.data.storage import StorageRegistry as JRegistry
from predictionio_tpu_torch.cli import main as cli_main
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import CoreWorkflow
from predictionio_tpu_torch.data.event import DataMap, Event, utcnow
from predictionio_tpu_torch.data.eventserver import (EventServer,
                                                     EventServerConfig)
from predictionio_tpu_torch.data.plugins import (INPUT_BLOCKER,
                                                 EventServerPlugin)
from predictionio_tpu_torch.data.stats import PRUNE_AFTER_SECONDS, Stats
from predictionio_tpu_torch.data.storage import (AccessKey, App, Channel,
                                                 StorageRegistry)
from predictionio_tpu_torch.models import recommendation as rec
from predictionio_tpu_torch.resilience import RetryPolicy, call_with_retry
from predictionio_tpu_torch.serving.server import FeedbackConfig
from predictionio_tpu_torch.streaming import Refresher
from predictionio_tpu_torch.utils.http import (Request, Router,
                                               parse_basic_auth_user)

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
MEM = {"PIO_STORAGE_SOURCES_MEM_TYPE": "MEM",
       "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
       "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}


def pev_config(tmp_path):
    return {"PIO_STORAGE_SOURCES_DB_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_DB_PATH": str(tmp_path / "pio.db"),
            "PIO_STORAGE_SOURCES_PEV_TYPE": "PEVLOG",
            "PIO_STORAGE_SOURCES_PEV_PATH": str(tmp_path / "pevlog"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "DB",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PEV",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "DB"}


def _blocker(base, plugin_type):
    """The blocker of `tests/test_eventserver.py` on either package's
    plugin base, under one class name and module, so that the two
    `/plugins.json` bodies agree."""

    def process(self, event_info, context):
        if event_info.event.properties.get_or_else("blocked", False):
            raise ValueError("event blocked by testblocker")

    return type("BlockerPlugin", (base,), {
        "__module__": __name__, "plugin_name": "testblocker",
        "plugin_description": "blocks events with property blocked=true",
        "plugin_type": plugin_type, "process": process})()


def _seed(registry, app_cls, key_cls, channel_cls) -> int:
    app_id = registry.get_meta_data_apps().insert(app_cls(0, "testapp"))
    keys = registry.get_meta_data_access_keys()
    keys.insert(key_cls("KEY", app_id, ()))
    keys.insert(key_cls("LIMITED", app_id, ("view",)))
    channel_id = registry.get_meta_data_channels().insert(
        channel_cls(0, "mobile", app_id))
    events = registry.get_events()
    events.init(app_id)
    events.init(app_id, channel_id)
    return app_id, channel_id


@pytest.fixture()
def servers():
    """(JAX server, port server), each on its own seeded MEM registry."""
    jreg, preg = JRegistry(dict(MEM)), StorageRegistry(dict(MEM))
    ids = _seed(jreg, JApp, JAccessKey, JChannel)
    assert _seed(preg, App, AccessKey, Channel) == ids
    jsrv = JEventServer(JEventServerConfig(
        ip="127.0.0.1", port=0, stats=True,
        plugins=[_blocker(JEventServerPlugin, J_INPUT_BLOCKER)]), jreg)
    psrv = EventServer(EventServerConfig(
        ip="127.0.0.1", port=0, stats=True,
        plugins=[_blocker(EventServerPlugin, INPUT_BLOCKER)]), preg)
    jsrv.start()
    psrv.start()
    yield (jsrv, jreg), (psrv, preg), ids
    jsrv.shutdown()
    psrv.shutdown()


def call(port, method, path, body=None, headers=None):
    data = (json.dumps(body).encode() if isinstance(body, (dict, list))
            else body)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method,
                                 headers=dict(headers or {}))
    if data is not None and "Content-Type" not in (headers or {}):
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _ev(i=0, **kw):
    return {"event": "view", "entityType": "user", "entityId": f"u{i}",
            "eventTime": f"2020-01-01T00:{i:02d}:00.000Z", **kw}


EV = _ev(1)
K = "accessKey=KEY"
BASIC = {"Authorization": "Basic " + base64.b64encode(b"KEY:").decode()}
FORM = {"Content-Type": "application/x-www-form-urlencoded"}
MAILCHIMP = {
    "type": "subscribe", "fired_at": "2009-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30"}
SEGMENT = {"type": "track", "user_id": "sio-user", "event": "signup",
           "timestamp": "2020-02-02T03:04:05.000Z",
           "properties": {"plan": "pro"}}

# A path may name the n-th generated event id of the run as {n}.
SCRIPTS = {
    "alive": [("GET", "/", None)],
    "missing_key": [("POST", "/events.json", EV)],
    "invalid_key": [("POST", "/events.json?accessKey=WRONG", EV)],
    "basic_auth_header": [("POST", "/events.json", EV, BASIC),
                          ("GET", "/events.json", None, BASIC)],
    "invalid_channel": [("POST", f"/events.json?{K}&channel=nope", EV)],
    "channel_isolation": [
        ("POST", f"/events.json?{K}&channel=mobile", EV),
        ("GET", f"/events.json?{K}", None),
        ("GET", f"/events.json?{K}&channel=mobile", None)],
    "post_get_delete": [
        ("POST", f"/events.json?{K}", EV),
        ("GET", f"/events/{{0}}.json?{K}", None),
        ("DELETE", f"/events/{{0}}.json?{K}", None),
        ("DELETE", f"/events/{{0}}.json?{K}", None),
        ("GET", f"/events/{{0}}.json?{K}", None)],
    "invalid_event_rejected": [
        ("POST", f"/events.json?{K}",
         {"event": "$unset", "entityType": "user", "entityId": "u1"}),
        ("POST", f"/events.json?{K}", {"event": "view"}),
        ("POST", f"/events.json?{K}", b"{not json"),
        ("POST", f"/events.json?{K}", b"")],
    "allowed_events_enforced": [
        ("POST", "/events.json?accessKey=LIMITED", EV),
        ("POST", "/events.json?accessKey=LIMITED", dict(EV, event="buy"))],
    "query_filters_and_default_limit": [
        *[("POST", f"/events.json?{K}",
           _ev(i, **({"targetEntityType": "item",
                      "targetEntityId": f"i{i % 3}"} if i % 2 else {})))
          for i in range(25)],
        ("GET", f"/events.json?{K}", None),
        ("GET", f"/events.json?{K}&limit=-1", None),
        ("GET", f"/events.json?{K}&startTime=2020-01-01T00:10:00.000Z"
                "&untilTime=2020-01-01T00:12:00.000Z&limit=-1", None),
        ("GET", f"/events.json?{K}&entityType=user&entityId=u3"
                "&reversed=true", None),
        ("GET", f"/events.json?{K}&targetEntityType=item"
                "&targetEntityId=i1&limit=-1", None),
        ("GET", f"/events.json?{K}&event=buy", None),
        ("GET", f"/events.json?{K}&limit=abc", None)],
    "reversed_requires_entity": [
        ("GET", f"/events.json?{K}&reversed=true", None)],
    "blocker_plugin_vetoes": [
        ("POST", f"/events.json?{K}", dict(EV, properties={"blocked": True})),
        ("POST", f"/batch/events.json?{K}",
         [EV, dict(EV, properties={"blocked": True})])],
    "routes_and_methods": [
        ("GET", "/nowhere", None), ("PUT", "/events.json", None),
        ("GET", f"/events/nope.json?{K}", None),
        ("DELETE", f"/events/nope.json?{K}", None)],
    "batch_mixed_statuses": [
        ("POST", f"/batch/events.json?{K}",
         [EV, {"event": "buy", "entityType": "user"},
          dict(EV, event="$bad")])],
    "batch_limit_50": [("POST", f"/batch/events.json?{K}", [EV] * 51)],
    "batch_not_an_array": [("POST", f"/batch/events.json?{K}", EV)],
    "batch_allowed_events": [
        ("POST", "/batch/events.json?accessKey=LIMITED",
         [EV, dict(EV, event="buy")])],
    "stats": [("POST", f"/events.json?{K}", EV),
              ("POST", f"/batch/events.json?{K}", [_ev(2), _ev(3)]),
              ("GET", f"/stats.json?{K}", None)],
    "encoded_event_id_roundtrip": [
        ("POST", f"/events.json?{K}", dict(EV, eventId="id with space")),
        ("GET", f"/events/{quote('id with space')}.json?{K}", None)],
    "slash_in_event_id_roundtrip": [
        ("POST", f"/events.json?{K}", dict(EV, eventId="a/b")),
        ("GET", f"/events/a%2Fb.json?{K}", None),
        ("DELETE", f"/events/a%2Fb.json?{K}", None)],
    "duplicate_event_id_is_400_everywhere": [
        ("POST", f"/events.json?{K}", dict(EV, eventId="dup1")),
        ("POST", f"/events.json?{K}", dict(EV, eventId="dup1")),
        ("POST", f"/batch/events.json?{K}", [dict(EV, eventId="dup1")])],
    "falsy_tags_rejected": [
        *[("POST", f"/events.json?{K}", dict(EV, tags=bad))
          for bad in (False, 0, "", "x", [1])],
        ("POST", f"/events.json?{K}", dict(EV, tags=["a", "b"]))],
    "plugins": [
        ("GET", f"/plugins/inputblocker/testblocker/status/x?{K}", None),
        ("GET", f"/plugins/inputblocker/testblocker?{K}", None),
        ("GET", f"/plugins/inputblocker/nope?{K}", None),
        ("GET", "/plugins.json", None)],
    "segmentio_json": [
        ("POST", f"/webhooks/segmentio.json?{K}", SEGMENT),
        ("GET", f"/events.json?{K}&entityType=user&entityId=sio-user",
         None)],
    "segmentio_bad_payload": [
        ("POST", f"/webhooks/segmentio.json?{K}", {"type": "track"})],
    "unknown_webhook": [
        ("POST", f"/webhooks/nonexistent.json?{K}", {}),
        ("GET", f"/webhooks/segmentio.json?{K}", None),
        ("GET", f"/webhooks/nonexistent.form?{K}", None),
        ("GET", f"/webhooks/mailchimp.form?{K}", None)],
    "mailchimp_form": [
        ("POST", f"/webhooks/mailchimp.form?{K}",
         urlencode(MAILCHIMP).encode(), FORM),
        ("POST", f"/webhooks/mailchimp.form?{K}",
         urlencode({"fired_at": "2009-03-26 21:35:57"}).encode(), FORM),
        ("GET", f"/events.json?{K}&entityType=user&entityId=8a25ff1d98",
         None),
        ("GET", f"/stats.json?{K}", None)],
}


def _run(port, script):
    """The script's (status, body) replies, with generated event ids
    replaced by their order of appearance and creation and start times
    dropped."""
    ids, out = [], []

    def norm(x):
        if isinstance(x, dict):
            return {k: (f"<id{ids.index(v)}>" if k == "eventId"
                        and v in ids else norm(v))
                    for k, v in x.items()
                    if k not in ("creationTime", "startTime")}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x

    for step in script:
        method, path, body, *headers = step
        status, reply = call(port, method, path.format(*ids), body,
                             headers[0] if headers else None)
        if method == "POST":
            for item in reply if isinstance(reply, list) else [reply]:
                if isinstance(item, dict) and "eventId" in item:
                    ids.append(item["eventId"])
        out.append((status, norm(reply)))
    return out, ids


def _stored(registry, ids, app_id, channel_id):
    out = []
    for ch in (None, channel_id):
        for e in registry.get_events().find(app_id, ch):
            j = e.to_api_json()
            j.pop("creationTime")
            if j["eventId"] in ids:
                j["eventId"] = f"<id{ids.index(j['eventId'])}>"
            out.append((ch, json.dumps(j, sort_keys=True)))
    return sorted(out, key=str)


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_same_replies_and_stored_events_as_the_jax_server(servers, case):
    (jsrv, jreg), (psrv, preg), (app_id, channel_id) = servers
    jout, jids = _run(jsrv.port, SCRIPTS[case])
    pout, pids = _run(psrv.port, SCRIPTS[case])
    for n, (a, b) in enumerate(zip(jout, pout)):
        assert a == b, f"{case} step {n}: JAX {a} != port {b}"
    assert len(jout) == len(pout)
    assert _stored(jreg, jids, app_id, channel_id) == _stored(
        preg, pids, app_id, channel_id)


def test_ingest_counts_by_surface_and_readiness(servers):
    _, (psrv, _), _ = servers
    call(psrv.port, "POST", f"/events.json?{K}", EV)
    call(psrv.port, "POST", f"/batch/events.json?{K}",
         [_ev(2), _ev(3), {"event": "x"}])
    call(psrv.port, "POST", f"/webhooks/segmentio.json?{K}", SEGMENT)
    assert psrv.ingested == {"single": 1, "batch": 2, "webhook": 1}
    assert call(psrv.port, "GET", "/health") == (200, {"status": "ok"})
    assert call(psrv.port, "GET", "/ready") == (200, {"ready": True})


def test_stats_buckets_are_pruned():
    from datetime import timedelta
    stats = Stats()
    ev = Event(event="view", entity_type="user", entity_id="u1")
    now = utcnow()
    stats.bookkeeping(1, 201, ev, now=now - timedelta(hours=5))
    stats.bookkeeping(1, 201, ev, now=now - timedelta(hours=4))
    assert len(stats._counts) == 2
    stats.bookkeeping(1, 201, ev, now=now)
    cutoff = max(k[1] for k in stats._counts) - PRUNE_AFTER_SECONDS
    assert all(k[1] > cutoff for k in stats._counts)
    assert len(stats._counts) == 1
    assert stats.get_stats(1, now=now)["currentHour"][0]["count"] == 1


def test_router_decodes_captures_after_matching():
    r = Router()
    r.get("/events/<event_id>.json")(
        lambda req: req.params["event_id"])
    r.get("/plugins/<a>/<rest:path>")(lambda req: req.params["rest"])
    req = Request("GET", "/events/a%2Fb.json", {}, {}, b"")
    assert r.dispatch(req) == "a/b"
    req = Request("GET", "/plugins/x/y/z%20w", {}, {}, b"")
    assert r.dispatch(req) == "y/z w"
    assert r.dispatch(Request("GET", "/events/a/b.json", {}, {},
                              b"")).status == 404
    assert parse_basic_auth_user({"Authorization": "Basic !!"}) is None
    assert parse_basic_auth_user({"authorization": "Basic " + base64.
                                  b64encode(b"K2:pw").decode()}) == "K2"


def test_events_posted_over_pevlog_read_back_in_the_jax_find(tmp_path):
    preg = StorageRegistry(pev_config(tmp_path))
    app_id, _ = _seed(preg, App, AccessKey, Channel)
    srv = EventServer(EventServerConfig(ip="127.0.0.1", port=0), preg)
    srv.start()
    try:
        rates = [{"event": "rate", "entityType": "user",
                  "entityId": f"u{i % 4}", "targetEntityType": "item",
                  "targetEntityId": f"i{i % 5}",
                  "properties": {"rating": float(i % 5 + 1)},
                  "eventTime": f"2021-03-0{1 + i % 3}T10:00:{i:02d}.000Z"}
                 for i in range(12)]
        for ev in rates[:4]:
            assert call(srv.port, "POST", f"/events.json?{K}", ev)[0] == 201
        status, body = call(srv.port, "POST", f"/batch/events.json?{K}",
                            rates[4:] + [{"event": "rate"}])
        assert [b["status"] for b in body] == [201] * 8 + [400]
        assert call(srv.port, "POST", f"/webhooks/segmentio.json?{K}",
                    SEGMENT)[0] == 201
    finally:
        srv.shutdown()
    ours = [e.to_api_json() for e in preg.get_events().find(app_id)]
    preg.close()
    jreg = JRegistry(pev_config(tmp_path))
    theirs = [e.to_api_json() for e in jreg.get_events().find(app_id)]
    jreg.close()
    assert len(ours) == 13 and theirs == ours
    posted = sorted(json.dumps(r, sort_keys=True) for r in rates)
    stored = sorted(json.dumps({k: v for k, v in e.items() if k not in (
        "eventId", "creationTime", "tags")}, sort_keys=True)
        for e in theirs if e["event"] == "rate")
    assert stored == posted


def _cli_env(tmp_path):
    return {**os.environ, "PYTHONPATH": str(REPO),
            "PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
            "PIO_STORAGE_SOURCES_PIO_PATH": str(tmp_path / "pio.db")}


def test_cli_eventserver_serves_until_sigterm(tmp_path):
    env = _cli_env(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "app", "new",
         "cliapp", "--access-key", "CLIKEY"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", "eventserver",
         "--ip", "127.0.0.1", "--port", "0", "--stats"], cwd=tmp_path,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("Event server started on 127.0.0.1:"), \
            proc.stderr.read()
        port = int(line.rsplit(":", 1)[1])
        status, body = call(port, "POST", "/events.json?accessKey=CLIKEY",
                            EV)
        assert status == 201 and "eventId" in body
        status, body = call(port, "GET", "/stats.json?accessKey=CLIKEY")
        assert body["currentHour"][0]["count"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    reg = StorageRegistry({"PIO_STORAGE_SOURCES_PIO_TYPE": "SQLITE",
                           "PIO_STORAGE_SOURCES_PIO_PATH":
                               str(tmp_path / "pio.db")})
    app = reg.get_meta_data_apps().get_by_name("cliapp")
    assert [e.entity_id for e in reg.get_events().find(app.id)] == ["u1"]
    reg.close()


def test_retry_policy_backs_off_then_raises():
    slept, calls = [], []

    def flaky():
        calls.append(1)
        raise ConnectionRefusedError("down")

    policy = RetryPolicy(attempts=3, base_delay=0.1, jitter=0.0)
    with pytest.raises(ConnectionRefusedError):
        call_with_retry(flaky, policy=policy, sleep=slept.append)
    assert len(calls) == 3 and slept == [0.1, 0.2]
    with pytest.raises(KeyError):   # not retryable: raised at once
        call_with_retry(lambda: {}["x"], policy=policy, sleep=slept.append)
    assert slept == [0.1, 0.2]


# -- the feedback loop ----------------------------------------------------------

def _rate(user, item, rating):
    return Event(event="rate", entity_type="user", entity_id=user,
                 target_entity_type="item", target_entity_id=item,
                 properties=DataMap({"rating": float(rating)}))


@pytest.fixture()
def trained(tmp_path):
    """SQLITE metadata + PEVLOG events holding a CPU-trained
    recommendation instance, and a port event server on the store."""
    registry = StorageRegistry(pev_config(tmp_path))
    app_id = registry.get_meta_data_apps().insert(App(0, "fbapp"))
    registry.get_meta_data_access_keys().insert(AccessKey("FB", app_id, ()))
    events = registry.get_events()
    events.init(app_id)
    events.insert_batch([_rate(f"u{u}", f"i{i}", 1 + (u * i) % 5)
                         for u in range(8) for i in range(6)
                         if (u + i) % 3], app_id)
    engine = rec.RecommendationEngine.apply()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"app_name": "fbapp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 4, "num_iterations": 4, "seed": 3}}]})
    row = CoreWorkflow.run_train(
        engine, params, RuntimeContext(registry=registry, device="cpu"))
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0), registry)
    es.start()
    yield registry, engine, row, app_id, es
    es.shutdown()
    registry.close()


def _deploy(registry, engine, row, feedback):
    return cli_main.deploy_instance(
        engine, row, RuntimeContext(registry=registry, device="cpu"),
        port=0, batch_max=4, feedback=feedback)


QUERIES = [{"user": "u1", "num": 3}, {"user": "u2", "num": 2,
                                      "blackList": ["i0"]},
           {"user": "nobody", "num": 2}, {"user": "u5", "num": 4}]


def test_one_predict_event_per_served_query(trained):
    registry, engine, row, app_id, es = trained
    srv = _deploy(registry, engine, row, FeedbackConfig(
        event_server_ip="127.0.0.1", event_server_port=es.port,
        access_key="FB"))
    try:
        replies = [call(srv.port, "POST", "/queries.json", q)
                   for q in QUERIES]
        assert all(s == 200 and "prId" not in b for s, b in replies)
        assert srv._feedback.flush(30.0)
        assert srv.status()["feedback"] == {
            "sent": 4, "dropped": 0, "queued": 0,
            "dropped_by_reason": {"queue_full": 0, "send_failed": 0}}
    finally:
        srv.stop()
    predicts = list(registry.get_events().find(app_id,
                                               event_names=["predict"]))
    assert len(predicts) == 4 and es.ingested == {"single": 4}
    by_query = {json.dumps(e.properties["query"], sort_keys=True): e
                for e in predicts}
    for q, (_, body) in zip(QUERIES, replies):
        full = {"user": q["user"], "num": q["num"],
                "blackList": q.get("blackList"), "whiteList": None}
        e = by_query[json.dumps(full, sort_keys=True)]
        assert e.entity_type == "pio_pr" and e.target_entity_id is None
        assert e.entity_id == e.properties["prId"]
        assert len(e.entity_id) == 64
        assert e.properties["engineInstanceId"] == row.id
        assert e.properties["prediction"] == body


def test_a_dead_event_server_drops_after_the_retries(trained, monkeypatch):
    registry, engine, row, _, es = trained
    port = es.port
    es.shutdown()                           # nothing listens there now
    sends = []
    from predictionio_tpu_torch.serving import server as srv_mod
    real = srv_mod._Feedback._send
    monkeypatch.setattr(srv_mod._Feedback, "_send",
                        lambda self, data: (sends.append(1),
                                            real(self, data)))
    srv = _deploy(registry, engine, row, FeedbackConfig(
        event_server_ip="127.0.0.1", event_server_port=port,
        access_key="FB"))
    try:
        replies = [call(srv.port, "POST", "/queries.json", q)
                   for q in QUERIES[:2]]
        assert [s for s, _ in replies] == [200, 200]
        assert srv._feedback.flush(30.0)
        fb = srv.status()["feedback"]
    finally:
        srv.stop()
    assert fb["sent"] == 0 and fb["dropped_by_reason"] == {
        "queue_full": 0, "send_failed": 2}
    assert len(sends) == 2 * srv_mod._Feedback.RETRIES


def test_a_full_queue_drops_instead_of_stalling(trained, monkeypatch):
    registry, engine, row, _, es = trained
    from predictionio_tpu_torch.serving import server as srv_mod
    gate = __import__("threading").Event()
    monkeypatch.setattr(srv_mod._Feedback, "_send",
                        lambda self, data: gate.wait(30))
    monkeypatch.setattr(srv_mod._Feedback, "QUEUE_MAX", 1)
    srv = _deploy(registry, engine, row, FeedbackConfig(
        event_server_ip="127.0.0.1", event_server_port=es.port))
    try:
        t0 = time.perf_counter()
        for q in QUERIES:
            assert call(srv.port, "POST", "/queries.json", q)[0] == 200
        assert time.perf_counter() - t0 < 20
        gate.set()
        assert srv._feedback.flush(30.0)
        fb = srv.status()["feedback"]
    finally:
        gate.set()
        srv.stop()
    # one in the worker's hands, one queued, the rest dropped
    assert fb["sent"] + fb["dropped"] == 4
    assert fb["dropped_by_reason"]["queue_full"] >= 2


def test_a_tick_over_only_predict_events_is_noop(trained):
    registry, engine, row, app_id, es = trained
    srv = _deploy(registry, engine, row, FeedbackConfig(
        event_server_ip="127.0.0.1", event_server_port=es.port,
        access_key="FB"))
    try:
        refresher = Refresher(srv, interval_s=999.0)
        assert refresher.tick() == "baseline"
        before = srv.deployment
        for q in QUERIES:
            call(srv.port, "POST", "/queries.json", q)
        assert srv._feedback.flush(30.0)
        wm = registry.get_events().ingest_watermark(app_id)
        assert wm != refresher.status()["watermark"]
        assert refresher.tick() == "noop"
        assert refresher.status()["watermark"] == wm
        assert srv.deployment is before
        assert refresher.ticks == {"baseline": 1, "noop": 1}
    finally:
        srv.stop()
