"""The Event Server: the REST collection plane for events.

The port of `predictionio_tpu/data/eventserver.py` (reference
`data/.../api/EventServer.scala:54-663`), with its routes, status codes,
auth and error messages:

  GET    /                      -> {"status": "alive"}
  GET    /health, /ready        -> liveness / readiness (utils.http base)
  GET    /plugins.json          -> plugin descriptions
  GET    /plugins/<type>/<name>/... -> plugin REST handler
  POST   /events.json           -> 201 {"eventId": id}
  GET    /events.json           -> filtered query (default limit 20)
  GET    /events/<id>.json      -> one event
  DELETE /events/<id>.json      -> {"message": "Found"/"Not Found"}
  POST   /batch/events.json     -> per-event statuses, max 50
  GET    /stats.json            -> hourly stats (requires stats=True)
  POST/GET /webhooks/<name>.json  -> JSON webhook connectors
  POST/GET /webhooks/<name>.form  -> form webhook connectors

Auth: `accessKey` query param, or HTTP Basic with the key as username
(EventServer.scala:92-130); an optional `channel` query param resolves a
channel by name within the key's app. A key with an event list refuses
other events with 403.

Every accepted event is one `EventStore.insert`, a batch's too, as in
the JAX package: each item of `/batch/events.json` gets its own status,
and one bad item fails none of the others. `ingested` counts the
accepted events by surface (single, batch, webhook), as
`pio_events_ingested_total{via}` does on `/metrics`, beside the
`pio_ingest_payload_bytes` histogram of request bodies. The server runs
on the HTTP base's wire (the selector wire unless `PIO_SERVE_WIRE=
threaded`) and honours `X-PIO-Deadline-Ms`.

Not ported yet: the startup `fsck` sweep and the readiness on storage
circuit breakers (ROADMAP.md, Queue 1 item 4; readiness is always
true).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence
from urllib.parse import parse_qs

from predictionio_tpu_torch.data.event import Event, parse_time
from predictionio_tpu_torch.data.plugins import (
    INPUT_BLOCKER, INPUT_SNIFFER, EventInfo, EventServerPlugin,
    EventServerPluginContext)
from predictionio_tpu_torch.data.stats import Stats
from predictionio_tpu_torch.data.storage import (StorageRegistry,
                                                 StorageWriteError, storage)
from predictionio_tpu_torch.data.webhooks import (FORM_CONNECTORS,
                                                  JSON_CONNECTORS)
from predictionio_tpu_torch.data.webhooks.connectors import (
    ConnectorException, connector_to_event)
from predictionio_tpu_torch.obs import MetricsRegistry
from predictionio_tpu_torch.utils.http import (HTTPError, HTTPServerBase,
                                               Request, Response,
                                               parse_basic_auth_user)

MAX_EVENTS_PER_BATCH_REQUEST = 50  # EventServer.scala:70
DEFAULT_QUERY_LIMIT = 20           # EventServer.scala:353
PAYLOAD_BUCKETS = (256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
                   1048576.0)


@dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070
    plugins: Sequence[EventServerPlugin] = ()
    stats: bool = False


@dataclass(frozen=True)
class AuthData:
    app_id: int
    channel_id: Optional[int]
    events: Sequence[str]


class EventServer(HTTPServerBase):
    def __init__(self, config: Optional[EventServerConfig] = None,
                 registry: Optional[StorageRegistry] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.config = config or EventServerConfig()
        super().__init__(host=self.config.ip, port=self.config.port,
                         metrics=metrics)
        self.registry = registry or storage()
        self.event_client = self.registry.get_events()
        self.access_keys_client = self.registry.get_meta_data_access_keys()
        self.channels_client = self.registry.get_meta_data_channels()
        self.stats = Stats()
        self.plugin_context = EventServerPluginContext(self.config.plugins)
        self._count_lock = threading.Lock()
        # accepted events by ingest surface: single, batch, webhook
        self.ingested: Dict[str, int] = {}
        self._ingest_counter = self.metrics.counter(
            "pio_events_ingested_total",
            "Events accepted into storage, by ingest surface",
            labels=("via",))
        self._payload_hist = self.metrics.histogram(
            "pio_ingest_payload_bytes",
            "Ingest request payload size in bytes",
            buckets=PAYLOAD_BUCKETS)
        self._install_routes()

    # -- auth ---------------------------------------------------------------
    def _auth(self, req: Request) -> AuthData:
        """EventServer.scala:92-130 withAccessKey."""
        key = req.query_get("accessKey")
        channel_name = req.query_get("channel")
        if key is None:
            key = parse_basic_auth_user(req.headers)
            if key is None:
                raise HTTPError(401, "Missing accessKey.")
        ak = self.access_keys_client.get(key)
        if ak is None:
            raise HTTPError(401, "Invalid accessKey.")
        channel_id = None
        if channel_name is not None:
            channel_map = {c.name: c.id for c in
                           self.channels_client.get_by_appid(ak.appid)}
            if channel_name not in channel_map:
                raise HTTPError(401, f"Invalid channel '{channel_name}'.")
            channel_id = channel_map[channel_name]
        return AuthData(ak.appid, channel_id, ak.events)

    # -- ingestion ------------------------------------------------------------
    def _ingest(self, event: Event, auth: AuthData,
                via: str = "single") -> str:
        info = EventInfo(auth.app_id, auth.channel_id, event)
        self.plugin_context.run_blockers(info)
        try:
            event_id = self.event_client.insert(
                event, auth.app_id, auth.channel_id)
        except StorageWriteError as e:
            # a rejected write (a duplicate explicit eventId) is a client
            # error on every surface: single, batch and webhooks
            raise HTTPError(400, str(e))
        self.plugin_context.notify_sniffers(info)
        with self._count_lock:
            self.ingested[via] = self.ingested.get(via, 0) + 1
        self._ingest_counter.labels(via=via).inc()
        if self.config.stats:
            self.stats.bookkeeping(auth.app_id, 201, event)
        return event_id

    # -- routes -------------------------------------------------------------
    def _install_routes(self) -> None:
        r = self.router

        @r.get("/")
        def index(req: Request) -> Response:
            return Response.json({"status": "alive"})

        @r.get("/plugins.json")
        def plugins_json(req: Request) -> Response:
            return Response.json(self.plugin_context.describe())

        def _plugin_rest(req: Request) -> Response:
            auth = self._auth(req)
            ptype, pname = req.params["ptype"], req.params["pname"]
            args = [a for a in req.params.get("args", "").split("/") if a]
            table = {INPUT_BLOCKER: self.plugin_context.input_blockers,
                     INPUT_SNIFFER: self.plugin_context.input_sniffers}
            if ptype not in table or pname not in table[ptype]:
                raise HTTPError(404, f"Unknown plugin {ptype}/{pname}")
            return Response.json(table[ptype][pname].handle_rest(
                auth.app_id, auth.channel_id, args))

        r.get("/plugins/<ptype>/<pname>")(_plugin_rest)
        r.get("/plugins/<ptype>/<pname>/<args:path>")(_plugin_rest)

        @r.post("/events.json")
        def post_event(req: Request) -> Response:
            auth = self._auth(req)
            self._payload_hist.observe(float(len(req.body)))
            event = Event.from_api_json(req.json())
            if auth.events and event.event not in auth.events:
                return Response.json(
                    {"message": f"{event.event} events are not allowed"}, 403)
            return Response.json({"eventId": self._ingest(event, auth)}, 201)

        @r.get("/events.json")
        def get_events(req: Request) -> Response:
            auth = self._auth(req)
            q = req.query
            reversed_flag = q.get("reversed", "false").lower() == "true"
            if reversed_flag and not (q.get("entityType")
                                      and q.get("entityId")):
                raise HTTPError(
                    400, "the parameter reversed can only be used with both "
                         "entityType and entityId specified.")
            limit = int(q["limit"]) if "limit" in q else DEFAULT_QUERY_LIMIT
            kwargs = {}
            if "targetEntityType" in q:
                kwargs["target_entity_type"] = q["targetEntityType"]
            if "targetEntityId" in q:
                kwargs["target_entity_id"] = q["targetEntityId"]
            events = list(self.event_client.find(
                auth.app_id, auth.channel_id,
                start_time=(parse_time(q["startTime"])
                            if "startTime" in q else None),
                until_time=(parse_time(q["untilTime"])
                            if "untilTime" in q else None),
                entity_type=q.get("entityType"),
                entity_id=q.get("entityId"),
                event_names=[q["event"]] if "event" in q else None,
                limit=limit, reversed=reversed_flag, **kwargs))
            if not events:
                return Response.json({"message": "Not Found"}, 404)
            return Response.json([e.to_api_json() for e in events])

        @r.get("/events/<event_id>.json")
        def get_event(req: Request) -> Response:
            auth = self._auth(req)
            event = self.event_client.get(
                req.params["event_id"], auth.app_id, auth.channel_id)
            if event is None:
                return Response.json({"message": "Not Found"}, 404)
            return Response.json(event.to_api_json())

        @r.delete("/events/<event_id>.json")
        def delete_event(req: Request) -> Response:
            auth = self._auth(req)
            found = self.event_client.delete(
                req.params["event_id"], auth.app_id, auth.channel_id)
            if found:
                return Response.json({"message": "Found"})
            return Response.json({"message": "Not Found"}, 404)

        @r.post("/batch/events.json")
        def post_batch(req: Request) -> Response:
            auth = self._auth(req)
            self._payload_hist.observe(float(len(req.body)))
            payload = req.json()
            if not isinstance(payload, list):
                raise HTTPError(400,
                                "Batch request body must be a JSON array")
            if len(payload) > MAX_EVENTS_PER_BATCH_REQUEST:
                raise HTTPError(
                    400, "Batch request must have less than or equal to "
                         f"{MAX_EVENTS_PER_BATCH_REQUEST} events")
            results = []
            for item in payload:
                try:
                    event = Event.from_api_json(item)
                except (ValueError, TypeError) as e:
                    results.append({"status": 400, "message": str(e)})
                    continue
                if auth.events and event.event not in auth.events:
                    results.append({
                        "status": 403,
                        "message": f"{event.event} events are not allowed"})
                    continue
                try:
                    event_id = self._ingest(event, auth, via="batch")
                    results.append({"status": 201, "eventId": event_id})
                except HTTPError as e:
                    results.append({"status": e.status,
                                    "message": e.message})
                except Exception as e:  # noqa: BLE001 — per-item status
                    results.append({"status": 500, "message": str(e)})
            return Response.json(results)

        @r.get("/stats.json")
        def stats_json(req: Request) -> Response:
            auth = self._auth(req)
            if not self.config.stats:
                return Response.json(
                    {"message": "To see stats, launch Event Server with "
                                "--stats argument."}, 404)
            return Response.json(self.stats.get_stats(auth.app_id))

        def _unsupported(name: str) -> Response:
            return Response.json(
                {"message": f"webhooks connection for {name} is not "
                            "supported."}, 404)

        @r.post("/webhooks/<name>.json")
        def webhook_json(req: Request) -> Response:
            auth = self._auth(req)
            self._payload_hist.observe(float(len(req.body)))
            connector = JSON_CONNECTORS.get(req.params["name"])
            if connector is None:
                return _unsupported(req.params["name"])
            try:
                event = connector_to_event(connector, req.json())
            except ConnectorException as e:
                raise HTTPError(400, str(e))
            return Response.json(
                {"eventId": self._ingest(event, auth, via="webhook")}, 201)

        @r.get("/webhooks/<name>.json")
        def webhook_json_get(req: Request) -> Response:
            self._auth(req)
            if req.params["name"] in JSON_CONNECTORS:
                return Response.json({"message": "Ok"})
            return _unsupported(req.params["name"])

        @r.post("/webhooks/<name>.form")
        def webhook_form(req: Request) -> Response:
            auth = self._auth(req)
            self._payload_hist.observe(float(len(req.body)))
            connector = FORM_CONNECTORS.get(req.params["name"])
            if connector is None:
                return _unsupported(req.params["name"])
            fields = {k: v[0] for k, v in
                      parse_qs(req.body.decode("utf-8"),
                               keep_blank_values=True).items()}
            try:
                event = connector_to_event(connector, fields)
            except ConnectorException as e:
                raise HTTPError(400, str(e))
            return Response.json(
                {"eventId": self._ingest(event, auth, via="webhook")}, 201)

        @r.get("/webhooks/<name>.form")
        def webhook_form_get(req: Request) -> Response:
            self._auth(req)
            if req.params["name"] in FORM_CONNECTORS:
                return Response.json({"message": "Ok"})
            return _unsupported(req.params["name"])


def create_event_server(config: Optional[EventServerConfig] = None,
                        registry: Optional[StorageRegistry] = None,
                        background: bool = True) -> EventServer:
    """EventServer.createEventServer (EventServer.scala:632-654)."""
    server = EventServer(config, registry)
    server.start(background=background)
    return server
