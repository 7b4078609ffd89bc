"""Webhook connectors.

The port of `predictionio_tpu/data/webhooks/connectors.py`.

- `JsonConnector` / `FormConnector` protocols: reference
  `data/.../webhooks/JsonConnector.scala` / `FormConnector.scala`.
- `SegmentIOConnector`: reference
  `data/.../webhooks/segmentio/SegmentIOConnector.scala` — maps the six
  Segment message types (identify/track/alias/page/screen/group) to events
  on entityType "user" keyed by user_id (falling back to anonymous_id).
- `MailChimpConnector`: reference
  `data/.../webhooks/mailchimp/MailChimpConnector.scala` — maps the six
  MailChimp webhook form types (subscribe/unsubscribe/profile/upemail/
  cleaned/campaign) to user->list events with 'yyyy-MM-dd HH:mm:ss' UTC
  `fired_at` timestamps converted to ISO8601.
"""

from __future__ import annotations

import abc
from datetime import datetime, timezone
from typing import Any, Dict, Mapping

from predictionio_tpu_torch.data.event import Event, format_time


class ConnectorException(Exception):
    """Parity: webhooks/ConnectorException.scala."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        """Convert a JSON webhook payload into event API JSON."""


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> Dict[str, Any]:
        """Convert form-encoded webhook fields into event API JSON."""


def connector_to_event(connector, data) -> Event:
    """Parity: ConnectorUtil.toEvent — convert then parse/validate."""
    return Event.from_api_json(connector.to_event_json(data))


# ---------------------------------------------------------------------------
# Segment.io
# ---------------------------------------------------------------------------

class SegmentIOConnector(JsonConnector):
    SUPPORTED = {"identify", "track", "alias", "page", "screen", "group"}

    def to_event_json(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        try:
            typ = data["type"]
        except KeyError:
            raise ConnectorException(
                "Cannot convert payload without a `type` field to event JSON.")
        if typ not in self.SUPPORTED:
            raise ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON.")

        user_id = data.get("user_id") or data.get("userId") \
            or data.get("anonymous_id") or data.get("anonymousId")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields.")
        timestamp = data.get("timestamp")
        if not timestamp:
            raise ConnectorException(
                "Cannot convert the payload: missing `timestamp`.")

        # per-type event properties (SegmentIOConnector.scala:105-146)
        props: Dict[str, Any] = {}
        if typ == "identify":
            props["traits"] = data.get("traits")
        elif typ == "track":
            props["properties"] = data.get("properties")
            props["event"] = data.get("event")
        elif typ == "alias":
            props["previous_id"] = data.get("previous_id") or data.get("previousId")
        elif typ in ("page", "screen"):
            props["name"] = data.get("name")
            props["properties"] = data.get("properties")
        elif typ == "group":
            props["group_id"] = data.get("group_id") or data.get("groupId")
            props["traits"] = data.get("traits")
        if data.get("context") is not None:
            props["context"] = data["context"]
        props = {k: v for k, v in props.items() if v is not None}

        return {
            "event": typ,
            "entityType": "user",
            "entityId": user_id,
            "eventTime": timestamp,
            "properties": props,
        }


# ---------------------------------------------------------------------------
# MailChimp
# ---------------------------------------------------------------------------

def _mailchimp_time(s: str) -> str:
    """'yyyy-MM-dd HH:mm:ss' in UTC -> ISO8601 (MailChimpConnector.scala:59-65)."""
    try:
        dt = datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(
            tzinfo=timezone.utc)
    except ValueError as e:
        raise ConnectorException(f"Cannot parse MailChimp time {s!r}: {e}")
    return format_time(dt)


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: Mapping[str, str]) -> Dict[str, Any]:
        typ = data.get("type")
        if typ is None:
            raise ConnectorException(
                "The field 'type' is required for MailChimp data.")
        handler = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }.get(typ)
        if handler is None:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp data type {typ} to event JSON")
        try:
            return handler(data)
        except KeyError as e:
            raise ConnectorException(
                f"Missing required MailChimp field: {e.args[0]}")

    @staticmethod
    def _merges(data: Mapping[str, str]) -> Dict[str, Any]:
        merges = {
            "EMAIL": data["data[merges][EMAIL]"],
            "FNAME": data["data[merges][FNAME]"],
            "LNAME": data["data[merges][LNAME]"],
        }
        if "data[merges][INTERESTS]" in data:
            merges["INTERESTS"] = data["data[merges][INTERESTS]"]
        return merges

    def _subscribe(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "subscribe", "entityType": "user",
            "entityId": d["data[id]"],
            "targetEntityType": "list", "targetEntityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "email": d["data[email]"],
                "email_type": d["data[email_type]"],
                "merges": self._merges(d),
                "ip_opt": d["data[ip_opt]"],
                "ip_signup": d["data[ip_signup]"],
            },
        }

    def _unsubscribe(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "unsubscribe", "entityType": "user",
            "entityId": d["data[id]"],
            "targetEntityType": "list", "targetEntityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "action": d["data[action]"],
                "reason": d["data[reason]"],
                "email": d["data[email]"],
                "email_type": d["data[email_type]"],
                "merges": self._merges(d),
                "ip_opt": d["data[ip_opt]"],
                "campaign_id": d["data[campaign_id]"],
            },
        }

    def _profile(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "profile", "entityType": "user",
            "entityId": d["data[id]"],
            "targetEntityType": "list", "targetEntityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "email": d["data[email]"],
                "email_type": d["data[email_type]"],
                "merges": self._merges(d),
                "ip_opt": d["data[ip_opt]"],
            },
        }

    def _upemail(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "upemail", "entityType": "user",
            "entityId": d["data[new_id]"],
            "targetEntityType": "list", "targetEntityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "new_email": d["data[new_email]"],
                "old_email": d["data[old_email]"],
            },
        }

    def _cleaned(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "cleaned", "entityType": "list",
            "entityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "campaignId": d["data[campaign_id]"],
                "reason": d["data[reason]"],
                "email": d["data[email]"],
            },
        }

    def _campaign(self, d: Mapping[str, str]) -> Dict[str, Any]:
        return {
            "event": "campaign", "entityType": "campaign",
            "entityId": d["data[id]"],
            "targetEntityType": "list", "targetEntityId": d["data[list_id]"],
            "eventTime": _mailchimp_time(d["fired_at"]),
            "properties": {
                "subject": d["data[subject]"],
                "status": d["data[status]"],
                "reason": d["data[reason]"],
            },
        }


# dispatch table (api/WebhooksConnectors.scala)
JSON_CONNECTORS: Dict[str, JsonConnector] = {"segmentio": SegmentIOConnector()}
FORM_CONNECTORS: Dict[str, FormConnector] = {"mailchimp": MailChimpConnector()}
