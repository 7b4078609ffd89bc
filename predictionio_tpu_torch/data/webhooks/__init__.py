"""Webhook connector framework: third-party payloads -> event JSON.

The port of `predictionio_tpu/data/webhooks/`. Parity: reference
`data/.../webhooks/{Json,Form}Connector.scala`,
`ConnectorUtil.scala`, and the dispatch table in
`data/.../api/WebhooksConnectors.scala` (segmentio JSON + mailchimp form).
"""

from predictionio_tpu_torch.data.webhooks.connectors import (
    ConnectorException, FormConnector, JsonConnector, connector_to_event,
    JSON_CONNECTORS, FORM_CONNECTORS,
)

__all__ = [
    "ConnectorException", "FormConnector", "JsonConnector",
    "connector_to_event", "JSON_CONNECTORS", "FORM_CONNECTORS",
]
