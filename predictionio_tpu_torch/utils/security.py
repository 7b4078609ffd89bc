"""Server TLS and the server key.

The port of `predictionio_tpu/utils/security.py` (reference
`common/.../configuration/SSLConfiguration.scala:32-74` and
`common/.../authentication/KeyAuthentication.scala:30-61`): PEM
certificate and key paths -> an `ssl.SSLContext` for a server, and the
optional server key that guards a prediction server's `/reload` and
`/stop`.

Config keys (the JAX names): PIO_SERVER_SSL_CERT, PIO_SERVER_SSL_KEY,
PIO_SERVER_SSL_ENFORCED, PIO_SERVER_ACCESS_KEY.
"""

from __future__ import annotations

import hmac
import ssl
from typing import Mapping, Optional

from predictionio_tpu_torch.utils.http import (HTTPError, Request,
                                               parse_basic_auth_user)


def ssl_context_from_config(cfg: Mapping[str, str]
                            ) -> Optional[ssl.SSLContext]:
    """A server SSLContext from PEM cert and key paths; None when SSL is
    not configured. Raises when SSL is enforced but not configured."""
    cert = cfg.get("PIO_SERVER_SSL_CERT")
    key = cfg.get("PIO_SERVER_SSL_KEY")
    enforced = cfg.get("PIO_SERVER_SSL_ENFORCED", "").lower() in ("1", "true")
    if not cert or not key:
        if enforced:
            raise ValueError(
                "PIO_SERVER_SSL_ENFORCED is set but PIO_SERVER_SSL_CERT/"
                "PIO_SERVER_SSL_KEY are not configured")
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile=cert, keyfile=key)
    return ctx


class KeyAuthentication:
    """The optional server key: when one is set, a request must present
    it as `?accessKey=` or as the Basic auth username, else 401."""

    def __init__(self, server_key: Optional[str] = None):
        self.server_key = server_key

    def check(self, req: Request) -> None:
        if not self.server_key:
            return
        supplied = req.query.get("accessKey") or parse_basic_auth_user(
            req.headers)
        # constant-time compare: the key gates /reload and /stop
        if not hmac.compare_digest(supplied or "", self.server_key):
            raise HTTPError(401, "Invalid accessKey.")
