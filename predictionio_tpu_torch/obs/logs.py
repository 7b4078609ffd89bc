"""Structured JSON logging with request ids.

The port of `predictionio_tpu/obs/logs.py`: one log line per event,
each a single JSON object on stderr (ts, level, component, event, plus
the event's fields; an HTTP request line adds request_id, method, path,
route, status, duration_ms; an error adds error and traceback). Built
on the standard logging tree ("pio.torch.obs.<component>"), so tests
capture it through caplog; the level honours PIO_OBS_LOG_LEVEL
(default INFO).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import traceback
import uuid
from datetime import datetime, timezone
from typing import Dict

_ROOT_NAME = "pio.torch.obs"
_setup_lock = threading.Lock()
_loggers: Dict[str, "StructuredLogger"] = {}


def new_request_id() -> str:
    """A fresh 16-hex-char request id (assigned by the HTTP middleware
    when the client did not send X-Request-ID)."""
    return uuid.uuid4().hex[:16]


def _ensure_root() -> logging.Logger:
    root = logging.getLogger(_ROOT_NAME)
    with _setup_lock:
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(message)s"))
            root.addHandler(handler)
            level = os.environ.get("PIO_OBS_LOG_LEVEL", "INFO").upper()
            root.setLevel(getattr(logging, level, logging.INFO))
    return root


class StructuredLogger:
    """Emits one JSON object per call through the stdlib logging tree."""

    def __init__(self, component: str):
        self.component = component
        _ensure_root()
        self._logger = logging.getLogger(f"{_ROOT_NAME}.{component}")

    def _emit(self, level: int, event: str, fields: dict) -> None:
        record = {
            "ts": datetime.now(timezone.utc).isoformat(
                timespec="milliseconds"),
            "level": logging.getLevelName(level).lower(),
            "component": self.component,
            "event": event,
        }
        record.update(fields)
        self._logger.log(level, json.dumps(record, default=str))

    def info(self, event: str, **fields) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit(logging.ERROR, event, fields)

    def exception(self, event: str, **fields) -> None:
        """error() + the current exception's traceback as a field."""
        fields.setdefault("traceback", traceback.format_exc())
        self._emit(logging.ERROR, event, fields)


def get_logger(component: str) -> StructuredLogger:
    # no lock around construction (StructuredLogger takes _setup_lock
    # itself); dict get/setdefault are individually atomic
    logger = _loggers.get(component)
    if logger is None:
        _loggers.setdefault(component, StructuredLogger(component))
        logger = _loggers[component]
    return logger
