"""Event-server plugin framework.

The port of `predictionio_tpu/data/plugins.py`. Parity: reference
`data/.../api/EventServerPlugin.scala` +
`EventServerPluginContext.scala` + `PluginsActor.scala` — input *blockers*
run synchronously on the ingest path and may veto an event by raising;
input *sniffers* observe asynchronously (here: a daemon worker thread
draining a queue, the actor-mailbox analog).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from predictionio_tpu_torch.data.event import Event

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


@dataclass(frozen=True)
class EventInfo:
    app_id: int
    channel_id: Optional[int]
    event: Event


class EventServerPlugin:
    """Subclass and register with an EventServerPluginContext."""

    plugin_name: str = "plugin"
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    def process(self, event_info: EventInfo,
                context: "EventServerPluginContext") -> None:
        """Blockers: raise to veto. Sniffers: observe."""

    def handle_rest(self, app_id: int, channel_id: Optional[int],
                    args: Sequence[str]) -> dict:
        return {}


class EventServerPluginContext:
    """Holds registered plugins; runs sniffers on a background thread."""

    def __init__(self, plugins: Optional[Sequence[EventServerPlugin]] = None):
        self.input_blockers: Dict[str, EventServerPlugin] = {}
        self.input_sniffers: Dict[str, EventServerPlugin] = {}
        self._queue: "queue.Queue[EventInfo]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        for p in plugins or ():
            self.register(p)

    def register(self, plugin: EventServerPlugin) -> None:
        if plugin.plugin_type == INPUT_BLOCKER:
            self.input_blockers[plugin.plugin_name] = plugin
        else:
            self.input_sniffers[plugin.plugin_name] = plugin
            self._ensure_worker()

    def _ensure_worker(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(target=self._drain, daemon=True,
                                            name="pio-torch-plugin-drain")
            self._worker.start()

    def _drain(self) -> None:
        while True:
            info = self._queue.get()
            for sniffer in list(self.input_sniffers.values()):
                try:
                    sniffer.process(info, self)
                except Exception:
                    pass  # sniffers must never break ingestion

    # -- ingest-path hooks --------------------------------------------------
    def run_blockers(self, info: EventInfo) -> None:
        """Raises if any blocker vetoes (EventServer.scala:275-279)."""
        for blocker in self.input_blockers.values():
            blocker.process(info, self)

    def notify_sniffers(self, info: EventInfo) -> None:
        if self.input_sniffers:
            self._queue.put(info)

    def describe(self) -> dict:
        def desc(plugins: Dict[str, EventServerPlugin]) -> dict:
            return {n: {"name": p.plugin_name,
                        "description": p.plugin_description,
                        "class": type(p).__module__ + "." + type(p).__name__}
                    for n, p in plugins.items()}
        return {"plugins": {
            "inputblockers": desc(self.input_blockers),
            "inputsniffers": desc(self.input_sniffers),
        }}
