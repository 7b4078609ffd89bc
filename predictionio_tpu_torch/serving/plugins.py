"""Engine-server plugins.

The port of `predictionio_tpu/serving/plugins.py` (reference
`core/.../workflow/EngineServerPlugin.scala`,
`EngineServerPluginContext.scala:40-91`): output *blockers* run on the
serve path and may rewrite or veto a prediction; output *sniffers*
observe (query, prediction) pairs on a worker thread. A prediction
server lists them on `/plugins.json` and routes `/plugins/<name>/...`
to a plugin's `handle_rest`.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


@dataclass(frozen=True)
class QueryInfo:
    engine_variant: str
    query: Any
    prediction: Any


class EngineServerPlugin:
    plugin_name: str = "plugin"
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    def process(self, info: QueryInfo,
                context: "EngineServerPluginContext") -> Any:
        """Blockers: return a (possibly rewritten) prediction or raise to
        veto. Sniffers: observe; return value ignored."""
        return info.prediction

    def handle_rest(self, args: Sequence[str]) -> dict:
        return {}


class EngineServerPluginContext:
    def __init__(self, plugins: Optional[Sequence[EngineServerPlugin]] = None):
        self.output_blockers: Dict[str, EngineServerPlugin] = {}
        self.output_sniffers: Dict[str, EngineServerPlugin] = {}
        self._queue: "queue.Queue[QueryInfo]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        for p in plugins or ():
            self.register(p)

    def register(self, plugin: EngineServerPlugin) -> None:
        if plugin.plugin_type == OUTPUT_BLOCKER:
            self.output_blockers[plugin.plugin_name] = plugin
        else:
            self.output_sniffers[plugin.plugin_name] = plugin
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._drain, daemon=True,
                    name="pio-torch-plugin-drain")
                self._worker.start()

    def _drain(self) -> None:
        while True:
            info = self._queue.get()
            for sniffer in list(self.output_sniffers.values()):
                try:
                    sniffer.process(info, self)
                except Exception:
                    pass  # sniffers must never break serving

    def run_blockers(self, info: QueryInfo) -> Any:
        """Fold the prediction through every blocker
        (CreateServer.scala:578-582)."""
        prediction = info.prediction
        for blocker in self.output_blockers.values():
            prediction = blocker.process(
                QueryInfo(info.engine_variant, info.query, prediction), self)
        return prediction

    def notify_sniffers(self, info: QueryInfo) -> None:
        if self.output_sniffers:
            self._queue.put(info)

    def describe(self) -> dict:
        def desc(plugins):
            return {name: {"description": p.plugin_description,
                           "class": type(p).__module__ + "." + type(p).__name__}
                    for name, p in plugins.items()}
        return {"plugins": {"outputblockers": desc(self.output_blockers),
                            "outputsniffers": desc(self.output_sniffers)}}
