"""Engine: named maps of the serving components.

The port of the part of `predictionio_tpu/core/engine.py` that deploy
needs: the algorithm and serving class maps and `make_components`.
Data sources, preparators, train and eval come with the training slice.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Type

from predictionio_tpu_torch.core.base import Algorithm, Serving
from predictionio_tpu_torch.core.params import EngineParams, Params


class Engine:
    """Named maps of component classes (Engine.scala:101-155). Pass a
    class instead of a map and it is registered under ''."""

    def __init__(self,
                 algorithms: "Mapping[str, Type[Algorithm]] | Type[Algorithm]",
                 serving: "Mapping[str, Type[Serving]] | Type[Serving]"):
        self.algorithm_classes = self._as_map(algorithms)
        self.serving_classes = self._as_map(serving)

    @staticmethod
    def _as_map(x) -> Dict[str, type]:
        if isinstance(x, Mapping):
            return dict(x)
        return {"": x}

    @staticmethod
    def _doer(table: Mapping[str, type], kind: str,
              name_params: Tuple[str, Params]):
        name, params = name_params
        if name not in table:
            raise KeyError(
                f"{kind} '{name}' is not registered in this engine; "
                f"available: {sorted(table)}")
        return table[name](params)

    def make_components(self, engine_params: EngineParams
                        ) -> Tuple[List[Algorithm], Serving]:
        algos = [self._doer(self.algorithm_classes, "Algorithm", ap)
                 for ap in engine_params.algorithm_params_list]
        if not algos:
            raise ValueError("EngineParams specifies no algorithms")
        serving = self._doer(self.serving_classes, "Serving",
                             engine_params.serving_params)
        return algos, serving


class EngineFactory:
    """Subclass and override `apply()` to return an Engine
    (controller/EngineFactory.scala)."""

    @classmethod
    def apply(cls) -> Engine:
        raise NotImplementedError
