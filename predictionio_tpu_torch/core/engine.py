"""Engine: named maps of the DASE component classes.

The port of `predictionio_tpu/core/engine.py`: the component class maps,
`make_components`, `train` (the sequential per-algorithm loop with phase
timings, the sanity checks and the stop-after flags of the run's
`WorkflowParams`, Engine.scala:643-708), the engine.json variant ->
`EngineParams` extraction (Engine.scala:357-420), `eval` (the folds x
algorithms loop, Engine.scala:730-820) and `bind_serving_context`.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Type

from predictionio_tpu_torch.core.base import (
    Algorithm, DataSource, Preparator, Serving, StopAfterPrepareInterruption,
    StopAfterReadInterruption, sanity_check)
from predictionio_tpu_torch.core.params import (EngineParams, Params,
                                                ParamsError, extract_params)
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.ingest.pipeline import take_phase_timings


class Engine:
    """Named maps of component classes (Engine.scala:101-155). Pass a
    class instead of a map and it is registered under ''."""

    def __init__(self,
                 data_source: "Mapping[str, Type[DataSource]] | Type[DataSource]",
                 preparator: "Mapping[str, Type[Preparator]] | Type[Preparator]",
                 algorithms: "Mapping[str, Type[Algorithm]] | Type[Algorithm]",
                 serving: "Mapping[str, Type[Serving]] | Type[Serving]"):
        self.data_source_classes = self._as_map(data_source)
        self.preparator_classes = self._as_map(preparator)
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
                        ) -> Tuple[DataSource, Preparator, List[Algorithm],
                                   Serving]:
        ds = self._doer(self.data_source_classes, "DataSource",
                        engine_params.data_source_params)
        prep = self._doer(self.preparator_classes, "Preparator",
                          engine_params.preparator_params)
        algos = [self._doer(self.algorithm_classes, "Algorithm", ap)
                 for ap in engine_params.algorithm_params_list]
        if not algos:
            raise ValueError("EngineParams specifies no algorithms")
        serving = self._doer(self.serving_classes, "Serving",
                             engine_params.serving_params)
        return ds, prep, algos, serving

    def train(self, ctx: RuntimeContext,
              engine_params: EngineParams) -> List[Any]:
        """Read, prepare, then train each algorithm in turn; returns one
        model per algorithm. `ctx.phase_timings` gets read_s (split into
        the ingest stages when the data source scanned the store),
        prepare_s and train_algo{i}_s beside what the trainers record
        there. The run's `WorkflowParams` may skip the sanity checks or
        stop after the read or the prepare (`StopAfterReadInterruption`,
        `StopAfterPrepareInterruption`)."""
        ds, prep, algos, _ = self.make_components(engine_params)
        bind_serving_context(algos, ctx)
        wp = ctx.workflow_params
        check = (lambda obj: None) if wp.skip_sanity_check else sanity_check
        tm = ctx.phase_timings
        tm.clear()   # a reused context must not leak a previous run's
        # phases into this run's record
        take_phase_timings()   # nor a previous read's ingest stages
        t0 = time.perf_counter()
        td = ds.read_training(ctx)
        tm["read_s"] = round(time.perf_counter() - t0, 4)
        tm.update({k: round(v, 4) for k, v in take_phase_timings().items()})
        check(td)
        if wp.stop_after_read:
            raise StopAfterReadInterruption()
        t0 = time.perf_counter()
        pd = prep.prepare(ctx, td)
        tm["prepare_s"] = round(time.perf_counter() - t0, 4)
        check(pd)
        if wp.stop_after_prepare:
            raise StopAfterPrepareInterruption()
        models = []
        for i, algo in enumerate(algos):
            t0 = time.perf_counter()
            model = algo.train(ctx, pd)
            tm[f"train_algo{i}_s"] = round(time.perf_counter() - t0, 4)
            check(model)
            models.append(model)
        return models

    def eval(self, ctx: RuntimeContext, engine_params: EngineParams
             ) -> List[Tuple[Any, Sequence[Tuple[Any, Any, Any]]]]:
        """[(eval info, [(query, prediction, actual)])] per fold of the
        data source's `read_eval`: per fold prepare, train every
        algorithm (on `ctx.device`), `batch_predict` the fold's queries
        and serve them; predictions joined by query index (union +
        groupByKey in the reference, Engine.scala:790-796)."""
        ds, prep, algos, serving = self.make_components(engine_params)
        bind_serving_context(algos, ctx)
        out = []
        for td, eval_info, qa_pairs in ds.read_eval(ctx):
            pd = prep.prepare(ctx, td)
            models = [a.train(ctx, pd) for a in algos]
            queries = [(i, serving.supplement(q))
                       for i, (q, _) in enumerate(qa_pairs)]
            per_algo = [dict(a.batch_predict(m, queries))
                        for a, m in zip(algos, models)]
            out.append((eval_info, [
                (q, serving.serve(q, [pa[i] for pa in per_algo]), a)
                for i, (q, a) in enumerate(qa_pairs)]))
        return out

    def engine_params_from_variant(self, variant: "Mapping | str"
                                   ) -> EngineParams:
        """An engine.json variant (parsed, or its JSON text) as
        `EngineParams`; unknown keys and unregistered names raise
        `ParamsError`."""
        if isinstance(variant, str):
            variant = json.loads(variant)
        known_top = {"id", "description", "engineFactory", "engine_factory",
                     "datasource", "preparator", "algorithms", "serving",
                     "sparkConf", "runtimeConf", "runtime_conf"}
        unknown_top = set(variant) - known_top
        if unknown_top:
            raise ParamsError(
                f"$: unknown engine variant key(s) {sorted(unknown_top)}; "
                f"known: {sorted(known_top)}")

        def one(table, kind, node) -> Tuple[str, Params]:
            if node is None:
                name = ""
                params_json: Any = {}
            else:
                bad = set(node) - {"name", "params"}
                if bad:
                    raise ParamsError(
                        f"$.{kind.lower()}: unknown key(s) {sorted(bad)}; "
                        "component nodes take only 'name' and 'params'")
                name = node.get("name", "")
                params_json = node.get("params", {})
            if name not in table:
                if len(table) == 1 and name == "":
                    name = next(iter(table))
                else:
                    raise ParamsError(
                        f"{kind} '{name}' not registered; "
                        f"available: {sorted(table)}")
            cls = table[name]
            pcls = getattr(cls, "params_class", None)
            if pcls is None:
                raise ParamsError(f"{kind} {cls.__name__} has no params_class")
            return name, extract_params(pcls, params_json, f"$.{kind.lower()}")

        algo_nodes = variant.get("algorithms") or []
        if not algo_nodes:
            # a single unnamed algorithm with default params
            algo_nodes = [{"name": "", "params": {}}]
        return EngineParams(
            data_source_params=one(self.data_source_classes, "Datasource",
                                   variant.get("datasource")),
            preparator_params=one(self.preparator_classes, "Preparator",
                                  variant.get("preparator")),
            algorithm_params_list=tuple(
                one(self.algorithm_classes, "Algorithm", n)
                for n in algo_nodes),
            serving_params=one(self.serving_classes, "Serving",
                               variant.get("serving")),
        )


def bind_serving_context(algos, ctx: RuntimeContext) -> None:
    """Give each algorithm with a `with_serving_context(ctx)` hook the
    run's context: algorithms that read the event store at serve time
    (e-commerce constraint events, ECommAlgorithm.scala:331-430) read it
    through the context they were bound to. Called on every path that
    runs predict: `Engine.train`, `Engine.eval`, eval's prefix-cached
    loop and `CoreWorkflow.prepare_deploy`."""
    for algo in algos:
        hook = getattr(algo, "with_serving_context", None)
        if callable(hook):
            hook(ctx)


class EngineFactory:
    """Subclass and override `apply()` to return an Engine
    (controller/EngineFactory.scala)."""

    @classmethod
    def apply(cls) -> Engine:
        raise NotImplementedError
