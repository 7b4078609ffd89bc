"""Train and deploy orchestration around the storage registry.

The port of `predictionio_tpu/core/workflow.py`:

  - `register_engine` / `resolve_engine`: engine factories by short
    name or dotted path (WorkflowUtils.getEngine); short names import
    `predictionio_tpu_torch.models.<name>`, which registers itself;
  - `CoreWorkflow.run_train` (CoreWorkflow.scala:45-101): an INIT row,
    TRAINING with a heartbeat thread, the model blob into `Models`, then
    COMPLETED with the run's phase timings in `runtime_conf`; a failure
    marks the row FAILED and re-raises, so deploy never picks it;
  - `CoreWorkflow.prepare_deploy` (Engine.prepareDeploy, Engine.scala:
    199-269): the components made once and bound to the deploy's
    context, the instance's blob back into models through them
    (retraining the algorithms that stored a `RetrainMarker`), moved to
    the context's device, then warmed by the same algorithms;
  - `prepare_deploy` for models in hand (a model loaded from an `.npz`,
    the sharded and tiered deploys), `derive_warm_buckets`,
    `warm_deploy` and `engine_params_from_instance`.

One difference from the JAX package: a warmup failure raises. The JAX
package logs it and serves through its generic paths, which here would
hide a kernel that does not build or launch.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from predictionio_tpu_torch.core.base import Algorithm, Serving
from predictionio_tpu_torch.core.engine import (Engine, EngineFactory,
                                               bind_serving_context)
from predictionio_tpu_torch.core.params import EngineParams
from predictionio_tpu_torch.core.persistence import (deserialize_models,
                                                     serialize_models)
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data.event import utcnow
from predictionio_tpu_torch.data.storage.base import (EngineInstance,
                                                      EngineInstanceStatus,
                                                      Model)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import record_train_phases

_log = logging.getLogger("pio.torch.workflow")

# factories registered under short names (the classpath-reflection
# analog); the bundled templates register themselves on import
_ENGINE_FACTORIES: Dict[str, Any] = {}


def register_engine(name: str, factory) -> None:
    _ENGINE_FACTORIES[name] = factory


def resolve_engine(factory_name: str) -> Engine:
    """An Engine from a registered short name or a dotted path
    'package.module.FactoryClass' (WorkflowUtils.getEngine)."""
    target = _ENGINE_FACTORIES.get(factory_name)
    if target is None and "." not in factory_name:
        mod_name = f"predictionio_tpu_torch.models.{factory_name}"
        try:
            importlib.import_module(mod_name)
            target = _ENGINE_FACTORIES.get(factory_name)
        except ModuleNotFoundError as e:
            if e.name != mod_name:
                raise   # a real dependency failure inside the template
    if target is None:
        module_name, _, attr = factory_name.rpartition(".")
        if not module_name:
            raise ValueError(
                f"Unknown engine factory {factory_name!r}; registered: "
                f"{sorted(_ENGINE_FACTORIES)} (or use a dotted path)")
        if module_name.split(".", 1)[0] == "predictionio_tpu":
            # an instance the JAX package recorded in a shared store
            raise ValueError(
                f"engine factory {factory_name!r} is of the JAX package "
                "(predictionio_tpu), which the port does not load")
        target = getattr(importlib.import_module(module_name), attr)
    if isinstance(target, Engine):
        return target
    if isinstance(target, type) and issubclass(target, EngineFactory):
        return target.apply()
    if callable(target):
        result = target()
        if isinstance(result, Engine):
            return result
    raise TypeError(f"{factory_name!r} did not produce an Engine")


def _heartbeat_interval(registry) -> float:
    """`PIO_TRAIN_HEARTBEAT_S` (default 5 s); <= 0 disables the beat."""
    try:
        return float(registry.config.get("PIO_TRAIN_HEARTBEAT_S", 5.0))
    except (TypeError, ValueError):
        return 5.0


class _Heartbeat:
    """A daemon thread that refreshes an instance's liveness beat."""

    def __init__(self, instances, instance_id: str, interval_s: float):
        self._stop = threading.Event()
        self._thread = None
        if interval_s > 0:
            self._thread = threading.Thread(
                target=self._run, args=(instances, instance_id, interval_s),
                name=f"pio-torch-heartbeat-{instance_id}", daemon=True)
            self._thread.start()

    def _run(self, instances, instance_id: str, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                instances.record_heartbeat(instance_id)
            except Exception as e:  # noqa: BLE001 — a beat never kills a train
                _log.warning("heartbeat_failed instance_id=%s error=%s: %s",
                             instance_id, type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=10.0)


def _named_params_json(name_params) -> str:
    name, p = name_params
    return json.dumps({"name": name, "params": dataclasses.asdict(p)})


def _algo_params_json(engine_params: EngineParams) -> str:
    return json.dumps([{"name": name, "params": dataclasses.asdict(p)}
                       for name, p in engine_params.algorithm_params_list])


def engine_params_from_instance(engine: Engine,
                                instance: EngineInstance) -> EngineParams:
    """EngineParams from the params JSON an instance recorded
    (Engine.engineInstanceToEngineParams, Engine.scala:422-492)."""
    return engine.engine_params_from_variant({
        "datasource": json.loads(instance.data_source_params or "{}"),
        "preparator": json.loads(instance.preparator_params or "{}"),
        "algorithms": json.loads(instance.algorithms_params or "[]"),
        "serving": json.loads(instance.serving_params or "{}"),
    })


class CoreWorkflow:
    """Training and deploy with the engine-instance lifecycle."""

    @staticmethod
    def run_train(engine: Engine, engine_params: EngineParams,
                  ctx: RuntimeContext, *, engine_factory: str = "",
                  engine_variant: str = "") -> EngineInstance:
        """Train, store the models, record the instance
        (CoreWorkflow.scala:45-101). The INIT row becomes TRAINING with
        a liveness beat every `PIO_TRAIN_HEARTBEAT_S`; after the blob is
        in the model repository it becomes COMPLETED, with the run's
        `phase_timings` (plus `blob_bytes` and `store_s`) in its
        `runtime_conf`. Any failure, a stop-after interruption included,
        leaves it FAILED, so deploy refuses it (commands/Engine.scala:
        235-236), and re-raises."""
        registry = ctx.registry
        instances = registry.get_meta_data_engine_instances()
        row = EngineInstance(
            id="", status=EngineInstanceStatus.INIT,
            start_time=utcnow(), end_time=utcnow(),
            engine_id="default", engine_version="default",
            engine_variant=engine_variant or "default",
            engine_factory=engine_factory,
            batch=ctx.workflow_params.batch,
            env={}, runtime_conf=dict(ctx.workflow_params.runtime_conf),
            data_source_params=_named_params_json(
                engine_params.data_source_params),
            preparator_params=_named_params_json(
                engine_params.preparator_params),
            algorithms_params=_algo_params_json(engine_params),
            serving_params=_named_params_json(engine_params.serving_params))
        instance_id = instances.insert(row)
        row = row.with_(id=instance_id, status=EngineInstanceStatus.TRAINING,
                        heartbeat=utcnow())
        instances.update(row)
        beat = _Heartbeat(instances, instance_id,
                          _heartbeat_interval(registry))
        try:
            models = engine.train(ctx, engine_params)
            _, _, algos, _ = engine.make_components(engine_params)
            t0 = time.perf_counter()
            blob = serialize_models(instance_id, algos, models, ctx)
            registry.get_model_data_models().insert(Model(instance_id, blob))
            tm = ctx.phase_timings
            tm["store_s"] = round(time.perf_counter() - t0, 4)
            tm["blob_bytes"] = len(blob)
            # the phases' seconds into the metrics registry, where `cli
            # train`'s report and /metrics read them
            record_train_phases({k: v for k, v in tm.items()
                                 if k.endswith("_s")})
            # the beat must be down before the terminal write: a late
            # get + update beat could bring TRAINING back after COMPLETED
            beat.stop()
            row = row.with_(
                status=EngineInstanceStatus.COMPLETED, end_time=utcnow(),
                runtime_conf={**row.runtime_conf, "phase_timings": dict(tm)})
            instances.update(row)
            return row
        except BaseException as e:
            beat.stop()
            _log.error("train_failed instance_id=%s error=%s: %s",
                       instance_id, type(e).__name__, e)
            instances.update(row.with_(status=EngineInstanceStatus.FAILED,
                                       end_time=utcnow()))
            raise

    @staticmethod
    def prepare_deploy(engine: Engine, instance: EngineInstance,
                       ctx: RuntimeContext, *,
                       warm_batch_max: Optional[int] = None,
                       items_device=None, timings: Optional[dict] = None,
                       mesh=None
                       ) -> Tuple[List[Algorithm], List[Any], Serving]:
        """The instance's models, ready to serve: (algorithms, models,
        serving) (Engine.prepareDeploy; CreateServer.scala:186-244),
        with the params the instance recorded. The components are made
        once and bound to `ctx` (`bind_serving_context`): the algorithms
        that load the models are the ones that serve them. Models with
        a `to(device, items_device=...)` method move to `ctx.device`
        (None = cuda; raises without CUDA), the item master to
        `items_device` ("cpu" keeps it in host RAM); then they are
        checked and warmed as `prepare_deploy` does models in hand, over
        `mesh` (a `ServeMesh`, or a fleet member's `ShardSlice`; None
        takes `serve_mesh_from_conf()`).
        `timings`, if given, gets the wall seconds of the blob's read
        (`load_s`), the move to the device (`place_s`) and the check and
        warmup (`warm_s`)."""
        if instance.status != EngineInstanceStatus.COMPLETED:
            raise ValueError(f"engine instance {instance.id} is "
                             f"{instance.status}, not COMPLETED")
        t0 = time.perf_counter()
        engine_params = engine_params_from_instance(engine, instance)
        ds, prep, algos, serving = engine.make_components(engine_params)
        bind_serving_context(algos, ctx)
        blob_row = ctx.registry.get_model_data_models().get(instance.id)
        if blob_row is None:
            raise ValueError(f"No model blob for instance {instance.id}")

        def retrain(indices):
            # read and prepare once; train only the marker algorithms
            td = ds.read_training(ctx)
            pd = prep.prepare(ctx, td)
            return {i: algos[i].train(ctx, pd) for i in indices}

        models = deserialize_models(blob_row.models, instance.id, algos,
                                    ctx, retrain)
        t1 = time.perf_counter()
        dev = resolve_device(ctx.device)
        models = [m.to(dev, items_device=items_device)
                  if callable(getattr(m, "to", None)) else m for m in models]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        out = _ready(algos, models, serving, warm_batch_max=warm_batch_max,
                     mesh=mesh)
        if timings is not None:
            timings.update(load_s=t1 - t0, place_s=t2 - t1,
                           warm_s=time.perf_counter() - t2)
        return out


def prepare_deploy(engine: Engine, models: Sequence[Any],
                   engine_params: Optional[EngineParams] = None, *,
                   warm_batch_max: Optional[int] = None,
                   observed_sizes: Optional[Dict[int, int]] = None,
                   mesh=None) -> Tuple[List[Algorithm], List[Any], Serving]:
    """Instantiate the serving components for `models` (one per
    algorithm) and warm them; returns (algorithms, models, serving).

    `warm_batch_max` caps the batch buckets warmed through each
    algorithm's `warm_serving` (the server passes its micro-batcher
    `batch_max`); None skips warmup. `mesh` (a `ServeMesh` or
    `ShardSlice`) is the serving mesh; None takes
    `serve_mesh_from_conf()`, which shards only over two or more local
    CUDA cards."""
    _, _, algos, serving = engine.make_components(
        engine_params or EngineParams())
    return _ready(algos, models, serving, warm_batch_max=warm_batch_max,
                  observed_sizes=observed_sizes, mesh=mesh)


def _ready(algos: List[Algorithm], models: Sequence[Any], serving: Serving,
           *, warm_batch_max: Optional[int] = None,
           observed_sizes: Optional[Dict[int, int]] = None, mesh=None
           ) -> Tuple[List[Algorithm], List[Any], Serving]:
    """Check `models` and warm them through `algos` (one per model)."""
    models = list(models)
    if len(models) != len(algos):
        raise ValueError(
            f"{len(models)} model(s) for {len(algos)} algorithm(s)")
    for model in models:
        check = getattr(model, "sanity_check", None)
        if callable(check):
            check()
    if warm_batch_max is not None:
        if mesh is None:
            from predictionio_tpu_torch.ops.topk_sharded import (
                serve_mesh_from_conf)
            mesh = serve_mesh_from_conf()
        warm_deploy(algos, models, warm_batch_max, mesh=mesh,
                    observed_sizes=observed_sizes)
    return algos, models, serving


def derive_warm_buckets(warm_batch_max: int,
                        observed_sizes: Optional[Dict[int, int]] = None
                        ) -> List[int]:
    """The batch shapes a deploy should warm.

    No observation history -> the full pow2 ladder 1..warm_batch_max.
    With a recorded batch-size histogram, only the observed pow2 shapes
    (clamped to the ladder) plus bucket 1."""
    cap = max(1, int(warm_batch_max))
    ladder: List[int] = []
    b = 1
    while b <= cap:
        ladder.append(b)
        b *= 2
    if not observed_sizes:
        return ladder
    wanted = {1}
    for size, count in observed_sizes.items():
        try:
            size, count = int(size), int(count)
        except (TypeError, ValueError):
            continue
        if count <= 0 or size < 1:
            continue
        # clamp outsized observations (batch_max shrank between runs)
        wanted.add(max(s for s in ladder if s <= size))
    return [s for s in ladder if s in wanted]


def warm_deploy(algos: Sequence[Algorithm], models: Sequence[Any],
                warm_batch_max: int, mesh=None,
                observed_sizes: Optional[Dict[int, int]] = None) -> int:
    """Warm every algorithm's serve plan for the pow2 batch buckets up
    to `warm_batch_max`, pinning model state on the device or sharding
    it over `mesh`; returns the number of buckets warmed. Raises on any
    warmup failure. Its wall time lands in `pio_serve_warmup_seconds` of
    the process-default registry."""
    buckets = derive_warm_buckets(warm_batch_max, observed_sizes)
    t0 = time.perf_counter()
    warmed = 0
    for algo, model in zip(algos, models):
        warmed += int(algo.warm_serving(model, buckets, mesh=mesh) or 0)
    from predictionio_tpu_torch.obs import get_registry
    get_registry().gauge(
        "pio_serve_warmup_seconds",
        "Wall time of the last deploy serve warmup").set(
        time.perf_counter() - t0)
    _log.info("serve_warmup buckets=%s warmed=%d seconds=%.3f", buckets,
              warmed, time.perf_counter() - t0)
    return warmed
