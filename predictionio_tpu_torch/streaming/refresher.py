"""Background serve-path refresher: delta scan -> fold-in -> hot swap.

The port of `predictionio_tpu/streaming/refresher.py`. A `Refresher`
thread rides inside `PredictionServer` and ticks every `interval_s`
seconds: it snapshots the ingest watermark, delta-scans the journal
tail, runs each algorithm's `fold_in` hook (the solve runs on the
card), then COMMITS: `swap_factors` puts the new item factors into the
warmed serve plans (same shape: the warmed buckets keep serving,
nothing is re-warmed) and a new deployment is published under the
server's `_dep_lock`.

Failure policy: every new model is computed BEFORE anything touches the
serve path; any commit failure swaps the last good factors back and
keeps the old deployment, and the watermark stays where it was, so the
same delta is tried again next tick. Both factor sets are valid while a
swap is under way, so in-flight requests never fail. `DeltaInvalidated`
(a delete between the snapshots, a new item, an over-budget delta, a
driver with no delta path) falls back to the full rebuild: a retrain in
this process from the complete store read, plans of unchanged shape
swapped, the others re-warmed (through `serve_mesh_from_conf()`, which
takes no run-time configuration yet).

The fold and the server's kernel launches share the card's default
stream, so they queue behind each other. `swap_factors` only rebinds the
plan's factor tensor: a launch already queued on the old tensor runs
before any later launch that could reuse its memory, because the
allocator hands a freed block out again only in that stream's order.

Freshness: `freshness_s` is the age of the newest event the serving
model reflects, taken at each successful tick (0 when the store and the
model agree). Events between the full train and the first watermark
(`baseline`) ride the next full retrain unless their user is touched
again (a fold reads a touched user's whole history). The tick counters
by outcome, each outcome's latest tick seconds (a fold's split into
scan, fold (of it the history read, and how many full scans it took),
swap and publish), `freshness_s` and the watermark the served model
reflects show on the server's `GET /` (`status()`), and the JAX
package's metrics on its `/metrics`: `pio_streaming_refresh_total
{outcome}`, `pio_streaming_refresh_seconds`, `pio_freshness_seconds`
and `pio_streaming_fold_rows_total{side}`.

A `/reload` publishes a deployment of another instance: it calls
`rebase()`, so that the next tick takes a fresh baseline, and a fold
computed meanwhile from the replaced deployment is dropped (outcome
`superseded`), its factor swaps undone.
The JAX package's trace spans, watchdog beat, fault seam and remote
ingest routing are not ported yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Dict, Optional, Tuple

from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.streaming.delta import Delta, scan_delta
from predictionio_tpu_torch.streaming.updaters import FoldContext

_log = logging.getLogger("pio.torch.refresher")


def locate_event_store(dep, registry) -> Optional[
        Tuple[object, int, object, dict]]:
    """(events DAO, app id, channel id, data source params) from a live
    deployment's instance (the `{"name": ..., "params": {...}}` the
    workflow records); None when the deployment names no app that
    exists."""
    from predictionio_tpu_torch.data.store import app_name_to_id
    instance = getattr(dep, "instance", None)
    if instance is None:
        return None
    try:
        raw = json.loads(instance.data_source_params or "{}")
    except ValueError:
        return None
    params = raw.get("params", {}) if isinstance(raw, dict) else {}
    app_name = params.get("app_name")
    if not app_name:
        return None
    try:
        app_id, channel_id = app_name_to_id(
            registry, app_name, params.get("channel"))
    except ValueError:
        return None
    return registry.get_events(), app_id, channel_id, params


class Refresher:
    """One background freshness loop per `PredictionServer`; `tick()`
    runs one pass and may be called directly (tests, tools)."""

    def __init__(self, server, interval_s: float, *,
                 stagger_s: float = 0.0):
        self.server = server
        self.interval_s = float(interval_s)
        self.stagger_s = float(stagger_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wm: Optional[Dict[str, int]] = None
        # the templates' history columns at the last fold's watermark
        # (FoldContext.history_columns)
        self._history: dict = {}
        self._lock = threading.Lock()     # the counters below
        self.ticks: Dict[str, int] = {}
        self.last_outcome = ""
        # outcome -> the seconds of its latest tick, by phase
        self.last_ticks: Dict[str, Dict[str, float]] = {}
        self.freshness_s = 0.0
        self._rebase = False
        reg = server.metrics
        self._m = {
            "freshness": reg.gauge(
                "pio_freshness_seconds",
                "age of the newest event reflected in the serving model, "
                "sampled at the last successful refresh tick"),
            "ticks": reg.counter(
                "pio_streaming_refresh_total",
                "refresh ticks by outcome", labels=("outcome",)),
            "tick_s": reg.histogram(
                "pio_streaming_refresh_seconds", "refresh tick duration"),
            "folded": reg.counter(
                "pio_streaming_fold_rows_total",
                "factor rows re-solved by fold-in", labels=("side",)),
        }

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-refresher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(max(10.0, self.interval_s + 5.0))

    def _loop(self) -> None:
        # replicas start offset by the stagger, so that at most one
        # folds at a time
        if self.stagger_s > 0 and self._stop.wait(self.stagger_s):
            return
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must keep ticking
                self._count("failed", {})
                _log.exception("refresh_tick_failed")
            if self._stop.wait(self.interval_s):
                return

    def status(self) -> Dict[str, object]:
        with self._lock:
            return {"interval_s": self.interval_s,
                    "ticks": dict(self.ticks),
                    "last_outcome": self.last_outcome,
                    "last_ticks": {k: dict(v)
                                   for k, v in self.last_ticks.items()},
                    "freshness_s": self.freshness_s,
                    "watermark": self._wm}

    def rebase(self) -> None:
        """The served deployment changed under the refresher (a
        /reload): the next tick takes a new baseline."""
        self._rebase = True

    def _count(self, outcome: str, phases: Dict[str, float]) -> None:
        with self._lock:
            self.ticks[outcome] = self.ticks.get(outcome, 0) + 1
            self.last_outcome = outcome
            self.last_ticks[outcome] = dict(phases)
        self._m["ticks"].labels(outcome=outcome).inc()
        if "seconds" in phases:
            self._m["tick_s"].observe(phases["seconds"])
        self._m["freshness"].set(self.freshness_s)

    # -- one tick -----------------------------------------------------------
    def tick(self) -> str:
        """One refresh pass; returns its outcome (no_deployment, no_app,
        no_watermark, baseline, noop, folded, no_hooks, superseded,
        full_rebuild or rolled_back; the loop counts a tick that raises
        as failed),
        also counted in `ticks`, with the pass's seconds in
        `last_ticks`."""
        t0 = time.perf_counter()
        phases: Dict[str, float] = {}
        outcome = self._tick_inner(phases)
        phases["seconds"] = time.perf_counter() - t0
        self._count(outcome, phases)
        return outcome

    def _tick_inner(self, phases: Dict[str, float]) -> str:
        if self._rebase:
            self._rebase = False
            self._wm = None
            self._history = {}
        dep = self.server.deployment
        if dep is None:
            return "no_deployment"
        located = locate_event_store(dep, self.server.ctx.registry)
        if located is None:
            return "no_app"
        events, app_id, channel_id, ds_params = located
        wm_now = events.ingest_watermark(app_id, channel_id)
        if wm_now is None:
            return "no_watermark"       # the driver cannot delta
        if self._wm is None:
            # the deploy-time baseline (module docstring, "Freshness")
            self._wm = wm_now
            self.freshness_s = 0.0
            return "baseline"
        if wm_now == self._wm:
            self.freshness_s = 0.0
            return "noop"
        try:
            t = time.perf_counter()
            delta = scan_delta(events, app_id, channel_id, self._wm, wm_now)
            phases["scan_s"] = time.perf_counter() - t
            fctx = FoldContext(store=events, app_id=app_id,
                               channel_id=channel_id, since=self._wm,
                               upto=wm_now, ds_params=ds_params,
                               history_cache=self._history)
            outcome = self._fold_and_swap(dep, delta, fctx, phases)
        except DeltaInvalidated as e:
            _log.warning("delta_invalidated reason=%s", e)
            t = time.perf_counter()
            self._full_rebuild(dep)
            phases["rebuild_s"] = time.perf_counter() - t
            outcome = "full_rebuild"
            self.freshness_s = 0.0
        except Exception:  # noqa: BLE001 — rolled back; retried next tick
            # the last good model keeps serving; the watermark stays, so
            # the same delta is tried again next tick
            _log.exception("refresh_swap_rolled_back")
            return "rolled_back"
        self._wm = wm_now
        return outcome

    # -- fold + commit ------------------------------------------------------
    def _fold_and_swap(self, dep, delta: Delta, fctx: FoldContext,
                       phases: Dict[str, float]) -> str:
        if delta.empty:
            self.freshness_s = 0.0
            return "noop"
        # phase 1: compute every new model (nothing a client sees moves)
        t = time.perf_counter()
        new_models = list(dep.models)
        swaps = []                      # (plan, new item factors)
        folded = False
        for i, (algo, model) in enumerate(zip(dep.algos, dep.models)):
            hook = getattr(algo, "fold_in", None)
            if hook is None or model is None:
                continue
            new_model = hook(model, delta, fctx)
            if new_model is None:
                continue
            new_models[i] = new_model
            folded = True
            plan = getattr(algo, "_serve_plan", None)
            factors = getattr(new_model, "item_factors", None)
            if plan is not None and factors is not None:
                swaps.append((plan, factors))
        _sync(new_models)
        phases["fold_s"] = time.perf_counter() - t
        phases["history_s"] = fctx.history_s
        phases["history_scans"] = fctx.history_scans
        if not folded:
            return "no_hooks"
        self._m["folded"].labels(side="user").inc(len(delta.touched_users))
        # phase 2: commit (device swap, then the publish), rolling back
        # to the last good factors on any failure
        done = []                       # (plan, previous factors)
        try:
            t = time.perf_counter()
            for plan, factors in swaps:
                done.append((plan, plan.swap_factors(factors)))
            phases["swap_s"] = time.perf_counter() - t
            t = time.perf_counter()
            current = self.server.publish(self.server._refresh_deployment(
                dep, new_models), expected=dep)
            phases["publish_s"] = time.perf_counter() - t
        except Exception:
            for plan, old in reversed(done):
                plan.swap_factors(old)
            raise
        if not current:
            for plan, old in reversed(done):
                plan.swap_factors(old)
            return "superseded"
        self.freshness_s = max(0.0, time.time() - delta.newest_us / 1e6)
        return "folded"

    # -- the full-scan fallback ---------------------------------------------
    def _full_rebuild(self, dep) -> None:
        """`DeltaInvalidated`: retrain in this process from the complete
        store read (the watermark-keyed prepared-data cache keeps the
        scan cheap when nothing moved), swap plans whose shape stayed,
        re-warm the others, and publish. The serve path never sees a
        half-built state."""
        from predictionio_tpu_torch.core.workflow import (
            engine_params_from_instance, warm_deploy)
        from predictionio_tpu_torch.ops.topk_sharded import (
            serve_mesh_from_conf)
        server = self.server
        ctx = server.ctx
        engine_params = engine_params_from_instance(dep.engine, dep.instance)
        ds, prep, _, _ = dep.engine.make_components(engine_params)
        pd = prep.prepare(ctx, ds.read_training(ctx))
        new_models = [algo.train(ctx, pd) for algo in dep.algos]
        done, rewarm = [], []
        try:
            for algo, model in zip(dep.algos, new_models):
                plan = getattr(algo, "_serve_plan", None)
                factors = getattr(model, "item_factors", None)
                if plan is None or factors is None:
                    continue
                if tuple(factors.shape) == (plan.n_items, plan.rank):
                    done.append((plan, plan.swap_factors(factors)))
                else:
                    rewarm.append((algo, model))
            if rewarm:
                # the catalog changed shape: warm new plans, with the
                # deploy's batch buckets
                warm_deploy([a for a, _ in rewarm], [m for _, m in rewarm],
                            server.batcher.batch_max,
                            mesh=serve_mesh_from_conf())
            server.publish(server._refresh_deployment(dep, new_models))
        except Exception:
            for plan, old in reversed(done):
                plan.swap_factors(old)
            raise


def _sync(models) -> None:
    """Wait for the fold's device work, so that its seconds are the
    solve's and a failure surfaces before the commit."""
    import torch
    for m in models:
        dev = getattr(m, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            torch.cuda.synchronize(dev)
