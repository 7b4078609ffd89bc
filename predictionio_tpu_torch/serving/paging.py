"""Demand paging for tiered serving plans (`ops/topk_tiered`).

The port of `predictionio_tpu/serving/paging.py`: one `PageManager` per
prediction server, a daemon thread that every `interval_s` folds each
tiered plan's access buffer into its per-item EWMA and runs one batched
promotion/eviction pass. Everything expensive (the fold, the
argpartition, the slab gather and upload) happens here, off the serve
path. `PIO_TIER_PAGE_INTERVAL_S` (default 1.0) is the JAX package's
knob. The thread is the watchdog's restartable role `tier-pager` (budget
`interval_s * 5 + 5`, the JAX one): a dead pager only lets the hot set
go stale, so it is respawned. It publishes the JAX package's tier
families on the registry it is given (else the process default), per
plan: `pio_tier_hot_items`, `pio_tier_hit_ratio`,
`pio_tier_promotions_total` and `pio_tier_page_seconds` (the wall time
of one slab rebuild and upload).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional

_log = logging.getLogger("pio.torch.paging")


def page_interval_s() -> float:
    try:
        return max(0.01, float(
            os.environ.get("PIO_TIER_PAGE_INTERVAL_S", "1.0") or 1.0))
    except ValueError:
        return 1.0


class PageManager:
    """The page thread over a server's tiered plans."""

    def __init__(self, interval_s: Optional[float] = None, metrics=None):
        self.interval_s = (interval_s if interval_s is not None
                           else page_interval_s())
        self._plans: List = []
        self._plans_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beat = None          # the watchdog's stamp (start)
        if metrics is None:
            from predictionio_tpu_torch.obs import get_registry
            metrics = get_registry()
        self._hot_items = metrics.gauge(
            "pio_tier_hot_items",
            "Device-resident hot-slab size of each tiered plan",
            labels=("plan",))
        self._hit_ratio = metrics.gauge(
            "pio_tier_hit_ratio",
            "Fraction of served top-k entries answered by the hot slab",
            labels=("plan",))
        self._promotions = metrics.counter(
            "pio_tier_promotions_total",
            "Items promoted into the hot slab by the page thread",
            labels=("plan",))
        self._page_seconds = metrics.histogram(
            "pio_tier_page_seconds",
            "Wall time of one batched slab promotion pass")

    def bind(self, plans) -> None:
        """Replace the tracked tiered plans."""
        with self._plans_lock:
            self._plans = list(plans)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        if self.beat is None:
            from predictionio_tpu_torch.resilience.watchdog import watchdog
            self.beat = watchdog().register(
                "tier-pager", budget_s=self.interval_s * 5.0 + 5.0,
                restart=self._spawn)
        self._spawn()

    def _spawn(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-tier-pager", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        beat, self.beat = self.beat, None
        if beat is not None:
            beat.close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        beat = self.beat
        if beat is not None:
            beat.guard(self._loop_body)
        else:
            self._loop_body()

    def _loop_body(self) -> None:
        beat = self.beat
        while not self._stop.wait(self.interval_s):
            if beat is not None:
                beat.tick()
            self.tick()

    def tick(self) -> int:
        """One fold + rebalance pass over every bound plan; returns the
        total promotions. A plan that fails is logged and skipped: a
        stalled pager only lets the hot set go stale, never wrong."""
        with self._plans_lock:
            plans = list(self._plans)
        promoted_total = 0
        for i, plan in enumerate(plans):
            label = str(i)
            try:
                plan.fold_accesses()
                promoted = plan.rebalance()
            except Exception as e:   # noqa: BLE001 — paging must not die
                _log.warning("tier_page_failed plan=%d error=%s: %s", i,
                             type(e).__name__, e)
                continue
            promoted_total += promoted
            try:
                self._publish(label, plan, promoted)
            except Exception:   # noqa: BLE001 — metrics never stop paging
                pass
        return promoted_total

    def _publish(self, label: str, plan, promoted: int) -> None:
        if promoted:
            self._promotions.labels(plan=label).inc(promoted)
            self._page_seconds.observe(plan.last_page_seconds)
        self._hot_items.labels(plan=label).set(float(plan.hot_items))
        self._hit_ratio.labels(plan=label).set(plan.hit_ratio())
