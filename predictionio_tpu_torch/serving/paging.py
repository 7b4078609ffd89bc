"""Demand paging for tiered serving plans (`ops/topk_tiered`).

The port of `predictionio_tpu/serving/paging.py`: one `PageManager` per
prediction server, a daemon thread that every `interval_s` folds each
tiered plan's access buffer into its per-item EWMA and runs one batched
promotion/eviction pass. Everything expensive (the fold, the
argpartition, the slab gather and upload) happens here, off the serve
path. `PIO_TIER_PAGE_INTERVAL_S` (default 1.0) is the JAX package's
knob. Its metrics and watchdog beat come with the server stack.
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

    def __init__(self, interval_s: Optional[float] = None):
        self.interval_s = (interval_s if interval_s is not None
                           else page_interval_s())
        self._plans: List = []
        self._plans_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def bind(self, plans) -> None:
        """Replace the tracked tiered plans."""
        with self._plans_lock:
            self._plans = list(plans)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="pio-torch-tier-pager", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def tick(self) -> int:
        """One fold + rebalance pass over every bound plan; returns the
        total promotions. A plan that fails is logged and skipped: a
        stalled pager only lets the hot set go stale, never wrong."""
        with self._plans_lock:
            plans = list(self._plans)
        promoted_total = 0
        for i, plan in enumerate(plans):
            try:
                plan.fold_accesses()
                promoted_total += plan.rebalance()
            except Exception as e:   # noqa: BLE001 — paging must not die
                _log.warning("tier_page_failed plan=%d error=%s: %s", i,
                             type(e).__name__, e)
        return promoted_total
