"""Deficit-round-robin pending queue of the serving micro-batcher.

The port of `predictionio_tpu/tenancy/drr.py` (the port keeps its own
copy). One FIFO lets a single aggressor fill the batcher's `queue_max`
and every other app's latency collapses with it. This queue keeps one
bounded lane per tenant and drains the lanes by deficit round robin
(Shreedhar & Varghese '96):

  - each tenant owns a deque capped at its own `queue_max`, so an
    aggressor fills only its own lane: `push` returns False and the
    batcher sheds that tenant;
  - the drainer visits the lanes in rotation; a visit grants `quantum *
    weight` deficit and pops one item per unit of it, so under
    contention throughput follows the weights whatever the arrival
    order;
  - per-tenant queue-delay EWMAs let the batcher's adaptive shed judge
    the submitting tenant's own lane: the tenant causing the backlog
    waits, and sheds, first.

With tenancy off every item lands in one lane and DRR is exactly FIFO.
Idle (empty) lanes are evicted past `max_tenants`.

Caller-locked: the micro-batcher serializes every call under its own
condition lock; this class takes no lock of its own.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Deque, List

# fraction of a new delay sample blended into a tenant's EWMA — same
# constant the batcher uses for its global queue-delay estimate
DELAY_ALPHA = 0.2


class _SubQueue:
    """One tenant's lane: bounded FIFO + DRR deficit + delay EWMA."""

    __slots__ = ("items", "deficit", "weight", "delay_ewma")

    def __init__(self, weight: float):
        self.items: Deque[Any] = deque()
        self.deficit = 0.0
        self.weight = max(weight, 0.05)
        self.delay_ewma = 0.0


class DRRQueue:
    """Weighted-fair pending queue; all methods caller-locked."""

    def __init__(self, *, quantum: float = 4.0, max_tenants: int = 1024):
        # tenants in round-robin order; rotation is "pop front, serve,
        # append back", so the OrderedDict order IS the DRR ring
        self._lanes: "OrderedDict[str, _SubQueue]" = OrderedDict()
        self._quantum = max(quantum, 1.0)
        self._max_tenants = max(1, int(max_tenants))
        self._total = 0

    def __len__(self) -> int:
        return self._total

    def depth(self, tenant: str) -> int:
        lane = self._lanes.get(tenant)
        return len(lane.items) if lane is not None else 0

    # -- enqueue -------------------------------------------------------------
    def push(self, tenant: str, item: Any, *, weight: float = 1.0,
             queue_max: int = 0) -> bool:
        """Append to the tenant's lane. False when the lane is at its
        own cap (`queue_max`, 0 = uncapped) — the caller sheds just
        that tenant."""
        lane = self._lanes.get(tenant)
        if lane is None:
            self._evict_idle_lane()
            lane = _SubQueue(weight)
            self._lanes[tenant] = lane   # bounded by _evict_idle_lane
        else:
            lane.weight = max(weight, 0.05)
        if queue_max > 0 and len(lane.items) >= queue_max:
            return False
        lane.items.append(item)
        self._total += 1
        return True

    def _evict_idle_lane(self) -> None:
        """Keep the lane map bounded: drop the stalest EMPTY lane once
        past `max_tenants`. Non-empty lanes are never dropped (their
        item count is already bounded by the global queue cap)."""
        if len(self._lanes) < self._max_tenants:
            return
        for label, lane in self._lanes.items():
            if not lane.items:
                del self._lanes[label]
                return

    # -- dequeue -------------------------------------------------------------
    def take(self, n: int) -> List[Any]:
        """Up to `n` items in deficit-round-robin order."""
        out: List[Any] = []
        if n <= 0 or self._total == 0:
            return out
        # one full rotation may not fill the batch (small deficits);
        # loop rotations until the batch is full or the queue is empty
        while len(out) < n and self._total > 0:
            label, lane = next(iter(self._lanes.items()))
            self._lanes.move_to_end(label)
            if not lane.items:
                lane.deficit = 0.0
                continue
            lane.deficit += self._quantum * lane.weight
            while lane.items and lane.deficit >= 1.0 and len(out) < n:
                out.append(lane.items.popleft())
                lane.deficit -= 1.0
                self._total -= 1
            if not lane.items:
                # standard DRR: an emptied lane forfeits leftover
                # deficit, so idle tenants cannot bank credit
                lane.deficit = 0.0
        return out

    def remove(self, tenant: str, item: Any) -> bool:
        """Withdraw a specific item (submit-timeout abandonment)."""
        lane = self._lanes.get(tenant)
        if lane is None:
            return False
        try:
            lane.items.remove(item)
        except ValueError:
            return False
        self._total -= 1
        return True

    def drain_all(self) -> List[Any]:
        """Every pending item, lane order (used by close())."""
        out: List[Any] = []
        for lane in self._lanes.values():
            out.extend(lane.items)
            lane.items.clear()
            lane.deficit = 0.0
        self._total = 0
        return out

    # -- per-tenant queue-delay tracking -------------------------------------
    def observe_delay(self, tenant: str, delay_s: float) -> None:
        lane = self._lanes.get(tenant)
        if lane is not None:
            lane.delay_ewma += DELAY_ALPHA * (delay_s - lane.delay_ewma)

    def delay_ewma(self, tenant: str) -> float:
        lane = self._lanes.get(tenant)
        return lane.delay_ewma if lane is not None else 0.0
