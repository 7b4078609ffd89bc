"""Incremental model updaters: the shared fold-in machinery.

The port of `predictionio_tpu/streaming/updaters.py`. The templates own
their data semantics (what counts as a rating, which events matter), so
each exposes a `fold_in(model, delta, fctx)` hook; this module holds
what those hooks share: the `FoldContext` (store access scoped to the
delta window) and the closed-form ALS fold helpers.

Fold-in semantics (the idempotence contract): a touched entity's FULL
history is read back from the event store and its factor row re-solved
from scratch against fixed opposite-side factors (one exact ALS
half-step, `ops.als.fold_in_rows`, on the device). The histories come
from the store's columns (`FoldContext.history_columns`: one scan, or
the last tick's columns extended by the delta), grouped by touched
entity, with the JAX package's semantics (find order, the last rating
of a pair wins at its first place). Re-applying the same delta changes
nothing, and untouched rows are bit-identical: the touched rows go into
a copy of the factors by `index_copy`. New USERS extend the BiMap (old
indexes stay; the user side is in no serve plan); new ITEMS raise
`DeltaInvalidated`, because the item-factor shape is that of the
warmed serve plans and a full rebuild is the right response.

The periodic full retrain stays ground truth: folded models live in
memory only and are never persisted.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.data.storage import columns
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.resilience.watchdog import progress


@dataclass
class FoldContext:
    """Store access scoped to one refresh tick's delta window.
    `history_cache`, a dict the caller keeps across ticks (the
    `Refresher` does), lets `history_columns` extend the last tick's
    history by this tick's delta instead of scanning the store again."""
    store: object                      # events DAO (registry.get_events())
    app_id: int
    channel_id: Optional[int]
    since: Dict[str, int]
    upto: Dict[str, int]
    ds_params: Dict[str, object] = field(default_factory=dict)
    history_cache: Optional[dict] = None
    # what `history_columns` cost this tick: seconds, and how many of
    # its reads scanned the whole store
    history_s: float = 0.0
    history_scans: int = 0

    def delta_columns(self, **kw):
        """A template-spec re-scan of the SAME delta frames the generic
        change scan decoded (bytes-bounded by the storage contract)."""
        return self.store.scan_columns(
            self.app_id, self.channel_id, since=self.since,
            upto=self.upto, **kw)

    def user_history(self, user_id: str, event_names: Sequence[str]):
        """A touched user's full history of `event_names`, as Events in
        find order (the serving-time read, LEventStore.findByEntity)."""
        return self.store.find(
            self.app_id, self.channel_id, entity_type="user",
            entity_id=user_id, event_names=list(event_names))

    def item_history(self, item_id: str, event_names: Sequence[str]):
        """Every user event of `event_names` that targets one item, in
        find order."""
        return self.store.find(
            self.app_id, self.channel_id, entity_type="user",
            target_entity_id=item_id, event_names=list(event_names))

    def history_columns(self, **kw):
        """The whole store's rows under a template's spec (`scan_columns`
        filters), in `find` order: every touched entity's full history at
        once. The JAX package reads them with one `find` per touched user
        and item, each of which walks every event of the segments the
        entity's Bloom bits do not rule out (at MovieLens-1M's shape, in
        one segment, 64 users and their items walk a million events some
        250 times).

        With `history_cache` holding this spec's rows at `since`, the
        result is those rows merged with the delta's, by the scan's own
        merge: the same columns as a full scan at `upto`, because a
        delta is exactly the frames appended after `since` (anything
        else raises `DeltaInvalidated`) and rows of equal time keep
        journal order. Otherwise the store is scanned, and the rows are
        cached only if no append landed during the scan."""
        t0 = time.perf_counter()
        key = json.dumps(kw, sort_keys=True, default=str)
        cache = self.history_cache
        hit = cache.get(key) if cache is not None else None
        if hit is not None and hit[0] == self.since:
            cols = columns.merge_blocks(
                [_block(hit[1]), _block(self.delta_columns(**kw))])
            snapshot = True
        else:
            cols = self.store.scan_columns(self.app_id, self.channel_id,
                                           **kw)
            self.history_scans += 1
            # cached only as the `upto` snapshot: no append landed
            snapshot = self.store.ingest_watermark(
                self.app_id, self.channel_id) == self.upto
        if cache is not None and snapshot:
            cache[key] = (self.upto, cols)
        self.history_s += time.perf_counter() - t0
        progress()                      # a refresher stage (watchdog)
        return cols


def _block(cols) -> tuple:
    """An `EventColumns` as a `columns.Block` (the same six fields)."""
    return (cols.entity_ix, cols.target_ix, cols.value, cols.t_us,
            cols.entities, cols.targets)


def extend_bimap(base: BiMap, new_keys: Sequence[str]) -> BiMap:
    """Stable extension: existing ids unchanged, unseen keys appended in
    first-seen order."""
    fresh, seen = [], set()
    for k in new_keys:
        if base.get(k) is None and k not in seen:
            fresh.append(k)
            seen.add(k)
    if not fresh:
        return base
    return BiMap.from_keys(base.keys() + fresh)


def _histories(keys: Sequence[str], own_ix: np.ndarray, own_table,
               opp_ix: np.ndarray, opp_table, opp_map: BiMap,
               value: np.ndarray, dedup_last_wins: bool,
               unknown: Callable[[str, str], str]):
    """One (opposite dense index, value) array pair per key of `keys`,
    from columnar rows in `find` order (`own_ix` / `opp_ix` index the
    scan's intern tables). With `dedup_last_wins` a pair keeps its last
    value, at its first occurrence (the JAX package's `_history_arrays`
    over time-sorted events). An opposite id `opp_map` does not know
    raises `DeltaInvalidated(unknown(key, id))`. Vectorized: the
    refresher thread shares the interpreter with the request threads."""
    pos = {k: n for n, k in enumerate(own_table)}
    slot = np.full(len(own_table), -1, np.int64)   # table id -> key
    for n, k in enumerate(keys):
        if k in pos:
            slot[pos[k]] = n
    rows = np.nonzero(slot[own_ix] >= 0)[0] if len(own_table) else \
        np.zeros(0, np.int64)
    owner = slot[own_ix[rows]]
    order = np.argsort(owner, kind="stable")     # by key, in find order
    rows, owner = rows[order], owner[order]
    dense = np.array([opp_map.get(k, -1) for k in opp_table], np.int64)
    opp = dense[opp_ix[rows]] if dense.size else np.zeros(0, np.int64)
    bad = np.nonzero(opp < 0)[0]
    if bad.size:
        j = bad[0]
        raise DeltaInvalidated(unknown(keys[owner[j]],
                                       opp_table[opp_ix[rows[j]]]))
    vals = value[rows]
    if dedup_last_wins and rows.size:
        pair = (owner << 32) | opp
        _, first = np.unique(pair, return_index=True)
        _, rev_first = np.unique(pair[::-1], return_index=True)
        sel = (pair.size - 1 - rev_first)[np.argsort(first, kind="stable")]
        owner, opp, vals = owner[sel], opp[sel], vals[sel]
    bounds = np.searchsorted(owner, np.arange(len(keys) + 1))
    return [(opp[a:b].astype(np.int32), vals[a:b].astype(np.float32))
            for a, b in zip(bounds[:-1], bounds[1:])]


def _put_rows(factors: torch.Tensor, rows: Sequence[int],
              new_rows: torch.Tensor) -> torch.Tensor:
    """A copy of `factors` with `rows` replaced (on the factors' device):
    every other row bit-identical."""
    idx = torch.tensor(list(rows), dtype=torch.long, device=factors.device)
    return factors.index_copy(0, idx, new_rows.to(factors.device))


def fold_als_users(history, users: BiMap, items: BiMap,
                   user_factors: torch.Tensor, item_factors: torch.Tensor,
                   touched: Sequence[str], *, dedup_last_wins: bool,
                   reg: float, implicit: bool = False, alpha: float = 1.0):
    """Re-solve the touched users' rows against FIXED item factors, on
    the user factors' device; `history` is `FoldContext.history_columns`
    under the template's spec. Returns (new user factors, new users
    BiMap, rows folded). New users are appended; a history touching an
    unknown item raises `DeltaInvalidated` (the item shape is the serve
    plans')."""
    users2 = extend_bimap(users, touched)
    histories = _histories(
        touched, history.entity_ix, history.entities, history.target_ix,
        history.targets, items, history.value, dedup_last_wins,
        lambda u, i: (f"user {u!r} touched unknown item {i!r}: the item "
                      "shape is that of the warmed serve plans"))
    rows = [users2.get(uid) for uid in touched]
    new_rows = als.fold_in_rows(item_factors, histories, reg=reg,
                                implicit=implicit, alpha=alpha,
                                device=user_factors.device)
    grown = len(users2) - user_factors.shape[0]
    if grown:
        user_factors = torch.cat(
            [user_factors, user_factors.new_zeros((grown,
                                                   user_factors.shape[1]))])
    return _put_rows(user_factors, rows, new_rows), users2, len(rows)


def fold_als_items(history, users2: BiMap, items: BiMap,
                   user_factors: torch.Tensor, item_factors: torch.Tensor,
                   touched: Sequence[str], *, dedup_last_wins: bool,
                   reg: float, implicit: bool = False, alpha: float = 1.0):
    """Re-solve the touched items' rows against the (already folded)
    user factors, on the user factors' device: the second half of the
    fold sweep, and the part that flows into the serve plans. Returns
    (new item factors on the item master's device, rows folded). Unknown
    items or users raise `DeltaInvalidated`."""
    for iid in touched:
        if items.get(iid) is None:
            raise DeltaInvalidated(
                f"new item {iid!r} in delta: the item shape is that of "
                "the warmed serve plans; full rebuild required")
    histories = _histories(
        touched, history.target_ix, history.targets, history.entity_ix,
        history.entities, users2, history.value, dedup_last_wins,
        lambda i, u: f"item {i!r} touched by unknown user {u!r}")
    rows = [items.get(iid) for iid in touched]
    new_rows = als.fold_in_rows(user_factors, histories, reg=reg,
                                implicit=implicit, alpha=alpha)
    return _put_rows(item_factors, rows, new_rows), len(rows)
