"""Rating columns and labeled points: dense numpy columns with the
BiMaps of their ids.

The numpy part of `predictionio_tpu/ingest/arrays.py`:
  - `RatingColumns` (the per-template `RDD[Rating]` of DataSource.scala:
    43-72): the fields, `from_events` over an Event stream, `from_store`
    (the columnar scan of `ingest.pipeline`, equal array for array) and
    `default_rating_of`;
  - `LabeledPoints` and `labeled_points_from_properties` (the
    classification template's `RDD[LabeledPoint]` from aggregated
    properties, `examples/scala-parallel-classification/.../
    DataSource.scala`).
Device columns (`shard`, a mesh form) are not ported: each trainer
uploads what it needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from predictionio_tpu_torch.data.event import Event, to_millis
from predictionio_tpu_torch.ingest.bimap import BiMap


@dataclass
class RatingColumns:
    """COO rating triples (user, item, rating, t_millis) with BiMaps."""
    user_ix: np.ndarray      # int32 [n]
    item_ix: np.ndarray      # int32 [n]
    rating: np.ndarray       # float32 [n]
    t_millis: np.ndarray     # int64 [n]
    users: BiMap
    items: BiMap

    @property
    def n(self) -> int:
        return self.user_ix.shape[0]

    @staticmethod
    def from_events(events: Iterable[Event], *,
                    rating_of: Optional[Callable[[Event], Optional[float]]] = None,
                    users: Optional[BiMap] = None,
                    items: Optional[BiMap] = None,
                    dedup_last_wins: bool = False) -> "RatingColumns":
        """Rating triples from events. `rating_of` maps an event to its
        rating (None = skip; default `default_rating_of`); rows whose id
        a fixed `users` / `items` BiMap lacks drop. `dedup_last_wins`
        keeps one row per (user, item), the latest by event time, at the
        pair's first position (the `.reduceByKey` of the ALS
        templates)."""
        rating_of = rating_of or default_rating_of
        rows: list = []
        for e in events:
            r = rating_of(e)
            if r is None or e.entity_id is None or e.target_entity_id is None:
                continue
            rows.append((e.entity_id, e.target_entity_id, float(r),
                         to_millis(e.event_time)))
        u_map = users if users is not None else BiMap.from_keys(
            r[0] for r in rows)
        i_map = items if items is not None else BiMap.from_keys(
            r[1] for r in rows)
        kept: list = []
        for uid, iid, r, t in rows:
            u, i = u_map.get(uid), i_map.get(iid)
            if u is None or i is None:   # unseen under a fixed BiMap: drop
                continue
            kept.append((u, i, r, t))
        if dedup_last_wins:
            by_key: Dict[Tuple[int, int], Tuple[int, int, float, int]] = {}
            for row in kept:
                k = (row[0], row[1])
                if k not in by_key or row[3] >= by_key[k][3]:
                    by_key[k] = row
            kept = list(by_key.values())
        if kept:
            u_ix, i_ix, rs, ts = (np.array(x) for x in zip(*kept))
        else:
            u_ix = i_ix = np.zeros(0, np.int32)
            rs, ts = np.zeros(0, np.float32), np.zeros(0, np.int64)
        return RatingColumns(u_ix.astype(np.int32), i_ix.astype(np.int32),
                             rs.astype(np.float32), ts.astype(np.int64),
                             u_map, i_map)

    @staticmethod
    def from_store(store, app_id: int, channel_id=None,
                   **kwargs) -> "RatingColumns":
        """`from_events(store.find(...))` on the columnar path (no Event
        objects); `kwargs` go to `ingest.pipeline.
        rating_columns_from_store`, whose `value_spec` stands for
        `rating_of`."""
        from predictionio_tpu_torch.ingest.pipeline import (
            rating_columns_from_store)
        return rating_columns_from_store(store, app_id, channel_id, **kwargs)


def default_rating_of(e: Event) -> Optional[float]:
    """`rate` events (and any carrying a `rating` property) use that
    property; other events (buy, view, like) count as 1.0."""
    if e.event == "rate" or "rating" in e.properties:
        v = e.properties.get_opt("rating")
        return float(v) if v is not None else None
    return 1.0


@dataclass
class LabeledPoints:
    """Dense feature matrix + labels (the RDD[LabeledPoint] analog)."""
    features: np.ndarray   # float32 [n, d]
    label: np.ndarray      # float32 [n]
    entities: BiMap        # row -> entityId

    @property
    def n(self) -> int:
        return self.features.shape[0]


def labeled_points_from_properties(
        props: Mapping[str, object], *,
        feature_attrs: Sequence[str],
        label_attr: str,
        label_map: Optional[Mapping[str, float]] = None) -> LabeledPoints:
    """Aggregated entity properties -> (features, label) arrays.

    `props` is the output of `EventStore.aggregate_properties` (entityId ->
    PropertyMap). Entities missing any required attr are skipped, as the
    classification DataSource drops them. `label_map` converts
    categorical string labels to floats."""
    ids: list = []
    feats: list = []
    labels: list = []
    for eid, pm in props.items():
        try:
            row = [float(pm.get(a)) for a in feature_attrs]
            raw = pm.get(label_attr)
            y = float(label_map[raw]) if label_map is not None else float(raw)
        except (KeyError, TypeError, ValueError):
            continue
        ids.append(eid)
        feats.append(row)
        labels.append(y)
    f = (np.array(feats, np.float32) if feats
         else np.zeros((0, len(feature_attrs)), np.float32))
    return LabeledPoints(f, np.array(labels, np.float32),
                         BiMap.from_keys(ids))
