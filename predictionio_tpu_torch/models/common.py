"""Shared helpers of the recommender templates."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.core.base import DataSource
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops.topk import (NEG_INF, BucketedTopK,
                                             build_mask, topk_scores)


# the neural templates' interactions: each event of these names is worth 1
INTERACTION_EVENTS = ("view", "rate", "buy")


@dataclass(frozen=True)
class InteractionDataSourceParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None
    event_names: Sequence[str] = INTERACTION_EVENTS


class InteractionDataSource(DataSource):
    """The two-tower and seqrec templates' data source: the app's
    user-item interaction events as rating columns, each worth 1."""
    params_class = InteractionDataSourceParams

    def read_training(self, ctx: RuntimeContext) -> RatingColumns:
        p = self.params
        return store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=list(p.event_names), value_spec={"*": 1.0})


@dataclass
class NeuralServingModel:
    """A neural template's model with its id maps; `net` keeps its
    weights in host RAM, `device` is where encoding, scoring and the
    fold's epoch run."""
    net: Any
    users: BiMap
    items: BiMap
    device: str = "cuda"

    def sanity_check(self):
        self.net.sanity_check()

    def to(self, device=None, items_device=None):
        """This model computing on `device` (None = cuda); the weights
        stay in host RAM."""
        return replace(self, device=str(resolve_device(device)))


def item_categories(registry, app_name: str,
                    channel: Optional[str] = None) -> Dict[str, List[str]]:
    """item id -> its `categories` property, from the aggregated `$set`,
    `$unset` and `$delete` events of the app's items (the e-commerce and
    similar-product data sources)."""
    cats: Dict[str, List[str]] = {}
    props = store.aggregate_properties(registry, app_name,
                                       channel_name=channel,
                                       entity_type="item")
    for item_id, pm in props.items():
        c = pm.get_opt("categories")
        if c:
            cats[item_id] = list(c)
    return cats


def generic_factors(plan, item_factors):
    """The item factors a template's paths past its banned-index plan
    score against: a single-device plan's resident copy, else the
    model's master (in host RAM once a sharded or tiered plan owns the
    card's copy)."""
    return plan.factors if isinstance(plan, BucketedTopK) else item_factors


def score_and_rank(vecs: np.ndarray, item_emb: np.ndarray, items: BiMap,
                   live: Sequence[tuple], *, device=None):
    """The shared scoring tail of the neural recommenders (two-tower,
    seqrec): per-query masks from the white and black lists, one masked
    top-k over the catalog through `topk_scores` (its `DispatchPolicy`
    picks the host or `device`, None = cuda), ItemScore assembly. `live`
    is [(original_index, query, ...)]; only index and query are read.
    Returns [(original_index, PredictedResult)], each trimmed to its
    query's `num`, masked slots dropped."""
    from predictionio_tpu_torch.models.recommendation import (
        ItemScore, PredictedResult)
    n_items = item_emb.shape[0]
    k = max(min(entry[1].num, n_items) for entry in live)
    mask = np.concatenate(
        [resolve_item_mask(items, white_list=entry[1].whiteList,
                           black_list=entry[1].blackList or ())
         for entry in live], axis=0)
    scores, ixs = topk_scores(np.asarray(vecs, np.float32),
                              np.asarray(item_emb, np.float32), mask, k=k,
                              device=device)
    out = []
    for row, entry in enumerate(live):
        i, q = entry[0], entry[1]
        found = [ItemScore(items.inverse(int(ix)), float(s))
                 for s, ix in zip(scores[row], ixs[row])
                 if s > NEG_INF / 2][:q.num]
        out.append((i, PredictedResult(tuple(found))))
    return out


def resolve_item_mask(items: BiMap,
                      item_categories: Optional[Dict[str, List[str]]] = None,
                      *,
                      categories: Optional[Sequence[str]] = None,
                      white_list: Optional[Sequence[str]] = None,
                      black_list: Sequence[str] = (),
                      extra_blacklist_ix: Sequence[int] = ()) -> np.ndarray:
    """One [1, n_items] allowed-mask from the standard template filters:
    whiteList / blackList (item ids; unknown ids ignored), extra
    blacklist indexes (seen, unavailable or query items), and a
    categories any-of filter over the per-item category lists. Used by
    the recommendation, similar-product, e-commerce and neural
    templates."""
    n = len(items)
    white = None
    if white_list is not None:
        white = [ix for it in white_list if (ix := items.get(it)) is not None]
    black = [ix for it in black_list if (ix := items.get(it)) is not None]
    black += list(extra_blacklist_ix)
    mask = build_mask(n, blacklist_ix=black, whitelist_ix=white).copy()
    if categories is not None:
        want = set(categories)
        cat_ok = np.zeros(n, bool)
        for item_id, cats in (item_categories or {}).items():
            ix = items.get(item_id)
            if ix is not None and want & set(cats):
                cat_ok[ix] = True
        mask &= cat_ok[None, :]
    return mask
