"""Shared helpers of the recommender templates."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops.topk import BucketedTopK, build_mask


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
    the recommendation, similar-product and e-commerce templates."""
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
