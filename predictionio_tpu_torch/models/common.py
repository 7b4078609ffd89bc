"""Shared serving helpers for the recommender templates."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.ops.topk import build_mask


def resolve_item_mask(items: BiMap, *,
                      white_list: Optional[Sequence[str]] = None,
                      black_list: Sequence[str] = ()) -> np.ndarray:
    """One [1, n_items] allowed-mask from a query's whiteList / blackList
    (item ids; unknown ids ignored)."""
    white = None
    if white_list is not None:
        white = [ix for it in white_list if (ix := items.get(it)) is not None]
    black = [ix for it in black_list if (ix := items.get(it)) is not None]
    return build_mask(len(items), blacklist_ix=black,
                      whitelist_ix=white).copy()
