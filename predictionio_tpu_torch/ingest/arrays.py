"""Rating columns: COO triples with the BiMaps of their ids.

The numpy part of `RatingColumns` from `predictionio_tpu/ingest/arrays.py`:
the fields, `n`, and an `.npz` file of the fields plus both id lists,
which stands in for the event store until that slice is ported (the
port has no `shard`, `from_store` or `from_events` yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Union

import numpy as np

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

    def save_npz(self, path: Union[str, Path]) -> None:
        """Write the four columns and both id lists (index order)."""
        np.savez(path, user_ix=self.user_ix, item_ix=self.item_ix,
                 rating=self.rating, t_millis=self.t_millis,
                 user_ids=np.array(self.users.keys(), dtype=str),
                 item_ids=np.array(self.items.keys(), dtype=str))

    @staticmethod
    def load_npz(path: Union[str, Path]) -> "RatingColumns":
        """Read a `save_npz` file; raises ValueError when the columns
        disagree in length, an id repeats, or an index lies outside its
        id list."""
        with np.load(path, allow_pickle=False) as z:
            user_ids, item_ids = z["user_ids"].tolist(), z["item_ids"].tolist()
            cols = RatingColumns(
                z["user_ix"].astype(np.int32), z["item_ix"].astype(np.int32),
                z["rating"].astype(np.float32),
                z["t_millis"].astype(np.int64),
                BiMap.from_keys(user_ids), BiMap.from_keys(item_ids))
        if (len(cols.users), len(cols.items)) != (len(user_ids),
                                                  len(item_ids)):
            raise ValueError(f"{path}: duplicate ids")
        n = cols.n
        if not (cols.item_ix.shape[0] == cols.rating.shape[0]
                == cols.t_millis.shape[0] == n):
            raise ValueError(f"{path}: rating columns differ in length")
        for ix, ids, name in ((cols.user_ix, cols.users, "user"),
                              (cols.item_ix, cols.items, "item")):
            if n and (ix.min() < 0 or ix.max() >= len(ids)):
                raise ValueError(f"{path}: a {name} index lies outside the "
                                 f"{len(ids)} {name} ids")
        return cols
