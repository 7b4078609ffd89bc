"""ALS model, serving side.

The port of `ALSModel` from `predictionio_tpu/ops/als.py`: the factor
matrices as tensors plus the id maps. The user factors live on the
serving device. The item factors (the item master) live there too, or
in host RAM when they are loaded with `items_device="cpu"`: a catalog
that a serving plan shards over several cards or tiers (a hot slab on
the card, the rest on the host) is never placed whole on one card.
Training,
fold-in and RMSE come with the training slice. A model trained by the
JAX package is carried over as numpy arrays (`als_model_from_numpy`) or
through an `.npz` file (`save_npz` / `load_npz`), which holds the two
factor matrices and both id lists and needs no pickle.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Sequence, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.bimap import BiMap


@dataclass
class ALSModel:
    """Factor matrices + BiMaps (`examples/.../ALSModel.scala`)."""
    user_factors: torch.Tensor   # [n_users, rank] f32
    item_factors: torch.Tensor   # [n_items, rank] f32
    users: BiMap
    items: BiMap

    @property
    def device(self) -> torch.device:
        """The serving device: that of the user factors. The item master
        may lie in host RAM while a serving plan holds the device copy."""
        return self.user_factors.device

    def sanity_check(self) -> None:
        if self.user_factors.dim() != 2 or self.item_factors.dim() != 2:
            raise ValueError("ALSModel factors must be 2-D")
        if self.user_factors.shape[1] != self.item_factors.shape[1]:
            raise ValueError(
                f"ALSModel rank mismatch: users {self.user_factors.shape[1]}"
                f" vs items {self.item_factors.shape[1]}")
        if (len(self.users), len(self.items)) != (
                self.user_factors.shape[0], self.item_factors.shape[0]):
            raise ValueError("ALSModel id maps and factor rows disagree")
        if not (torch.isfinite(self.user_factors).all()
                and torch.isfinite(self.item_factors).all()):
            raise ValueError("ALSModel has non-finite factors")

    def save_npz(self, path: Union[str, Path]) -> None:
        """Write factors and id lists (row order) to an `.npz`."""
        np.savez(path,
                 user_factors=self.user_factors.cpu().numpy(),
                 item_factors=self.item_factors.cpu().numpy(),
                 user_ids=np.array(self.users.keys(), dtype=str),
                 item_ids=np.array(self.items.keys(), dtype=str))


def als_model_from_numpy(user_factors: np.ndarray, item_factors: np.ndarray,
                         user_ids: Sequence[str], item_ids: Sequence[str],
                         device=None, items_device=None) -> ALSModel:
    """An `ALSModel` on `device` (None = cuda) from host factors and the
    ids of their rows, e.g. the arrays and BiMap keys of a model the JAX
    package trained. `items_device` places the item master (None = the
    same device); `"cpu"` keeps it in host RAM, so that the deploy's
    `serve_plan` can shard or tier a catalog past one card's budget."""
    dev = resolve_device(device)
    item_dev = dev if items_device is None else resolve_device(items_device)
    users = BiMap.from_keys(str(u) for u in user_ids)
    items = BiMap.from_keys(str(i) for i in item_ids)
    if len(users) != len(user_ids) or len(items) != len(item_ids):
        raise ValueError("als_model_from_numpy: duplicate ids")
    model = ALSModel(
        torch.tensor(user_factors, dtype=torch.float32, device=dev),
        torch.tensor(item_factors, dtype=torch.float32, device=item_dev),
        users, items)
    model.sanity_check()
    return model


def load_npz(path: Union[str, Path], device=None,
             items_device=None) -> ALSModel:
    """Read a `save_npz` file onto `device` (None = cuda), the item
    master onto `items_device` (as in `als_model_from_numpy`)."""
    with np.load(path, allow_pickle=False) as z:
        return als_model_from_numpy(
            z["user_factors"], z["item_factors"],
            z["user_ids"].tolist(), z["item_ids"].tolist(), device=device,
            items_device=items_device)
