"""Two-tower neural recommender template.

The port of `predictionio_tpu/models/twotower.py` (BASELINE.md config
5; no reference counterpart: the neural upgrade of the ALS templates).
It reads the recommendation template's event shapes (`view`, `rate`,
`buy` interactions, each worth 1) and answers its wire format, so
`"engineFactory": "twotower"` swaps in for `"recommendation"`:
  - train: `ops.twotower.twotower_train` on the context's device (None
    = cuda; raises without CUDA unless "cpu"), both towers materialized
    into host RAM;
  - predict: the user's tower row against every item's through
    `models.common.score_and_rank` (white and black lists; the top-k
    dispatch policy picks the host or the model's device); an unknown
    user gets an empty result;
  - streaming fold-in: one warm-start epoch from the served weights over
    the store's full interaction set on the model's device; a new user
    or item, or a model without raw weights, raises `DeltaInvalidated`
    (the table shapes are baked into the net), and the refresher
    rebuilds in full. The refresher publishes the new model; no plan
    holds the embeddings, so there is no factor swap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.core.base import (Algorithm, FirstServing,
                                              IdentityPreparator)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.models.common import (
    INTERACTION_EVENTS, InteractionDataSource, InteractionDataSourceParams,
    NeuralServingModel, score_and_rank)
from predictionio_tpu_torch.models.recommendation import (PredictedResult,
                                                          Query)
from predictionio_tpu_torch.ops.twotower import TwoTowerModel, twotower_train

EVENT_NAMES = INTERACTION_EVENTS
DataSourceParams = InteractionDataSourceParams
TwoTowerDataSource = InteractionDataSource


class TwoTowerServingModel(NeuralServingModel):
    """`net` holds the materialized towers (`ops.twotower.TwoTowerModel`)."""


@dataclass(frozen=True)
class TwoTowerParams(Params):
    emb_dim: int = 32
    hidden: int = 64
    out_dim: int = 32
    batch_size: int = 1024
    epochs: int = 10
    lr: float = 0.01
    temperature: float = 0.1
    seed: Optional[int] = None


class TwoTowerAlgorithm(Algorithm):
    params_class = TwoTowerParams
    query_class = Query

    def _train(self, u_ix, i_ix, n_users: int, n_items: int, device, *,
               epochs: int, init_params=None) -> TwoTowerModel:
        p = self.params
        return twotower_train(
            u_ix, i_ix, n_users=n_users, n_items=n_items,
            emb_dim=p.emb_dim, hidden=p.hidden, out_dim=p.out_dim,
            batch_size=p.batch_size, epochs=epochs, lr=p.lr,
            temperature=p.temperature,
            seed=p.seed if p.seed is not None else 0, device=device,
            init_params=init_params)

    def train(self, ctx: RuntimeContext,
              pd: RatingColumns) -> TwoTowerServingModel:
        if pd.n == 0:
            raise ValueError("No interaction events found")
        dev = resolve_device(ctx.device)
        net = self._train(pd.user_ix, pd.item_ix, len(pd.users),
                          len(pd.items), dev, epochs=self.params.epochs)
        return TwoTowerServingModel(net, pd.users, pd.items, str(dev))

    def fold_in(self, model: TwoTowerServingModel, delta,
                fctx) -> Optional[TwoTowerServingModel]:
        """One warm-start epoch from the served weights over the full
        interaction set (fresh Adam moments: a mini-epoch, not a
        retrain); the delta only decides whether it runs. None when the
        delta holds none of the data source's events."""
        ev_names = list(fctx.ds_params.get("event_names", EVENT_NAMES))
        spec = dict(entity_type="user", event_names=ev_names,
                    value_spec={"*": 1.0}, require_target=True)
        if fctx.delta_columns(**spec).n == 0:
            return None
        if model.net.params is None:
            raise DeltaInvalidated(
                "the model has no raw tower weights; full rebuild required")
        full = fctx.history_columns(**spec)
        u_of = np.array([model.users.get(e, -1) for e in full.entities],
                        np.int64)
        i_of = np.array([model.items.get(t, -1) for t in full.targets],
                        np.int64)
        if (u_of < 0).any() or (i_of < 0).any():
            raise DeltaInvalidated(
                "new users or items since train: the embedding-table "
                "shapes are baked into the net; full rebuild required")
        net = self._train(u_of[full.entity_ix], i_of[full.target_ix],
                          len(model.users), len(model.items), model.device,
                          epochs=1, init_params=model.net.params)
        return TwoTowerServingModel(net, model.users, model.items,
                                    model.device)

    def predict(self, model: TwoTowerServingModel,
                query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: TwoTowerServingModel,
                      queries: Sequence[Tuple[int, Query]]
                      ) -> List[Tuple[int, PredictedResult]]:
        out: List[Tuple[int, PredictedResult]] = []
        live = []
        for i, q in queries:
            u = model.users.get(q.user)
            if u is None:
                out.append((i, PredictedResult()))
            else:
                live.append((i, q, u))
        if not live:
            return out
        vecs = model.net.user_emb[np.array([u for _, _, u in live])]
        out.extend(score_and_rank(vecs, model.net.item_emb, model.items,
                                  live, device=model.device))
        return out


class TwoTowerEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source=TwoTowerDataSource,
            preparator=IdentityPreparator,
            algorithms={"twotower": TwoTowerAlgorithm, "": TwoTowerAlgorithm},
            serving=FirstServing,
        )


def engine() -> Engine:
    return TwoTowerEngine.apply()


register_engine("twotower", TwoTowerEngine)
