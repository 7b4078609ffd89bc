"""Similar-product template: implicit ALS, like/dislike ALS and
cooccurrence in one multi-algorithm engine.

The port of `predictionio_tpu/models/similarproduct.py` (parity target
`examples/scala-parallel-similarproduct/multi-events-multi-algos/`):
  - the data source reads `view` events, `like` (+1) / `dislike` (-1)
    events with the latest of a pair winning, and the items' `$set`
    categories (`DataSource.scala`);
  - ALSAlgorithm: MLlib implicit ALS on views (`ALSAlgorithm.scala:120`)
    on the context's device; a query is a set of items, answered with
    the items most cosine-similar to their mean vector, with category /
    whiteList / blackList filters and the query items excluded;
  - LikeAlgorithm: implicit ALS on like = +1 / dislike = -1
    (`LikeAlgorithm.scala:37-101`); the confidence is 1 + alpha * |r|,
    so a dislike weighs like a like, as in MLlib;
  - CooccurrenceAlgorithm: item-item cooccurrence counts
    (`CooccurrenceAlgorithm.scala:47-110`), counted on the device
    (`ops.cooccur`) and served by host numpy;
  - ScoreAverageServing averages each item's score over the algorithms
    that returned it (`Serving.scala`);
  - wire: query `{"items": ["i1"], "num": 4}` ->
    `{"itemScores": [{"item": ..., "score": ...}]}`.

A deployment warms one cosine plan per factor algorithm
(`ops.topk_sharded.similar_plan`: `BucketedSimilar`, or
`ShardedBucketedSimilar` over a serving mesh); the cooccurrence model
has no plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              IdentityPreparator, Serving)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models.common import (item_categories,
                                                  resolve_item_mask)
from predictionio_tpu_torch.ops.als import als_train
from predictionio_tpu_torch.ops.cooccur import (
    CooccurrenceModel, merge_pair_counts, top_cooccurrences_from_pairs)
from predictionio_tpu_torch.ops.topk import NEG_INF, topk_similar
from predictionio_tpu_torch.ops.topk_sharded import similar_plan


@dataclass(frozen=True)
class Query(Params):
    items: Sequence[str] = ()
    num: int = 10
    categories: Optional[Sequence[str]] = None
    whiteList: Optional[Sequence[str]] = None
    blackList: Optional[Sequence[str]] = None


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    itemScores: Sequence[ItemScore] = ()


@dataclass
class TrainingData:
    """views + likes + item categories (the template's TrainingData)."""
    views: RatingColumns
    likes: RatingColumns           # rating +1 like / -1 dislike
    item_categories: Dict[str, List[str]]


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None


class SimilarProductDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        p = self.params
        views = store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=["view"], value_spec={"*": 1.0})
        likes = store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=["like", "dislike"],
            value_spec={"like": 1.0, "dislike": -1.0},
            dedup_last_wins=True)   # the latest like/dislike wins
        return TrainingData(views, likes,
                            item_categories(ctx.registry, p.app_name,
                                            p.channel))


def _resolve_filters(model_items: BiMap, item_categories,
                     query: Query) -> np.ndarray:
    """Allowed-item mask: categories, white and black lists, and the
    query items themselves excluded (ALSAlgorithm.scala's predict
    filters)."""
    query_ix = [ix for it in query.items
                if (ix := model_items.get(it)) is not None]
    return resolve_item_mask(
        model_items, item_categories, categories=query.categories,
        white_list=query.whiteList, black_list=query.blackList or (),
        extra_blacklist_ix=query_ix)


@dataclass
class SimilarModel:
    """Item factors and categories (the P2L productFeatures analog),
    plus the user-side factors the streaming fold solves against; the
    tensors on the serving device."""
    item_factors: torch.Tensor
    items: BiMap
    item_categories: Dict[str, List[str]]
    user_factors: Optional[torch.Tensor] = None
    users: Optional[BiMap] = None

    @property
    def device(self) -> torch.device:
        return self.item_factors.device

    def sanity_check(self):
        assert torch.isfinite(self.item_factors).all()

    def to(self, device=None, items_device=None) -> "SimilarModel":
        """This model on `device` (None = cuda). The cosine plans serve
        from the item factors, so `items_device` is that of the plans'
        master too."""
        dev = resolve_device(device)
        item_dev = dev if items_device is None else resolve_device(
            items_device)
        uf = None if self.user_factors is None else self.user_factors.to(
            dev)
        return SimilarModel(self.item_factors.to(item_dev), self.items,
                            self.item_categories, user_factors=uf,
                            users=self.users)


class _FactorSimilarityAlgorithm(Algorithm):
    """Shared predict: cosine top-k against the mean of the query items'
    factors, one device program per batch."""

    query_class = Query

    def __init__(self, params: Optional[Params] = None):
        super().__init__(params)
        self._serve_plan = None

    def predict(self, model: SimilarModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def warm_serving(self, model: SimilarModel, buckets, mesh=None) -> int:
        """Deploy warmup: the cosine plan `similar_plan` picks (the item
        factors pinned on the model's device, or sharded over `mesh`),
        every bucket run once."""
        self._serve_plan = similar_plan(
            model.item_factors, k=Query().num, buckets=buckets, mesh=mesh,
            device=model.device)
        return self._serve_plan.warm()

    def batch_predict(self, model: SimilarModel,
                      queries: Sequence[Tuple[int, Query]]
                      ) -> List[Tuple[int, PredictedResult]]:
        out: List[Tuple[int, PredictedResult]] = []
        live = []
        for i, q in queries:
            ixs = [ix for it in q.items
                   if (ix := model.items.get(it)) is not None]
            if not ixs:   # no known query item: empty (the template warns)
                out.append((i, PredictedResult()))
            else:
                live.append((i, q, ixs))
        if not live:
            return out
        factors = model.item_factors
        n_items = factors.shape[0]
        k = max(min(q.num, n_items) for _, q, _ in live)
        vecs = torch.stack([
            factors[torch.tensor(ixs, device=factors.device)].mean(dim=0)
            for _, _, ixs in live])
        mask = np.concatenate(
            [_resolve_filters(model.items, model.item_categories, q)
             for _, q, _ in live], axis=0)
        plan = self._serve_plan
        if plan is not None and plan.fits(k=k):
            scores, ixs = plan(vecs, mask)
        else:
            scores, ixs = topk_similar(vecs, factors, mask, k=k)
        for row, (i, q, _) in enumerate(live):
            found = [ItemScore(model.items.inverse(int(ix)), float(s))
                     for s, ix in zip(scores[row], ixs[row])
                     if s > NEG_INF / 2][:q.num]
            out.append((i, PredictedResult(tuple(found))))
        return out

    def _fold(self, model: SimilarModel, fctx, *, event_names,
              value_spec, dedup_last_wins) -> Optional[SimilarModel]:
        """Shared streaming fold: implicit-ALS half-steps (on the card)
        over the rows this algorithm's delta events touched: user rows
        against the fixed item factors, then item rows against the new
        user factors. A model with no user-side factors needs the full
        rebuild."""
        from predictionio_tpu_torch.streaming.updaters import (
            fold_als_items, fold_als_users)
        if model.user_factors is None or model.users is None:
            raise DeltaInvalidated(
                "artifact predates streaming (no user-side factors); "
                "full rebuild required")
        p = self.params
        cols = fctx.delta_columns(
            entity_type="user", event_names=list(event_names),
            value_spec=value_spec, require_target=True)
        if cols.n == 0:
            return None
        history = fctx.history_columns(
            entity_type="user", event_names=list(event_names),
            value_spec=value_spec, require_target=True)
        uf, users2, _ = fold_als_users(
            history, model.users, model.items, model.user_factors,
            model.item_factors, list(cols.entities),
            dedup_last_wins=dedup_last_wins, reg=p.lambda_, implicit=True,
            alpha=p.alpha)
        yf, _ = fold_als_items(
            history, users2, model.items, uf, model.item_factors,
            list(cols.targets), dedup_last_wins=dedup_last_wins,
            reg=p.lambda_, implicit=True, alpha=p.alpha)
        return SimilarModel(yf, model.items, model.item_categories,
                            user_factors=uf, users=users2)


@dataclass(frozen=True)
class ALSParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None


def _train_implicit(ctx: RuntimeContext, p: ALSParams, cols: RatingColumns,
                    item_categories) -> SimilarModel:
    x, y = als_train(
        cols, rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
        implicit=True, alpha=p.alpha,
        seed=p.seed if p.seed is not None else 0,
        timings=ctx.phase_timings, device=ctx.device)
    return SimilarModel(y, cols.items, item_categories, user_factors=x,
                        users=cols.users)


class ALSAlgorithm(_FactorSimilarityAlgorithm):
    """Implicit ALS on view events (ALSAlgorithm.scala:120)."""

    params_class = ALSParams

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> SimilarModel:
        if pd.views.n == 0:
            raise ValueError("No view events found "
                             "(ALSAlgorithm.scala require non-empty)")
        return _train_implicit(ctx, self.params, pd.views,
                               pd.item_categories)

    def fold_in(self, model: SimilarModel, delta,
                fctx) -> Optional[SimilarModel]:
        """Streaming fold-in on the delta's view events."""
        return self._fold(model, fctx, event_names=["view"],
                          value_spec={"*": 1.0}, dedup_last_wins=False)


class LikeAlgorithm(_FactorSimilarityAlgorithm):
    """Implicit ALS on like (+1) / dislike (-1) events
    (LikeAlgorithm.scala:37-101)."""

    params_class = ALSParams

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> SimilarModel:
        if pd.likes.n == 0:
            raise ValueError("No like/dislike events found")
        return _train_implicit(ctx, self.params, pd.likes,
                               pd.item_categories)

    def fold_in(self, model: SimilarModel, delta,
                fctx) -> Optional[SimilarModel]:
        """Streaming fold-in on like/dislike events (the latest of a pair
        wins, as in training)."""
        return self._fold(model, fctx, event_names=["like", "dislike"],
                          value_spec={"like": 1.0, "dislike": -1.0},
                          dedup_last_wins=True)


@dataclass(frozen=True)
class CooccurrenceParams(Params):
    n: int = 20   # cooccurrences kept per item
    # optional per-user distinct-item cap (Mahout --maxPrefsPerUser);
    # None = exact parity with the reference self-join
    max_items_per_user: Optional[int] = None


@dataclass
class CoocModel:
    top: CooccurrenceModel
    items: BiMap
    item_categories: Dict[str, List[str]]


class CooccurrenceAlgorithm(Algorithm):
    """(CooccurrenceAlgorithm.scala:47-110)"""

    params_class = CooccurrenceParams
    query_class = Query

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> CoocModel:
        """The top-n partners of every item, counted on `ctx.device`."""
        views = pd.views
        top = top_cooccurrences_from_pairs(
            views.user_ix, views.item_ix,
            len(views.users), len(views.items), self.params.n,
            max_items_per_user=self.params.max_items_per_user,
            device=ctx.device)
        return CoocModel(top, views.items, pd.item_categories)

    def fold_in(self, model: CoocModel, delta,
                fctx) -> Optional[CoocModel]:
        """Streaming count-merge fold: for each user the delta touched,
        an item is NEWLY connected when its full-history view count
        equals its delta view count (every view of it by that user is in
        the delta), and each new item pairs once with the user's other
        distinct items: exactly the pairs the reference self-join would
        gain. The increments merge into the stored top-N lists through
        `ops.cooccur.merge_pair_counts` (its docstring states the
        truncation's approximation; the full retrain is ground truth)."""
        cols = fctx.delta_columns(
            entity_type="user", event_names=["view"],
            value_spec={"*": 1.0}, require_target=True)
        if cols.n == 0:
            return None
        delta_cnt: Dict[str, Dict[str, int]] = {}
        for eix, tix in zip(cols.entity_ix, cols.target_ix):
            u = cols.entities[int(eix)]
            it = cols.targets[int(tix)]
            d = delta_cnt.setdefault(u, {})
            d[it] = d.get(it, 0) + 1
        pairs: Dict[Tuple[int, int], float] = {}
        for u, dcnt in delta_cnt.items():
            full: Dict[int, int] = {}
            for ev in fctx.user_history(u, ["view"]):
                ix = model.items.get(ev.target_entity_id)
                if ix is None:
                    raise DeltaInvalidated(
                        f"user {u!r} viewed unknown item "
                        f"{ev.target_entity_id!r}; full rebuild "
                        "required")
                full[ix] = full.get(ix, 0) + 1
            new: List[int] = []
            for it, c in dcnt.items():
                ix = model.items.get(it)
                if ix is None:
                    raise DeltaInvalidated(
                        f"new item {it!r} in delta; full rebuild "
                        "required")
                if full.get(ix, 0) == c:
                    new.append(ix)
            new_set = set(new)
            old = [ix for ix in full if ix not in new_set]
            for ai, a in enumerate(new):
                for b in old + new[ai + 1:]:
                    key = (a, b) if a < b else (b, a)
                    pairs[key] = pairs.get(key, 0.0) + 1.0
        if not pairs:
            return None
        return CoocModel(merge_pair_counts(model.top, pairs),
                         model.items, model.item_categories)

    def predict(self, model: CoocModel, query: Query) -> PredictedResult:
        n_items = len(model.items)
        scores = np.zeros(n_items, np.float64)
        for it in query.items:
            ix = model.items.get(it)
            if ix is None:
                continue
            scores[model.top.top_items[ix]] += model.top.top_counts[ix]
        mask = _resolve_filters(model.items, model.item_categories, query)[0]
        scores[~mask] = -np.inf
        # np.argsort's default (unstable) order, as in the JAX package:
        # tied items come out in its order
        order = np.argsort(-scores)[:query.num]
        found = [ItemScore(model.items.inverse(int(ix)), float(scores[ix]))
                 for ix in order if np.isfinite(scores[ix]) and scores[ix] > 0]
        return PredictedResult(tuple(found))


class ScoreAverageServing(Serving):
    """Average the score per item across the algorithms that answered
    (Serving.scala of multi-events-multi-algos)."""

    def serve(self, query: Query,
              predictions: Sequence[PredictedResult]) -> PredictedResult:
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for p in predictions:
            for s in p.itemScores:
                sums[s.item] = sums.get(s.item, 0.0) + s.score
                counts[s.item] = counts.get(s.item, 0) + 1
        averaged = [ItemScore(item, sums[item] / counts[item])
                    for item in sums]
        averaged.sort(key=lambda s: -s.score)
        return PredictedResult(tuple(averaged[:query.num]))


class SimilarProductEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source=SimilarProductDataSource,
            preparator=IdentityPreparator,
            algorithms={"als": ALSAlgorithm, "": ALSAlgorithm,
                        "likealgo": LikeAlgorithm,
                        "cooccurrence": CooccurrenceAlgorithm},
            serving=ScoreAverageServing,
        )


def engine() -> Engine:
    return SimilarProductEngine.apply()


register_engine("similarproduct", SimilarProductEngine)
