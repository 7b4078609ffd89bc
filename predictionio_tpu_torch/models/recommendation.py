"""Recommendation template: explicit ALS with blacklist and whitelist
filtering.

The port of `predictionio_tpu/models/recommendation.py` (parity target
`examples/scala-parallel-recommendation/blacklist-items/`):
  - the data source reads `rate` events (rating property) and `buy`
    events (`buy_rating`) of the app and channel through the columnar
    store read (`data.store.rating_columns`, last rating per (user,
    item) wins), as DataSource.scala:43-72 does;
  - ALSAlgorithm.train wraps `ops.als.als_train` (MLlib explicit ALS,
    `ALSAlgorithm.scala:51-93`) on the context's device;
  - predict = top-N with blacklist filter, empty result for unknown
    users (`ALSAlgorithm.scala:96-112`);
  - wire format: query `{"user": "1", "num": 4}` ->
    `{"itemScores": [{"item": "i", "score": s}]}`;
  - streaming fold-in (`ALSAlgorithm.fold_in`): the delta's touched
    users re-solved against fixed item factors, then the touched items
    against the new user factors, on the serving device;
  - eval: the data source's k-fold `read_eval` (DataSource.scala:
    76-101) and `PrecisionAtK` (the template's Evaluation.scala).

A deployment serves blackList queries through the warmed plan that
`ops.topk_sharded.serve_plan` picks (single-device, sharded, tiered or
a fleet slice), that is through the fused CUDA kernel; whiteList
queries and queries past the plan (num > 10, more than 64 bans) take
the generic paths: on the card over a single-device plan's factors,
in host RAM over the item master when a sharded or tiered plan holds
the card's copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              FirstServing,
                                              IdentityPreparator)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.evaluation import OptionAverageMetric
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.models.common import (generic_factors,
                                                  resolve_item_mask)
from predictionio_tpu_torch.ops.als import ALSModel, als_train
from predictionio_tpu_torch.ops.topk import (NEG_INF, BucketedTopK,
                                             _off_host, topk_scores,
                                             topk_scores_filtered)
from predictionio_tpu_torch.ops.topk_sharded import serve_plan


@dataclass(frozen=True)
class Query(Params):
    user: str
    num: int = 10
    blackList: Optional[Sequence[str]] = None
    whiteList: Optional[Sequence[str]] = None


@dataclass(frozen=True)
class ItemScore:
    item: str
    score: float


@dataclass(frozen=True)
class PredictedResult:
    itemScores: Sequence[ItemScore] = ()


@dataclass(frozen=True)
class ActualResult:
    """The test-fold ratings of the query's user (Evaluation.scala)."""
    ratings: Sequence[Tuple[str, float]] = ()


@dataclass(frozen=True)
class EvalParams(Params):
    """(DataSourceEvalParams, DataSource.scala:30)"""
    k_fold: int = 3
    query_num: int = 10


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None
    buy_rating: float = 4.0
    eval_params: Optional[EvalParams] = None


class RecommendationDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> RatingColumns:
        """The app's ratings from the run context's registry: the same
        columns as `RatingColumns.from_events` with rating_of {rate ->
        properties.rating, buy -> buy_rating} (DataSource.scala:61-66),
        scanned without Event objects."""
        p = self.params
        return store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=["rate", "buy"],
            value_spec={"rate": ("prop", "rating"),
                        "buy": float(p.buy_rating)},
            dedup_last_wins=True)

    def read_eval(self, ctx: RuntimeContext):
        """k folds by rating index modulo k (CrossValidation.scala:26-67
        splitData): per fold the other folds' ratings to train on and,
        for each user of the test fold in id order, a query for
        `query_num` items with the user's test ratings in store order.
        The lists come from one stable sort of the test ratings by user,
        equal to the JAX package's per-user scan of every rating."""
        p = self.params
        if p.eval_params is None:
            raise ValueError("eval requires DataSourceParams.eval_params")
        rc = self.read_training(ctx)
        k = p.eval_params.k_fold
        fold_of = np.arange(rc.n) % k
        folds = []
        for fold in range(k):
            test_sel = fold_of == fold
            train = RatingColumns(
                rc.user_ix[~test_sel], rc.item_ix[~test_sel],
                rc.rating[~test_sel], rc.t_millis[~test_sel],
                rc.users, rc.items)
            test = np.nonzero(test_sel)[0]
            test = test[np.argsort(rc.user_ix[test], kind="stable")]
            users = rc.user_ix[test]
            starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]])
            qa: List[Tuple[Query, ActualResult]] = []
            for rows in np.split(test, starts[1:]) if test.size else ():
                ratings = tuple(
                    (rc.items.inverse(int(i)), float(r))
                    for i, r in zip(rc.item_ix[rows], rc.rating[rows]))
                qa.append((Query(user=rc.users.inverse(int(
                    rc.user_ix[rows[0]])), num=p.eval_params.query_num),
                           ActualResult(ratings)))
            folds.append((train, f"fold{fold}", qa))
        return folds


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: Optional[int] = None


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    query_class = Query

    # the plan's width: blackLists up to this many known ids fit it
    SERVE_BANNED_WIDTH = 64

    def __init__(self, params: Optional[Params] = None):
        super().__init__(params)
        self._serve_plan = None   # the plan warm_serving built

    def train(self, ctx: RuntimeContext, pd: RatingColumns) -> ALSModel:
        """Explicit ALS on `ctx.device` (None = cuda); the solver phases
        and `solver_residual` go into `ctx.phase_timings`."""
        p = self.params
        if pd.n == 0:
            raise ValueError(
                "No rating events found; check appName and event import "
                "(parity: ALSAlgorithm.scala:56-61 require non-empty)")
        x, y = als_train(
            pd, rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
            seed=p.seed if p.seed is not None else 0,
            timings=ctx.phase_timings, device=ctx.device)
        return ALSModel(x, y, pd.users, pd.items)

    def predict(self, model: ALSModel, query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def warm_serving(self, model: ALSModel, buckets, mesh=None) -> int:
        """Deploy warmup: build the serving plan `serve_plan` picks (the
        item factors pinned on the model's device; sharded over `mesh`
        when it is forced or the catalog exceeds one device; tiered past
        the device budget when the item master lies in host RAM) and
        launch the fused kernel once per bucket (blackList queries are
        the common case; whiteList queries use the dense-mask path).

        A sharded, tiered or slice plan holds its own device state, so
        the model's item master moves to host RAM here (it serves the
        generic paths from there): no whole copy of the catalog stays
        on a card beside the plan's."""
        plan = serve_plan(
            model.item_factors, k=Query(user="").num, buckets=buckets,
            banned_width=self.SERVE_BANNED_WIDTH, mesh=mesh,
            device=model.device)
        if not isinstance(plan, BucketedTopK) \
                and _off_host(model.item_factors):
            model.item_factors = model.item_factors.cpu()
        self._serve_plan = plan
        return plan.warm()

    def _generic_factors(self, model: ALSModel) -> torch.Tensor:
        return generic_factors(self._serve_plan, model.item_factors)

    def fold_in(self, model: ALSModel, delta, fctx) -> Optional[ALSModel]:
        """Streaming fold-in: closed-form ALS half-steps over the delta's
        touched rows only: touched users re-solved against fixed item
        factors, then touched items against the new user factors, with
        the data source's semantics (rate -> rating, buy -> buy_rating,
        the last rating of a pair wins). Untouched rows stay
        bit-identical; None when the delta holds no rating of this
        template. The periodic full retrain stays ground truth."""
        from predictionio_tpu_torch.streaming.updaters import (
            fold_als_items, fold_als_users)
        p = self.params
        buy_rating = float(fctx.ds_params.get("buy_rating", 4.0))
        # touched sets under THIS template's events: a user touched only
        # by a foreign event has no rating history, and folding it would
        # zero a good row
        rated = fctx.delta_columns(
            entity_type="user", event_names=["rate", "buy"],
            value_spec={"*": 1.0}, require_target=True)
        if rated.n == 0:
            return None
        # the data source's read: rate -> its rating (dropped without
        # one), buy -> buy_rating, the last rating of a pair wins
        history = fctx.history_columns(
            entity_type="user", event_names=["rate", "buy"],
            value_spec={"rate": ("prop", "rating"), "buy": buy_rating},
            require_target=True)
        uf, users2, _ = fold_als_users(
            history, model.users, model.items, model.user_factors,
            model.item_factors, list(rated.entities), dedup_last_wins=True,
            reg=p.lambda_)
        yf, _ = fold_als_items(
            history, users2, model.items, uf, model.item_factors,
            list(rated.targets), dedup_last_wins=True, reg=p.lambda_)
        return ALSModel(uf, yf, users2, model.items)

    def batch_predict(self, model: ALSModel,
                      queries: Sequence[Tuple[int, Query]]
                      ) -> List[Tuple[int, PredictedResult]]:
        """One scoring call over the whole batch; unknown users get empty
        results (ALSAlgorithm.scala:96-112 semantics)."""
        known = [(i, q, model.users.get(q.user)) for i, q in queries]
        out: List[Tuple[int, PredictedResult]] = [
            (i, PredictedResult()) for i, _, u in known if u is None]
        live = [(i, q, u) for i, q, u in known if u is not None]
        if not live:
            return out
        n_items = model.item_factors.shape[0]
        k = max(min(q.num, n_items) for _, q, _ in live)
        rows = torch.tensor([u for _, _, u in live], device=model.device)
        vecs = model.user_factors[rows]
        if all(q.whiteList is None for _, q, _ in live):
            banned = [
                [ix for ix in (model.items.get(b) for b in (q.blackList or ()))
                 if ix is not None]
                for _, q, _ in live]
            plan = self._serve_plan
            if plan is not None and plan.fits(
                    max_banned=max(map(len, banned), default=0), k=k):
                scores, ixs = plan(vecs, banned)
            else:
                items = self._generic_factors(model)
                scores, ixs = topk_scores_filtered(
                    vecs.to(items.device), items, banned, k=k)
        else:
            mask = np.concatenate(
                [resolve_item_mask(model.items, white_list=q.whiteList,
                                   black_list=q.blackList or ())
                 for _, q, _ in live], axis=0)
            items = self._generic_factors(model)
            scores, ixs = topk_scores(vecs.to(items.device), items, mask,
                                      k=k)
        for row, (i, q, _) in enumerate(live):
            items = []
            for s, ix in zip(scores[row], ixs[row]):
                if s <= NEG_INF / 2 or len(items) >= q.num:
                    continue
                items.append(ItemScore(model.items.inverse(int(ix)),
                                       float(s)))
            out.append((i, PredictedResult(tuple(items))))
        return out


class PrecisionAtK(OptionAverageMetric):
    """Precision@K with a rating threshold: of the top-K recommended
    items, the fraction the user rated >= threshold in the test fold,
    over min(k, |positives|); None (skipped) when the user has no
    positive item there (`examples/scala-parallel-recommendation/
    blacklist-items/src/main/scala/Evaluation.scala`)."""

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    def header(self) -> str:
        return f"Precision@K (k={self.k}, threshold={self.rating_threshold})"

    def calculate_one(self, q: Query, p: PredictedResult,
                      a: ActualResult) -> Optional[float]:
        positives = {item for item, r in a.ratings
                     if r >= self.rating_threshold}
        if not positives:
            return None
        top = [s.item for s in p.itemScores[:self.k]]
        if not top:
            return 0.0
        hits = sum(1 for item in top if item in positives)
        return hits / min(self.k, len(positives))


class RecommendationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(data_source=RecommendationDataSource,
                      preparator=IdentityPreparator,
                      algorithms={"als": ALSAlgorithm, "": ALSAlgorithm},
                      serving=FirstServing)


register_engine("recommendation", RecommendationEngine)
