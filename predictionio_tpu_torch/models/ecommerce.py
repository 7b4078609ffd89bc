"""E-commerce recommendation template: implicit ALS with serving-time
constraints and a popularity fallback.

The port of `predictionio_tpu/models/ecommerce.py` (parity target
`examples/scala-parallel-ecommercerecommendation/adjust-score/src/main/
scala/ECommAlgorithm.scala`):
  - train: implicit ALS on `view` events on the context's device (over
    its mesh when that has two or more "data" shards), plus
    buy-count popularity (`train:90-160`, `trainDefault:214+`); the buys
    share the views' BiMaps, so popularity lines up with the factors;
  - three-way predict (`predict:331-430`):
      known user   -> dot(user vector, item vectors)  (predictKnownUser:469)
      unknown user -> cosine to recently viewed items  (predictSimilar:539)
      no signal    -> popularity (buy counts)          (predictDefault:506)
  - serving-time event-store reads inside predict: the user's seen items
    (view and buy events) and the latest `$set` of the constraint entity
    `unavailableItems`; the reference reads LEventStore per request with
    200 ms timeouts, here the same reads hit the store synchronously;
  - filters: categories, whiteList, blackList, seen, unavailable.

A deployment serves known-user queries without categories or whiteList
through the warmed plan `ops.topk_sharded.serve_plan` picks, its banned
width sized to the unavailable items plus headroom: on a card, the fused
CUDA kernel. Queries whose bans outgrow the plan take the generic
`topk_scores_filtered` (the plain version on the card), the rest the
per-query three-way predict. `serve_paths` counts the queries of each
path and the store reads with their seconds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              FirstServing,
                                              IdentityPreparator)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.ingest.bimap import BiMap
from predictionio_tpu_torch.models.common import (generic_factors,
                                                  item_categories,
                                                  resolve_item_mask)
from predictionio_tpu_torch.ops.als import als_train
from predictionio_tpu_torch.ops.topk import (NEG_INF, BucketedTopK,
                                             _next_pow2, _off_host,
                                             topk_scores,
                                             topk_scores_filtered,
                                             topk_similar)
from predictionio_tpu_torch.ops.topk_sharded import serve_plan


@dataclass(frozen=True)
class Query(Params):
    user: str = ""
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
    views: RatingColumns
    buys: RatingColumns
    item_categories: Dict[str, List[str]]


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None


class ECommDataSource(DataSource):
    params_class = DataSourceParams

    def read_training(self, ctx: RuntimeContext) -> TrainingData:
        p = self.params
        views = store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=["view"], value_spec={"*": 1.0})
        # buys share the view BiMaps so popularity aligns with factors
        buys = store.rating_columns(
            ctx.registry, p.app_name, p.channel,
            event_names=["buy"], value_spec={"*": 1.0},
            users=views.users, items=views.items)
        return TrainingData(views, buys,
                            item_categories(ctx.registry, p.app_name,
                                            p.channel))


@dataclass
class ECommModel:
    """Factors, id maps, the buy-count popularity and the item
    categories; the tensors on the serving device (the item master may
    lie in host RAM while a sharded or tiered plan holds the card's
    copy)."""
    user_factors: torch.Tensor      # [n_users, rank] f32
    item_factors: torch.Tensor      # [n_items, rank] f32
    users: BiMap
    items: BiMap
    popularity: torch.Tensor        # [n_items] f32 buy counts
    item_categories: Dict[str, List[str]]

    @property
    def device(self) -> torch.device:
        return self.user_factors.device

    def sanity_check(self):
        assert torch.isfinite(self.user_factors).all()
        assert torch.isfinite(self.item_factors).all()

    def to(self, device=None, items_device=None) -> "ECommModel":
        """This model on `device` (None = cuda), its item master on
        `items_device` (None = the same device)."""
        dev = resolve_device(device)
        item_dev = dev if items_device is None else resolve_device(
            items_device)
        return ECommModel(self.user_factors.to(dev),
                          self.item_factors.to(item_dev), self.users,
                          self.items, self.popularity.to(dev),
                          self.item_categories)


@dataclass(frozen=True)
class ECommParams(Params):
    app_name: str = "default"
    channel: Optional[str] = None
    unseen_only: bool = True
    seen_events: Sequence[str] = ("view", "buy")
    similar_events: Sequence[str] = ("view",)
    num_recent_events: int = 10
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # None = the solver's default; raise it for large implicit problems,
    # whose normal equations a high alpha makes stiff
    cg_iters: Optional[int] = None


class ECommAlgorithm(Algorithm):
    params_class = ECommParams
    query_class = Query

    def __init__(self, params: Optional[Params] = None):
        super().__init__(params)
        self._serve_plan = None
        self._serving_ctx = None
        # queries by the path that answered them, and the store reads
        # made for them (count, seconds)
        self.serve_paths = {"plan": 0, "generic": 0, "per_query": 0,
                            "store_reads": 0, "store_read_s": 0.0}

    def train(self, ctx: RuntimeContext, pd: TrainingData) -> ECommModel:
        """Implicit ALS on `ctx.device` (sharded over `ctx.mesh` when
        it has two or more "data" shards); the solver phases and the
        residual of the run go into `ctx.phase_timings`, whose
        `solver_residual` the convergence gates read."""
        # the training context also serves direct train -> predict use;
        # prepare_deploy binds a fresh one at deploy time
        self._serving_ctx = ctx
        p = self.params
        if pd.views.n == 0:
            raise ValueError("No view events found "
                             "(ECommAlgorithm.train require non-empty)")
        extra = {} if p.cg_iters is None else {"cg_iters": p.cg_iters}
        x, y = als_train(
            pd.views, rank=p.rank, iterations=p.num_iterations,
            reg=p.lambda_, implicit=True, alpha=p.alpha,
            seed=p.seed if p.seed is not None else 0, mesh=ctx.mesh,
            timings=ctx.phase_timings, device=ctx.device, **extra)
        pop = np.zeros(len(pd.views.items), np.float32)
        np.add.at(pop, pd.buys.item_ix, 1.0)
        return ECommModel(x, y, pd.views.users, pd.views.items,
                          torch.from_numpy(pop).to(x.device),
                          pd.item_categories)

    # -- serving-time store reads (ECommAlgorithm.scala:331-430) -----------
    def _find(self, ctx: RuntimeContext, **kw) -> list:
        t0 = time.perf_counter()
        try:
            return list(store.find_by_entity(
                ctx.registry, self.params.app_name,
                channel_name=self.params.channel, **kw))
        except store.AppNotFoundError:
            return []
        finally:
            self.serve_paths["store_reads"] += 1
            self.serve_paths["store_read_s"] += time.perf_counter() - t0

    def _seen_items(self, ctx: RuntimeContext, user: str) -> List[str]:
        p = self.params
        if not p.unseen_only:
            return []
        return [e.target_entity_id for e in self._find(
            ctx, entity_type="user", entity_id=user,
            event_names=list(p.seen_events)) if e.target_entity_id]

    def _unavailable_items(self, ctx: RuntimeContext) -> List[str]:
        events = self._find(ctx, entity_type="constraint",
                            entity_id="unavailableItems",
                            event_names=["$set"], limit=1,
                            latest_first=True)
        if not events:
            return []
        return list(events[0].properties.get_or_else("items", []))

    def _recent_items(self, ctx: RuntimeContext, user: str) -> List[str]:
        p = self.params
        return [e.target_entity_id for e in self._find(
            ctx, entity_type="user", entity_id=user,
            event_names=list(p.similar_events),
            limit=p.num_recent_events, latest_first=True)
            if e.target_entity_id]

    def _mask(self, ctx: RuntimeContext, model: ECommModel, query: Query,
              unavailable: Sequence[str]) -> np.ndarray:
        extra = [ix for it in unavailable
                 if (ix := model.items.get(it)) is not None]
        extra += [ix for it in self._seen_items(ctx, query.user)
                  if (ix := model.items.get(it)) is not None]
        return resolve_item_mask(
            model.items, model.item_categories, categories=query.categories,
            white_list=query.whiteList, black_list=query.blackList or (),
            extra_blacklist_ix=extra)

    def _ctx(self) -> RuntimeContext:
        if self._serving_ctx is None:
            raise RuntimeError(
                "ECommAlgorithm.predict needs a serving context for its "
                "event-store reads; train/deploy through the Engine "
                "workflow, or call with_serving_context(ctx) first")
        return self._serving_ctx

    def _generic_factors(self, model: ECommModel) -> torch.Tensor:
        return generic_factors(self._serve_plan, model.item_factors)

    def predict(self, model: ECommModel, query: Query) -> PredictedResult:
        ctx = self._ctx()
        return self._predict_one(ctx, model, query,
                                 self._unavailable_items(ctx))

    def _predict_one(self, ctx: RuntimeContext, model: ECommModel,
                     query: Query,
                     unavailable: Sequence[str]) -> PredictedResult:
        self.serve_paths["per_query"] += 1
        mask = self._mask(ctx, model, query, unavailable)
        items = self._generic_factors(model)
        k = min(query.num, items.shape[0])
        u_ix = model.users.get(query.user)
        if u_ix is not None and bool(model.user_factors[u_ix].any()):
            scores, ixs = topk_scores(
                model.user_factors[u_ix][None, :].to(items.device), items,
                mask, k=k)                                # predictKnownUser
        else:
            recent = [ix for it in self._recent_items(ctx, query.user)
                      if (ix := model.items.get(it)) is not None]
            if recent:
                vec = items[torch.tensor(recent, device=items.device)].mean(
                    dim=0)
                scores, ixs = topk_similar(vec[None, :], items, mask,
                                           k=k)           # predictSimilar
            else:
                pop = model.popularity
                scores, ixs = topk_scores(
                    torch.ones((1, 1), device=pop.device), pop[:, None],
                    mask, k=k)                            # predictDefault
        found = [ItemScore(model.items.inverse(int(ix)), float(s))
                 for s, ix in zip(scores[0], ixs[0]) if s > NEG_INF / 2]
        return PredictedResult(tuple(found))

    def warm_serving(self, model: ECommModel, buckets, mesh=None) -> int:
        """Deploy warmup: the banned-index plan `serve_plan` picks, its
        banned width sized to the CURRENT unavailableItems constraint
        plus headroom for a user's seen items and blackList, every bucket
        launched once. A sharded or tiered plan holds its own device
        state, so the model's item master moves to host RAM."""
        ctx = self._serving_ctx
        n_unavail = len(self._unavailable_items(ctx)) if ctx else 0
        width = _next_pow2(max(256, n_unavail + 128))
        plan = serve_plan(model.item_factors, k=Query().num,
                          buckets=buckets, banned_width=width, mesh=mesh,
                          device=model.device)
        if not isinstance(plan, BucketedTopK) \
                and _off_host(model.item_factors):
            model.item_factors = model.item_factors.cpu()
        self._serve_plan = plan
        return plan.warm()

    def fold_in(self, model: ECommModel, delta,
                fctx) -> Optional[ECommModel]:
        """Streaming fold-in: implicit-ALS half-steps (on the card) over
        the rows the delta's VIEW events touched, plus a buy-count merge
        into the popularity. The touched sets come from this template's
        own spec: a buy of a never-viewed item is outside the factor
        model (train builds the BiMaps from views) and forces no
        rebuild. Count-merged popularity may count events that race a
        full rebuild twice; the periodic full retrain stays ground
        truth. None when the delta holds neither views nor buys."""
        from predictionio_tpu_torch.streaming.updaters import (
            fold_als_items, fold_als_users)
        p = self.params
        views = fctx.delta_columns(
            entity_type="user", event_names=["view"],
            value_spec={"*": 1.0}, require_target=True)
        buys = fctx.delta_columns(
            entity_type="user", event_names=["buy"],
            value_spec={"*": 1.0}, require_target=True)
        pop = model.popularity.clone()
        bought = [ix for tix in buys.target_ix
                  if (ix := model.items.get(buys.targets[int(tix)]))
                  is not None]
        if bought:
            pop.index_add_(0, torch.tensor(bought, device=pop.device),
                           torch.ones(len(bought), device=pop.device))
        if views.n == 0:
            if buys.n == 0:
                return None
            return ECommModel(model.user_factors, model.item_factors,
                              model.users, model.items, pop,
                              model.item_categories)
        history = fctx.history_columns(
            entity_type="user", event_names=["view"],
            value_spec={"*": 1.0}, require_target=True)
        uf, users2, _ = fold_als_users(
            history, model.users, model.items, model.user_factors,
            model.item_factors, list(views.entities), dedup_last_wins=False,
            reg=p.lambda_, implicit=True, alpha=p.alpha)
        yf, _ = fold_als_items(
            history, users2, model.items, uf, model.item_factors,
            list(views.targets), dedup_last_wins=False, reg=p.lambda_,
            implicit=True, alpha=p.alpha)
        return ECommModel(uf, yf, users2, model.items, pop,
                          model.item_categories)

    def batch_predict(self, model: ECommModel, queries):
        """Batched serve path. Known-user queries without dense-mask needs
        (no categories, no whiteList) coalesce into one banned-index
        top-k: through the deploy-warmed plan when their bans fit it,
        else the generic `topk_scores_filtered`. Everything else
        (unknown users, dense filters) takes the per-query three-way
        predict. The unavailableItems read is shared by the batch."""
        ctx = self._ctx()
        unavailable = self._unavailable_items(ctx)
        unavail_ix = [ix for it in unavailable
                      if (ix := model.items.get(it)) is not None]
        n_items = model.item_factors.shape[0]
        batched = []    # (orig_i, query, user_ix, banned indices)
        out = []
        for i, q in queries:
            u_ix = model.users.get(q.user)
            if (q.categories is None and q.whiteList is None
                    and u_ix is not None
                    and bool(model.user_factors[u_ix].any())):
                banned = list(unavail_ix)
                banned += [ix for it in self._seen_items(ctx, q.user)
                           if (ix := model.items.get(it)) is not None]
                banned += [ix for it in (q.blackList or ())
                           if (ix := model.items.get(it)) is not None]
                batched.append((i, q, u_ix, banned))
            else:
                out.append((i, self._predict_one(ctx, model, q,
                                                 unavailable)))
        if not batched:
            return out
        plan = self._serve_plan

        def _fits_plan(q, banned) -> bool:
            return plan is not None and plan.fits(
                max_banned=len(banned), k=min(q.num, n_items))

        # per-query plan gating: a heavy user whose seen history
        # overflows the plan's banned width goes generic alone; the rest
        # of the batch keeps the plan
        fit = [r for r in batched if _fits_plan(r[1], r[3])]
        rest = [r for r in batched if not _fits_plan(r[1], r[3])]
        for rows, use_plan in ((fit, True), (rest, False)):
            if not rows:
                continue
            vecs = model.user_factors[torch.tensor(
                [u for _, _, u, _ in rows], device=model.device)]
            banned_lists = [b for _, _, _, b in rows]
            k = max(min(q.num, n_items) for _, q, _, _ in rows)
            if use_plan:
                scores, ixs = plan(vecs, banned_lists)
                self.serve_paths["plan"] += len(rows)
            else:
                items = self._generic_factors(model)
                scores, ixs = topk_scores_filtered(
                    vecs.to(items.device), items, banned_lists, k=k)
                self.serve_paths["generic"] += len(rows)
            for row, (i, q, _, _) in enumerate(rows):
                found = []
                for s, ix in zip(scores[row], ixs[row]):
                    if s <= NEG_INF / 2 or len(found) >= q.num:
                        continue
                    found.append(ItemScore(model.items.inverse(int(ix)),
                                           float(s)))
                out.append((i, PredictedResult(tuple(found))))
        return out

    def with_serving_context(self, ctx: RuntimeContext) -> "ECommAlgorithm":
        self._serving_ctx = ctx
        return self


class ECommerceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source=ECommDataSource,
            preparator=IdentityPreparator,
            algorithms={"ecomm": ECommAlgorithm, "": ECommAlgorithm},
            serving=FirstServing,
        )


def engine() -> Engine:
    return ECommerceEngine.apply()


register_engine("ecommerce", ECommerceEngine)
