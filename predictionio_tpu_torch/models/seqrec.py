"""Sequential recommender template: a causal transformer over each
user's item history.

The port of `predictionio_tpu/models/seqrec.py` (no reference
counterpart: the reference's recommenders are order-blind). It reads the
recommendation template's event shapes and answers its wire format
(`"engineFactory": "seqrec"`):
  - train: `ops.seqrec.build_sequences` over the interactions, then
    `seqrec_train` on the context's device (None = cuda; raises without
    CUDA unless "cpu");
  - predict: the user's RECENT history read from the event store at
    query time (4 x seq_len events newest first, the ones the model's
    item map knows, the last seq_len of them: the e-commerce template's
    serve-time read, ECommAlgorithm.scala:331-430), right-aligned with
    PAD, encoded on the model's device (`seqrec_encode`), then scored
    through `models.common.score_and_rank`; a user with no history gets
    an empty result. `serve_paths` counts the store reads and their
    seconds, and the encodes and theirs;
  - streaming fold-in: one warm-start epoch over sequences rebuilt from
    the store's full interaction set on the model's device; only a new
    ITEM raises `DeltaInvalidated` (the tied table's shape is baked into
    the net). New users need nothing: serving reads their history.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.core.base import (Algorithm, FirstServing,
                                              IdentityPreparator)
from predictionio_tpu_torch.core.engine import Engine, EngineFactory
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.runtime import RuntimeContext
from predictionio_tpu_torch.core.workflow import register_engine
from predictionio_tpu_torch.data import store
from predictionio_tpu_torch.data.storage.base import DeltaInvalidated
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ingest.arrays import RatingColumns
from predictionio_tpu_torch.models.common import (
    INTERACTION_EVENTS, InteractionDataSource, InteractionDataSourceParams,
    NeuralServingModel, score_and_rank)
from predictionio_tpu_torch.models.recommendation import (PredictedResult,
                                                          Query)
from predictionio_tpu_torch.ops.seqrec import (SeqRecModel, build_sequences,
                                               seqrec_encode, seqrec_train)

EVENT_NAMES = INTERACTION_EVENTS
DataSourceParams = InteractionDataSourceParams
SeqRecDataSource = InteractionDataSource


class SeqRecServingModel(NeuralServingModel):
    """`net` holds the encoder's weights (`ops.seqrec.SeqRecModel`)."""


@dataclass(frozen=True)
class SeqRecParams(Params):
    app_name: str = "default"           # serve-time history reads
    channel: Optional[str] = None
    event_names: Sequence[str] = EVENT_NAMES
    seq_len: int = 32
    dim: int = 64
    n_heads: int = 2
    n_layers: int = 2
    batch_size: int = 256
    epochs: int = 20
    lr: float = 3e-3
    temperature: float = 0.07
    seed: Optional[int] = None


class SeqRecAlgorithm(Algorithm):
    params_class = SeqRecParams
    query_class = Query

    def __init__(self, params: Optional[Params] = None):
        super().__init__(params)
        self._serving_ctx = None
        self.serve_paths = {"store_reads": 0, "store_read_s": 0.0,
                            "encodes": 0, "encode_s": 0.0}

    def _train(self, seqs, targets, n_items: int, seq_len: int, device, *,
               epochs: int, init_params=None) -> SeqRecModel:
        p = self.params
        return seqrec_train(
            seqs, targets, n_items=n_items, seq_len=seq_len, dim=p.dim,
            n_heads=p.n_heads, n_layers=p.n_layers,
            batch_size=min(p.batch_size, len(seqs)), epochs=epochs,
            lr=p.lr, temperature=p.temperature,
            seed=p.seed if p.seed is not None else 0, device=device,
            init_params=init_params)

    def train(self, ctx: RuntimeContext,
              pd: RatingColumns) -> SeqRecServingModel:
        # the training context also serves direct train -> predict use;
        # prepare_deploy binds a fresh one at deploy time
        self._serving_ctx = ctx
        p = self.params
        if pd.n == 0:
            raise ValueError("No interaction events found")
        seqs, targets = build_sequences(
            pd.user_ix, pd.item_ix, pd.t_millis,
            n_items=len(pd.items), seq_len=p.seq_len)
        if not len(seqs):
            raise ValueError(
                "No user has >= 2 events; sequences cannot be built")
        dev = resolve_device(ctx.device)
        net = self._train(seqs, targets, len(pd.items), p.seq_len, dev,
                          epochs=p.epochs)
        return SeqRecServingModel(net, pd.users, pd.items, str(dev))

    def fold_in(self, model: SeqRecServingModel, delta,
                fctx) -> Optional[SeqRecServingModel]:
        """One warm-start epoch from the served weights over sequences
        rebuilt from the full event set (fresh Adam moments: a
        mini-epoch, not a retrain); the delta only decides whether it
        runs. None when the delta holds none of the template's events or
        no user has two of them."""
        p = self.params
        spec = dict(entity_type="user", event_names=list(p.event_names),
                    value_spec={"*": 1.0}, require_target=True)
        if fctx.delta_columns(**spec).n == 0:
            return None
        full = fctx.history_columns(**spec)
        i_of = np.array([model.items.get(t, -1) for t in full.targets],
                        np.int64)
        if (i_of < 0).any():
            raise DeltaInvalidated(
                "new items since train: the tied item-table shape is "
                "baked into the net; full rebuild required")
        seqs, targets = build_sequences(
            full.entity_ix.astype(np.int64), i_of[full.target_ix],
            full.t_millis, n_items=model.net.n_items,
            seq_len=model.net.seq_len)
        if not len(seqs):
            return None
        net = self._train(seqs, targets, model.net.n_items,
                          model.net.seq_len, model.device, epochs=1,
                          init_params=model.net.params)
        return SeqRecServingModel(net, model.users, model.items,
                                  model.device)

    # -- serving -------------------------------------------------------------
    def _ctx(self) -> RuntimeContext:
        if self._serving_ctx is None:
            raise RuntimeError(
                "SeqRecAlgorithm.predict needs a serving context for "
                "its event-store reads; train/deploy through the Engine "
                "workflow, or call with_serving_context(ctx) first")
        return self._serving_ctx

    def with_serving_context(self, ctx: RuntimeContext) -> None:
        self._serving_ctx = ctx

    def _history(self, model: SeqRecServingModel, user: str) -> List[int]:
        """The user's most recent item ids the model knows, newest last.
        The read is 4 x seq_len wide before the filter: the item map is
        frozen at training, so a burst of events on newer items must
        give way to older known history, not empty it."""
        p = self.params
        t0 = time.perf_counter()
        try:
            events = list(store.find_by_entity(
                self._ctx().registry, p.app_name, channel_name=p.channel,
                entity_type="user", entity_id=user,
                event_names=list(p.event_names),
                limit=4 * model.net.seq_len, latest_first=True))
        except store.AppNotFoundError:
            return []
        finally:
            self.serve_paths["store_reads"] += 1
            self.serve_paths["store_read_s"] += time.perf_counter() - t0
        hist = [ix for e in reversed(events)
                if e.target_entity_id is not None
                and (ix := model.items.get(e.target_entity_id)) is not None]
        return hist[-model.net.seq_len:]

    def predict(self, model: SeqRecServingModel,
                query: Query) -> PredictedResult:
        return self.batch_predict(model, [(0, query)])[0][1]

    def batch_predict(self, model: SeqRecServingModel,
                      queries: Sequence[Tuple[int, Query]]
                      ) -> List[Tuple[int, PredictedResult]]:
        out: List[Tuple[int, PredictedResult]] = []
        live = []
        S = model.net.seq_len
        for i, q in queries:
            hist = self._history(model, q.user)
            if not hist:
                out.append((i, PredictedResult()))
            else:
                live.append((i, q, hist))
        if not live:
            return out
        seqs = np.full((len(live), S), model.net.n_items, np.int32)
        for row, (_, _, hist) in enumerate(live):
            seqs[row, S - len(hist):] = hist
        t0 = time.perf_counter()
        vecs = seqrec_encode(model.net, seqs, device=model.device)
        self.serve_paths["encodes"] += 1
        self.serve_paths["encode_s"] += time.perf_counter() - t0
        out.extend(score_and_rank(vecs, model.net.item_emb, model.items,
                                  live, device=model.device))
        return out


class SeqRecEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source=SeqRecDataSource,
            preparator=IdentityPreparator,
            algorithms={"seqrec": SeqRecAlgorithm, "": SeqRecAlgorithm},
            serving=FirstServing,
        )


def engine() -> Engine:
    return SeqRecEngine.apply()


register_engine("seqrec", SeqRecEngine)
