"""Item-item cooccurrence counting.

The port of `predictionio_tpu/ops/cooccur.py`, which replaces the
similar-product template's RDD self-join
(`examples/scala-parallel-similarproduct/multi-events-multi-algos/src/main/
scala/CooccurrenceAlgorithm.scala:47-110`): count the users who
interacted with both items i and j, keep the top-N cooccurring items per
item.

Two regimes, on `device` (None = cuda; raises without CUDA unless
`device="cpu"`):

* Template scale (`cooccurrence_matrix`): with A the {0,1} user x item
  interaction matrix, C = A^T A, an fp32 product accumulated over user
  chunks on the device (TF32 off: counts below 2^24 are exact whatever
  the summation order). It materializes the dense [n_items, n_items]
  matrix, so it runs only up to `_DENSE_ITEM_LIMIT` items.

* Catalog scale (`top_cooccurrences_streaming`): never n^2. Items are
  taken in row blocks; for each block the COMPLETE rows C[b0:b0+B, :]
  are built on the device by scatter-adding (`index_put_` with
  accumulate), for every (user, item-in-block) pair, +1 at the columns
  of that user's whole item list, then reduced to the per-row top-N
  before the next block. The per-row top-N is exact because each block
  is fully accumulated first; the counts are exact integers in fp32, so
  the atomics' order changes no bit. Work is the sparse self-join's
  sum_u d_u^2, and device memory is the [B, n_items+1] block (column
  n_items is the dump column of the padding slots), its sort, and the
  degree-bucketed per-user item lists.

Every top-k ranks by (count desc, index asc), `lax.top_k`'s lowest-index
tie-break, through `ops.topk._topk_rows` (a stable sort): counts are
small integers, so ties are the rule, and a row with fewer than N
partners fills its tail with zero-count slots by lowest index, the
zeroed self column among them. Packing, the cap and the merge stay host
numpy, as in the JAX package.

Heavy users dominate sum_u d_u^2, so `max_items_per_user` optionally
caps each user's distinct items by a deterministic subsample (Mahout
ItemSimilarityJob's --maxPrefsPerUser). The default is uncapped: exact
parity with the reference self-join.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.topk import _topk_rows


def cooccurrence_matrix(user_ix: np.ndarray, item_ix: np.ndarray,
                        n_users: int, n_items: int, *,
                        user_chunk: int = 4096, device=None) -> np.ndarray:
    """Dense [n_items, n_items] cooccurrence counts (the diagonal is the
    item's popularity), accumulated on `device`, returned on the host.
    Duplicate (user, item) pairs count once, matching the reference's
    per-user distinct item sets."""
    dev = resolve_device(device)
    pairs = np.unique(np.stack([user_ix, item_ix], axis=1), axis=0)
    c = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
    # np.unique sorts by user, so each chunk is a contiguous slice found
    # by binary search
    for start in range(0, n_users, user_chunk):
        end = min(start + user_chunk, n_users)
        lo = np.searchsorted(pairs[:, 0], start, side="left")
        hi = np.searchsorted(pairs[:, 0], end, side="left")
        if lo == hi:
            continue
        rows = torch.from_numpy(pairs[lo:hi, 0] - start).to(dev)
        cols = torch.from_numpy(pairs[lo:hi, 1].astype(np.int64)).to(dev)
        a = torch.zeros((end - start, n_items), dtype=torch.float32,
                        device=dev)
        a[rows.long(), cols] = 1.0
        c.addmm_(a.T, a)
    return c.cpu().numpy()


@dataclass
class CooccurrenceModel:
    """Top-N cooccurring items per item (CooccurrenceAlgorithm.scala
    topCooccurrences)."""
    top_items: np.ndarray    # [n_items, n] int32 indexes
    top_counts: np.ndarray   # [n_items, n] float32 counts (0 = no entry)

    def sanity_check(self):
        assert self.top_items.shape == self.top_counts.shape


def merge_pair_counts(model: CooccurrenceModel,
                      pair_updates: Dict[Tuple[int, int], float]
                      ) -> CooccurrenceModel:
    """Fold symmetric pair-count increments into the stored top-N lists
    (the streaming count-merge fold of this model).

    Each ``(i, j) -> c`` update bumps j in i's row and i in j's row. A
    partner not in a row's top-N enters with count == the increment
    alone: its true historical count is unknown once the row was cut to
    top-N, so merged counts are a LOWER bound for new entrants, the
    documented approximation of the count-merge fold (the periodic full
    retrain is ground truth). Rows no update touches are returned
    untouched (the same row values, bit-equal)."""
    top_items = model.top_items.copy()
    top_counts = model.top_counts.copy()
    n_items, k = top_items.shape
    per_row: Dict[int, Dict[int, float]] = {}
    for (i, j), inc in pair_updates.items():
        if i == j:
            continue
        for row, col in ((int(i), int(j)), (int(j), int(i))):
            if row >= n_items or col >= n_items:
                raise ValueError(
                    f"pair ({row}, {col}) outside catalog of {n_items} "
                    "items — new items need a full rebuild")
            d = per_row.setdefault(row, {})
            d[col] = d.get(col, 0.0) + float(inc)
    for row, deltas in per_row.items():
        counts = {int(it): float(c)
                  for it, c in zip(top_items[row], top_counts[row])
                  if c > 0}
        for col, inc in deltas.items():
            counts[col] = counts.get(col, 0.0) + inc
        ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:k]
        top_items[row] = 0
        top_counts[row] = 0.0
        for s, (it, c) in enumerate(ranked):
            top_items[row, s] = it
            top_counts[row, s] = c
    return CooccurrenceModel(top_items, top_counts)


def top_cooccurrences(cooccur: np.ndarray, n: int, *,
                      device=None) -> CooccurrenceModel:
    """Top-`n` partners of every item of a dense count matrix, its self
    pairs dropped, ranked on `device`."""
    dev = resolve_device(device)
    c = torch.as_tensor(np.asarray(cooccur, np.float32), device=dev).clone()
    c.fill_diagonal_(0.0)   # drop self pairs
    counts, items = _topk_rows(c, min(n, c.shape[0]))
    return CooccurrenceModel(items.cpu().numpy().astype(np.int32),
                             counts.cpu().numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# streaming (catalog-scale) path
# ---------------------------------------------------------------------------

# above this many items the dense [n_items, n_items] counts matrix
# (f32) would cross 64 MiB and the router switches to streaming
_DENSE_ITEM_LIMIT = 4096

# default device budget for the [row_block, n_items+1] block accumulator
_BLOCK_BUDGET_BYTES = 256 * 1024 * 1024

# pairs scatter-added per step: bounds the [pairs, cap] index block
_PAIR_CHUNK = 8192

# per-user item-list buckets: x2 ladder from 8, the padding bound of the
# ALS degree buckets (ops/als.py _cap_ladder)
_USER_BUCKET_BASE = 8


def _user_buckets(degrees: np.ndarray) -> List[int]:
    caps = [_USER_BUCKET_BASE]
    dmax = int(degrees.max()) if degrees.size else 1
    while caps[-1] < dmax:
        caps.append(caps[-1] * 2)
    return caps


def _scatter_block(c_b: torch.Tensor, rows_local: torch.Tensor,
                   cols: torch.Tensor) -> None:
    """c_b[rows_local[p], cols[p, s]] += 1 for every pair p and item slot
    s, in place. Padding slots (== n_items) land in the dump column."""
    rows = rows_local[:, None].expand_as(cols)
    c_b.index_put_((rows.reshape(-1), cols.reshape(-1)),
                   c_b.new_ones(()).expand(cols.numel()), accumulate=True)


def _block_topk(c_b: torch.Tensor, b0: int, k: int):
    """Top-k of the complete block rows, self column zeroed (in place;
    the block is spent)."""
    n_items = c_b.shape[1] - 1
    c = c_b[:, :n_items]
    rows = torch.arange(c.shape[0], device=c.device)
    c[rows, b0 + rows] = 0.0
    return _topk_rows(c, k)


def _cap_users(pairs: np.ndarray, cap: int, seed: int) -> np.ndarray:
    """Deterministically subsample each user's distinct items to `cap`
    (Mahout ItemSimilarityJob --maxPrefsPerUser)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(pairs))
    shuffled = pairs[order]
    # a stable sort by user restores the user grouping in shuffled item
    # order, so keeping the first `cap` rows per user is a uniform sample
    shuffled = shuffled[np.argsort(shuffled[:, 0], kind="stable")]
    seg_start = np.r_[0, np.flatnonzero(np.diff(shuffled[:, 0])) + 1]
    rank_in_user = np.arange(len(shuffled)) - np.repeat(
        seg_start, np.diff(np.r_[seg_start, len(shuffled)]))
    return shuffled[rank_in_user < cap]


def top_cooccurrences_streaming(
        user_ix: np.ndarray, item_ix: np.ndarray,
        n_users: int, n_items: int, n: int, *,
        row_block: Optional[int] = None,
        max_items_per_user: Optional[int] = None,
        seed: int = 0,
        block_budget_bytes: int = _BLOCK_BUDGET_BYTES,
        device=None) -> CooccurrenceModel:
    """Exact per-item top-N cooccurrences without the dense n^2 matrix,
    the blocks accumulated and ranked on `device`.

    Device memory is a [row_block, n_items+1] f32 block, its sort, and
    the bucketed per-user item lists, never [n_items, n_items]. With no
    `max_items_per_user` the result is bit-identical to
    `top_cooccurrences(cooccurrence_matrix(...), n)`."""
    del n_users
    dev = resolve_device(device)
    k = min(n, n_items)
    pairs = np.unique(np.stack([np.asarray(user_ix, np.int64),
                                np.asarray(item_ix, np.int64)], axis=1),
                      axis=0)
    if max_items_per_user is not None:
        pairs = _cap_users(pairs, max_items_per_user, seed)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    if row_block is None:
        row_block = int(block_budget_bytes // (4 * (n_items + 1)))
        row_block = max(64, min(n_items, (row_block // 8) * 8))

    top_items = np.zeros((n_items, k), np.int32)
    top_counts = np.zeros((n_items, k), np.float32)
    if not len(pairs):
        return CooccurrenceModel(top_items, top_counts)

    # --- bucket users by degree; per bucket: padded item lists on the
    # device + that bucket's pairs sorted by item, bucket-local users --
    uniq_users, user_pos, degrees = np.unique(
        pairs[:, 0], return_inverse=True, return_counts=True)
    buckets = []   # (items_pad [n_b, cap] device, by_item_pairs [m_b, 2])
    for cap in _user_buckets(degrees):
        in_b = ((degrees <= cap)
                & (degrees > (cap // 2 if cap > _USER_BUCKET_BASE else 0)))
        sel = np.flatnonzero(in_b)
        if not len(sel):
            continue
        local_of = np.full(len(uniq_users), -1, np.int64)
        local_of[sel] = np.arange(len(sel))
        mask = local_of[user_pos] >= 0
        bp = pairs[mask]
        blocal = local_of[user_pos[mask]]
        # pairs arrive user-sorted, so slots fill in item order per user
        starts = np.r_[0, np.flatnonzero(np.diff(blocal)) + 1]
        slot = np.arange(len(bp)) - np.repeat(
            starts, np.diff(np.r_[starts, len(bp)]))
        items_pad = np.full((len(sel), cap), n_items, np.int64)
        items_pad[blocal, slot] = bp[:, 1]
        order = np.argsort(bp[:, 1], kind="stable")
        by_item = np.stack([blocal[order], bp[order, 1]], axis=1)
        buckets.append((torch.from_numpy(items_pad).to(dev), by_item))

    # --- stream row blocks: full accumulation, then the exact top-k -----
    for b0 in range(0, n_items, row_block):
        bsz = min(row_block, n_items - b0)
        todo = [(ip, bi[np.searchsorted(bi[:, 1], b0):
                        np.searchsorted(bi[:, 1], b0 + bsz)])
                for ip, bi in buckets]
        if not any(len(t[1]) for t in todo):
            continue   # no events touch this block: its rows stay zero
        c_b = torch.zeros((bsz, n_items + 1), dtype=torch.float32,
                          device=dev)
        for items_pad, blk in todo:
            for s in range(0, len(blk), _PAIR_CHUNK):
                ch = torch.from_numpy(blk[s:s + _PAIR_CHUNK]).to(dev)
                _scatter_block(c_b, ch[:, 1] - b0, items_pad[ch[:, 0]])
        counts, items = _block_topk(c_b, b0, k)
        top_counts[b0:b0 + bsz] = counts.cpu().numpy()
        top_items[b0:b0 + bsz] = items.cpu().numpy()
    return CooccurrenceModel(top_items, top_counts)


def top_cooccurrences_from_pairs(
        user_ix: np.ndarray, item_ix: np.ndarray,
        n_users: int, n_items: int, n: int, *,
        max_items_per_user: Optional[int] = None,
        seed: int = 0, device=None) -> CooccurrenceModel:
    """Route by catalog size: the dense product up to `_DENSE_ITEM_LIMIT`
    items, streaming row blocks above it (no n^2 allocation)."""
    if n_items <= _DENSE_ITEM_LIMIT and max_items_per_user is None:
        c = cooccurrence_matrix(user_ix, item_ix, n_users, n_items,
                                device=device)
        return top_cooccurrences(c, n, device=device)
    return top_cooccurrences_streaming(
        user_ix, item_ix, n_users, n_items, n,
        max_items_per_user=max_items_per_user, seed=seed, device=device)
