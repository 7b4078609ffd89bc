"""Tiered factor storage: a device-resident demand-paged hot set over a
host-RAM master copy, with exact top-k.

The port of `predictionio_tpu/ops/topk_tiered.py`. `TieredTopK` keeps
the whole `[n_items, rank]` factor matrix in host RAM and pins only a
hot slab `[hot_items, rank]` on the device, chosen by EWMA'd per-item
access counts that `serving/paging.PageManager` folds off the serve
path. It takes its master from host RAM and refuses a catalog that
already lies on a card: tiering that would free no device memory.
A serve call is:

  1. DEVICE: the hot slab scores through an inner `BucketedTopK`, that
     is through the fused kernel. Hot slots are kept sorted ascending by
     global id, so the kernel's lowest-index tie-break in slot space is
     the global-id tie-break.
  2. HOST: cold items score through host BLAS with an O(n)
     argpartition top-k (`_topk_cold`, the stable tie semantics of
     `_topk_host`), hot columns masked strictly below NEG_INF so a
     masked column never displaces a banned candidate.
  3. MERGE: the hot and cold candidates re-rank by (-score, global id).

The result equals the single-device `BucketedTopK` bit for bit when the
two tiers' products agree bit for bit, which integer-valued factors
guarantee; on real-valued factors the kernel's FMA order and the host
BLAS order may differ in the last bits, as the JAX package documents
for its own tiers. Paging swaps the slab through
`BucketedTopK.swap_factors`: the warmed buckets are reused, nothing is
launched again.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.ops.topk import (
    NEG_INF, BucketedTopK, DEFAULT_SERVE_BUCKETS, _host_f32, _off_host,
    _record_dispatch, _topk_host,
)

# Strictly below NEG_INF: marks hot columns in the cold host pass.
# Legitimate candidates (banned ones at exactly NEG_INF included) always
# outrank it, so it reaches the final top-k only when the candidate pool
# is smaller than k, which cannot happen while both tiers hold >= k items.
_MASKED = np.float32(-np.inf)


def _topk_cold(scores: np.ndarray, k: int):
    """O(n) per-row top-k with `_topk_host`'s lowest-index-first tie
    semantics: `argpartition` preselects, every item tied with the k-th
    score re-enters the pool, and a stable (-score, index) cut picks the
    final k (an all-tied row sorts the whole row, as argsort would)."""
    b, n = scores.shape
    k = min(k, n)
    if k >= n:
        return _topk_host(scores, k)
    out_s = np.empty((b, k), np.float32)
    out_ix = np.empty((b, k), np.int64)
    for row in range(b):
        s = scores[row]
        part = np.argpartition(-s, k - 1)[:k]
        cand = np.flatnonzero(s >= s[part].min())
        order = np.lexsort((cand, -s[cand]))[:k]
        pick = cand[order]
        out_s[row] = s[pick]
        out_ix[row] = pick
    return out_s, out_ix.astype(np.int32)


class TieredTopK:
    """Serving plan for catalogs bigger than the device budget: host
    master + device hot slab + exact hot/cold merge. Satisfies the
    `BucketedTopK` warm/fits/swap_factors/__call__ contract."""

    def __init__(self, item_factors, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 banned_width: int = 256, hot_items: int = 0,
                 ewma_decay: float = 0.8, device=None):
        if _off_host(item_factors):
            raise ValueError(
                f"TieredTopK needs its master in host RAM, got a catalog "
                f"on {item_factors.device}: load the item factors with "
                "items_device='cpu' (ops.als)")
        master = _host_f32(item_factors)
        self.n_items, self.rank = master.shape
        self.k = max(1, min(k, self.n_items))
        self.banned_width = banned_width
        self.master = master
        hot = int(hot_items) if hot_items > 0 else max(1, self.n_items // 4)
        self.hot_items = max(1, min(hot, self.n_items))
        # the page swap and the serve read of (slot_gids, slab) are
        # atomic together: slot ids decoded against a swapped slab
        # would alias wrong global ids
        self._page_lock = threading.Lock()
        self.slot_gids = np.arange(self.hot_items, dtype=np.int64)
        self._hot = BucketedTopK(master[self.slot_gids],
                                 k=min(self.k, self.hot_items),
                                 buckets=buckets, banned_width=banned_width,
                                 device=device)
        # served-gid arrays appended by the serve path (GIL-atomic) and
        # drained by the pager's fold
        self._access_buf: List[np.ndarray] = []
        self._ewma = np.zeros(self.n_items, np.float64)
        self.ewma_decay = float(ewma_decay)
        self.hits = 0
        self.served = 0
        self.promotions_total = 0
        self.page_count = 0
        self.last_page_seconds = 0.0

    # -- plan contract ------------------------------------------------------
    @property
    def factors(self):
        """The device-resident state: the hot slab."""
        return self._hot.factors

    @property
    def buckets(self):
        return self._hot.buckets

    @property
    def max_bucket(self) -> int:
        return self._hot.max_bucket

    @property
    def calls(self) -> int:
        """Bucket calls made through the hot slab's plan (warmup
        included): one kernel launch each on a CUDA device."""
        return self._hot.calls

    def resident_per_device_bytes(self) -> float:
        # the inner BucketedTopK registered itself; 0 here so the slab
        # is not counted twice by plan_resident_bytes()
        return 0.0

    def warm(self) -> int:
        return self._hot.warm()

    def fits(self, *, max_banned: int, k: int) -> bool:
        return (self._hot.fits(max_banned=max_banned, k=self._hot.k)
                and k <= self.k and max_banned <= self.banned_width)

    def swap_factors(self, item_factors) -> np.ndarray:
        """Whole-model hot swap: replace the host master and rebuild the
        slab from the current slot assignment; returns the previous
        master (the rollback token)."""
        host = _host_f32(item_factors)
        if host.shape != (self.n_items, self.rank):
            raise ValueError(
                f"swap_factors shape {host.shape} != "
                f"{(self.n_items, self.rank)}: catalog changed; re-warm "
                "instead")
        with self._page_lock:
            prev = self.master
            self.master = host
            self._hot.swap_factors(host[self.slot_gids])
        return prev

    def __call__(self, user_vecs, banned_lists: Sequence[Sequence[int]]):
        """Score `[b, rank]` queries (host or device) against the full
        catalog; returns host (scores [b, k], GLOBAL ids [b, k])."""
        user_vecs = _host_f32(user_vecs)
        b = user_vecs.shape[0]
        k = self.k
        # -- hot tier: the device slab through the fused kernel ------------
        with self._page_lock:
            gids = self.slot_gids
            master = self.master
            # global banned ids -> slot ids; out-of-slab bans drop here
            # (the cold pass applies them in global id space)
            hot_banned = []
            for bl in banned_lists:
                if len(bl):
                    arr = np.asarray(bl, np.int64)
                    pos = np.searchsorted(gids, arr)
                    pos = pos[(pos < gids.shape[0])
                              & (gids[np.minimum(pos, gids.shape[0] - 1)]
                                 == arr)]
                    hot_banned.append(pos.tolist())
                else:
                    hot_banned.append(())
            hot_s, hot_slots = self._hot(user_vecs, hot_banned)
            hot_g = gids[hot_slots.astype(np.int64)]
        # -- cold tier: host BLAS over the master --------------------------
        t0 = time.perf_counter()
        cold = user_vecs @ master.T
        for row, bl in enumerate(banned_lists):
            if len(bl):
                cold[row, np.asarray(bl, np.int64)] = NEG_INF
        # hot columns masked AFTER the bans: a banned hot item must sit
        # at _MASKED here, or it would surface from both tiers
        cold[:, gids] = _MASKED
        cold_s, cold_g = _topk_cold(cold, k)
        _record_dispatch("host", b * max(self.n_items - self.hot_items, 1),
                         time.perf_counter() - t0)
        # -- exact merge by (-score, global id) ----------------------------
        cand_s = np.concatenate([hot_s, cold_s], axis=1)
        cand_g = np.concatenate([hot_g, cold_g.astype(np.int64)], axis=1)
        n_hot = hot_s.shape[1]
        out_s = np.empty((b, k), np.float32)
        out_g = np.empty((b, k), np.int64)
        hot_hits = 0
        for row in range(b):
            order = np.lexsort((cand_g[row], -cand_s[row]))[:k]
            out_s[row] = cand_s[row, order]
            out_g[row] = cand_g[row, order]
            hot_hits += int(np.count_nonzero(order < n_hot))
        self._access_buf.append(out_g.ravel())
        self.hits += hot_hits
        self.served += b * k
        return out_s, out_g.astype(np.int32)

    # -- paging (called from the page thread only) -------------------------
    def fold_accesses(self) -> int:
        """Drain the serve path's access buffer into the per-item EWMA;
        returns how many top-k slots were folded."""
        buf, self._access_buf = self._access_buf, []
        if not buf:
            self._ewma *= self.ewma_decay
            return 0
        gids = np.concatenate(buf)
        counts = np.bincount(gids, minlength=self.n_items)
        self._ewma = self._ewma * self.ewma_decay \
            + counts[:self.n_items].astype(np.float64)
        return int(gids.shape[0])

    def rebalance(self, hysteresis: float = 0.25,
                  min_swap: int = 1) -> int:
        """One batched promotion/eviction pass: pick the EWMA top
        `hot_items` (incumbents get a `hysteresis` retention bonus so
        near-ties never thrash), rebuild the slab sorted by global id and
        swap it in under the page lock. Returns the number of
        promotions (0 = slab unchanged)."""
        eff = self._ewma.copy()
        eff[self.slot_gids] *= (1.0 + hysteresis)
        # a vanishing id-ordered tie-break: equal EWMAs must pick the
        # same set every pass
        eff -= np.arange(self.n_items, dtype=np.float64) * 1e-12
        desired = np.argpartition(-eff, self.hot_items - 1)[:self.hot_items]
        promoted = np.setdiff1d(desired, self.slot_gids,
                                assume_unique=False)
        if promoted.shape[0] < max(1, min_swap):
            return 0
        t0 = time.perf_counter()
        new_gids = np.sort(desired).astype(np.int64)
        with self._page_lock:
            # the slab gathers under the lock: a concurrent whole-model
            # swap_factors must not leave rows of the old master
            self._hot.swap_factors(self.master[new_gids])
            self.slot_gids = new_gids
        self.promotions_total += int(promoted.shape[0])
        self.page_count += 1
        self.last_page_seconds = time.perf_counter() - t0
        return int(promoted.shape[0])

    def hit_ratio(self) -> float:
        """Fraction of served top-k entries answered by the hot slab."""
        return self.hits / self.served if self.served else 0.0

    def stats(self) -> dict:
        return {"hot_items": self.hot_items, "n_items": self.n_items,
                "hit_ratio": round(self.hit_ratio(), 4),
                "served": self.served,
                "promotions_total": self.promotions_total,
                "pages": self.page_count}


def tier_mode() -> str:
    """PIO_SERVE_TIER: `auto` (tier when the catalog exceeds the
    effective device budget), `on` (always tier), `off`."""
    mode = (os.environ.get("PIO_SERVE_TIER", "auto") or "auto").lower()
    if mode in ("on", "1", "true"):
        return "on"
    if mode in ("off", "0", "false"):
        return "off"
    return "auto"


def hot_frac() -> Optional[float]:
    """PIO_TIER_HOT_FRAC: fraction of the catalog to pin hot (clamped
    to (0, 1]); unset -> size the slab from the device budget."""
    raw = (os.environ.get("PIO_TIER_HOT_FRAC", "") or "").strip()
    if not raw:
        return None
    try:
        return min(max(float(raw), 1e-6), 1.0)
    except ValueError:
        return None
