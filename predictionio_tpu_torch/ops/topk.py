"""Masked top-k scoring: the serve-time hot path of the recommenders.

The port of `predictionio_tpu/ops/topk.py` (single-device pieces).
Scoring is one program over a query batch: user vectors against the
item factor matrix, a filter, then top-k ordered by (score desc, id
asc), the lowest-index tie-break of `lax.top_k` that the JAX package
promises on every path.

  - `topk_scores` / `topk_scores_filtered`: the generic paths. Small
    problems run as host numpy (as in the JAX package, chosen by
    `DispatchPolicy`); the device branch is plain torch ops, as the JAX
    package left it to XLA: an fp32 matmul with TF32 off, the mask,
    then a stable sort.
  - `BucketedTopK`: the deploy-warmed serving plan. The factors are
    pinned on the device once; every bucket of a call goes through the
    hand-written fused kernel (`ops/fused_topk.py`), with no per-bucket
    chain to fall back to.
  - `topk_similar` / `BucketedSimilar`: cosine top-k under a dense
    [b, n_items] mask (the similar-product and e-commerce templates),
    the JAX package's `_topk_similar_raw`: rows scaled by 1 / (norm +
    1e-9), an fp32 product, the mask, the stable top-k. It is XLA there
    and plain torch ops here (no Pallas kernel).

Every dispatch lands in `DISPATCH_COUNTS` and the policy's EWMAs.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Optional, Sequence, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device

NEG_INF = -1e30

# [b, n_items] score cells below which the host path wins (the JAX
# package's default; to be re-measured on the card)
HOST_CROSSOVER_CELLS = int(os.environ.get(
    "PIO_TOPK_HOST_CROSSOVER_CELLS", 4 << 20))

# calls by the path that served them; plain ints under the GIL
DISPATCH_COUNTS = {"host": 0, "device": 0, "fused": 0, "sharded": 0}

# bucket calls of every fused top-k plan of the process (BucketedTopK,
# ShardedBucketedTopK), warmups included; each is one K1 launch per
# shard, so a server that reloads can hold its kernel's launches
# against the calls of the plans it retired too
PLAN_CALLS = 0


def count_plan_call() -> None:
    global PLAN_CALLS
    PLAN_CALLS += 1

# below this many cells the policy never promotes to the device
PROMOTE_FLOOR_CELLS = int(os.environ.get(
    "PIO_TOPK_PROMOTE_FLOOR_CELLS", 1 << 16))

# with no device observation yet, every Nth promotable-sized problem
# goes to the device to seed its EWMA; 0 disables probing
EXPLORE_EVERY = int(os.environ.get("PIO_TOPK_EXPLORE_EVERY", 32))


class DispatchPolicy:
    """Amortized host/device dispatch from observed per-path latency.

    Cold start is the one-shot rule: device iff cells >=
    HOST_CROSSOVER_CELLS. Once both paths have been observed, problems
    between PROMOTE_FLOOR_CELLS and the crossover go where the predicted
    latency is lower:

        host:   cells * host_s_per_cell_EWMA * (1 + in-flight host calls)
        device: device_call_s_EWMA

    Promotion is one-directional: at or above the crossover the device
    always wins."""

    def __init__(self, alpha: float = 0.25):
        self._alpha = alpha
        self._lock = threading.Lock()
        self._host_s_per_cell: Optional[float] = None
        self._device_call_s: Optional[float] = None
        self._sharded_call_s: Optional[float] = None
        self._host_inflight = 0
        self._probe_tick = 0

    def choose(self, cells: int) -> str:
        if cells >= HOST_CROSSOVER_CELLS:
            return "device"
        if cells < PROMOTE_FLOOR_CELLS:
            return "host"
        with self._lock:
            h, d = self._host_s_per_cell, self._device_call_s
            inflight = self._host_inflight
            if d is None and EXPLORE_EVERY > 0:
                self._probe_tick += 1
                if self._probe_tick % EXPLORE_EVERY == 0:
                    return "device"
        if h is None or d is None:
            return "host"
        return "device" if d <= cells * h * (1.0 + inflight) else "host"

    def host_begin(self) -> None:
        with self._lock:
            self._host_inflight += 1

    def host_end(self) -> None:
        with self._lock:
            self._host_inflight = max(0, self._host_inflight - 1)

    def observe(self, path: str, cells: int,
                seconds: Optional[float]) -> None:
        if seconds is None or cells <= 0:
            return
        a = self._alpha
        with self._lock:
            if path == "host":
                per_cell = seconds / cells
                prev = self._host_s_per_cell
                self._host_s_per_cell = (per_cell if prev is None
                                         else prev + a * (per_cell - prev))
            elif path == "sharded":
                prev = self._sharded_call_s
                self._sharded_call_s = (seconds if prev is None
                                        else prev + a * (seconds - prev))
            else:
                prev = self._device_call_s
                self._device_call_s = (seconds if prev is None
                                       else prev + a * (seconds - prev))

    def snapshot(self) -> dict:
        with self._lock:
            return {"host_s_per_cell": self._host_s_per_cell,
                    "device_call_s": self._device_call_s,
                    "sharded_call_s": self._sharded_call_s,
                    "host_inflight": self._host_inflight}

    def restore(self, state: dict) -> None:
        """Re-seed the EWMAs from a `snapshot()`; the in-flight count is
        transient and never restored; junk fields are ignored."""
        with self._lock:
            h = state.get("host_s_per_cell")
            d = state.get("device_call_s")
            s = state.get("sharded_call_s")
            if isinstance(h, (int, float)) and h > 0:
                self._host_s_per_cell = float(h)
            if isinstance(d, (int, float)) and d > 0:
                self._device_call_s = float(d)
            if isinstance(s, (int, float)) and s > 0:
                self._sharded_call_s = float(s)


DISPATCH_POLICY = DispatchPolicy()


def _record_dispatch(path: str, cells: int,
                     seconds: Optional[float] = None) -> None:
    DISPATCH_COUNTS[path] += 1
    DISPATCH_POLICY.observe(path, cells, seconds)


# Live serving plans with device-pinned factor state, weakly held: the
# capacity checks in ops/topk_sharded subtract these bytes before
# deciding whether a NEW catalog still fits one device; without the
# subtraction a second deploy of a near-capacity catalog passes the
# check against an empty card while the first plan is still pinned.
_RESIDENT_PLANS: "weakref.WeakSet" = weakref.WeakSet()


def register_resident_plan(plan) -> None:
    """Track a plan whose factor state is device-resident. Weak
    references only: a dropped deployment's plan leaves the accounting
    as soon as it is garbage-collected."""
    _RESIDENT_PLANS.add(plan)


def plan_resident_bytes() -> float:
    """Per-device bytes currently pinned by live serving plans."""
    total = 0.0
    for plan in list(_RESIDENT_PLANS):
        try:
            total += float(plan.resident_per_device_bytes())
        except Exception:   # noqa: BLE001 — accounting is best-effort
            continue
    return total


def _topk_host(scores: np.ndarray, k: int):
    """Stable argsort, so ties go to the lowest index as on the device
    path; int32 indices."""
    k = min(k, scores.shape[1])
    ix = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, ix, axis=1), ix.astype(np.int32)


def _topk_rows(scores: torch.Tensor, k: int):
    """Top-k of each row by (score desc, index asc): a stable sort,
    since `torch.topk` does not promise the lowest-index tie-break."""
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return scores.gather(1, order), order.to(torch.int32)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


ArrayLike = Union[np.ndarray, torch.Tensor]


def _placement(device, *arrays) -> torch.device:
    """The device the call runs on: that of tensor inputs, else the
    resolved `device` (None = cuda, raising without it)."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return resolve_device(a.device)
    return resolve_device(device)


def topk_scores_filtered(user_vecs: ArrayLike, item_factors: ArrayLike,
                         banned_lists: Sequence[Sequence[int]], *, k: int,
                         device=None):
    """Top-k scoring with per-query banned-item index lists (blacklist
    filtering). Small host problems densify the filter and go through
    `topk_scores`; the device branch builds the filter on the device
    from a [b, max_banned] index block. Returns host (scores [b, k],
    ids [b, k])."""
    from predictionio_tpu_torch.ops.fused_topk import fused_topk_reference
    dev = _placement(device, user_vecs, item_factors)
    n_items = item_factors.shape[0]
    k = min(k, n_items)
    b = user_vecs.shape[0]
    cells = b * n_items
    on_dev = isinstance(user_vecs, torch.Tensor) \
        or isinstance(item_factors, torch.Tensor)
    if not on_dev and DISPATCH_POLICY.choose(cells) == "host":
        mask = np.ones((b, n_items), bool)
        for row, banned in enumerate(banned_lists):
            if len(banned):
                mask[row, np.asarray(banned, int)] = False
        return topk_scores(user_vecs, item_factors, mask, k=k, device=dev)
    width = max((len(bl) for bl in banned_lists), default=0)
    banned = np.full((b, max(width, 1)), n_items, np.int32)
    for row, bl in enumerate(banned_lists):
        if len(bl):
            banned[row, :len(bl)] = np.asarray(bl, np.int32)
    t0 = time.perf_counter()
    scores, ixs = fused_topk_reference(
        torch.as_tensor(user_vecs, dtype=torch.float32, device=dev),
        torch.as_tensor(item_factors, dtype=torch.float32, device=dev),
        torch.from_numpy(banned).to(dev), k=k, n_valid=n_items)
    out = scores.cpu().numpy(), ixs.cpu().numpy()
    _record_dispatch("device", cells, time.perf_counter() - t0)
    return out


def topk_scores(user_vecs: ArrayLike, item_factors: ArrayLike,
                mask: ArrayLike, *, k: int, device=None):
    """scores = U @ Y^T with invalid items masked out.

    user_vecs:    [b, rank]
    item_factors: [n_items, rank]
    mask:         [b, n_items] bool, True = item allowed for that query
    Returns host (scores [b, k], ids [b, k]); masked-out slots score
    NEG_INF. Tensor inputs run on their device; host inputs go to the
    host or to `device` by `DispatchPolicy`."""
    dev = _placement(device, user_vecs, item_factors, mask)
    k = min(k, item_factors.shape[0])
    cells = user_vecs.shape[0] * item_factors.shape[0]
    on_dev = any(isinstance(a, torch.Tensor)
                 for a in (user_vecs, item_factors, mask))
    if on_dev or DISPATCH_POLICY.choose(cells) == "device":
        t0 = time.perf_counter()
        scores = torch.matmul(
            torch.as_tensor(user_vecs, dtype=torch.float32, device=dev),
            torch.as_tensor(item_factors, dtype=torch.float32, device=dev).T)
        scores = scores.masked_fill(
            ~torch.as_tensor(mask, dtype=torch.bool, device=dev), NEG_INF)
        s, i = _topk_rows(scores, k)
        out = s.cpu().numpy(), i.cpu().numpy()
        _record_dispatch("device", cells, time.perf_counter() - t0)
        return out
    t0 = time.perf_counter()
    DISPATCH_POLICY.host_begin()
    try:
        scores = np.asarray(user_vecs) @ np.asarray(item_factors).T
        scores = np.where(np.asarray(mask), scores, np.float32(NEG_INF))
        out = _topk_host(scores, k)
    finally:
        DISPATCH_POLICY.host_end()
    _record_dispatch("host", cells, time.perf_counter() - t0)
    return out


def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    """Rows scaled by 1 / (L2 norm + 1e-9), as the JAX package's
    `_topk_similar_raw` scales both sides (a zero row stays zero)."""
    return a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-9)


def _similar_rows(query_vecs: torch.Tensor, unit_factors: torch.Tensor,
                  mask: torch.Tensor, k: int):
    """Cosine top-k of `query_vecs` against factors already scaled by
    `_unit_rows`, under the bool `mask` (True = allowed): the device
    program of `topk_similar` and of the plans."""
    scores = torch.matmul(_unit_rows(query_vecs), unit_factors.T)
    return _topk_rows(scores.masked_fill(~mask, NEG_INF), k)


def topk_similar(query_vecs: ArrayLike, item_factors: ArrayLike,
                 mask: ArrayLike, *, k: int, device=None):
    """Cosine-similarity top-k (the similar-product template's scoring,
    `ALSAlgorithm.scala` of multi-events-multi-algos): `query_vecs`
    [b, rank] (mean item vectors, typically) against `item_factors`
    [n_items, rank] under `mask` [b, n_items]. Tensor inputs run on their
    device; host inputs go to the host or to `device` by
    `DispatchPolicy`, as `topk_scores` does. Returns host (scores [b, k],
    ids [b, k])."""
    dev = _placement(device, query_vecs, item_factors, mask)
    k = min(k, item_factors.shape[0])
    cells = query_vecs.shape[0] * item_factors.shape[0]
    on_dev = any(isinstance(a, torch.Tensor)
                 for a in (query_vecs, item_factors, mask))
    if on_dev or DISPATCH_POLICY.choose(cells) == "device":
        t0 = time.perf_counter()
        s, i = _similar_rows(
            torch.as_tensor(query_vecs, dtype=torch.float32, device=dev),
            _unit_rows(torch.as_tensor(item_factors, dtype=torch.float32,
                                       device=dev)),
            torch.as_tensor(mask, dtype=torch.bool, device=dev), k)
        out = s.cpu().numpy(), i.cpu().numpy()
        _record_dispatch("device", cells, time.perf_counter() - t0)
        return out
    t0 = time.perf_counter()
    DISPATCH_POLICY.host_begin()
    try:
        q = np.asarray(query_vecs)
        f = np.asarray(item_factors)
        qn = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-9)
        fn = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-9)
        scores = np.where(np.asarray(mask), qn @ fn.T, np.float32(NEG_INF))
        out = _topk_host(scores, k)
    finally:
        DISPATCH_POLICY.host_end()
    _record_dispatch("host", cells, time.perf_counter() - t0)
    return out


def build_mask(n_items: int,
               blacklist_ix: Sequence[int] = (),
               whitelist_ix: Optional[Sequence[int]] = None,
               batch: int = 1) -> np.ndarray:
    """Host-side mask assembly from index lists (unknown ids are resolved
    to indexes by the caller via BiMap and simply absent here)."""
    if whitelist_ix is not None:
        mask = np.zeros(n_items, bool)
        mask[np.asarray(list(whitelist_ix), int)] = True
    else:
        mask = np.ones(n_items, bool)
    if len(blacklist_ix):
        mask[np.asarray(list(blacklist_ix), int)] = False
    return np.broadcast_to(mask, (batch, n_items))


# Batch buckets warmed by default (powers of two; the micro-batcher's
# batch_max caps which of these a deployment actually warms).
DEFAULT_SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class BucketedTopK:
    """Per-model serving plan: banned-index top-k over device-resident
    factors, one fused-kernel shape per batch bucket.

    Built at deploy warmup (`Algorithm.warm_serving` from
    `core.workflow.warm_deploy`): the factors are placed on the device
    once and pinned for the plan's lifetime; `warm()` builds the kernel
    library and launches every bucket once. A call pads the batch to the
    smallest warmed bucket (zero vectors, all-filler bans, sliced off
    before return) and the banned block to the fixed width with
    `n_items`, which matches no item. Batches past the largest bucket
    are chunked. Queries that do not fit the plan (k above `self.k`,
    more bans than `banned_width`, whitelists) go through the generic
    `topk_scores*` paths; callers gate on `fits()`.

    Buckets above the kernel's `MAX_BUCKET` are not warmed (chunking
    covers those batches), and a plan `k` above its `MAX_K` raises."""

    def __init__(self, item_factors: ArrayLike, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 banned_width: int = 256, device=None):
        from predictionio_tpu_torch.ops import fused_topk
        if device is None and isinstance(item_factors, torch.Tensor):
            device = item_factors.device
        self.device = resolve_device(device)
        self.factors = _pin(item_factors, self.device)
        self.n_items, self.rank = self.factors.shape
        self.k = max(1, min(k, self.n_items))
        if self.k > fused_topk.MAX_K:
            raise ValueError(
                f"BucketedTopK k={self.k} above the fused kernel's "
                f"{fused_topk.MAX_K}; larger k goes through topk_scores*")
        self.buckets = tuple(sorted(
            {_next_pow2(b) for b in buckets
             if b > 0 and _next_pow2(b) <= fused_topk.MAX_BUCKET})) or (1,)
        self.banned_width = _next_pow2(max(1, banned_width))
        self._warm: set = set()
        # bucket calls made by this plan (warmup included): one kernel
        # call each on a CUDA device
        self.calls = 0
        register_resident_plan(self)

    def resident_per_device_bytes(self) -> float:
        """Bytes this plan pins on its device: the whole factor block."""
        return float(self.factors.numel() * self.factors.element_size())

    def warm(self) -> int:
        """Build the kernel library (CUDA) and launch every bucket once;
        returns how many buckets were warmed (idempotent). Raises when
        the kernel does not build or launch."""
        from predictionio_tpu_torch.ops import fused_topk
        if self.device.type == "cuda":
            fused_topk.load_library()
        warmed = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            banned = np.full((b, self.banned_width), self.n_items, np.int32)
            self._launch(torch.zeros((b, self.rank), dtype=torch.float32,
                                     device=self.device), banned)
            self._warm.add(b)
            warmed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # surface faults here
        return warmed

    def swap_factors(self, item_factors: ArrayLike) -> torch.Tensor:
        """Replace the resident factor block with a same-shape one (the
        streaming refresher's commit); returns the previous factors as
        the rollback token. A catalog change must re-warm instead."""
        new = _pin(item_factors, self.device)
        if tuple(new.shape) != (self.n_items, self.rank):
            raise ValueError(
                f"swap_factors shape {tuple(new.shape)} != "
                f"{(self.n_items, self.rank)}: catalog changed; re-warm "
                "instead")
        prev, self.factors = self.factors, new
        return prev

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def fits(self, *, max_banned: int, k: int) -> bool:
        """Whether a batch with these parameters can use the plan."""
        return (bool(self._warm)
                and k <= self.k and max_banned <= self.banned_width)

    def _bucket_for(self, b: int) -> int:
        for bucket in self.buckets:
            if bucket >= b:
                return bucket
        return self.max_bucket

    def _launch(self, vecs: torch.Tensor, banned: np.ndarray):
        from predictionio_tpu_torch.ops import fused_topk
        self.calls += 1
        count_plan_call()
        return fused_topk.fused_topk(
            vecs, self.factors, torch.from_numpy(banned).to(self.device),
            k=self.k, n_valid=self.n_items)

    def __call__(self, user_vecs: ArrayLike,
                 banned_lists: Sequence[Sequence[int]]):
        """Score `user_vecs` [b, rank] (host or on the plan's device)
        against the resident factors with per-row banned-index lists;
        returns host (scores [b, k], ids [b, k])."""
        b = user_vecs.shape[0]
        if b > self.max_bucket:
            parts = [self(user_vecs[lo:lo + self.max_bucket],
                          banned_lists[lo:lo + self.max_bucket])
                     for lo in range(0, b, self.max_bucket)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        bucket = self._bucket_for(b)
        if bucket not in self._warm:
            raise RuntimeError(
                f"BucketedTopK bucket {bucket} not warmed; call warm() "
                "at deploy time")
        t0 = time.perf_counter()
        vecs = torch.zeros((bucket, self.rank), dtype=torch.float32,
                           device=self.device)
        vecs[:b] = torch.as_tensor(user_vecs, dtype=torch.float32,
                                   device=self.device)
        banned = np.full((bucket, self.banned_width), self.n_items, np.int32)
        for row, bl in enumerate(banned_lists):
            if len(bl):
                banned[row, :len(bl)] = np.asarray(bl, np.int32)
        scores, ixs = self._launch(vecs, banned)
        scores, ixs = scores.cpu().numpy(), ixs.cpu().numpy()
        _record_dispatch("fused", bucket * self.n_items,
                         time.perf_counter() - t0)
        return scores[:b], ixs[:b]


def _host_f32(a: ArrayLike) -> np.ndarray:
    """`a` (host array or tensor on any device) as a C-contiguous fp32
    numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32)


def _off_host(a: ArrayLike) -> bool:
    """Whether `a` is a tensor outside host RAM (on a card)."""
    return isinstance(a, torch.Tensor) and a.device.type != "cpu"


def _pin(item_factors: ArrayLike, device: torch.device) -> torch.Tensor:
    """The factors as a contiguous fp32 tensor on `device` (no copy when
    they already are one)."""
    return torch.as_tensor(item_factors, dtype=torch.float32,
                           device=device).contiguous()


class BucketedSimilar:
    """Serving plan of the dense-mask cosine path (the similar-product
    template's `batch_predict`): the item factors pinned on the device
    once, with their unit rows beside them, and every batch bucket run
    once at warmup, so a deployment's first query allocates nothing new.

    The filter is the template's dense [b, n_items] category/white/black
    mask, so the mask block is padded to the bucket with all-False rows
    (their lanes score NEG_INF and are sliced off before return).
    Batches past the largest bucket are chunked. The scoring is
    `_similar_rows`: plain torch ops, as the JAX package's plan is XLA."""

    def __init__(self, item_factors: ArrayLike, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 device=None):
        if device is None and isinstance(item_factors, torch.Tensor):
            device = item_factors.device
        self.device = resolve_device(device)
        self.factors = _pin(item_factors, self.device)
        self._unit = _unit_rows(self.factors)
        self.n_items, self.rank = self.factors.shape
        self.k = max(1, min(k, self.n_items))
        self.buckets = tuple(sorted({_next_pow2(b)
                                     for b in buckets if b > 0})) or (1,)
        self._warm: set = set()
        # bucket calls made by this plan (warmup included)
        self.calls = 0
        register_resident_plan(self)

    def resident_per_device_bytes(self) -> float:
        """The factors and their unit rows."""
        return float(2 * self.factors.numel() * 4)

    def warm(self) -> int:
        """Run every bucket once; returns how many were warmed
        (idempotent)."""
        warmed = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            self._launch(torch.zeros((b, self.rank), dtype=torch.float32,
                                     device=self.device),
                         torch.zeros((b, self.n_items), dtype=torch.bool,
                                     device=self.device))
            self._warm.add(b)
            warmed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    def swap_factors(self, item_factors: ArrayLike) -> torch.Tensor:
        """Replace the resident factors with a same-shape block (the
        refresher's commit); returns the previous ones as the rollback
        token. A catalog change must re-warm instead."""
        new = _pin(item_factors, self.device)
        if tuple(new.shape) != (self.n_items, self.rank):
            raise ValueError(
                f"swap_factors shape {tuple(new.shape)} != "
                f"{(self.n_items, self.rank)}: catalog changed; re-warm "
                "instead")
        unit = _unit_rows(new)
        prev, self.factors, self._unit = self.factors, new, unit
        return prev

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def fits(self, *, k: int) -> bool:
        return bool(self._warm) and k <= self.k

    def _bucket_for(self, b: int) -> int:
        for bucket in self.buckets:
            if bucket >= b:
                return bucket
        return self.max_bucket

    def _launch(self, vecs: torch.Tensor, mask: torch.Tensor):
        self.calls += 1
        return _similar_rows(vecs, self._unit, mask, self.k)

    def __call__(self, query_vecs: ArrayLike, mask: ArrayLike):
        """Cosine top-k of `query_vecs` [b, rank] (host or on the plan's
        device) against the resident factors under the dense mask
        [b, n_items]; returns host (scores [b, k], ids [b, k])."""
        b = query_vecs.shape[0]
        if b > self.max_bucket:
            parts = [self(query_vecs[lo:lo + self.max_bucket],
                          mask[lo:lo + self.max_bucket])
                     for lo in range(0, b, self.max_bucket)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        bucket = self._bucket_for(b)
        if bucket not in self._warm:
            raise RuntimeError(
                f"BucketedSimilar bucket {bucket} not warmed; call warm() "
                "at deploy time")
        t0 = time.perf_counter()
        vecs = torch.zeros((bucket, self.rank), dtype=torch.float32,
                           device=self.device)
        vecs[:b] = torch.as_tensor(query_vecs, dtype=torch.float32,
                                   device=self.device)
        mask_p = torch.zeros((bucket, self.n_items), dtype=torch.bool,
                             device=self.device)
        mask_p[:b] = torch.as_tensor(mask, dtype=torch.bool,
                                     device=self.device)
        scores, ixs = self._launch(vecs, mask_p)
        scores, ixs = scores.cpu().numpy(), ixs.cpu().numpy()
        _record_dispatch("device", bucket * self.n_items,
                         time.perf_counter() - t0)
        return scores[:b], ixs[:b]
