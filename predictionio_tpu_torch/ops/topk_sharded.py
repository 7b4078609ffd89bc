"""Sharded serving plans and the banned-index serve-plan selection.

The port of `predictionio_tpu/ops/topk_sharded.py`. A catalog is
partitioned row-wise over a `ServeMesh`, a list of torch devices that
may name one device more than once (several shards on one card run one
after another on its stream):

  - `ShardedBucketedTopK`: the item factors are zero-padded to a
    multiple of the shard count and placed once, one contiguous
    `[per_shard, rank]` block per device (`parallel.mesh.shard_put`).
    A call uploads the query block and the GLOBAL banned ids to each
    device, and for every shard, on its device: launches the fused
    kernel's sharded form (`fused_topk.shard_local_candidates`, the JAX
    package's `_kernel_dynamic`) with the shard's first global row
    `base` and `n_valid = clip(n_items - base, 0, per_shard)` for
    `min(k, per_shard)` candidates. The kernel reads the GLOBAL bans
    (an id matches only when it falls on the shard, so other shards'
    ids and the `n_items` filler match nothing) and emits global ids.
    The candidates gather on `devices[0]` in shard-major order, and a
    stable sort takes the global top-k. That is bit-identical to the
    single-device plan, ties included: shard-major order is global-id
    order for equal scores, and any item of the global top-k has fewer
    than k items above it globally, hence fewer in its own shard, hence
    is among its shard's candidates.
  - `ShardSliceTopK`: a fleet member's plan over its own contiguous
    row block, with an inner plan chosen by `serve_plan` (no mesh) and
    global ids out.
  - `ShardedBucketedSimilar`: the dense-mask cosine plan (the
    similar-product template's) over the same row partition: each shard
    scores its unit rows against the unit query rows under its columns
    of the mask (the padding columns False), keeps its
    `min(k, per_shard)` best by (score desc, id asc), and the merge on
    `devices[0]` is the banned-index plan's, with the same tie argument.

`similar_plan` shards by the same `_wants_shard` rule and otherwise
builds the single-device `BucketedSimilar` (a fleet `ShardSlice` too:
the dense-mask path has no slice form). `serve_plan` chooses, in this
order: a `ShardSlice` builds the slice
plan; a mesh that warrants it shards (`_wants_shard`: forced, or the
factors exceed the effective device capacity); a catalog past the
effective capacity tiers (`_tier_hot_items`, `PIO_SERVE_TIER`), but
only when the catalog's master lies in host RAM; else the
single-device `BucketedTopK`. A catalog can outgrow one card only when
its master stays on the host, so a deployment that should shard or
tier on its own loads its item factors with `items_device="cpu"`
(`ops.als`). `serve_mesh_from_conf` builds a mesh over two or more
local CUDA cards only; a mesh that repeats one device, or a fleet
`ShardSlice`, is for a caller that passes it explicitly. Each sharded
plan, and a fleet member's slice plan, publishes `pio_serve_shards` and
`pio_serve_shard_bytes{shard}` (the factor bytes each shard pins; a
member, its own slice's) to the process's metrics registry.
"""

from __future__ import annotations

import os
import re
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops import topk
from predictionio_tpu_torch.ops.topk import (
    DEFAULT_SERVE_BUCKETS, NEG_INF, BucketedSimilar, BucketedTopK, _host_f32,
    _next_pow2, _off_host, _record_dispatch, _topk_rows, _unit_rows,
)
from predictionio_tpu_torch.parallel.mesh import shard_put


@dataclass(frozen=True)
class ServeMesh:
    """The devices a sharded plan spreads the catalog over, shard s on
    `devices[s]`, plus HOW the mesh was chosen: `forced` means sharding
    was explicitly configured and engages regardless of catalog size;
    an un-forced mesh only shards a catalog past one device's
    capacity."""
    devices: Tuple[torch.device, ...]
    forced: bool = False

    def __post_init__(self):
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def n_shards(self) -> int:
        return len(self.devices)


@dataclass(frozen=True)
class ShardSlice:
    """A cross-host fleet shard assignment: this member owns one
    contiguous row block of the catalog (shard `index` of `n_shards`,
    the same ceil-divided partition the local sharded plan uses)."""
    n_shards: int
    index: int


def parse_fleet_mesh(spec: str):
    """Parse a cross-host mesh spec: `items=N@fleet` (router side) or
    `items=N@fleet:i` (member side: this process owns shard i). Returns
    (n_shards, index-or-None), or None when `spec` is not a fleet
    mesh."""
    m = re.match(r"\s*items\s*=\s*(\d+)\s*@\s*fleet(?::(\d+))?\s*$",
                 spec or "")
    if m is None:
        return None
    n = int(m.group(1))
    idx = int(m.group(2)) if m.group(2) is not None else None
    if n < 1 or (idx is not None and not 0 <= idx < n):
        raise ValueError(f"bad fleet mesh spec {spec!r}: need "
                         "items=N@fleet[:i] with 0 <= i < N")
    return n, idx


def serve_mesh_from_conf(conf=None):
    """The deploy-time serving mesh: the local CUDA cards, or None when
    sharded serving is off or pointless (fewer than two cards).
    `conf` is the merged engine-instance + server runtime_conf; a
    configured training mesh there forces the sharded path (training
    and serving agree on the device layout): whatever its axes
    ("data=2,model=2" as "data=4"), the plan shards the catalog over
    every local card, as the JAX package's "items" axis does. A cross-host
    `items=N@fleet:i` mesh returns a `ShardSlice` instead: this member
    serves only its owned catalog rows and the fleet router merges
    across members; the router's own `items=N@fleet` forces nothing.
    `PIO_SERVE_SHARD` (auto/on/off; `on` forces the sharded path) and
    `PIO_SERVE_SHARDS` (a cap on the shard count) are the JAX package's
    own knobs."""
    conf_mesh = str((conf or {}).get("mesh", "") or "")
    fleet = parse_fleet_mesh(conf_mesh)
    if fleet is not None:
        n, idx = fleet
        if idx is not None:
            return ShardSlice(n_shards=n, index=idx)
        conf_mesh = ""
    mode = (os.environ.get("PIO_SERVE_SHARD", "auto") or "auto").lower()
    if mode in ("off", "0", "false"):
        return None
    count = torch.cuda.device_count()
    want = int(os.environ.get("PIO_SERVE_SHARDS", "0") or 0)
    n = min(want, count) if want > 0 else count
    if n < 2:
        return None
    return ServeMesh(tuple(torch.device("cuda", i) for i in range(n)),
                     forced=mode in ("on", "1", "true") or bool(conf_mesh))


def device_capacity_bytes(device=None) -> Optional[float]:
    """One device's memory for the fits-one-device check:
    `PIO_DEVICE_HBM_BYTES` wins, else the total memory of `device` (the
    current CUDA card for None) when it is a CUDA device, else None. A
    CPU plan has no known capacity, so it never auto-shards or
    auto-tiers."""
    env = os.environ.get("PIO_DEVICE_HBM_BYTES", "").strip()
    if env:
        return float(env)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return float(torch.cuda.get_device_properties(device).total_memory)


def effective_device_capacity(device=None) -> Optional[float]:
    """The bytes a NEW plan may still pin on one device: capacity with
    20% headroom for workspace, minus the bytes live plans already hold
    resident. Without the subtraction a second deploy of a near-capacity
    catalog passes the check against an empty card."""
    cap = device_capacity_bytes(device)
    if cap is None:
        return None
    return cap * 0.8 - topk.plan_resident_bytes()


def _wants_shard(n_items: int, rank: int, mesh) -> bool:
    """Whether `serve_plan` builds the sharded plan: a mesh of two or
    more entries AND (forced, or the factors do not fit the effective
    capacity of its first device)."""
    if not isinstance(mesh, ServeMesh) or mesh.n_shards < 2:
        return False
    if mesh.forced:
        return True
    cap = effective_device_capacity(mesh.devices[0])
    if cap is None:
        return False
    return n_items * rank * 4 > cap


def _tier_hot_items(n_items: int, rank: int, device=None) -> Optional[int]:
    """Hot-slab size when tiered storage should engage, else None.
    `PIO_SERVE_TIER=on` always tiers, `auto` only past the effective
    device budget, `off` never. `PIO_TIER_HOT_FRAC` sizes the slab;
    unset, it fills the budget (a quarter of the catalog when the budget
    is unknown but tiering is on)."""
    from predictionio_tpu_torch.ops import topk_tiered
    mode = topk_tiered.tier_mode()
    if mode == "off":
        return None
    cap = effective_device_capacity(device)
    nbytes = n_items * rank * 4
    if mode == "auto" and (cap is None or nbytes <= cap):
        return None
    frac = topk_tiered.hot_frac()
    if frac is not None:
        hot = int(n_items * frac)
    elif cap is not None and cap > 0:
        hot = int(cap // (rank * 4))
    else:
        hot = n_items // 4
    return max(1, min(hot, n_items))


def serve_plan(item_factors, *, k: int,
               buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
               banned_width: int = 256, mesh=None, device=None):
    """The banned-index serving plan for this deployment (selection
    order in the module docstring). `device` places the single-device,
    tiered and slice plans; a sharded plan lives on its mesh's devices.
    Every plan satisfies the same warm/fits/__call__ contract."""
    n_items, rank = item_factors.shape
    if device is None and isinstance(item_factors, torch.Tensor):
        device = item_factors.device
    if isinstance(mesh, ShardSlice):
        return ShardSliceTopK(item_factors, k=k, buckets=buckets,
                              banned_width=banned_width, slice_spec=mesh,
                              device=device)
    if _wants_shard(n_items, rank, mesh):
        return ShardedBucketedTopK(item_factors, k=k, buckets=buckets,
                                   banned_width=banned_width, mesh=mesh)
    hot = _tier_hot_items(n_items, rank, device)
    if hot is not None and _off_host(item_factors):
        # tiering frees device memory only when the master lies in host
        # RAM: `auto` serves a catalog already on the card in place, and
        # `on` reaches TieredTopK, which refuses it
        from predictionio_tpu_torch.ops import topk_tiered
        if topk_tiered.tier_mode() != "on":
            hot = None
    if hot is not None:
        from predictionio_tpu_torch.ops.topk_tiered import TieredTopK
        return TieredTopK(item_factors, k=k, buckets=buckets,
                          banned_width=banned_width, hot_items=hot,
                          device=device)
    return BucketedTopK(item_factors, k=k, buckets=buckets,
                        banned_width=banned_width, device=device)


def similar_plan(item_factors, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 mesh=None, device=None):
    """The dense-mask cosine serving plan: sharded over `mesh` when
    `_wants_shard` says so, else the single-device `BucketedSimilar` on
    `device` (a fleet `ShardSlice` keeps the whole catalog: every member
    answers alike and the router's merge drops the duplicates)."""
    n_items, rank = item_factors.shape
    if not isinstance(mesh, ShardSlice) and _wants_shard(n_items, rank,
                                                         mesh):
        return ShardedBucketedSimilar(item_factors, k=k, buckets=buckets,
                                      mesh=mesh)
    if device is None and isinstance(item_factors, torch.Tensor):
        device = item_factors.device
    return BucketedSimilar(item_factors, k=k, buckets=buckets,
                           device=device)


def _publish_shard_gauges(n_shards: int, shard_rows: dict,
                          rank: int) -> None:
    """`pio_serve_shards` and `pio_serve_shard_bytes{shard}` (the JAX
    names) in the process's registry: the shard count and the factor
    bytes each shard of `shard_rows` (shard -> rows) pins."""
    from predictionio_tpu_torch.obs import get_registry
    reg = get_registry()
    reg.gauge("pio_serve_shards",
              "Shard count of the current sharded serving plan "
              "(0/absent = single-device)").set(float(n_shards))
    g = reg.gauge("pio_serve_shard_bytes",
                  "Resident factor bytes pinned per shard by the "
                  "sharded serving plan", labels=("shard",))
    for shard, rows in shard_rows.items():
        g.labels(shard=str(shard)).set(float(rows * rank * 4))


class ShardedBucketedTopK:
    """Banned-index top-k over row-sharded resident factors: per-shard
    candidates through the fused kernel, merged on `devices[0]` (the
    module docstring has the shape and the tie argument). Drop-in for
    `BucketedTopK`. A mesh of one device is served as one shard; only
    `serve_plan` decides whether a deployment shards at all."""

    def __init__(self, item_factors, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 banned_width: int = 256, mesh: ServeMesh = None):
        from predictionio_tpu_torch.ops import fused_topk
        if not isinstance(mesh, ServeMesh) or mesh.n_shards < 1:
            raise ValueError(
                f"ShardedBucketedTopK needs a ServeMesh, got {mesh!r}")
        host = _host_f32(item_factors)
        self.n_items, self.rank = host.shape
        self.k = max(1, min(k, self.n_items))
        if self.k > fused_topk.MAX_K:
            raise ValueError(
                f"ShardedBucketedTopK k={self.k} above the fused kernel's "
                f"{fused_topk.MAX_K}; larger k goes through topk_scores*")
        self.buckets = tuple(sorted(
            {_next_pow2(b) for b in buckets
             if b > 0 and _next_pow2(b) <= fused_topk.MAX_BUCKET})) or (1,)
        self.banned_width = _next_pow2(max(1, banned_width))
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_shards = mesh.n_shards
        # the host copy is the swap rollback token; the shards are the
        # plan's resident state
        self._host_factors = host
        self.factors = shard_put(host, self.devices)
        self.per_shard = self.factors[0].shape[0]
        self.n_pad = self.per_shard * self.n_shards
        # a shard never contributes more candidates than it holds; the
        # merge still sees >= k of them overall
        self.k_shard = min(self.k, self.per_shard)
        self._warm: set = set()
        # bucket calls made by this plan (warmup included): one kernel
        # launch per shard each on CUDA devices
        self.calls = 0
        topk.register_resident_plan(self)
        _publish_shard_gauges(self.n_shards, dict.fromkeys(
            range(self.n_shards), self.per_shard), self.rank)

    def resident_per_device_bytes(self) -> float:
        """Bytes this plan pins on its most loaded device: one padded
        shard's rows times the shards that device holds."""
        most = max(Counter(self.devices).values())
        return float(self.per_shard * self.rank * 4 * most)

    def swap_factors(self, item_factors) -> np.ndarray:
        """Replace the resident factors with a same-shape catalog,
        re-split per shard; the warmed buckets keep serving. Returns the
        previous host factors (the rollback token)."""
        host = _host_f32(item_factors)
        if host.shape != (self.n_items, self.rank):
            raise ValueError(
                f"swap_factors shape {host.shape} != "
                f"{(self.n_items, self.rank)}: catalog changed; re-warm "
                "instead")
        factors = shard_put(host, self.devices)
        prev, self._host_factors = self._host_factors, host
        self.factors = factors
        return prev

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def _bucket_for(self, b: int) -> int:
        for bucket in self.buckets:
            if bucket >= b:
                return bucket
        return self.max_bucket

    def warm(self) -> int:
        """Build the kernel library (CUDA), launch every bucket on every
        shard once and synchronise each device; returns how many buckets
        were warmed (idempotent). Raises when a launch fails."""
        from predictionio_tpu_torch.ops import fused_topk
        cuda = sorted({d for d in self.devices if d.type == "cuda"},
                      key=str)
        if cuda:
            fused_topk.load_library()
        warmed = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            banned = torch.full((b, self.banned_width), self.n_items,
                                dtype=torch.int32)
            self._launch(torch.zeros((b, self.rank), dtype=torch.float32,
                                     device=self.devices[0]), banned)
            self._warm.add(b)
            warmed += 1
        for d in cuda:
            torch.cuda.synchronize(d)   # surface faults here
        return warmed

    def fits(self, *, max_banned: int, k: int) -> bool:
        """Same gate as `BucketedTopK.fits`."""
        return (bool(self._warm)
                and k <= self.k and max_banned <= self.banned_width)

    def _launch(self, vecs: torch.Tensor, banned: torch.Tensor):
        """One bucket call on device tensors: `vecs [bucket, rank]` on
        any device, `banned [bucket, W]` GLOBAL ids (the `n_items`
        filler padding). Returns (scores, global ids) [bucket, k] on
        `devices[0]`, not synchronised."""
        from predictionio_tpu_torch.ops import fused_topk
        topk.count_plan_call(self)
        per, n_items, dev0 = self.per_shard, self.n_items, self.devices[0]
        inputs = {}   # device -> (vecs, banned) uploaded once per device
        scores, gids = [], []
        for s, (dev, fac) in enumerate(zip(self.devices, self.factors)):
            if dev not in inputs:
                inputs[dev] = (vecs.to(dev), banned.to(dev))
            v, ban = inputs[dev]
            base = s * per
            # the kernel reads the global bans against its base and
            # emits global ids: the filler and other shards' ids match
            # nothing
            sc, ix = fused_topk.shard_local_candidates(
                v, fac, ban, k=self.k_shard,
                n_valid=min(max(n_items - base, 0), per), id_base=base)
            scores.append(sc.to(dev0))
            gids.append(ix.to(dev0))
        # shard-major concatenation = global-id order for equal scores
        s_cat = torch.cat(scores, dim=1)
        g_cat = torch.cat(gids, dim=1)
        top_s, pos = _topk_rows(s_cat, self.k)
        return top_s, g_cat.gather(1, pos.long())

    def __call__(self, user_vecs, banned_lists: Sequence[Sequence[int]]):
        """Score `[b, rank]` queries (host or device) against the
        sharded catalog with per-row GLOBAL banned-id lists; returns host
        (scores [b, k], ids [b, k]). Pads to the bucket grid; chunks past
        the largest bucket."""
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
                f"ShardedBucketedTopK bucket {bucket} not warmed; call "
                "warm() at deploy time")
        t0 = time.perf_counter()
        dev0 = self.devices[0]
        vecs = torch.zeros((bucket, self.rank), dtype=torch.float32,
                           device=dev0)
        vecs[:b] = torch.as_tensor(user_vecs, dtype=torch.float32,
                                   device=dev0)
        banned = np.full((bucket, self.banned_width), self.n_items, np.int32)
        for row, bl in enumerate(banned_lists):
            if len(bl):
                banned[row, :len(bl)] = np.asarray(bl, np.int32)
        scores, ixs = self._launch(vecs, torch.from_numpy(banned))
        scores, ixs = scores.cpu().numpy(), ixs.cpu().numpy()
        _record_dispatch("sharded", bucket * self.n_items,
                         time.perf_counter() - t0)
        return scores[:b], ixs[:b]


class ShardedBucketedSimilar:
    """Dense-mask cosine top-k over row-sharded resident factors: the
    mask is split by columns to match the catalog rows, each shard
    scores its own unit rows (row-local scaling, the single-device
    plan's arithmetic), keeps its best `min(k, per_shard)`, and the
    candidates merge on `devices[0]` as in `ShardedBucketedTopK`.
    Drop-in for `BucketedSimilar`."""

    def __init__(self, item_factors, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 mesh: ServeMesh = None):
        if not isinstance(mesh, ServeMesh) or mesh.n_shards < 1:
            raise ValueError(
                f"ShardedBucketedSimilar needs a ServeMesh, got {mesh!r}")
        host = _host_f32(item_factors)
        self.n_items, self.rank = host.shape
        self.k = max(1, min(k, self.n_items))
        self.buckets = tuple(sorted({_next_pow2(b)
                                     for b in buckets if b > 0})) or (1,)
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_shards = mesh.n_shards
        self._host_factors = host
        self._place(host)
        self.per_shard = self.factors[0].shape[0]
        self.n_pad = self.per_shard * self.n_shards
        self.k_shard = min(self.k, self.per_shard)
        self._warm: set = set()
        # bucket calls made by this plan (warmup included)
        self.calls = 0
        topk.register_resident_plan(self)
        _publish_shard_gauges(self.n_shards, dict.fromkeys(
            range(self.n_shards), self.per_shard), self.rank)

    def _place(self, host: np.ndarray) -> None:
        self.factors = shard_put(host, self.devices)
        self._unit = [_unit_rows(f) for f in self.factors]

    def resident_per_device_bytes(self) -> float:
        """One padded shard's rows and unit rows times the shards that
        the most loaded device holds."""
        most = max(Counter(self.devices).values())
        return float(2 * self.per_shard * self.rank * 4 * most)

    def swap_factors(self, item_factors) -> np.ndarray:
        """Replace the resident factors with a same-shape catalog, re-split
        per shard; returns the previous host factors (the rollback
        token)."""
        host = _host_f32(item_factors)
        if host.shape != (self.n_items, self.rank):
            raise ValueError(
                f"swap_factors shape {host.shape} != "
                f"{(self.n_items, self.rank)}: catalog changed; re-warm "
                "instead")
        prev, self._host_factors = self._host_factors, host
        self._place(host)
        return prev

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def _bucket_for(self, b: int) -> int:
        for bucket in self.buckets:
            if bucket >= b:
                return bucket
        return self.max_bucket

    def warm(self) -> int:
        """Run every bucket on every shard once and synchronise each
        CUDA device; returns how many buckets were warmed (idempotent)."""
        warmed = 0
        for b in self.buckets:
            if b in self._warm:
                continue
            self._launch(torch.zeros((b, self.rank), dtype=torch.float32,
                                     device=self.devices[0]),
                         torch.zeros((b, self.n_pad), dtype=torch.bool))
            self._warm.add(b)
            warmed += 1
        for d in sorted({d for d in self.devices if d.type == "cuda"},
                        key=str):
            torch.cuda.synchronize(d)
        return warmed

    def fits(self, *, k: int) -> bool:
        return bool(self._warm) and k <= self.k

    def _launch(self, vecs: torch.Tensor, mask: torch.Tensor):
        """One bucket call: `vecs [bucket, rank]` on any device, `mask
        [bucket, n_pad]` (the padding columns False). Returns (scores,
        global ids) [bucket, k] on `devices[0]`, not synchronised."""
        self.calls += 1
        per, dev0 = self.per_shard, self.devices[0]
        unit_q = _unit_rows(vecs)
        inputs = {}   # device -> unit query rows, uploaded once per device
        scores, gids = [], []
        for s, (dev, unit) in enumerate(zip(self.devices, self._unit)):
            if dev not in inputs:
                inputs[dev] = unit_q.to(dev)
            m = mask[:, s * per:(s + 1) * per].to(dev)
            local = torch.matmul(inputs[dev], unit.T).masked_fill(~m,
                                                                  NEG_INF)
            sc, ix = _topk_rows(local, self.k_shard)
            scores.append(sc.to(dev0))
            gids.append((ix + s * per).to(dev0))
        # shard-major concatenation = global-id order for equal scores
        top_s, pos = _topk_rows(torch.cat(scores, dim=1), self.k)
        return top_s, torch.cat(gids, dim=1).gather(1, pos.long())

    def __call__(self, query_vecs, mask):
        """Cosine top-k of `[b, rank]` queries (host or device) against
        the sharded catalog under the dense mask [b, n_items]; returns
        host (scores [b, k], ids [b, k]). Pads to the bucket grid; chunks
        past the largest bucket."""
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
                f"ShardedBucketedSimilar bucket {bucket} not warmed; call "
                "warm() at deploy time")
        t0 = time.perf_counter()
        dev0 = self.devices[0]
        vecs = torch.zeros((bucket, self.rank), dtype=torch.float32,
                           device=dev0)
        vecs[:b] = torch.as_tensor(query_vecs, dtype=torch.float32,
                                   device=dev0)
        # padding lanes and padding catalog columns are all-False
        mask_p = torch.zeros((bucket, self.n_pad), dtype=torch.bool)
        mask_p[:b, :self.n_items] = torch.as_tensor(np.asarray(mask, bool))
        scores, ixs = self._launch(vecs, mask_p)
        scores, ixs = scores.cpu().numpy(), ixs.cpu().numpy()
        _record_dispatch("sharded", bucket * self.n_items,
                         time.perf_counter() - t0)
        return scores[:b], ixs[:b]


class ShardSliceTopK:
    """The cross-host member-side plan: this process owns one contiguous
    ceil-divided row block of the catalog and serves its candidates in
    GLOBAL id space; a router merges across members by (-score, global
    id). The inner plan over the slice comes from `serve_plan` with no
    mesh, so a slice past the device budget tiers itself. Bans outside
    the slice are dropped on the host before the inner plan sees them."""

    def __init__(self, item_factors, *, k: int,
                 buckets: Sequence[int] = DEFAULT_SERVE_BUCKETS,
                 banned_width: int = 256, slice_spec: ShardSlice = None,
                 device=None):
        full = _host_f32(item_factors)
        n_total, rank = full.shape
        n = int(slice_spec.n_shards)
        idx = int(slice_spec.index)
        per = -(-n_total // n)
        self.base = min(per * idx, n_total)
        self._hi = min(self.base + per, n_total)
        if self._hi <= self.base:
            raise ValueError(
                f"fleet shard {idx}/{n} is empty for {n_total} items: "
                "lower the shard count")
        self.slice_spec = slice_spec
        self.n_items = n_total        # the global catalog size
        self.rank = rank
        self.slice_items = self._hi - self.base
        self.k = max(1, min(k, n_total))
        self.banned_width = banned_width
        self._inner = serve_plan(full[self.base:self._hi], k=k,
                                 buckets=buckets, banned_width=banned_width,
                                 mesh=None, device=device)
        # this member pins its own slice only
        _publish_shard_gauges(n, {idx: self.slice_items}, rank)

    # -- plan contract (delegates) ------------------------------------------
    @property
    def factors(self):
        return self._inner.factors

    @property
    def buckets(self):
        return self._inner.buckets

    @property
    def max_bucket(self) -> int:
        return self._inner.max_bucket

    @property
    def calls(self) -> int:
        """The inner plan's bucket calls (warmup included)."""
        return self._inner.calls

    def resident_per_device_bytes(self) -> float:
        # the inner plan registered itself; 0 here avoids counting twice
        return 0.0

    def warm(self) -> int:
        return self._inner.warm()

    def fits(self, *, max_banned: int, k: int) -> bool:
        # k above the slice's own candidate count still fits: the member
        # contributes min(k, slice_items) candidates and the router merge
        # fills from the other members
        return (k <= self.k and max_banned <= self.banned_width
                and self._inner.fits(max_banned=max_banned,
                                     k=min(k, self._inner.k)))

    def swap_factors(self, item_factors):
        """Hot swap: takes the full new catalog or a slice-shaped block
        (a rollback token)."""
        host = _host_f32(item_factors)
        if host.shape == (self.n_items, self.rank):
            return self._inner.swap_factors(host[self.base:self._hi])
        return self._inner.swap_factors(host)

    def __call__(self, user_vecs, banned_lists: Sequence[Sequence[int]]):
        """This member's top-k in global id space: host (scores
        [b, k_local], GLOBAL ids [b, k_local]) over its rows only."""
        local = []
        for bl in banned_lists:
            if len(bl):
                arr = np.asarray(bl, np.int64)
                arr = arr[(arr >= self.base) & (arr < self._hi)]
                local.append((arr - self.base).tolist())
            else:
                local.append(())
        scores, ixs = self._inner(user_vecs, local)
        return scores, ixs + np.int32(self.base)
