"""The port's sharded serving (`predictionio_tpu_torch/ops/topk_sharded.py`,
`parallel/mesh.py` and the K2 call site `fused_topk.shard_local_candidates`)
against the JAX package, on CPU meshes that name the CPU several times.

Integer-valued factors make every product exact, so scores and ids must
be bit-identical, ties included. The per-shard candidates are held
against the JAX kernel `_kernel_dynamic` in Pallas interpret mode; the
whole sharded plan against the JAX single-device oracles (`BucketedTopK`
warmed with the XLA chain and with the fused kernel, and
`_topk_scores_banned`), since the JAX `ShardedBucketedTopK` does not run
under this jax version's `shard_map` replication check. The selection
(`serve_plan`, `serve_mesh_from_conf`, `parse_fleet_mesh`) is compared
with the JAX functions for the same environment."""

import gc
import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import fused_topk as jax_fused
from predictionio_tpu.ops import topk as jt
from predictionio_tpu.ops import topk_sharded as jts
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops import topk as pt
from predictionio_tpu_torch.ops import topk_sharded as ps
from predictionio_tpu_torch.ops.topk_tiered import TieredTopK
from predictionio_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.torch

N, RANK, K, WIDTH = 203, 8, 6, 16
BUCKETS = (1, 2, 4, 8)


def _int(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def _cpu_mesh(n, forced=True):
    return ps.ServeMesh(("cpu",) * n, forced=forced)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def _jax_chain(vecs, factors, bans, k):
    """`_topk_scores_banned` on a filler-padded banned block."""
    width = max(1, max(map(len, bans)))
    banned = np.full((len(bans), width), factors.shape[0], np.int32)
    for row, bl in enumerate(bans):
        banned[row, :len(bl)] = bl
    return jax.device_get(jt._topk_scores_banned_device(
        vecs, factors, banned, k=k, has_bans=True))


# -- K2: the per-shard candidates against _kernel_dynamic -------------------

def _k2_case(n_shards, nv_case, bucket):
    n_items, rank, k = 700, 10, 10
    per = pmesh.pad_to_multiple(n_items, n_shards) // n_shards
    factors = _int((per, rank), seed=n_shards)
    vecs = _int((bucket, rank), seed=20 + bucket)
    n_valid = {"per": per, "per-1": per - 1, "5": 5, "0": 0}[nv_case]
    # local bans: nothing, a span over the 128-row tile edge, the ragged
    # end, every row (an all-banned row), the filler `per` alone
    cases = [[], list(range(120, 136)), list(range(per - 6, per)),
             list(range(per)), [per]]
    width = 256
    banned = np.full((bucket, width), per, np.int32)
    for row in range(bucket):
        ids = cases[row % len(cases)][:width]
        banned[row, :len(ids)] = ids
    return factors, vecs, banned, n_valid, k


@pytest.mark.parametrize("bucket", [1, 8])
@pytest.mark.parametrize("nv_case", ["per", "per-1", "5", "0"])
@pytest.mark.parametrize("n_shards", [3, 4])
def test_shard_local_candidates_bit_identical_to_jax_k2(
        n_shards, nv_case, bucket, monkeypatch):
    factors, vecs, banned, n_valid, k = _k2_case(n_shards, nv_case, bucket)
    before = fused_topk.SHARD_LAUNCHES
    s, i = fused_topk.shard_local_candidates(
        torch.from_numpy(vecs), torch.from_numpy(factors),
        torch.from_numpy(banned), k=k, n_valid=n_valid)
    assert fused_topk.SHARD_LAUNCHES == before    # no launch on the CPU
    monkeypatch.setenv("PIO_FUSED_TILE_ITEMS", "128")
    call = jax_fused._pallas_topk(
        factors.shape[0], factors.shape[1], k=k, bucket=bucket,
        banned_width=banned.shape[1], n_valid=None, interpret=True)
    ref = jax.device_get(jax.jit(call)(
        np.array([n_valid], np.int32), vecs, factors, banned))
    _same((s.numpy(), i.numpy()), ref)
    assert (i.numpy() < factors.shape[0]).all()
    if n_valid < k:
        masked = (s.numpy() == np.float32(pt.NEG_INF)).sum(axis=1)
        assert (masked >= k - n_valid).all()


@pytest.mark.parametrize("bucket", [1, 8])
@pytest.mark.parametrize("n_shards", [3, 4])
def test_global_bans_with_id_base_bit_identical_to_jax_k2(
        n_shards, bucket, monkeypatch):
    """K2 as `ShardedBucketedTopK` launches it: the GLOBAL bans and the
    shard's first global row as `id_base`, global ids out. Held against
    the JAX `_kernel_dynamic` fed the bans translated to local ids, its
    ids + base: bans straddling every shard edge, the `n_items` filler,
    another shard's ids, an all-banned shard."""
    n_items, rank, k, width = 700, 10, 10, 256
    per = pmesh.pad_to_multiple(n_items, n_shards) // n_shards
    parts = pmesh.shard_put(_int((n_items, rank), seed=50 + n_shards),
                            [torch.device("cpu")] * n_shards)
    vecs = _int((bucket, rank), seed=60 + bucket)
    edges = [e for s in range(1, n_shards)
             for e in range(s * per - 3, s * per + 3)]
    cases = [[], edges, [0, per - 1, per, n_items - 1, n_items],
             list(range(per)), list(range(per, 2 * per)), edges[::-1]]
    glob = np.full((bucket, width), n_items, np.int32)
    for row in range(bucket):
        ids = cases[row % len(cases)]
        glob[row, :len(ids)] = ids
    monkeypatch.setenv("PIO_FUSED_TILE_ITEMS", "128")
    call = jax.jit(jax_fused._pallas_topk(
        per, rank, k=k, bucket=bucket, banned_width=width, n_valid=None,
        interpret=True))
    for idx, fac in enumerate(parts):
        base = idx * per
        n_valid = min(max(n_items - base, 0), per)
        s, i = fused_topk.shard_local_candidates(
            torch.from_numpy(vecs), fac, torch.from_numpy(glob), k=k,
            n_valid=n_valid, id_base=base)
        local = np.full((bucket, width), per, np.int32)
        for row in range(bucket):
            mine = [g - base for g in glob[row] if 0 <= g - base < per]
            local[row, :len(mine)] = mine
        rs, ri = jax.device_get(call(np.array([n_valid], np.int32), vecs,
                                     fac.numpy(), local))
        np.testing.assert_array_equal(i.numpy(), ri + base)
        np.testing.assert_array_equal(s.numpy(), rs)


def test_shard_local_candidates_refuses_k_above_the_shard():
    with pytest.raises(ValueError, match="above the shard"):
        fused_topk.shard_local_candidates(
            torch.zeros((1, 4)), torch.zeros((3, 4)),
            torch.zeros((1, 1), dtype=torch.int32), k=4, n_valid=3)


# -- the mesh helpers ---------------------------------------------------------

@pytest.mark.parametrize("n,m", [(203, 8), (5, 4), (2, 3), (0, 4), (16, 4)])
def test_pad_helpers_match_jax(n, m):
    from predictionio_tpu.parallel import mesh as jmesh
    assert pmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    a = _int((n, 3), seed=n)
    target = pmesh.pad_to_multiple(n, m)
    np.testing.assert_array_equal(pmesh.pad_rows(a, target, fill=7),
                                  jmesh.pad_rows(a, target, fill=7))


def test_shard_put_blocks_and_padding():
    host = _int((N, RANK), seed=1)
    parts = pmesh.shard_put(host, [torch.device("cpu")] * 8)
    assert len(parts) == 8
    assert all(p.shape == (26, RANK) and p.is_contiguous()
               and p.dtype == torch.float32 for p in parts)
    whole = torch.cat(parts).numpy()
    np.testing.assert_array_equal(whole[:N], host)
    assert not whole[N:].any()                  # 5 zero padding rows
    host[0, 0] = 99.0                           # no memory shared
    assert parts[0][0, 0].item() != 99.0
    with pytest.raises(ValueError, match="no devices"):
        pmesh.shard_put(host, [])


# -- the whole sharded plan against the single-device oracles --------------

_ORACLES = {}


@pytest.fixture(params=["off", "on"])
def oracle(request):
    """The JAX single-device plan over the 203-item catalog, warmed with
    the XLA chain (`off`) or the fused kernel in interpret mode (`on`);
    built once per mode."""
    mode = request.param
    if mode not in _ORACLES:
        prev = os.environ.get("PIO_SERVE_FUSED")
        os.environ["PIO_SERVE_FUSED"] = mode
        try:
            plan = jt.BucketedTopK(_int((N, RANK), seed=1), k=K,
                                   buckets=BUCKETS, banned_width=WIDTH)
            assert plan.warm() == 4
            assert plan.fused_buckets == (4 if mode == "on" else 0)
        finally:
            if prev is None:
                os.environ.pop("PIO_SERVE_FUSED", None)
            else:
                os.environ["PIO_SERVE_FUSED"] = prev
        _ORACLES[mode] = plan
    return _ORACLES[mode]


@pytest.fixture(params=[2, 3, 4, 8])
def sharded(request):
    plan = ps.ShardedBucketedTopK(_int((N, RANK), seed=1), k=K,
                                  buckets=BUCKETS, banned_width=WIDTH,
                                  mesh=_cpu_mesh(request.param))
    assert plan.n_shards == request.param
    assert plan.per_shard == pmesh.pad_to_multiple(N, request.param) \
        // request.param
    assert plan.warm() == 4 and plan.warm() == 0
    return plan


def _bans(b, seed):
    rng = np.random.default_rng(seed)
    return [sorted(rng.choice(N, size=int(rng.integers(0, WIDTH)),
                              replace=False).tolist()) for _ in range(b)]


def test_every_bucket_bit_identical(sharded, oracle):
    for b in (1, 2, 3, 5, 8):
        vecs = _int((b, RANK), seed=10 + b)
        bans = _bans(b, seed=b)
        got = sharded(vecs, bans)
        _same(got, oracle(vecs, bans))
        _same(got, _jax_chain(vecs, _int((N, RANK), seed=1), bans, K))


def test_bans_straddling_shard_edges(sharded, oracle):
    per = sharded.per_shard
    edges = [list(range(s * per - 4, s * per + 4))
             for s in range(1, sharded.n_shards) if s * per < N]
    # a ban of item g must not also ban g + per (the wrap of a negative
    # local index) nor g - per
    bans = (edges + [[0, per - 1, per, N - 1]] * 2)[:8]
    vecs = np.ones((len(bans), RANK), np.float32)
    _same(sharded(vecs, bans), oracle(vecs, bans))
    vecs = _int((len(bans), RANK), seed=3)
    _same(sharded(vecs, bans), oracle(vecs, bans))


def test_padding_rows_never_leak(sharded, oracle):
    # queries that score every real item below zero: zero-valued padding
    # rows would win if they were not masked
    vecs = -np.ones((4, RANK), np.float32)
    factors = np.abs(_int((N, RANK), seed=5)) + 1.0
    plan = ps.ShardedBucketedTopK(factors, k=K, buckets=BUCKETS,
                                  banned_width=WIDTH, mesh=sharded.mesh)
    plan.warm()
    got = plan(vecs, [[]] * 4)
    assert (got[1] < N).all()
    _same(got, _jax_chain(vecs, factors, [[]] * 4, K))
    bans = [list(range(N - WIDTH, N))] * 4
    got = plan(vecs, bans)
    assert (got[1] < N).all()
    _same(got, _jax_chain(vecs, factors, bans, K))


def test_chunks_past_largest_bucket(sharded, oracle):
    vecs = _int((19, RANK), seed=77)
    bans = _bans(19, seed=77)
    calls = sharded.calls
    _same(sharded(vecs, bans), oracle(vecs, bans))
    assert sharded.calls - calls == 3         # 8 + 8 + 3 (padded to 4)


def test_swap_factors(sharded, oracle):
    new = _int((N, RANK), seed=99)
    prev = sharded.swap_factors(new)
    np.testing.assert_array_equal(prev, _int((N, RANK), seed=1))
    vecs = _int((5, RANK), seed=5)
    bans = _bans(5, seed=5)
    _same(sharded(vecs, bans), _jax_chain(vecs, new, bans, K))
    with pytest.raises(ValueError, match="catalog changed"):
        sharded.swap_factors(_int((N + 1, RANK), seed=2))
    sharded.swap_factors(prev)                   # the rollback token
    _same(sharded(vecs, bans), oracle(vecs, bans))


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_all_banned_rows_tie_break_by_global_id(n_shards):
    """Every item banned: NEG_INF scores with global ids 0..k-1, as the
    oracle gives, whatever shard each id lives on."""
    factors = _int((N, RANK), seed=1)
    plan = ps.ShardedBucketedTopK(factors, k=K, buckets=(2,),
                                  banned_width=256, mesh=_cpu_mesh(n_shards))
    plan.warm()
    vecs = _int((2, RANK), seed=4)
    bans = [list(range(N)), []]
    got = plan(vecs, bans)
    np.testing.assert_array_equal(got[1][0], np.arange(K))
    assert (got[0][0] == np.float32(pt.NEG_INF)).all()
    _same(got, _jax_chain(vecs, factors, bans, K))


@pytest.mark.parametrize("n_items,n_shards,k", [(5, 4, 4), (5, 4, 5),
                                                (7, 3, 6), (2, 3, 2)])
def test_k_above_per_shard(n_items, n_shards, k):
    """Tiny catalogs: shards hold fewer than k rows (k_shard clamps) and
    the last shard may hold none (n_valid 0); the merge still returns
    k."""
    factors = _int((n_items, 4), seed=n_items)
    plan = ps.ShardedBucketedTopK(factors, k=k, buckets=(1, 2, 4),
                                  banned_width=4, mesh=_cpu_mesh(n_shards))
    assert plan.k_shard == min(k, plan.per_shard) < k
    plan.warm()
    vecs = _int((3, 4), seed=30)
    for bans in ([[], [0], [n_items - 1, 0]],
                 [list(range(min(n_items, 4)))] * 3):
        got = plan(vecs, bans)
        assert got[1].shape == (3, k)
        _same(got, _jax_chain(vecs, factors, bans, k))


def test_sharded_plan_contract_and_dispatch_count():
    factors = _int((N, RANK), seed=1)
    with pytest.raises(ValueError, match="needs a ServeMesh"):
        ps.ShardedBucketedTopK(factors, k=K, mesh=None)
    with pytest.raises(ValueError, match="above the fused kernel"):
        ps.ShardedBucketedTopK(factors, k=fused_topk.MAX_K + 1,
                               mesh=_cpu_mesh(2))
    plan = ps.ShardedBucketedTopK(factors, k=K, buckets=(1, 3, 300),
                                  banned_width=10, mesh=_cpu_mesh(3))
    assert plan.buckets == (1, 4)       # pow2; above the kernel's 128 dropped
    assert plan.banned_width == 16
    assert not plan.fits(max_banned=0, k=1)
    with pytest.raises(RuntimeError, match="not warmed"):
        plan(_int((1, RANK), seed=0), [[]])
    assert plan.warm() == 2
    assert plan.fits(max_banned=16, k=K)
    assert not plan.fits(max_banned=17, k=K)
    assert not plan.fits(max_banned=0, k=K + 1)
    before = pt.DISPATCH_COUNTS["sharded"]
    plan(_int((3, RANK), seed=0), [[]] * 3)
    assert pt.DISPATCH_COUNTS["sharded"] == before + 1
    assert pt.DISPATCH_POLICY.snapshot()["sharded_call_s"] is not None
    # one device holding every shard pins all of them
    assert plan.resident_per_device_bytes() == 3 * plan.per_shard * RANK * 4


def test_device_tensor_queries():
    factors = _int((N, RANK), seed=1)
    plan = ps.ShardedBucketedTopK(factors, k=K, buckets=BUCKETS,
                                  banned_width=WIDTH, mesh=_cpu_mesh(3))
    plan.warm()
    vecs = _int((3, RANK), seed=3)
    bans = _bans(3, seed=3)
    _same(plan(torch.from_numpy(vecs), bans), plan(vecs, bans))


# -- the fleet-member slice plan ---------------------------------------------

@pytest.mark.parametrize("index", [0, 1, 2])
def test_shard_slice_matches_jax(index):
    factors = _int((407, RANK), seed=7)
    spec_p, spec_j = ps.ShardSlice(3, index), jts.ShardSlice(3, index)
    port = ps.ShardSliceTopK(factors, k=K, buckets=(1, 2),
                             banned_width=64, slice_spec=spec_p,
                             device="cpu")
    ref = jts.ShardSliceTopK(factors, k=K, buckets=(1, 2),
                             banned_width=64, slice_spec=spec_j)
    assert (port.base, port._hi) == (ref.base, ref._hi)
    assert port.warm() == ref.warm() == 2
    assert isinstance(port._inner, pt.BucketedTopK)
    boundary = ref._hi
    vecs = _int((2, RANK), seed=6)
    for bans in ([list(range(boundary - 4, boundary + 4))] * 2,
                 [[0, 1, 406], []], [[], []]):
        got = port(vecs, bans)
        _same(got, ref(vecs, bans))
        assert ((got[1] >= port.base) & (got[1] < port._hi)).all()
    assert port.fits(max_banned=64, k=K) == ref.fits(max_banned=64, k=K)
    assert port.fits(max_banned=65, k=K) == ref.fits(max_banned=65, k=K)
    assert port.resident_per_device_bytes() == 0.0
    new = _int((407, RANK), seed=8)
    port.swap_factors(new)
    ref.swap_factors(new)
    _same(port(vecs, [[], [5]]), ref(vecs, [[], [5]]))


def test_shard_slice_union_is_the_oracle():
    factors = _int((407, RANK), seed=7)
    slices = [ps.ShardSliceTopK(factors, k=K, buckets=(2,), banned_width=16,
                                slice_spec=ps.ShardSlice(3, i), device="cpu")
              for i in range(3)]
    for p in slices:
        p.warm()
    vecs = _int((2, RANK), seed=9)
    bans = [list(range(slices[0]._hi - 3, slices[0]._hi + 3)), []]
    cands = [p(vecs, bans) for p in slices]
    ref = _jax_chain(vecs, factors, bans, K)
    for row in range(2):
        pool = sorted([(float(s[row, j]), int(ix[row, j]))
                       for s, ix in cands for j in range(s.shape[1])],
                      key=lambda t: (-t[0], t[1]))[:K]
        assert [g for _, g in pool] == ref[1][row].tolist()


def test_empty_slice_raises_like_jax():
    tiny = np.ones((2, 4), np.float32)
    for mod in (ps, jts):
        with pytest.raises(ValueError, match="is empty"):
            mod.ShardSliceTopK(tiny, k=1, buckets=(1,), banned_width=4,
                               slice_spec=mod.ShardSlice(3, 2))


# -- selection ---------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "items=4@fleet", "items=4@fleet:2", " items = 3 @ fleet:0 ", "items=8",
    "", None, "items=4@fleet:4", "items=0@fleet", "items=2@fleet:-1"])
def test_parse_fleet_mesh_matches_jax(spec):
    try:
        want = jts.parse_fleet_mesh(spec)
    except ValueError:
        with pytest.raises(ValueError, match="bad fleet mesh"):
            ps.parse_fleet_mesh(spec)
        return
    assert ps.parse_fleet_mesh(spec) == want


@pytest.mark.parametrize("shard,shards", [
    ("auto", ""), ("on", ""), ("off", ""), ("auto", "3"), ("on", "1"),
    ("on", "3"), ("auto", "1"), ("off", "3")])
def test_serve_mesh_from_conf_matches_jax(shard, shards, monkeypatch):
    """With 8 local cards (the JAX side has the 8 virtual CPU devices),
    the same env gives the same shard count and `forced`."""
    monkeypatch.setenv("PIO_SERVE_SHARD", shard)
    monkeypatch.setenv("PIO_SERVE_SHARDS", shards)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got, want = ps.serve_mesh_from_conf(), jts.serve_mesh_from_conf(None)
    if want is None:
        assert got is None
        return
    assert (got.n_shards, got.forced) == (want.n_shards, want.forced)
    assert got.devices == tuple(torch.device("cuda", i)
                                for i in range(got.n_shards))


def test_serve_mesh_from_conf_needs_two_cards(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_SHARD", "on")
    for count in (0, 1):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert ps.serve_mesh_from_conf() is None


def _kind(plan):
    return type(plan).__name__


@pytest.mark.parametrize("n_shards,forced,hbm,tier,frac", [
    (0, False, "", "auto", ""),           # no mesh, unknown capacity
    (3, True, "", "auto", ""),            # a forced mesh always shards
    (3, False, "", "auto", ""),           # un-forced: capacity unknown
    (3, False, "4096", "auto", ""),       # un-forced past capacity
    (3, False, "1e12", "auto", ""),       # un-forced, fits
    (1, True, "4096", "auto", ""),        # one entry never shards: tiers
    (0, False, "4096", "auto", ""),       # no mesh past capacity: tiers
    (0, False, "4096", "off", ""),        # tiering off
    (0, False, "", "on", "0.25"),         # tiering forced, slab by frac
    (0, False, "", "on", ""),             # forced, unknown budget
    (0, False, "40000", "on", ""),        # forced, slab fills the budget
    (2, True, "", "on", "0.5"),           # the mesh wins over tiering
])
def test_serve_plan_choice_matches_jax(n_shards, forced, hbm, tier, frac,
                                       monkeypatch):
    # the two packages' resident-plan registries hold different live
    # plans; the choice is compared at the same capacity
    monkeypatch.setattr(jt, "plan_resident_bytes", lambda: 0.0)
    monkeypatch.setattr(pt, "plan_resident_bytes", lambda: 0.0)
    for name, val in (("PIO_DEVICE_HBM_BYTES", hbm),
                      ("PIO_SERVE_TIER", tier), ("PIO_TIER_HOT_FRAC", frac)):
        monkeypatch.setenv(name, val)
    factors = _int((400, RANK), seed=2)
    jmesh = pmesh_ = None
    if n_shards:
        from jax.sharding import Mesh
        jmesh = jts.ServeMesh(Mesh(np.array(jax.devices()[:n_shards]),
                                   (jts.SHARD_AXIS,)), forced)
        pmesh_ = _cpu_mesh(n_shards, forced)
    want = jts.serve_plan(factors, k=4, buckets=(1,), banned_width=4,
                          mesh=jmesh)
    got = ps.serve_plan(factors, k=4, buckets=(1,), banned_width=4,
                        mesh=pmesh_, device="cpu")
    assert _kind(got) == _kind(want)
    if isinstance(got, TieredTopK):
        assert got.hot_items == want.hot_items
    if isinstance(got, ps.ShardedBucketedTopK):
        assert (got.n_shards, got.per_shard) == (want.n_shards,
                                                 want.per_shard)
    del got, want


def test_serve_plan_slice_recurses():
    factors = _int((407, RANK), seed=7)
    plan = ps.serve_plan(factors, k=K, buckets=(1,), banned_width=8,
                         mesh=ps.ShardSlice(3, 1), device="cpu")
    assert isinstance(plan, ps.ShardSliceTopK)
    assert plan.slice_items == 136 and isinstance(plan._inner,
                                                  pt.BucketedTopK)


def test_capacity_counts_resident_plans(monkeypatch):
    """A second deploy of the same catalog sees the first plan's bytes:
    the budget shrinks by what live plans pin, and a catalog that fitted
    once tiers the second time instead of overcommitting the card."""
    gc.collect()
    monkeypatch.setenv("PIO_SERVE_TIER", "auto")
    monkeypatch.delenv("PIO_TIER_HOT_FRAC", raising=False)
    monkeypatch.setenv("PIO_DEVICE_HBM_BYTES", "10000000")
    before = ps.effective_device_capacity("cpu")
    f = np.ones((1000, 8), np.float32)
    plan = pt.BucketedTopK(f, k=4, buckets=(1,), banned_width=4,
                           device="cpu")
    assert ps.effective_device_capacity("cpu") == pytest.approx(
        before - f.nbytes)
    sharded = ps.ShardedBucketedTopK(f, k=4, buckets=(1,), banned_width=4,
                                     mesh=_cpu_mesh(3))
    assert ps.effective_device_capacity("cpu") == pytest.approx(
        before - f.nbytes - 3 * 334 * 8 * 4)
    del plan, sharded
    gc.collect()
    assert ps.effective_device_capacity("cpu") == pytest.approx(before)

    g = _int((500, 8), seed=8)
    resident0 = pt.plan_resident_bytes()
    budget = (resident0 + g.nbytes * 1.25) / 0.8
    monkeypatch.setenv("PIO_DEVICE_HBM_BYTES", str(budget))
    first = ps.serve_plan(g, k=4, buckets=(1,), banned_width=4, device="cpu")
    assert isinstance(first, pt.BucketedTopK)
    second = ps.serve_plan(g, k=4, buckets=(1,), banned_width=4,
                           device="cpu")
    assert isinstance(second, TieredTopK) and second.hot_items < 500


def test_off_host_catalog_is_never_tiered(monkeypatch):
    """Tiering needs the master in host RAM: `auto` serves a catalog that
    already lies off the host in place, and `on` refuses it. A `meta`
    tensor stands in for a card's here."""
    monkeypatch.setattr(pt, "plan_resident_bytes", lambda: 0.0)
    monkeypatch.setenv("PIO_DEVICE_HBM_BYTES", "4096")
    monkeypatch.delenv("PIO_TIER_HOT_FRAC", raising=False)
    on_card = torch.empty((400, RANK), device="meta")
    monkeypatch.setenv("PIO_SERVE_TIER", "auto")
    host = ps.serve_plan(np.zeros((400, RANK), np.float32), k=4,
                         buckets=(1,), banned_width=4, device="meta")
    assert isinstance(host, TieredTopK)
    plan = ps.serve_plan(on_card, k=4, buckets=(1,), banned_width=4)
    assert isinstance(plan, pt.BucketedTopK) and plan.factors is on_card
    monkeypatch.setenv("PIO_SERVE_TIER", "on")
    with pytest.raises(ValueError, match="host RAM"):
        ps.serve_plan(on_card, k=4, buckets=(1,), banned_width=4)


def test_device_capacity(monkeypatch):
    monkeypatch.delenv("PIO_DEVICE_HBM_BYTES", raising=False)
    assert ps.device_capacity_bytes("cpu") is None
    assert ps.effective_device_capacity("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ps.device_capacity_bytes() is None
    monkeypatch.setenv("PIO_DEVICE_HBM_BYTES", "123")
    assert ps.device_capacity_bytes("cpu") == 123.0


def test_serve_mesh_holds_torch_devices():
    m = ps.ServeMesh(("cpu", torch.device("cpu")), forced=True)
    assert m.devices == (torch.device("cpu"),) * 2 and m.n_shards == 2
    assert not ps._wants_shard(10, 4, ps.ServeMesh(("cpu",), forced=True))
    assert not ps._wants_shard(10, 4, None)
    assert ps._wants_shard(10, 4, m)


# -- end to end: a sharded deployment answers as the single-device one --------

N_USERS, N_ITEMS, E2E_RANK = 40, 301, 16
USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_sharded_deploy_answers_as_single_device():
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (N_USERS, E2E_RANK)).astype(np.float32)
    y = rng.integers(-4, 5, (N_ITEMS, E2E_RANK)).astype(np.float32)
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    queries = []
    for n in range(24):
        q = {"user": USERS[n % N_USERS], "num": 1 + n % 10}
        if n % 3 == 0:     # bans across the 3 shard edges (101, 202)
            q["blackList"] = [ITEMS[j] for j in
                              [*range(96, 106), *range(198, 206), 300]]
        queries.append(q)
    single = cli.deploy(model, port=0, batch_max=8)
    sharded = cli.deploy(model, port=0, batch_max=8,
                         mesh=_cpu_mesh(3))
    try:
        plan = sharded.deployment.algos[0]._serve_plan
        assert isinstance(plan, ps.ShardedBucketedTopK)
        assert plan.n_shards == 3 and plan.per_shard == 101
        assert isinstance(single.deployment.algos[0]._serve_plan,
                          pt.BucketedTopK)
        before = pt.DISPATCH_COUNTS["sharded"]
        for q in queries:
            assert _post(sharded.port, q) == _post(single.port, q)
        assert pt.DISPATCH_COUNTS["sharded"] - before == len(queries)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{sharded.port}/", timeout=30) as resp:
            status = json.loads(resp.read())
        assert status["plans"] == ["ShardedBucketedTopK"]
    finally:
        single.stop()
        sharded.stop()


# -- the dense-mask cosine plan (similar-product template) ------------------

def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sim_mask(b, seed, n=N):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, n)) > 0.4
    if b > 1:
        mask[1] = False
        mask[1, [0, n - 1]] = True     # fewer allowed items than k
    return mask


@pytest.mark.parametrize("n_shards", [2, 3, 4, 8])
def test_sharded_similar_matches_single_device_plan(n_shards):
    """`ShardedBucketedSimilar` on a CPU mesh answers as `BucketedSimilar`
    on the same catalog (ids equal, scores to 1e-6: the per-shard
    products differ from the whole one only in fp32 summation order),
    and both as the JAX `_topk_similar_raw`; padding rows never leak."""
    factors = _real((N, RANK), seed=41)
    single = pt.BucketedSimilar(factors, k=K, buckets=BUCKETS, device="cpu")
    plan = ps.ShardedBucketedSimilar(factors, k=K, buckets=BUCKETS,
                                     mesh=_cpu_mesh(n_shards))
    assert plan.n_pad == pmesh.pad_to_multiple(N, n_shards)
    assert single.warm() == plan.warm() == 4 and plan.warm() == 0
    for b in (1, 3, 8, 13):            # 13: chunks past the largest bucket
        vecs = _real((b, RANK), seed=42 + b)
        mask = _sim_mask(b, seed=b)
        got = plan(vecs, mask)
        np.testing.assert_array_equal(got[1], single(vecs, mask)[1])
        np.testing.assert_allclose(got[0], single(vecs, mask)[0],
                                   rtol=1e-6, atol=1e-6)
        want = jax.device_get(jt._topk_similar_raw(vecs, factors, mask,
                                                    k=K))
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
        assert (got[1] < N).all()
    assert plan.calls == 4 + 1 + 1 + 1 + 2


def test_sharded_similar_swap_and_selection(monkeypatch):
    factors = _real((N, RANK), seed=51)
    plan = ps.similar_plan(factors, k=K, buckets=BUCKETS,
                           mesh=_cpu_mesh(3))
    assert isinstance(plan, ps.ShardedBucketedSimilar)
    assert isinstance(ps.similar_plan(factors, k=K, buckets=BUCKETS,
                                      mesh=_cpu_mesh(3, forced=False),
                                      device="cpu"), pt.BucketedSimilar)
    assert isinstance(ps.similar_plan(factors, k=K, buckets=BUCKETS,
                                      mesh=ps.ShardSlice(2, 0),
                                      device="cpu"), pt.BucketedSimilar)
    plan.warm()
    new = _real((N, RANK), seed=52)
    prev = plan.swap_factors(new)
    np.testing.assert_array_equal(prev, factors)
    vecs, mask = _real((2, RANK), seed=53), _sim_mask(2, seed=9)
    single = pt.BucketedSimilar(new, k=K, buckets=BUCKETS, device="cpu")
    single.warm()
    np.testing.assert_array_equal(plan(vecs, mask)[1], single(vecs, mask)[1])
    with pytest.raises(ValueError, match="catalog changed"):
        plan.swap_factors(new[1:])
    assert plan.resident_per_device_bytes() == 2 * plan.per_shard * RANK * 4 * 3
