"""The port's fused top-k (`predictionio_tpu_torch/ops/fused_topk.py`)
against the JAX package's fused kernel in Pallas interpret mode and its
`_topk_scores_banned` oracle.

On the CPU the wrapper runs the kernel's plain PyTorch version, so these
tests hold that version to the JAX semantics: bit-identical scores and
ids on integer-valued factors (exact products, ties included); within
rtol=atol=1e-6 on real-valued factors, where only the fp32 summation
order of the products differs. The CUDA kernel itself is held against
the plain version on the card by `chip_smoke.py`."""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import fused_topk as jax_fused
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import fused_topk

pytestmark = pytest.mark.torch

N_ITEMS = 700   # not a multiple of the 128-item or the 512-item tile
WIDTH = 16


def _int(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-4, 5, size=shape).astype(np.float32)


def _bans(b, n, width, seed=3):
    """Rows cycle through: nothing, a span over the 128 edge, a span
    over the 512 edge, the catalog's ragged end, random ids."""
    rng = np.random.default_rng(seed)
    cases = [[], list(range(124, 132)), list(range(506, 518)),
             list(range(n - 6, n)),
             sorted(rng.choice(n, size=width, replace=False).tolist())]
    banned = np.full((b, width), n, np.int32)
    for row in range(b):
        ids = cases[row % len(cases)][:width]
        banned[row, :len(ids)] = ids
    return banned


def _jax_kernel(vecs, factors, banned, *, k, n_valid, tile, monkeypatch):
    monkeypatch.setenv("PIO_FUSED_TILE_ITEMS", str(tile))
    call = jax_fused._pallas_topk(
        factors.shape[0], factors.shape[1], k=k, bucket=vecs.shape[0],
        banned_width=banned.shape[1], n_valid=n_valid, interpret=True)
    return jax.device_get(jax.jit(call)(vecs, factors, banned))


def _jax_chain(vecs, factors, banned, *, k):
    return jax.device_get(jax_topk._topk_scores_banned_device(
        vecs, factors, banned, k=k, has_bans=True))


def _port(vecs, factors, banned, *, k, n_valid):
    s, i = fused_topk.fused_topk(torch.from_numpy(vecs),
                                 torch.from_numpy(factors),
                                 torch.from_numpy(banned), k=k,
                                 n_valid=n_valid)
    return s.numpy(), i.numpy()


def _same(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("rank", [10, 64])
@pytest.mark.parametrize("bucket", [1, 3, 8, 64])
def test_bit_identical_to_jax_kernel_and_chain(rank, bucket, monkeypatch):
    factors = _int((N_ITEMS, rank), seed=rank)
    vecs = _int((bucket, rank), seed=100 + bucket)
    banned = _bans(bucket, N_ITEMS, WIDTH)
    for k in (1, 10):
        port = _port(vecs, factors, banned, k=k, n_valid=N_ITEMS)
        _same(port, _jax_chain(vecs, factors, banned, k=k))
        for tile in (128, 512):
            _same(port, _jax_kernel(vecs, factors, banned, k=k,
                                    n_valid=N_ITEMS, tile=tile,
                                    monkeypatch=monkeypatch))


@pytest.mark.parametrize("rank", [10, 64])
def test_k_equals_n_items(rank, monkeypatch):
    n = 200
    factors = _int((n, rank), seed=5)
    vecs = _int((3, rank), seed=6)
    banned = _bans(3, n, WIDTH)
    port = _port(vecs, factors, banned, k=n, n_valid=n)
    _same(port, _jax_chain(vecs, factors, banned, k=n))
    _same(port, _jax_kernel(vecs, factors, banned, k=n, n_valid=n,
                            tile=128, monkeypatch=monkeypatch))


@pytest.mark.parametrize("n_valid", [5, 333, 640])
def test_n_valid_below_n_items(n_valid, monkeypatch):
    """Rows past n_valid score NEG_INF and are still emitted when fewer
    than k valid items remain (n_valid=5 < k=10), lowest id first."""
    factors = _int((N_ITEMS, 10), seed=8)
    vecs = _int((8, 10), seed=9)
    banned = _bans(8, N_ITEMS, WIDTH)
    port = _port(vecs, factors, banned, k=10, n_valid=n_valid)
    for tile in (128, 512):
        _same(port, _jax_kernel(vecs, factors, banned, k=10,
                                n_valid=n_valid, tile=tile,
                                monkeypatch=monkeypatch))
    masked = (port[0] == np.float32(-1e30)).sum(axis=1)
    assert (masked >= 10 - n_valid).all()


@pytest.mark.parametrize("k", [1, 10, 60])
def test_all_banned_row(k, monkeypatch):
    """Every item banned: NEG_INF scores with ids 0..k-1, never a
    duplicate; the other rows are unaffected."""
    n = 60
    factors = _int((n, 4), seed=11)
    vecs = _int((2, 4), seed=12)
    banned = np.full((2, 64), n, np.int32)
    banned[0, :n] = np.arange(n)
    port = _port(vecs, factors, banned, k=k, n_valid=n)
    np.testing.assert_array_equal(port[1][0], np.arange(k))
    assert (port[0][0] == np.float32(-1e30)).all()
    _same(port, _jax_chain(vecs, factors, banned, k=k))
    _same(port, _jax_kernel(vecs, factors, banned, k=k, n_valid=n,
                            tile=512, monkeypatch=monkeypatch))


@pytest.mark.parametrize("rank", [10, 64])
def test_real_valued_within_tolerance(rank, monkeypatch):
    rng = np.random.default_rng(21)
    factors = rng.standard_normal((N_ITEMS, rank)).astype(np.float32)
    vecs = rng.standard_normal((8, rank)).astype(np.float32)
    banned = _bans(8, N_ITEMS, WIDTH)
    port = _port(vecs, factors, banned, k=10, n_valid=N_ITEMS)
    for ref in (_jax_chain(vecs, factors, banned, k=10),
                _jax_kernel(vecs, factors, banned, k=10, n_valid=N_ITEMS,
                            tile=128, monkeypatch=monkeypatch)):
        np.testing.assert_array_equal(port[1], ref[1])
        np.testing.assert_allclose(port[0], ref[0], rtol=1e-6, atol=1e-6)


def test_filler_and_out_of_range_bans_match_nothing():
    factors = _int((300, 6), seed=31)
    vecs = _int((2, 6), seed=32)
    clean = np.full((2, 4), 300, np.int32)
    noisy = np.array([[300, 10**6, 2**31 - 1, 300],
                      [300, 300, 300, 300]], np.int32)
    _same(_port(vecs, factors, clean, k=10, n_valid=300),
          _port(vecs, factors, noisy, k=10, n_valid=300))


def test_cpu_wrapper_runs_plain_version_without_counting():
    before = fused_topk.LAUNCHES
    factors = _int((130, 8), seed=41)
    vecs = _int((2, 8), seed=42)
    banned = _bans(2, 130, 4)
    _same(_port(vecs, factors, banned, k=5, n_valid=130),
          tuple(t.numpy() for t in fused_topk.fused_topk_reference(
              torch.from_numpy(vecs), torch.from_numpy(factors),
              torch.from_numpy(banned), k=5, n_valid=130)))
    assert fused_topk.LAUNCHES == before


@pytest.mark.parametrize("k", [10, 64])
def test_all_equal_scores_lowest_ids_win(k, monkeypatch):
    """Every item scores the same: the lowest unbanned ids come out, in
    order, past the banned ones (the running lists compare the whole
    (score, id) pair, not the score alone)."""
    n = 700
    factors = np.ones((n, 8), np.float32)
    vecs = np.ones((3, 8), np.float32)
    banned = np.full((3, 64), n, np.int32)
    banned[1, :3] = [0, 3, 5]
    banned[2, :64] = np.arange(64)
    port = _port(vecs, factors, banned, k=k, n_valid=n)
    np.testing.assert_array_equal(port[1][0], np.arange(k))
    np.testing.assert_array_equal(
        port[1][1], [i for i in range(k + 3) if i not in (0, 3, 5)][:k])
    np.testing.assert_array_equal(port[1][2], np.arange(64, 64 + k))
    assert (port[0] == np.float32(8.0)).all()
    _same(port, _jax_kernel(vecs, factors, banned, k=k, n_valid=n,
                            tile=128, monkeypatch=monkeypatch))


@pytest.mark.parametrize("bucket,k", [(128, 10), (8, 64), (128, 64)])
def test_largest_bucket_and_k_match_jax_kernel(bucket, k, monkeypatch):
    factors = _int((N_ITEMS, 10), seed=51)
    vecs = _int((bucket, 10), seed=52)
    banned = _bans(bucket, N_ITEMS, WIDTH)
    port = _port(vecs, factors, banned, k=k, n_valid=N_ITEMS - 7)
    _same(port, _jax_kernel(vecs, factors, banned, k=k,
                            n_valid=N_ITEMS - 7, tile=128,
                            monkeypatch=monkeypatch))


@pytest.mark.parametrize("id_base", [0, 1, 640, 10**6])
def test_id_base_offsets_bans_and_ids(id_base):
    """With `id_base`, bans name rows by row + id_base and ids come back
    as row + id_base; ids outside the rows (below the base, past the
    last row, the filler) match nothing. The same answer as the local
    bans without a base, ids offset."""
    factors = _int((N_ITEMS, 6), seed=61)
    vecs = _int((5, 6), seed=62)
    local = _bans(5, N_ITEMS, WIDTH)
    local[:, -1] = N_ITEMS
    glob = np.where(local < N_ITEMS, local + id_base, 2**31 - 1)
    glob[:, -1] = id_base - 1 if id_base else N_ITEMS + 5  # no row
    glob = glob.astype(np.int32)
    s, i = fused_topk.fused_topk(torch.from_numpy(vecs),
                                 torch.from_numpy(factors),
                                 torch.from_numpy(glob), k=10,
                                 n_valid=N_ITEMS - 3, id_base=id_base)
    ref = _port(vecs, factors, local, k=10, n_valid=N_ITEMS - 3)
    np.testing.assert_array_equal(s.numpy(), ref[0])
    np.testing.assert_array_equal(i.numpy(), ref[1] + id_base)


@pytest.mark.parametrize("b,rank,k,fits", [
    (1, 64, 10, True), (64, 64, 10, True), (128, 64, 64, True),
    (128, 200, 64, False), (8, 2000, 10, False)])
def test_shared_memory_budget(b, rank, k, fits):
    """The wrapper refuses, before any launch, the shapes whose ring of
    two factor stages, queries and (warp, row) lists overflow a block's
    shared memory: the kernel's own formula (`smem_bytes`)."""
    need = fused_topk._smem_bytes(b, rank, k, fused_topk.MIN_STAGES)
    assert (need <= fused_topk._MAX_SMEM) == fits
    args = (torch.zeros((b, rank)), torch.zeros((300, rank)),
            torch.zeros((b, 4), dtype=torch.int32))
    if fits:
        fused_topk._check(*args, k, 300)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fused_topk._check(*args, k, 300)


def test_id_base_past_int32_refused():
    args = (torch.zeros((1, 4)), torch.zeros((300, 4)),
            torch.zeros((1, 4), dtype=torch.int32))
    fused_topk._check(*args, 5, 300, 2**31 - 301)
    with pytest.raises(ValueError, match="past int32"):
        fused_topk._check(*args, 5, 300, 2**31 - 300)


@pytest.mark.parametrize("name", ["kernel", "count", "product", "no_bound",
                                  "bound_every_tile"])
def test_kernel_variant_patches_apply(name):
    """The design probes patch the kernel's source by exact anchors;
    each must still find its anchor in the source as it is."""
    from predictionio_tpu_torch.tools import kernel_variants as kv
    src = kv.variant_source(name)
    assert (src == fused_topk.SOURCE.read_text()) == (name == "kernel")
    assert "score_blocks" in src and "merge_blocks" in src
