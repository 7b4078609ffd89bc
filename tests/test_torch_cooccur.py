"""The port's cooccurrence counting (`predictionio_tpu_torch.ops.cooccur`)
against the JAX package's `ops/cooccur.py`, on the CPU.

Counts are small integers, exact in fp32 whatever the order of the sums
and the scatter's atomics, and both packages rank by (count desc, index
asc), ties included (a row short of n partners fills its tail with
zero-count slots by lowest index, the zeroed self column among them).
So every comparison here is `np.array_equal`: the 8 cases of
`tests/test_cooccur.py` and the op cases of `tests/test_similarproduct.py`
through both modules, then ties, rows short of n partners, several row
blocks and pair chunks, the cap and `merge_pair_counts`."""

import numpy as np
import pytest

from predictionio_tpu.ops import cooccur as jco
from predictionio_tpu_torch.ops import cooccur as pco

pytestmark = pytest.mark.torch

CPU = "cpu"


def _random_pairs(rng, n_users, n_items, n_events):
    return rng.randint(0, n_users, n_events), rng.randint(0, n_items,
                                                           n_events)


def _equal(p, j):
    assert p.top_items.dtype == np.int32 and p.top_counts.dtype == np.float32
    assert np.array_equal(p.top_items, np.asarray(j.top_items))
    assert np.array_equal(p.top_counts, np.asarray(j.top_counts))


@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_matches_dense_and_jax(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    n_users, n_items = 40, 50
    u, i = _random_pairs(rng, n_users, n_items, 600)
    dense = pco.top_cooccurrences(
        pco.cooccurrence_matrix(u, i, n_users, n_items, device=CPU), 7,
        device=CPU)
    _equal(dense, jco.top_cooccurrences(
        jco.cooccurrence_matrix(u, i, n_users, n_items), 7))
    # a small row block and a tiny pair chunk cross block boundaries
    monkeypatch.setattr(pco, "_PAIR_CHUNK", 16)
    monkeypatch.setattr(jco, "_PAIR_CHUNK", 16)
    stream = pco.top_cooccurrences_streaming(u, i, n_users, n_items, 7,
                                             row_block=8, device=CPU)
    _equal(stream, dense)   # zero-count ties too, not only where c > 0
    _equal(stream, jco.top_cooccurrences_streaming(u, i, n_users, n_items,
                                                   7, row_block=8))


def test_duplicate_events_count_once():
    u = np.array([5, 5, 5, 5])
    i = np.array([0, 0, 0, 1])
    m = pco.top_cooccurrences_streaming(u, i, 10, 3, 2, device=CPU)
    assert m.top_counts[0, 0] == 1.0 and m.top_items[0, 0] == 1
    assert m.top_counts[1, 0] == 1.0 and m.top_items[1, 0] == 0
    _equal(m, jco.top_cooccurrences_streaming(u, i, 10, 3, 2))


def test_empty_events():
    m = pco.top_cooccurrences_streaming(
        np.array([], np.int64), np.array([], np.int64), 0, 5, 3, device=CPU)
    assert m.top_items.shape == (5, 3)
    assert not m.top_counts.any()
    _equal(m, jco.top_cooccurrences_streaming(
        np.array([], np.int64), np.array([], np.int64), 0, 5, 3))


def test_small_catalog_routes_dense(monkeypatch):
    called = {}
    real = pco.cooccurrence_matrix

    def spy(*a, **k):
        called["dense"] = True
        return real(*a, **k)
    monkeypatch.setattr(pco, "cooccurrence_matrix", spy)
    m = pco.top_cooccurrences_from_pairs(np.array([0, 0]), np.array([0, 1]),
                                         1, 2, 1, device=CPU)
    assert called.get("dense")
    _equal(m, jco.top_cooccurrences_from_pairs(np.array([0, 0]),
                                               np.array([0, 1]), 1, 2, 1))


def test_large_catalog_never_builds_dense(monkeypatch):
    """A 59,000-item catalog routes to streaming and never builds the
    dense n^2 matrix; blocks no event touches are skipped."""
    def boom(*a, **k):
        raise AssertionError("dense n^2 path used at catalog scale")
    monkeypatch.setattr(pco, "cooccurrence_matrix", boom)
    n_items = 59_000
    rng = np.random.RandomState(0)
    u = rng.randint(0, 200, 3000)
    i = np.concatenate([rng.randint(0, 40, 2800),
                        rng.randint(58_990, n_items, 200)])
    m = pco.top_cooccurrences_from_pairs(u, i, 200, n_items, 10, device=CPU)
    assert m.top_items.shape == (n_items, 10)
    assert m.top_counts[:40].any() and m.top_counts[58_990:].any()
    assert not m.top_counts[1000:58_000].any()
    _equal(m, jco.top_cooccurrences_from_pairs(u, i, 200, n_items, 10))


def test_cap_routes_streaming_and_bounds_degree():
    n_items = 30
    u = np.zeros(n_items, np.int64)
    i = np.arange(n_items, dtype=np.int64)
    m = pco.top_cooccurrences_from_pairs(u, i, 1, n_items, 5,
                                         max_items_per_user=4, device=CPU)
    assert (m.top_counts > 0).sum() == 4 * 3   # 4 items x 3 others
    _equal(m, jco.top_cooccurrences_from_pairs(u, i, 1, n_items, 5,
                                               max_items_per_user=4))


def test_cap_is_deterministic_and_uniformish():
    pairs = np.stack([np.zeros(100, np.int64),
                      np.arange(100, dtype=np.int64)], axis=1)
    a = pco._cap_users(pairs, 10, seed=3)
    np.testing.assert_array_equal(a, pco._cap_users(pairs, 10, seed=3))
    np.testing.assert_array_equal(a, jco._cap_users(pairs, 10, seed=3))
    assert len(a) == 10
    c = pco._cap_users(pairs, 10, seed=4)
    assert set(map(tuple, a)) != set(map(tuple, c))


def test_cap_noop_below_cap():
    rng = np.random.RandomState(0)
    u, i = _random_pairs(rng, 20, 15, 100)
    pairs = np.unique(np.stack([u, i], axis=1), axis=0)
    capped = pco._cap_users(pairs, 50, seed=0)
    capped = capped[np.lexsort((capped[:, 1], capped[:, 0]))]
    np.testing.assert_array_equal(pairs, capped)


# -- the similar-product template's op cases --------------------------------

def test_matrix_matches_numpy_and_jax():
    u = np.array([0, 0, 1, 1, 2], np.int32)
    i = np.array([0, 1, 0, 1, 1], np.int32)
    c = pco.cooccurrence_matrix(u, i, 3, 2, device=CPU)
    assert c[0, 1] == 2 and c[1, 0] == 2
    assert c[0, 0] == 2 and c[1, 1] == 3   # popularity on the diagonal
    assert np.array_equal(c, np.asarray(jco.cooccurrence_matrix(u, i, 3, 2)))


def test_dedup_duplicate_views():
    u = np.array([0, 0, 0], np.int32)
    i = np.array([0, 0, 1], np.int32)
    c = pco.cooccurrence_matrix(u, i, 1, 2, device=CPU)
    assert c[0, 1] == 1
    assert np.array_equal(c, np.asarray(jco.cooccurrence_matrix(u, i, 1, 2)))


def test_top_excludes_self():
    c = np.array([[5.0, 2.0], [2.0, 7.0]])
    m = pco.top_cooccurrences(c, 1, device=CPU)
    assert m.top_items[0, 0] == 1 and m.top_counts[0, 0] == 2.0
    _equal(m, jco.top_cooccurrences(c, 1))


# -- beyond the JAX package's cases ------------------------------------------

def test_ties_and_rows_short_of_n_partners():
    """Every count ties (each user views the same few items), and some
    items have fewer partners than n: both tails are the lowest zero
    indexes, the self column among them, in the JAX order. A row block
    that no event touches is skipped by both packages' streaming path:
    its rows stay all zero (ids too), where the dense path ranks their
    zero counts 0, 1, 2, ..."""
    u = np.repeat(np.arange(6), 4)
    i = np.tile([3, 7, 8, 11], 6)
    u = np.r_[u, [9, 9]]
    i = np.r_[i, [0, 14]]
    n_items = 16
    for n in (3, 8, 16):
        dense = pco.top_cooccurrences(
            pco.cooccurrence_matrix(u, i, 10, n_items, device=CPU), n,
            device=CPU)
        _equal(dense, jco.top_cooccurrences(
            jco.cooccurrence_matrix(u, i, 10, n_items), n))
        stream = pco.top_cooccurrences_streaming(u, i, 10, n_items, n,
                                                 row_block=5, device=CPU)
        _equal(stream, jco.top_cooccurrences_streaming(
            u, i, 10, n_items, n, row_block=5))
        # rows 0-14 lie in touched blocks and equal the dense lists; the
        # block of row 15 holds no event
        _equal(pco.CooccurrenceModel(stream.top_items[:15],
                                     stream.top_counts[:15]),
               pco.CooccurrenceModel(dense.top_items[:15],
                                     dense.top_counts[:15]))
        assert not stream.top_items[15].any()
    m = pco.top_cooccurrences(
        pco.cooccurrence_matrix(u, i, 10, n_items, device=CPU), 8,
        device=CPU)
    assert m.top_items[3].tolist()[:3] == [7, 8, 11]
    assert m.top_items[0].tolist()[:3] == [14, 0, 1]   # self zeroed, kept


@pytest.mark.parametrize("row_block,chunk", [(8, 5), (24, 64), (1000, 8192)])
def test_row_blocks_and_pair_chunks(row_block, chunk, monkeypatch):
    rng = np.random.RandomState(4)
    n_items = 200
    u = rng.randint(0, 80, 3000)
    i = rng.zipf(1.3, 3000) % n_items
    want = jco.top_cooccurrences(jco.cooccurrence_matrix(u, i, 80, n_items),
                                 12)
    monkeypatch.setattr(pco, "_PAIR_CHUNK", chunk)
    got = pco.top_cooccurrences_streaming(u, i, 80, n_items, 12,
                                          row_block=row_block, device=CPU)
    _equal(got, want)


def test_budget_sets_the_row_block(monkeypatch):
    seen = []
    real = pco._block_topk

    def spy(c_b, b0, k):
        seen.append(c_b.shape[0])
        return real(c_b, b0, k)
    monkeypatch.setattr(pco, "_block_topk", spy)
    rng = np.random.RandomState(2)
    u, i = rng.randint(0, 30, 900), rng.randint(0, 300, 900)
    m = pco.top_cooccurrences_streaming(u, i, 30, 300, 5,
                                        block_budget_bytes=4 * 301 * 70,
                                        device=CPU)
    assert seen == [64] * 4 + [300 - 256]   # 70 rows -> 64, the floor
    _equal(m, jco.top_cooccurrences_streaming(
        u, i, 30, 300, 5, block_budget_bytes=4 * 301 * 70))


@pytest.mark.parametrize("cap,seed", [(3, 0), (10, 5)])
def test_cap_matches_jax(cap, seed):
    rng = np.random.RandomState(seed)
    u, i = rng.randint(0, 50, 2500), rng.zipf(1.2, 2500) % 400
    _equal(pco.top_cooccurrences_streaming(
        u, i, 50, 400, 9, max_items_per_user=cap, seed=seed, device=CPU),
        jco.top_cooccurrences_streaming(
            u, i, 50, 400, 9, max_items_per_user=cap, seed=seed))


def test_dense_route_equals_streaming_route_at_the_limit():
    """At `_DENSE_ITEM_LIMIT` items the router takes the dense product;
    the streaming route gives the same lists, bit for bit."""
    n_items = pco._DENSE_ITEM_LIMIT
    rng = np.random.RandomState(6)
    u, i = rng.randint(0, 300, 6000), rng.zipf(1.3, 6000) % n_items
    dense = pco.top_cooccurrences_from_pairs(u, i, 300, n_items, 10,
                                             device=CPU)
    _equal(dense, pco.top_cooccurrences_streaming(u, i, 300, n_items, 10,
                                                  device=CPU))


def test_merge_pair_counts_matches_jax():
    rng = np.random.RandomState(1)
    u, i = rng.randint(0, 40, 700), rng.randint(0, 60, 700)
    base = pco.top_cooccurrences_streaming(u, i, 40, 60, 6, device=CPU)
    jbase = jco.CooccurrenceModel(base.top_items.copy(),
                                  base.top_counts.copy())
    updates = {(int(a), int(b)): float(c) for a, b, c in zip(
        rng.randint(0, 60, 50), rng.randint(0, 60, 50),
        rng.randint(1, 4, 50))}
    got = pco.merge_pair_counts(base, updates)
    _equal(got, jco.merge_pair_counts(jbase, updates))
    touched = {r for a, b in updates for r in (a, b) if a != b}
    untouched = [r for r in range(60) if r not in touched]
    assert np.array_equal(got.top_items[untouched],
                          base.top_items[untouched])
    with pytest.raises(ValueError, match="outside catalog"):
        pco.merge_pair_counts(base, {(0, 60): 1.0})


def test_entry_points_default_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i = np.array([0, 0]), np.array([0, 1])
    for call in (lambda: pco.cooccurrence_matrix(u, i, 1, 2),
                 lambda: pco.top_cooccurrences(np.eye(2), 1),
                 lambda: pco.top_cooccurrences_streaming(u, i, 1, 2, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
