"""The port's random forest (`predictionio_tpu_torch.ops.forest`) against
the JAX package's `ops/forest.py`, on the CPU.

Bit for bit: `quantile_bins` and `apply_bins` (host numpy, the sampled
path included), `_histogram` on the whole and on the chunked path (the
weights are whole numbers, so every bin is exact in fp32), and a forest
of one tree over every feature (nothing drawn matters there). Split
selection and a whole level take the JAX package's own threefry weights
and ranks; a split may differ only where the node's two best gains lie
within GAIN_TIE (float64 gains from the same histogram), which the test
checks. A forest of 10 trees draws from the port's `torch.Generator`,
not threefry (by design), so it is held to the JAX forest's held-out
accuracy within 0.02. The host loop and the device traversal answer
alike, and both as the JAX model's predict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import forest as jfo
from predictionio_tpu_torch.ops import forest as pfo

pytestmark = pytest.mark.torch

GAIN_TIE = 1e-6


def _separable(n, seed):
    """The JAX tests' three-class data (tests/test_classification.py)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.zeros(n)
    y[x[:, 0] > 0.5] = 1
    y[(x[:, 0] <= 0.5) & (x[:, 1] > 0.3)] = 2
    return x, y


@pytest.mark.parametrize("n,bins,sample", [(3000, 32, None),
                                           (2000, 300, 500)])
def test_bins_are_bit_identical(monkeypatch, n, bins, sample):
    """Quantile edges (the row sample past `_QUANTILE_SAMPLE` rows too)
    and the binned features, uint8 and int32."""
    if sample is not None:
        monkeypatch.setattr(jfo, "_QUANTILE_SAMPLE", sample)
        monkeypatch.setattr(pfo, "_QUANTILE_SAMPLE", sample)
    x = np.random.RandomState(7).randn(n, 6).astype(np.float32)
    je, pe = jfo.quantile_bins(x, bins), pfo.quantile_bins(x, bins)
    assert pe.dtype == je.dtype and np.array_equal(pe, je)
    jb, pb = jfo.apply_bins(x, je), pfo.apply_bins(x, pe)
    assert pb.dtype == jb.dtype == (np.uint8 if bins < 257 else np.int32)
    assert np.array_equal(pb, jb)


def _hist_inputs(t=3, n=500, f=5, b=8, c=3, n_nodes=4, seed=0):
    rng = np.random.RandomState(seed)
    node = rng.randint(0, n_nodes, (t, n)).astype(np.int32)
    y = rng.randint(0, c, n).astype(np.int32)
    s = node * c + y[None, :]
    w = rng.poisson(1.0, (t, n)).astype(np.float32)
    xb = rng.randint(0, b, (n, f)).astype(np.int32)
    fb = xb + np.arange(f, dtype=np.int32)[None, :] * b
    return s, w, fb, dict(n_nodes=n_nodes, c=c, f=f, b=b)


@pytest.mark.parametrize("budget", [None, 4096])
def test_histogram_is_bit_identical(monkeypatch, budget):
    """The whole sample set in one scatter, and (with a budget of 4 KiB
    in both modules) in chunks: the JAX lax.scan over padded chunks, the
    port's loop over index_add_ chunks."""
    if budget is not None:
        monkeypatch.setattr(jfo, "_HIST_KEY_BUDGET", budget)
        monkeypatch.setattr(pfo, "_HIST_KEY_BUDGET", budget)
    s, w, fb, kw = _hist_inputs()
    want = np.asarray(jfo._histogram(jnp.asarray(s), jnp.asarray(w),
                                     jnp.asarray(fb), **kw))
    got = pfo._histogram(torch.from_numpy(s), torch.from_numpy(w),
                         torch.from_numpy(fb), **kw).numpy()
    assert got.shape == want.shape == (3, 4, 5, 8, 3)
    assert np.array_equal(got, want)
    assert got.sum() == w.sum() * kw["f"]


def _gains64(hist, ranks, subset, impurity):
    """Gains [t, nd, f*B] in float64 from a histogram, with the last bin
    and the features outside the subset at -inf."""
    h = hist.astype(np.float64)
    left = np.cumsum(h, axis=3)
    total = left[:, :, :, -1:, :]
    right = total - left

    def imp(cnt):
        n = cnt.sum(-1)
        p = cnt / np.maximum(n, 1e-9)[..., None]
        if impurity == "gini":
            return 1.0 - (p * p).sum(-1), n
        return -(p * np.log2(np.where(p > 0, p, 1.0))).sum(-1), n

    il, nl = imp(left)
    ir, nr = imp(right)
    ip, _ = imp(total[:, :, 0, 0, :])
    gain = ip[:, :, None, None] - (nl * il + nr * ir) / np.maximum(nl + nr,
                                                                  1e-9)
    gain[:, :, :, -1] = -np.inf
    gain[~(ranks < subset)] = -np.inf
    return gain.reshape(gain.shape[0], gain.shape[1], -1)


def _near_tied_trees(got, want, hist, ranks, subset, impurity, b):
    """Equal splits, or at a differing (tree, node) two best gains
    within GAIN_TIE of which the port took one: returns the trees with
    such a near-tie."""
    (gf, gb), (wf, wb) = got, want
    gains = _gains64(hist, ranks, subset, impurity)
    trees = set()
    for t, nd in zip(*np.nonzero((gf != wf) | (gb != wb))):
        g = np.sort(gains[t, nd])[::-1]
        assert g[0] - g[1] <= GAIN_TIE, (t, nd, g[:2])
        assert gains[t, nd, gf[t, nd] * b + gb[t, nd]] >= g[0] - GAIN_TIE
        trees.add(int(t))
    return trees


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_level_equals_the_jax_level_on_its_own_draws(impurity):
    """`_select_splits` and a whole `grow_level` fed the JAX package's
    threefry Poisson weights and per-node feature ranks (subset 2 of 5)
    choose the JAX splits and route every sample alike."""
    t, n, f, b, c, nd = 4, 800, 5, 16, 3, 2
    rng = np.random.RandomState(3)
    x = rng.randn(n, f).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 2] > 0.5)).astype(np.int32)
    xb = jfo.apply_bins(x, jfo.quantile_bins(x, b)).astype(np.int32)
    fb = xb + np.arange(f, dtype=np.int32)[None, :] * b
    node = rng.randint(0, nd, (t, n)).astype(np.int32)
    kboot, klevel = jax.random.split(jax.random.PRNGKey(5))
    w = np.asarray(jax.random.poisson(kboot, 1.0, (t, n)), np.float32)
    ranks = np.asarray(jnp.argsort(jax.random.uniform(
        klevel, (t, nd, f)), axis=-1).argsort(-1))
    kw = dict(n_nodes=nd, n_classes=c, n_features=f, n_bins=b, subset=2,
              impurity=impurity)
    jf, jb, jnode = (np.asarray(a) for a in jfo._grow_level(
        klevel, jnp.asarray(fb), jnp.asarray(node), jnp.asarray(y),
        jnp.asarray(w), jnp.asarray(xb), **kw))
    pf, pb, pnode = (a.numpy() for a in pfo.grow_level(
        torch.from_numpy(fb), torch.from_numpy(node).long(),
        torch.from_numpy(y).long(), torch.from_numpy(w),
        torch.from_numpy(xb).to(torch.uint8),
        torch.from_numpy(np.array(ranks)),
        **kw))
    hist = pfo._histogram(torch.from_numpy(node * c + y[None, :]),
                          torch.from_numpy(w), torch.from_numpy(fb),
                          n_nodes=nd, c=c, f=f, b=b)
    sf, sb = (a.numpy() for a in pfo._select_splits(
        hist, torch.from_numpy(np.array(ranks)), n_nodes=nd, c=c, f=f, b=b,
        subset=2, impurity=impurity))
    assert np.array_equal(sf, pf) and np.array_equal(sb, pb)
    tied = _near_tied_trees((pf, pb), (jf, jb), hist.numpy(), ranks, 2,
                            impurity, b)
    same = [k for k in range(t) if k not in tied]
    assert len(same) >= t - 1
    assert np.array_equal(pnode[same], jnode[same])
    assert set(np.unique(pnode)) <= set(range(2 * nd))


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_one_tree_over_every_feature_equals_the_jax_tree(impurity):
    """n_trees = 1, every feature: no draw matters, so the port's tree is
    the JAX package's, splits, bins and leaves."""
    x, y = _separable(1500, 0)
    kw = dict(n_trees=1, max_depth=3, impurity=impurity, seed=2)
    jm = jfo.forest_train(x, y, **kw)
    pm = pfo.forest_train(x, y, **kw, device="cpu")
    for name in ("bin_edges", "split_feature", "split_bin", "leaf_class",
                 "classes"):
        assert np.array_equal(getattr(pm, name), getattr(jm, name)), name
    assert (pm.predict(x) == y).mean() > 0.9


def test_forest_accuracy_within_002_of_the_jax_forest():
    """10 trees from the port's own draws: held-out accuracy on the JAX
    tests' separable data within 0.02 of the JAX forest's, both above
    0.95 (the JAX test's bar)."""
    x, y = _separable(3000, 0)
    xt, yt = _separable(1000, 1)
    jacc = (jfo.forest_train(x, y, n_trees=10, max_depth=5,
                             seed=0).predict(xt) == yt).mean()
    pm = pfo.forest_train(x, y, n_trees=10, max_depth=5, seed=0,
                          device="cpu")
    pm.sanity_check()
    pacc = (pm.predict(xt) == yt).mean()
    assert pacc > 0.95 and jacc > 0.95
    assert abs(pacc - jacc) <= 0.02, (pacc, jacc)


def test_draws_come_from_the_seeded_generator():
    """One seed, one forest; another seed draws other weights."""
    x, y = _separable(600, 4)
    kw = dict(n_trees=5, max_depth=3, device="cpu")
    a, b = (pfo.forest_train(x, y, seed=9, **kw) for _ in range(2))
    c = pfo.forest_train(x, y, seed=10, **kw)
    assert np.array_equal(a.split_feature, b.split_feature)
    assert np.array_equal(a.leaf_class, b.leaf_class)
    assert not (np.array_equal(a.split_feature, c.split_feature)
                and np.array_equal(a.split_bin, c.split_bin))


def test_host_and_device_predict_agree_and_match_the_jax_model():
    """Both routes of one model, at sizes on both sides of the
    crossover, and the JAX `ForestModel.predict` on the same arrays."""
    rng = np.random.RandomState(3)
    x = rng.randn(600, 8).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float32)
         + (x[:, 1] > 1).astype(np.float32))
    pm = pfo.forest_train(x, y, n_trees=4, max_depth=4, seed=1,
                          device="cpu")
    jm = jfo.ForestModel(pm.bin_edges, pm.split_feature, pm.split_bin,
                         pm.leaf_class, pm.classes, pm.max_depth)
    xb = pfo.apply_bins(x, pm.bin_edges)
    assert np.array_equal(pm.predict_host(xb), pm.predict_device(xb))
    big = np.repeat(x[:300], 20, axis=0)               # over the crossover
    assert pm.n_trees * len(big) >= pm.HOST_CROSSOVER_CELLS
    assert np.array_equal(pm.predict(big), jm.predict(big))
    assert np.array_equal(pm.predict(x[:5]), jm.predict(x[:5]))
    assert np.array_equal(pm.predict(big)[:100:20], pm.predict(x[:5]))


def test_entropy_single_tree_and_a_pure_node():
    """The JAX tests' entropy tree and an all-one-class forest (every node
    pure from the root: always-left splits, leaves of the one class)."""
    x, y = _separable(800, 5)
    m = pfo.forest_train(x, y, n_trees=1, max_depth=4, impurity="entropy",
                         seed=2, device="cpu")
    assert (m.predict(x) == y).mean() > 0.9
    x = np.random.RandomState(6).randn(100, 3).astype(np.float32)
    m = pfo.forest_train(x, np.ones(100), n_trees=3, max_depth=4, seed=0,
                         device="cpu")
    assert (m.predict(x) == 1.0).all()
    # every sample stays in node 0 of each level (gain 0: always left,
    # feature 0); the empty nodes take bin 0 of their first allowed
    # feature (gain 1 - 0), as in the JAX package
    first = [(1 << level) - 1 for level in range(4)]
    assert (m.split_feature[:, first] == 0).all()
    assert (m.split_bin[:, first] == 31).all()
    assert (np.delete(m.split_bin, first, axis=1) == 0).all()


def test_impurity_matches_the_jax_impurity():
    counts = np.array([[3.0, 1.0, 0.0], [0.0, 0.0, 0.0], [2.0, 2.0, 2.0]],
                      np.float32)
    total = counts.sum(-1, keepdims=True)
    for kind in ("gini", "entropy"):
        want = np.asarray(jfo._impurity(jnp.asarray(counts),
                                        jnp.asarray(total), kind))
        got = pfo._impurity(torch.from_numpy(counts),
                            torch.from_numpy(total), kind).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="Unknown impurity"):
        pfo._impurity(torch.from_numpy(counts), torch.from_numpy(total),
                      "mse")
    with pytest.raises(ValueError, match="featureSubsetStrategy"):
        pfo._subset_size("half", 10, 3)
    assert [pfo._subset_size(s, 100, 10) for s in
            ("auto", "all", "sqrt", "log2", "onethird")] == \
        [jfo._subset_size(s, 100, 10) for s in
         ("auto", "all", "sqrt", "log2", "onethird")]


def test_training_refuses_to_carry_on_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _separable(50, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pfo.forest_train(x, y, n_trees=2, max_depth=2)
    m = pfo.forest_train(x, y, n_trees=2, max_depth=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.to()
    cuda_model = pfo.ForestModel(m.bin_edges, m.split_feature, m.split_bin,
                                 m.leaf_class, m.classes, m.max_depth)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_model.predict_device(pfo.apply_bins(x, m.bin_edges))
