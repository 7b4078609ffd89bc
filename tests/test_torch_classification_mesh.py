"""The port's classification over a device mesh (`ops.forest`,
`ops.naive_bayes`, `ops.logreg` with `mesh=`) against its own
one-device training and the JAX package's mesh path, on the CPU.

The JAX package's `TestShardedClassification`
(`tests/test_classification.py`) at 1, 2, 3, 4 and 8 port shards
(`[torch.device("cpu")] * n`), at its tolerances:
- the forest equals the one-device forest exactly (split_feature,
  split_bin, leaf_class), at n = 600 and with padding at n = 601: its
  weights are whole numbers, so the summed histograms are exact;
- NB's pi and theta within rtol 1e-5 (its f32 sums in another order);
- logreg's w within rtol 5e-3 / atol 5e-4 and at least 99% of the
  predictions equal (200 full-batch Adam steps over another summation
  order).
Against the JAX mesh path on its 8 virtual CPU devices: a sharded level
fed the JAX draws chooses the JAX splits, as `test_torch_forest.py`'s
one-device level does (a tree may differ only at a near-tied gain); NB
and logreg at the tolerances above. A mesh with a "model" axis trains
over its "data" axis alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from predictionio_tpu.ops import forest as jfo
from predictionio_tpu.ops import logreg as jlr
from predictionio_tpu.ops import naive_bayes as jnb
from predictionio_tpu.parallel import MeshSpec as JMeshSpec
from predictionio_tpu.parallel import make_mesh as jmake_mesh
from predictionio_tpu_torch.ops import forest as pfo
from predictionio_tpu_torch.ops import logreg as plr
from predictionio_tpu_torch.ops import naive_bayes as pnb
from predictionio_tpu_torch.parallel import Mesh, MeshSpec, make_mesh
from test_torch_forest import _near_tied_trees

pytestmark = pytest.mark.torch

CPU = torch.device("cpu")
SHARDS = [1, 2, 3, 4, 8]


def cpu_mesh(n, **other):
    spec = {"data": n, **other}
    return make_mesh(MeshSpec(spec), [CPU] * int(np.prod(list(spec.values()))))


def _forest_data(n=600, f=8, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 3] > 0).astype(np.float32)
         + (x[:, 1] > 1).astype(np.float32))
    return x, y


def _nb_data():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 5, (203, 4)).astype(np.float32)
    return x, (x[:, 0] > 2).astype(np.float32)


def _lr_data():
    rng = np.random.RandomState(1)
    x = rng.randn(205, 6).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 0).astype(np.float32)


def _same_forest(a, b):
    for name in ("split_feature", "split_bin", "leaf_class"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("n,trees,depth,seed", [(600, 5, 4, 2),
                                                (601, 3, 3, 5)])
def test_forest_sharded_equals_one_device(n_shards, n, trees, depth, seed):
    x, y = _forest_data(n=n)
    kw = dict(n_trees=trees, max_depth=depth, seed=seed)
    one = pfo.forest_train(x, y, **kw, device="cpu")
    _same_forest(one, pfo.forest_train(x, y, **kw, mesh=cpu_mesh(n_shards)))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_nb_sharded_matches_single_and_jax(n_shards):
    x, y = _nb_data()
    one = pnb.nb_train(x, y, 1.0, device="cpu")
    got = pnb.nb_train(x, y, 1.0, mesh=cpu_mesh(n_shards))
    want = jnb.nb_train(x, y, 1.0, mesh=jmake_mesh(
        JMeshSpec({"data": n_shards})))
    for ref in (one, want):
        np.testing.assert_allclose(got.pi, ref.pi, rtol=1e-5)
        np.testing.assert_allclose(got.theta, ref.theta, rtol=1e-5)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_logreg_sharded_matches_single_and_jax(n_shards):
    x, y = _lr_data()
    one = plr.logreg_train(x, y, steps=50, device="cpu")
    got = plr.logreg_train(x, y, steps=50, mesh=cpu_mesh(n_shards))
    want = jlr.logreg_train(x, y, steps=50, mesh=jmake_mesh(
        JMeshSpec({"data": n_shards})))
    for ref in (one, want):
        np.testing.assert_allclose(got.w, ref.w, rtol=5e-3, atol=5e-4)
        agree = (plr.logreg_predict(got, x)
                 == np.asarray(ref.labels[np.argmax(x @ ref.w + ref.b, 1)]))
        assert agree.mean() > 0.99


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_level_equals_the_jax_mesh_level_on_its_draws(impurity,
                                                              n_shards):
    """`grow_level_sharded` fed the JAX package's threefry weights and
    feature ranks (subset 2 of 5) against the JAX `_grow_level` over a
    mesh of as many devices: the port's sharded level equals its
    one-device level exactly, and the JAX splits but at near ties."""
    t, n, f, b, c, nd = 4, 800, 5, 16, 3, 2
    rng = np.random.RandomState(3)
    x = rng.randn(n, f).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 2] > 0.5)).astype(np.int32)
    xb = jfo.apply_bins(x, jfo.quantile_bins(x, b)).astype(np.int32)
    fb = xb + np.arange(f, dtype=np.int32)[None, :] * b
    node = rng.randint(0, nd, (t, n)).astype(np.int32)
    kboot, klevel = jax.random.split(jax.random.PRNGKey(5))
    w = np.asarray(jax.random.poisson(kboot, 1.0, (t, n)), np.float32)
    ranks = np.array(jnp.argsort(jax.random.uniform(
        klevel, (t, nd, f)), axis=-1).argsort(-1))
    kw = dict(n_nodes=nd, n_classes=c, n_features=f, n_bins=b, subset=2,
              impurity=impurity)
    jf, jb, jnode = (np.asarray(a) for a in jfo._grow_level(
        klevel, jnp.asarray(fb), jnp.asarray(node), jnp.asarray(y),
        jnp.asarray(w), jnp.asarray(xb), mesh=jmake_mesh(
            JMeshSpec({"data": n_shards})), **kw))
    per = n // n_shards
    shards = [tuple(torch.from_numpy(np.ascontiguousarray(a))
                    for a in (fb[r], node[:, r].astype(np.int64),
                              y[r].astype(np.int64), w[:, r],
                              xb[r].astype(np.uint8)))
              for r in (slice(s * per, (s + 1) * per)
                        for s in range(n_shards))]
    pf, pb, pnodes = pfo.grow_level_sharded(
        shards, torch.from_numpy(ranks), cpu_mesh(n_shards).along("data"),
        **kw)
    of, ob, onode = pfo.grow_level(
        torch.from_numpy(fb), torch.from_numpy(node).long(),
        torch.from_numpy(y).long(), torch.from_numpy(w),
        torch.from_numpy(xb).to(torch.uint8), torch.from_numpy(ranks), **kw)
    pnode = torch.cat(pnodes, dim=1)
    assert torch.equal(pf, of) and torch.equal(pb, ob)
    assert torch.equal(pnode, onode)
    hist = pfo._histogram(torch.from_numpy(node * c + y[None, :]),
                          torch.from_numpy(w), torch.from_numpy(fb),
                          n_nodes=nd, c=c, f=f, b=b)
    pf, pb, pnode = pf.numpy(), pb.numpy(), pnode.numpy()
    tied = _near_tied_trees((pf, pb), (jf, jb), hist.numpy(), ranks, 2,
                            impurity, b)
    same = [k for k in range(t) if k not in tied]
    assert len(same) >= t - 1
    assert np.array_equal(pf[same], jf[same])
    assert np.array_equal(pnode[same], jnode[same])


def test_a_model_axis_replicates_the_data_shards():
    """data=2 x model=2 trains every classifier over its "data" axis:
    the forest equals data=2's exactly, NB and logreg too (the same
    shards in the same order)."""
    x, y = _forest_data()
    two, grid = cpu_mesh(2), cpu_mesh(2, model=2)
    _same_forest(pfo.forest_train(x, y, n_trees=3, max_depth=3, mesh=two),
                 pfo.forest_train(x, y, n_trees=3, max_depth=3, mesh=grid))
    xn, yn = _nb_data()
    a = pnb.nb_train(xn, yn, mesh=two)
    b = pnb.nb_train(xn, yn, mesh=grid)
    assert np.array_equal(a.theta, b.theta) and np.array_equal(a.pi, b.pi)
    xl, yl = _lr_data()
    a = plr.logreg_train(xl, yl, steps=20, mesh=two)
    b = plr.logreg_train(xl, yl, steps=20, mesh=grid)
    assert np.array_equal(a.w, b.w) and np.array_equal(a.b, b.b)


def test_model_device_and_timings_on_a_mesh():
    """The mesh-trained models predict on the mesh's first local device;
    NB reports transfer_s and solve_s, the forest bin_s and device_s, as
    on one device; the forest's fallback counts the unpadded labels."""
    x, y = _forest_data(n=601)
    tm: dict = {}
    m = pfo.forest_train(x, y, n_trees=2, max_depth=2, mesh=cpu_mesh(4),
                         timings=tm)
    assert m.device == "cpu" and {"bin_s", "device_s"} <= set(tm)
    xn, yn = _nb_data()
    tm = {}
    nb = pnb.nb_train(xn, yn, mesh=cpu_mesh(4), timings=tm)
    assert nb.device == "cpu" and {"transfer_s", "solve_s"} <= set(tm)
    np.testing.assert_array_equal(
        pnb.nb_predict(nb, xn), pnb.nb_predict(
            pnb.nb_train(xn, yn, device="cpu"), xn))


def test_a_model_axis_across_processes_is_refused():
    """Only "data" may span processes: a mesh whose "model" axis splits
    over two processes raises before any collective."""
    spanning = Mesh(("model", "data"), (2, 2), (CPU,) * 4, 0, 2)
    x, y = _nb_data()
    for train in (lambda: pnb.nb_train(x, y, mesh=spanning),
                  lambda: plr.logreg_train(x, y, steps=2, mesh=spanning),
                  lambda: pfo.forest_train(x, y, n_trees=2, max_depth=2,
                                           mesh=spanning)):
        with pytest.raises(NotImplementedError, match="'model' axis"):
            train()
