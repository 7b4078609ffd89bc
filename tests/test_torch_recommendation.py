"""The port's recommendation template and deploy warmup against the JAX
package: a model trained by `predictionio_tpu.ops.als.als_train` is
carried over with `als_model_from_numpy` (and through the `.npz` round
trip), both algorithms are warmed, and `batch_predict` must give the
same item lists for blackList, whiteList, unknown-user, num > 10 and
num > n_items queries. On integer-valued factors the scores are
bit-identical too; on trained (real-valued) factors they agree to
rtol=1e-5, the fp32 summation order of the two matmuls being the only
difference."""

import numpy as np
import pytest
import torch

from predictionio_tpu.core import workflow as jwf
from predictionio_tpu.ingest import BiMap
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch.core import workflow as pwf
from predictionio_tpu_torch.models import recommendation as prec
from predictionio_tpu_torch.ops import als as pals
from predictionio_tpu_torch.ops import fused_topk
from predictionio_tpu_torch.ops import topk as pt
from predictionio_tpu_torch.ops import topk_sharded as ps
from predictionio_tpu_torch.ops import topk_tiered as ptt

pytestmark = pytest.mark.torch

N_USERS, N_ITEMS = 30, 45


def _trained():
    rng = np.random.default_rng(0)
    u = rng.integers(0, N_USERS, 400)
    i = rng.integers(0, N_ITEMS, 400)
    r = rng.integers(1, 6, 400).astype(np.float32)
    x, y = jals.als_train((u, i, r), N_USERS, N_ITEMS, rank=8, iterations=4,
                          seed=3)
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


def _integer():
    rng = np.random.default_rng(1)
    return (rng.integers(-3, 4, (N_USERS, 8)).astype(np.float32),
            rng.integers(-3, 4, (N_ITEMS, 8)).astype(np.float32))


USERS = [f"u{n}" for n in range(N_USERS)]
ITEMS = [f"i{n}" for n in range(N_ITEMS)]

BATCHES = {
    "blacklist": [dict(user="u1", num=4, blackList=["i0", "i3", "nope"]),
                  dict(user="u2", num=10),
                  dict(user="ghost", num=3),
                  dict(user="u3", num=2, blackList=ITEMS[::2])],
    "whitelist": [dict(user="u4", num=5, whiteList=["i1", "i2", "i9",
                                                    "nope"]),
                  dict(user="u5", num=3, blackList=["i7"]),
                  dict(user="u6", num=4, whiteList=ITEMS[10:30],
                       blackList=["i11"])],
    "unknown": [dict(user="ghost", num=3), dict(user="", num=1)],
    "num_over_plan": [dict(user="u7", num=15), dict(user="u8", num=12,
                                                    blackList=["i5"])],
    "num_over_items": [dict(user="u9", num=N_ITEMS + 10),
                       dict(user="u10", num=60, blackList=ITEMS[:40])],
    "all_banned": [dict(user="u11", num=5, blackList=ITEMS)],
}


def _jax_algo(x, y):
    model = jals.ALSModel(x, y, BiMap.from_keys(USERS),
                          BiMap.from_keys(ITEMS))
    algo = jrec.ALSAlgorithm(jrec.ALSAlgorithmParams())
    algo.warm_serving(model, [1, 2, 4, 8])
    return algo, model


def _port_algo(model):
    algo = prec.ALSAlgorithm()
    assert algo.warm_serving(model, [1, 2, 4, 8]) == 4
    return algo


def _predict(algo, model, qcls, batch):
    return dict(algo.batch_predict(model, [(i, qcls(**q))
                                           for i, q in enumerate(batch)]))


def _compare(jout, pout, exact):
    assert jout.keys() == pout.keys()
    for i in jout:
        j = [(s.item, s.score) for s in jout[i].itemScores]
        p = [(s.item, s.score) for s in pout[i].itemScores]
        assert [it for it, _ in p] == [it for it, _ in j]
        if exact:
            assert [s for _, s in p] == [s for _, s in j]
        else:
            np.testing.assert_allclose([s for _, s in p], [s for _, s in j],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factors", ["trained", "integer"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_batch_predict_matches_jax(factors, batch):
    x, y = _trained() if factors == "trained" else _integer()
    jalgo, jmodel = _jax_algo(x, y)
    pmodel = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    palgo = _port_algo(pmodel)
    _compare(_predict(jalgo, jmodel, jrec.Query, BATCHES[batch]),
             _predict(palgo, pmodel, prec.Query, BATCHES[batch]),
             exact=factors == "integer")


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("kind", ["sharded", "tiered"])
def test_batch_predict_behind_every_plan_matches_jax(kind, batch,
                                                     monkeypatch):
    """Behind a sharded or a tiered plan, blackList batches go through the
    plan and the generic paths (whiteList, num > 10, unknown users) score
    against the model's item master; every answer is the JAX
    single-device template's, bit for bit on integer factors."""
    x, y = _integer()
    jalgo, jmodel = _jax_algo(x, y)
    pmodel = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    mesh = None
    if kind == "sharded":
        mesh = ps.ServeMesh(("cpu",) * 3, forced=True)
    else:
        monkeypatch.setenv("PIO_SERVE_TIER", "on")
        monkeypatch.setenv("PIO_TIER_HOT_FRAC", "0.5")
    palgo = prec.ALSAlgorithm()
    assert palgo.warm_serving(pmodel, [1, 2, 4, 8], mesh=mesh) == 4
    plan_class = (ps.ShardedBucketedTopK if kind == "sharded"
                  else ptt.TieredTopK)
    assert isinstance(palgo._serve_plan, plan_class)
    assert palgo._generic_factors(pmodel) is pmodel.item_factors
    _compare(_predict(jalgo, jmodel, jrec.Query, BATCHES[batch]),
             _predict(palgo, pmodel, prec.Query, BATCHES[batch]), exact=True)


def test_host_master_auto_shards_past_one_device(monkeypatch):
    """An item master in host RAM lets the deploy shard on its own: over
    an un-forced mesh, a catalog past one device's budget shards, and one
    within it stays on a single device, whose resident copy the generic
    paths then use."""
    x, y = _integer()
    monkeypatch.setattr(pt, "plan_resident_bytes", lambda: 0.0)
    mesh = ps.ServeMesh(("cpu",) * 3)
    for hbm, plan_class in ((y.nbytes, ps.ShardedBucketedTopK),
                            (100 * y.nbytes, pt.BucketedTopK)):
        monkeypatch.setenv("PIO_DEVICE_HBM_BYTES", str(hbm))
        model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu",
                                          items_device="cpu")
        algos, _, _ = pwf.prepare_deploy(prec.RecommendationEngine.apply(),
                                         [model], warm_batch_max=4,
                                         mesh=mesh)
        palgo = algos[0]
        assert isinstance(palgo._serve_plan, plan_class)
        if plan_class is pt.BucketedTopK:
            assert palgo._generic_factors(model) is palgo._serve_plan.factors


def test_blacklist_batches_go_through_the_plan():
    x, y = _integer()
    pmodel = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    palgo = _port_algo(pmodel)
    calls = palgo._serve_plan.calls
    _predict(palgo, pmodel, prec.Query, BATCHES["blacklist"])
    assert palgo._serve_plan.calls == calls + 1
    _predict(palgo, pmodel, prec.Query, BATCHES["num_over_plan"])
    _predict(palgo, pmodel, prec.Query, BATCHES["whitelist"])
    assert palgo._serve_plan.calls == calls + 1


def test_npz_round_trip(tmp_path):
    x, y = _trained()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    path = tmp_path / "model.npz"
    model.save_npz(path)
    back = pals.load_npz(path, device="cpu")
    assert torch.equal(back.user_factors, model.user_factors)
    assert torch.equal(back.item_factors, model.item_factors)
    assert back.users == model.users and back.items == model.items
    jalgo, jmodel = _jax_algo(x, y)
    palgo = _port_algo(back)
    for batch in BATCHES.values():
        _compare(_predict(jalgo, jmodel, jrec.Query, batch),
                 _predict(palgo, back, prec.Query, batch), exact=False)


def test_items_device_places_the_master(tmp_path):
    """`items_device` puts the item master apart from the user factors;
    the model's serving device is that of its user factors."""
    x, y = _integer()
    path = tmp_path / "model.npz"
    pals.als_model_from_numpy(x, y, USERS, ITEMS,
                              device="cpu").save_npz(path)
    back = pals.load_npz(path, device="cpu", items_device="cpu")
    assert back.item_factors.device.type == "cpu"
    assert torch.equal(back.item_factors, torch.from_numpy(y))
    split = pals.ALSModel(back.user_factors,
                          torch.empty(y.shape, device="meta"),
                          back.users, back.items)
    assert split.device == torch.device("cpu")


def test_model_checks():
    x, y = _integer()
    with pytest.raises(ValueError, match="duplicate"):
        pals.als_model_from_numpy(x, y, ["a"] * N_USERS, ITEMS, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        pals.als_model_from_numpy(x, y, USERS[:-1], ITEMS, device="cpu")
    bad = y.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        pals.als_model_from_numpy(x, bad, USERS, ITEMS, device="cpu")


def test_train_then_serve_on_the_cpu():
    """The template trains (the port's `als_train`, on the CPU) and the
    model it returns warms and answers like any carried-over model."""
    from predictionio_tpu_torch.core.runtime import RuntimeContext
    from predictionio_tpu_torch.ingest.arrays import RatingColumns
    from predictionio_tpu_torch.ingest.bimap import BiMap as PBiMap
    rng = np.random.default_rng(0)
    cols = RatingColumns(rng.integers(0, N_USERS, 400).astype(np.int32),
                         rng.integers(0, N_ITEMS, 400).astype(np.int32),
                         rng.integers(1, 6, 400).astype(np.float32),
                         np.zeros(400, np.int64), PBiMap.from_keys(USERS),
                         PBiMap.from_keys(ITEMS))
    algo = prec.ALSAlgorithm(prec.ALSAlgorithmParams(rank=8,
                                                     num_iterations=4))
    model = algo.train(RuntimeContext(device="cpu"), cols)
    assert model.user_factors.shape == (N_USERS, 8)
    assert model.users == cols.users and model.items == cols.items
    assert algo.warm_serving(model, [1, 2, 4, 8]) == 4
    out = _predict(algo, model, prec.Query, BATCHES["blacklist"])
    assert [s.item for s in out[0].itemScores if s.item in ("i0", "i3")] \
        == []
    assert len(out[1].itemScores) == 10 and out[2].itemScores == ()


@pytest.mark.parametrize("batch_max,observed", [
    (64, None), (1, None), (20, None), (64, {4: 3, 33: 1, "x": 2}),
    (8, {64: 5, 2: 0})])
def test_derive_warm_buckets_matches_jax(batch_max, observed):
    assert pwf.derive_warm_buckets(batch_max, observed) == \
        jwf.derive_warm_buckets(batch_max, observed)


def test_prepare_deploy_warms_the_plan():
    x, y = _integer()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")
    algos, models, serving = pwf.prepare_deploy(
        prec.RecommendationEngine.apply(), [model], warm_batch_max=16)
    assert algos[0]._serve_plan.buckets == (1, 2, 4, 8, 16)
    assert algos[0]._serve_plan.calls == 5
    assert models == [model]
    assert serving.serve(None, ["first", "second"]) == "first"


def test_warmup_failure_raises(monkeypatch):
    """Unlike the JAX package, which logs a failed warmup and serves on
    its generic paths, the port raises: a kernel that does not build or
    launch must not hide behind the plain version."""
    x, y = _integer()
    model = pals.als_model_from_numpy(x, y, USERS, ITEMS, device="cpu")

    def broken(*a, **kw):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(fused_topk, "fused_topk", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pwf.prepare_deploy(prec.RecommendationEngine.apply(), [model],
                           warm_batch_max=4)
